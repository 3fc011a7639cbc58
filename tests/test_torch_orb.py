"""Parity of the port's ORB front end (image ops, FAST, selection,
orientation, BRIEF) with the JAX package, stage by stage: each stage gets the
same input in both packages, so one stage's rounding cannot hide or cause a
difference in the next."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.io import synthetic as jsyn
from rumi_slam_tpu.ops import fast as jfast
from rumi_slam_tpu.ops import image as jimg
from rumi_slam_tpu.ops import orb as jorb
from rumi_slam_tpu.ops import select as jsel
from rumi_slam_tpu_torch.ops import fast as tfast
from rumi_slam_tpu_torch.ops import image as timg
from rumi_slam_tpu_torch.ops import orb as torb
from rumi_slam_tpu_torch.ops import select as tsel

torch.set_num_threads(1)

H, W = 240, 320


def random_image(seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)


def rendered_image():
    """A 320x240 frame of the synthetic world (the tests' textured input)."""
    seq = jsyn.SyntheticSequence(n_frames=1, width=W, height=H, seed=7)
    return np.asarray(seq.frame(0)[0])


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- image ops

@pytest.mark.parametrize("level", [1, 2, 3])
def test_pyramid_level_within_5e3(level):
    """Antialiased bilinear resize: the same triangle filter as
    jax.image.resize, summed in another order (4.3e-3 at level 1 on a random
    480x640 image)."""
    img = random_image()
    pj = jimg.build_pyramid(jnp.asarray(img), level + 1, 1.2)
    pt = timg.build_pyramid(t(img), level + 1, 1.2)
    assert tuple(pt[level].shape) == pj[level].shape
    np.testing.assert_allclose(pt[level].numpy(), np.asarray(pj[level]), rtol=0, atol=5e-3)


def test_gaussian_blur_within_1e4():
    img = random_image(1)
    np.testing.assert_allclose(timg.gaussian_blur(t(img)).numpy(),
                               np.asarray(jimg.gaussian_blur(jnp.asarray(img))),
                               rtol=0, atol=1e-4)


def test_max_pool3x3_exact():
    img = random_image(2)
    np.testing.assert_array_equal(timg.max_pool3x3(t(img)).numpy(),
                                  np.asarray(jimg.max_pool3x3(jnp.asarray(img))))


def _centers(n=64, seed=3):
    rng = np.random.default_rng(seed)
    yx = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], -1).astype(np.int32)
    yx[:4] = [[0, 0], [H - 1, W - 1], [0, W - 1], [H - 1, 0]]  # reflect at every border
    return yx


def test_gather_patches_exact():
    img, yx = random_image(4), _centers()
    np.testing.assert_array_equal(
        timg.gather_patches(t(img), t(yx), 19).numpy(),
        np.asarray(jimg.gather_patches(jnp.asarray(img), jnp.asarray(yx), 19)))


def test_gather_patches_multi_exact():
    imgs = np.stack([random_image(5), random_image(6)])
    yx = _centers(seed=7)
    np.testing.assert_array_equal(
        timg.gather_patches_multi(t(imgs), t(yx), 19).numpy(),
        np.asarray(jimg.gather_patches_multi(jnp.asarray(imgs), jnp.asarray(yx), 19)))


# ------------------------------------------------------- FAST, NMS, select

def _level(level):
    img = rendered_image()
    return np.asarray(jimg.build_pyramid(jnp.asarray(img), level + 1, 1.2)[level])


@pytest.mark.parametrize("level", [0, 2])
def test_fast_score_pair_same_corners(level):
    """Same level image: identical corner sets; scores agree to float32
    summation order (a sum of 16 terms)."""
    il = _level(level)
    sj, wj = jfast.fast_score_pair(jnp.asarray(il), 20.0, 7.0)
    st, wt = tfast.fast_score_pair(t(il), 20.0, 7.0)
    for a, b in ((sj, st), (wj, wt)):
        a = np.asarray(a)
        np.testing.assert_array_equal(b.numpy() > 0, a > 0)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-4)
    assert (np.asarray(wj) > 0).sum() > 50  # the frame is corner-rich


def test_fast_score_matches_pair():
    il = _level(0)
    np.testing.assert_array_equal(tfast.fast_score(t(il), 20.0).numpy(),
                                  tfast.fast_score_pair(t(il), 20.0, 7.0)[0].numpy())
    np.testing.assert_allclose(tfast.fast_score(t(il), 7.0).numpy(),
                               np.asarray(jfast.fast_score(jnp.asarray(il), 7.0)),
                               rtol=1e-5, atol=1e-4)


def test_nms3x3_exact():
    score = np.asarray(jfast.fast_score(jnp.asarray(_level(0)), 7.0))
    np.testing.assert_array_equal(tfast.nms3x3(t(score)).numpy(),
                                  np.asarray(jfast.nms3x3(jnp.asarray(score))))


@pytest.mark.parametrize("n_total,cell,k_cell", [(256, 32, 5), (64, 16, 3), (2000, 32, 5)])
def test_select_keypoints_identical(n_total, cell, k_cell):
    """Same score map: identical yx, scores and validity, including the order
    among ties (scores quantised to a few values, plus all the zeros)."""
    rng = np.random.default_rng(8)
    score = (rng.integers(0, 4, (H, W)) * (rng.random((H, W)) < 0.05)).astype(np.float32)
    out_j = jsel.select_keypoints(jnp.asarray(score), n_total, cell=cell, k_cell=k_cell)
    out_t = tsel.select_keypoints(t(score), n_total, cell=cell, k_cell=k_cell)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------- ORB

@pytest.mark.parametrize("name", ["PATTERN", "ROT_TABLE", "_SAMPLING", "ORI_MASK",
                                  "ORI_Y", "ORI_X"])
def test_orb_constants_equal(name):
    np.testing.assert_array_equal(getattr(torb, name), getattr(jorb, name))


def test_fast_circle_equal():
    np.testing.assert_array_equal(tfast.CIRCLE, jfast.CIRCLE)


def test_sampling_buffer_is_the_bf16_matrix():
    ext = torb.ORBExtractor()
    np.testing.assert_array_equal(ext.sampling.float().numpy(),
                                  np.asarray(jorb.SAMPLING_BF16).astype(np.float32))


@pytest.mark.parametrize("n,levels,scale", [(1024, 8, 1.2), (2048, 8, 1.2), (256, 3, 1.2),
                                            (100, 4, 1.5)])
def test_level_budgets_equal(n, levels, scale):
    assert torb.level_budgets(n, levels, scale) == jorb.level_budgets(n, levels, scale)


def _patches(seed=9, n=256):
    return np.random.default_rng(seed).uniform(0, 255, (n, torb.PATCH, torb.PATCH)).astype(np.float32)


def test_orientation_close_and_same_bins():
    """Not bit-identical: the moments are sums of ~700 products with heavy
    cancellation, summed in another order, and atan2 differs by an ulp
    (measured: 2e-5 rad at most on random patches).  The descriptor only
    sees the 12-degree rotation bin, which must agree."""
    p = _patches()
    a = np.asarray(jorb._orientation(jnp.asarray(p)))
    b = torb.ORBExtractor().orientation(t(p)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=5e-5)
    to_bin = lambda x: np.mod(np.round(x * (30 / (2 * np.pi))).astype(np.int32), 30)
    np.testing.assert_array_equal(to_bin(b), to_bin(a))


def test_descriptors_bit_identical():
    """Same patches and angles: identical bits (every BRIEF value is an exact
    difference of two bf16 pixels in both packages)."""
    p = _patches(10)
    ang = np.random.default_rng(11).uniform(-np.pi, np.pi, p.shape[0]).astype(np.float32)
    dj = np.asarray(jorb._descriptors(jnp.asarray(p), jnp.asarray(ang)))
    dt = torb.ORBExtractor().descriptors(t(p), t(ang)).numpy()
    assert dt.dtype == np.int32
    np.testing.assert_array_equal(dt.view(np.uint32), dj)


def test_pack_bits_high_bit():
    bits = torch.zeros((1, 256), dtype=torch.bool)
    bits[0, 31] = True          # the sign bit of word 0
    bits[0, 32 * 7] = True      # bit 0 of word 7
    words = torb.pack_bits(bits).numpy().view(np.uint32)[0]
    assert words[0] == 2**31 and words[7] == 1 and words[1:7].sum() == 0


def test_extract_orb_agreement():
    """Whole extraction on a rendered 320x240 frame, 3 levels, 256 features.

    Threshold: at least 98% of the rows must agree exactly (uv, octave,
    valid and all 256 descriptor bits).  Levels >= 1 differ by up to 5e-3
    in the pyramid, so a FAST threshold can flip an odd corner and move the
    selection ranks after it; 98% leaves room for a handful of such flips.
    Measured: 255 of the 256 rows."""
    img = rendered_image()
    fj = jorb.extract_orb(jnp.asarray(img), n_features=256, n_levels=3)
    ft = torb.ORBExtractor(n_features=256, n_levels=3)(t(img))
    assert ft.desc.dtype == torch.int32 and ft.octave.dtype == torch.int32
    same_kp = (np.all(ft.uv.numpy() == np.asarray(fj.uv), -1)
               & (ft.octave.numpy() == np.asarray(fj.octave))
               & (ft.valid.numpy() == np.asarray(fj.valid)))
    same_desc = np.all(ft.desc.numpy().view(np.uint32) == np.asarray(fj.desc), -1)
    frac = float(np.mean(same_kp & same_desc))
    print(f"extract_orb agreement: keypoints {same_kp.mean():.4f}, "
          f"keypoints+descriptors {frac:.4f}")
    assert frac >= 0.98
    np.testing.assert_allclose(ft.angle.numpy()[same_kp], np.asarray(fj.angle)[same_kp],
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(ft.response.numpy()[same_kp],
                               np.asarray(fj.response)[same_kp], rtol=1e-5, atol=1e-3)
