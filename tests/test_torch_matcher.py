"""Parity of the port's matcher with the JAX package: Hamming distances,
the radius gate, best/second-best selection with its tie order, and the
fused matcher's plain version against the JAX Pallas kernel (interpret mode,
as tests/test_pallas_and_gba.py runs it on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.ops import matcher as jm
from rumi_slam_tpu.ops.pallas_matcher import fused_match as j_fused_match
from rumi_slam_tpu_torch.ops import fused_matcher as tfm
from rumi_slam_tpu_torch.ops import matcher as tm

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def descs(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)


def as_port(d):
    return t(d.view(np.int32))


def problem(F, P, seed=0, n_copy=100, span=300.0):
    """The contract of test_pallas_and_gba.py: random descriptors, some
    point descriptors copied from queries so real matches exist, ~10%
    invalid rows on each side, uv uniform over a span.  Half of the copied
    points also sit within 20 px of their query, so that many pass the gate."""
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    n_copy = min(n_copy, F, P)
    rows = rng.choice(P, n_copy, replace=False)
    qrows = rng.choice(F, n_copy, replace=False)
    dp[rows] = dq[qrows]
    valid_q = rng.random(F) > 0.1
    valid_p = rng.random(P) > 0.1
    uv_q = rng.uniform(0, span, (F, 2)).astype(np.float32)
    uv_p = rng.uniform(0, span, (P, 2)).astype(np.float32)
    near = rows[: n_copy // 2]
    uv_p[near] = uv_q[qrows[: n_copy // 2]] + rng.uniform(-14, 14, (len(near), 2))
    return dq, dp, uv_q, uv_p, valid_q, valid_p


def test_unpack_pm1_equal():
    d = descs(64, 1)
    np.testing.assert_array_equal(tm.unpack_pm1(as_port(d)).numpy(),
                                  np.asarray(jm.unpack_pm1(jnp.asarray(d))))


def test_hamming_matrix_equals_jax_and_oracles():
    a, b = descs(64, 2), descs(96, 3)
    ref = np.asarray(jm.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tm.hamming_matrix(as_port(a), as_port(b)).numpy(), ref)
    np.testing.assert_array_equal(tm.hamming_matrix_popcount(as_port(a), as_port(b)).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))), ref)


def test_radius_mask_equal_including_boundary():
    rng = np.random.default_rng(4)
    uv_a = rng.uniform(0, 100, (32, 2)).astype(np.float32)
    uv_a[:8] = np.round(uv_a[:8])  # integer pixels: the 3-4-5 offsets below are exact
    uv_b = np.concatenate([rng.uniform(0, 100, (32, 2)), uv_a[:8] + [3.0, 4.0]]).astype(np.float32)
    m_t = tm.radius_mask(t(uv_a), t(uv_b), 5.0).numpy()
    np.testing.assert_array_equal(m_t, np.asarray(jm.radius_mask(jnp.asarray(uv_a),
                                                                 jnp.asarray(uv_b), 5.0)))
    assert m_t[np.arange(8), 32 + np.arange(8)].all()  # exactly on the radius: inside


def test_match_tie_order():
    """Two equal best columns: lax.top_k keeps the lower index first and the
    second best equals the best, so the ratio test rejects the row."""
    dist = np.full((3, 6), 200.0, np.float32)
    dist[0, [2, 4]] = 10.0          # tie -> rejected by ratio
    dist[1, [5, 1]] = [10.0, 30.0]  # unique best at column 5
    dist[2, [0, 3]] = 40.0          # tie at the distance gate
    valid = np.ones(3, bool)
    valid_b = np.ones(6, bool)
    for max_dist, ratio in ((50.0, 0.9), (50.0, 1.01)):
        ij, dj = jm.match(jnp.asarray(dist), jnp.asarray(valid), jnp.asarray(valid_b),
                          max_dist=max_dist, ratio=ratio)
        it, dt = tm.match(t(dist), t(valid), t(valid_b), max_dist=max_dist, ratio=ratio)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert it.numpy().tolist() == [2, 5, 0]  # ratio 1.01 admits ties: lowest index


@pytest.mark.parametrize("max_dist,ratio", [(80.0, 0.9), (100.0, 0.9), (50.0, 0.8)])
def test_match_equals_jax(max_dist, ratio):
    dq, dp, uv_q, uv_p, vq, vp = problem(128, 512, seed=5)
    dist = jm.hamming_matrix(jnp.asarray(dq), jnp.asarray(dp))
    mask = jm.radius_mask(jnp.asarray(uv_q), jnp.asarray(uv_p), 60.0)
    ij, dj = jm.match(dist, jnp.asarray(vq), jnp.asarray(vp), mask=mask,
                      max_dist=max_dist, ratio=ratio)
    it, dt = tm.match(tm.hamming_matrix(as_port(dq), as_port(dp)), t(vq), t(vp),
                      mask=tm.radius_mask(t(uv_q), t(uv_p), 60.0),
                      max_dist=max_dist, ratio=ratio)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).sum() > 20


def test_fused_match_plain_equals_pallas_interpret():
    """The contract of test_pallas_and_gba.py::test_fused_match_equals_reference:
    idx identical to the Pallas kernel (interpret mode) and to matcher.match
    with radius_mask; dist equal on matched rows."""
    dq, dp, uv_q, uv_p, vq, vp = problem(256, 1024, seed=0)
    radius = 60.0
    idx_f, dist_f = j_fused_match(jnp.asarray(dq), jnp.asarray(dp), jnp.asarray(uv_q),
                                  jnp.asarray(uv_p), radius, jnp.asarray(vq), jnp.asarray(vp),
                                  max_dist=80.0, ratio=0.9, interpret=True)
    idx_r, _ = jm.match(jm.hamming_matrix(jnp.asarray(dq), jnp.asarray(dp)),
                        jnp.asarray(vq), jnp.asarray(vp),
                        mask=jm.radius_mask(jnp.asarray(uv_q), jnp.asarray(uv_p), radius),
                        max_dist=80.0, ratio=0.9)
    it, dt = tfm.fused_match_plain(as_port(dq), as_port(dp), t(uv_q), t(uv_p), radius,
                                   t(vq), t(vp), max_dist=80.0, ratio=0.9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(idx_f))
    np.testing.assert_array_equal(it.numpy(), np.asarray(idx_r))
    m = it.numpy() >= 0
    assert m.sum() > 20
    np.testing.assert_array_equal(dt.numpy()[m], np.asarray(dist_f)[m])
    assert np.isinf(dt.numpy()[~m]).all()


@pytest.mark.parametrize("F,P,radius", [(200, 700, 40.0), (1, 3, 500.0), (37, 129, 25.0)])
def test_fused_match_plain_ragged_equals_unfused_jax(F, P, radius):
    """Shapes the Pallas kernel cannot take (F % 256, P % 128 != 0): against
    the unfused JAX match."""
    dq, dp, uv_q, uv_p, vq, vp = problem(F, P, seed=F + P, n_copy=F // 2 + 1)
    ij, dj = jm.match(jm.hamming_matrix(jnp.asarray(dq), jnp.asarray(dp)),
                      jnp.asarray(vq), jnp.asarray(vp),
                      mask=jm.radius_mask(jnp.asarray(uv_q), jnp.asarray(uv_p), radius),
                      max_dist=80.0, ratio=0.9)
    it, dt = tfm.fused_match_plain(as_port(dq), as_port(dp), t(uv_q), t(uv_p), radius,
                                   t(vq), t(vp), max_dist=80.0, ratio=0.9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_fused_match_on_cpu_is_the_plain_version_and_launches_nothing():
    dq, dp, uv_q, uv_p, vq, vp = problem(64, 256, seed=6)
    args = (as_port(dq), as_port(dp), t(uv_q), t(uv_p), 50.0, t(vq), t(vp))
    before = tfm.fused_match.launches
    it, dt = tfm.fused_match(*args)
    ip, dp_ = tfm.fused_match_plain(*args)
    assert tfm.fused_match.launches == before
    np.testing.assert_array_equal(it.numpy(), ip.numpy())
    np.testing.assert_array_equal(dt.numpy(), dp_.numpy())


def test_fused_match_rejects_other_devices():
    dq, dp, uv_q, uv_p, vq, vp = problem(8, 16, seed=7)
    meta = [x.to("meta") for x in (as_port(dq), as_port(dp), t(uv_q), t(uv_p))]
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_match(*meta, 10.0, t(vq).to("meta"), t(vp).to("meta"))


def test_kernel_build_without_nvcc_raises():
    """On a host without the CUDA toolkit, asking for the kernel raises an
    error that names nvcc; there is no fallback library."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc"):
        tfm.build_library()
