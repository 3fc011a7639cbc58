"""Parity of the port's matcher with the JAX package: Hamming distances,
the radius gate, best/second-best selection with its tie order, and the
fused matcher's plain version against the JAX Pallas kernel (interpret mode,
as tests/test_pallas_and_gba.py runs it on the CPU), the plain model of the
CUDA kernel's split-and-merge against both, and ``match_bank`` against the JAX
package's ``match_chunked``.  Tolerance throughout: ``idx`` exact, ``dist``
exact (integers in float32)."""

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


def pallas_interpret(dq, dp, uv_q, uv_p, radius, vq, vp, **kw):
    idx, dist = j_fused_match(jnp.asarray(dq), jnp.asarray(dp), jnp.asarray(uv_q),
                              jnp.asarray(uv_p), radius, jnp.asarray(vq), jnp.asarray(vp),
                              interpret=True, **kw)
    return np.asarray(idx), np.asarray(dist)


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_fused_match_plain_split_equals_plain_and_pallas(n_splits):
    """The kernel's split-and-merge, modelled in plain PyTorch, gives what
    the unsplit plain version and the Pallas kernel give, whether or not the
    splits divide P (1024 = 7 * 147 - 5)."""
    dq, dp, uv_q, uv_p, vq, vp = problem(256, 1024, seed=0)
    args = (as_port(dq), as_port(dp), t(uv_q), t(uv_p), 60.0, t(vq), t(vp))
    i_s, d_s = tfm.fused_match_plain_split(*args, n_splits=n_splits, max_dist=80.0, ratio=0.9)
    i_p, d_p = tfm.fused_match_plain(*args, max_dist=80.0, ratio=0.9)
    i_j, d_j = pallas_interpret(dq, dp, uv_q, uv_p, 60.0, vq, vp, max_dist=80.0, ratio=0.9)
    np.testing.assert_array_equal(i_s.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_s.numpy(), d_p.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_j)
    m = i_j >= 0
    assert m.sum() > 20
    np.testing.assert_array_equal(d_s.numpy()[m], d_j[m])


@pytest.mark.parametrize("F,P,n_splits", [(37, 129, 4), (200, 701, 3), (5, 3, 7), (64, 100, 100)])
def test_fused_match_plain_split_ragged(F, P, n_splits):
    """P that no split count divides, and more splits than points."""
    dq, dp, uv_q, uv_p, vq, vp = problem(F, P, seed=F + P, n_copy=F // 2 + 1)
    args = (as_port(dq), as_port(dp), t(uv_q), t(uv_p), 40.0, t(vq), t(vp))
    i_s, d_s = tfm.fused_match_plain_split(*args, n_splits=n_splits)
    i_p, d_p = tfm.fused_match_plain(*args)
    np.testing.assert_array_equal(i_s.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_s.numpy(), d_p.numpy())


def tie_problem():
    """256 queries against 256 points with every uv at one pixel, so that the
    gate passes every pair.  Query 0's descriptor with one bit flipped sits
    at points 10 and 200 (a tie at distance 1 across splits of 128 and of 64),
    query 1's at points 20 and 21 (a tie inside a split), query 2's own only
    at point 150 (exactly one candidate
    once the rest is invalid), and query 3 has no valid point at all."""
    rng = np.random.default_rng(11)
    dq = rng.integers(0, 2**32, (256, 8), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (256, 8), dtype=np.uint32)
    dp[10] = dp[200] = dq[0] ^ np.uint32(1)
    dp[20] = dp[21] = dq[1] ^ np.uint32(1)
    dp[150] = dq[2]
    uv = np.full((256, 2), 50.0, np.float32)
    return dq, dp, uv, uv.copy(), np.ones(256, bool), np.ones(256, bool)


@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_split_ties_resolve_to_lowest_index(n_splits):
    dq, dp, uv_q, uv_p, vq, vp = tie_problem()
    args = (as_port(dq), as_port(dp), t(uv_q), t(uv_p), 5.0, t(vq), t(vp))
    for ratio, want in ((0.9, [-1, -1, 150]), (1.01, [10, 20, 150])):
        i_s, d_s = tfm.fused_match_plain_split(*args, n_splits=n_splits, ratio=ratio)
        i_p, d_p = tfm.fused_match_plain(*args, ratio=ratio)
        i_j, _ = pallas_interpret(dq, dp, uv_q, uv_p, 5.0, vq, vp, max_dist=80.0, ratio=ratio)
        np.testing.assert_array_equal(i_s.numpy(), i_p.numpy())
        np.testing.assert_array_equal(d_s.numpy(), d_p.numpy())
        np.testing.assert_array_equal(i_s.numpy(), i_j)
        assert i_s.numpy()[:3].tolist() == want   # a tie fails the ratio test below 1


@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_split_one_candidate_and_none(n_splits):
    """With one candidate the second best stays at its 1e9 start, so the
    ratio test passes; with none ``idx`` is -1 and ``dist`` inf."""
    dq, dp, uv_q, uv_p, vq, vp = tie_problem()
    vp[:] = False
    vp[150] = True                      # the only valid point, query 2's copy
    uv_q[3] = [300.0, 300.0]            # query 3 sees nothing inside its window
    args = (as_port(dq), as_port(dp), t(uv_q), t(uv_p), 5.0, t(vq), t(vp))
    i_s, d_s = tfm.fused_match_plain_split(*args, n_splits=n_splits, max_dist=256.0)
    i_p, d_p = tfm.fused_match_plain(*args, max_dist=256.0)
    i_j, _ = pallas_interpret(dq, dp, uv_q, uv_p, 5.0, vq, vp, max_dist=256.0, ratio=0.9)
    np.testing.assert_array_equal(i_s.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_s.numpy(), d_p.numpy())
    np.testing.assert_array_equal(i_s.numpy(), i_j)
    assert i_s[2] == 150 and d_s[2] == 0.0
    assert i_s[3] == -1 and np.isinf(d_s[3].item())
    assert (np.delete(i_s.numpy(), 3) == 150).all()   # every other query: its one candidate


@pytest.mark.parametrize("n_q,n_p,n_sm", [(1024, 16384, 132), (2048, 16384, 132),
                                          (1024, 262144, 132), (1000, 50000, 132),
                                          (1, 1, 132), (300, 0, 108)])
def test_split_plan_covers_the_points(n_q, n_p, n_sm):
    """The grid plan the wrapper hands the kernel: whole tiles, every point
    covered, no empty split, and at the main path's shapes at least three
    blocks for every SM."""
    n_splits, tiles_per_split = tfm.split_plan(n_q, n_p, n_sm)
    tiles = max(1, -(-n_p // tfm.POINTS_PER_TILE))
    assert n_splits >= 1 and tiles_per_split >= 1
    assert n_splits * tiles_per_split >= tiles > (n_splits - 1) * tiles_per_split
    if n_p >= 16384:
        assert -(-n_q // tfm.QUERIES_PER_BLOCK) * n_splits >= 3 * n_sm


@pytest.mark.parametrize("n_chunks", [1, 4, 16])
def test_match_bank_on_cpu_equals_jax_match_chunked(n_chunks):
    """The inputs of test_torch_reloc.py::test_match_chunked_matches_jax:
    copies planted so that there are matches, a tie across chunks and a
    second best one bit away.  On CPU tensors ``match_bank`` launches
    nothing."""
    a, b = descs(100, 1), descs(256, 2)
    b[::9][:11] = a[:11]
    b[5] = b[200] = a[20]
    b[130] = a[21]
    b[131] = a[21] ^ np.uint32(1)
    va = np.random.default_rng(3).random(100) > 0.1
    vb = np.random.default_rng(4).random(256) > 0.1
    before = tfm.match_bank.launches
    for max_dist, ratio in ((50.0, 0.9), (100.0, 0.95)):
        ij, dj = jm.match_chunked(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                                  jnp.asarray(vb), n_chunks=n_chunks, max_dist=max_dist,
                                  ratio=ratio)
        it, dt = tfm.match_bank(as_port(a), t(va), as_port(b), t(vb), n_chunks=n_chunks,
                                max_dist=max_dist, ratio=ratio)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert tfm.match_bank.launches == before
    assert (it.numpy() >= 0).sum() >= 5


def test_match_bank_rejects_other_devices():
    a, b = as_port(descs(8, 1)).to("meta"), as_port(descs(16, 2)).to("meta")
    va, vb = torch.ones(8, dtype=torch.bool, device="meta"), torch.ones(16, dtype=torch.bool,
                                                                        device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.match_bank(a, va, b, vb, n_chunks=1)


def test_kernel_build_without_nvcc_raises():
    """On a host without the CUDA toolkit, asking for the kernel raises an
    error that names nvcc; there is no fallback library."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc"):
        tfm.build_library()
