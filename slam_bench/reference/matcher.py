# Frozen copy of rumi_slam_tpu_torch/ops/matcher.py at commit 359566b (plain PyTorch,
# no kernel): the benchmark's reference.  Imports made relative; no other change.
"""Batched Hamming descriptor matching, plain PyTorch (port of
``rumi_slam_tpu/ops/matcher.py``).

Descriptors are int32 ``[N, 8]`` words with the uint32 bit pattern of the JAX
package's descriptors.  ``ham(a, b) = (256 - a.b) / 2`` over ±1 vectors is a
float32 matmul whose every partial sum is an integer <= 256, so it is exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .select import top_k

TH_LOW = 50.0    # reference ORBmatcher.h TH_LOW
TH_HIGH = 100.0  # reference ORBmatcher.h TH_HIGH
HISTO_BINS = 30

BIG = 1e9


def _bits(desc_packed):
    """[N, 8] int32 -> [N, 256] int32 in {0, 1}; bit j of word w -> 32w + j.
    The arithmetic shift of a negative word still leaves bit j at bit 0."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc_packed.device)
    bits = (desc_packed[:, :, None] >> shifts) & 1
    return bits.reshape(desc_packed.shape[0], 256)


def unpack_pm1(desc_packed):
    """[N, 8] int32 -> [N, 256] int8 in {-1, +1}."""
    return (2 * _bits(desc_packed) - 1).to(torch.int8)


def hamming_matrix(desc_a, desc_b):
    """Dense Hamming distances [Na, Nb] float32 via a ±1 float32 matmul."""
    a = unpack_pm1(desc_a).to(torch.float32)
    b = unpack_pm1(desc_b).to(torch.float32)
    return (256.0 - a @ b.T) * 0.5


def hamming_matrix_popcount(desc_a, desc_b):
    """Bit-counting oracle for tests: popcount(a ^ b) summed over the words."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    return torch.sum((x[..., None] >> shifts) & 1, dim=(-2, -1)).to(torch.float32)


def radius2(radius) -> float:
    """Squared window radius rounded as float32 arithmetic rounds it, so that
    every matcher path gates on the same number."""
    r = np.float32(radius)
    return float(r * r)


def radius_mask(uv_a, uv_b, radius):
    """[Na, Nb] bool — b within ``radius`` px of a (scalar radius)."""
    d = uv_a[:, None, :] - uv_b[None, :, :]
    return torch.sum(d * d, dim=-1) <= radius2(radius)


def octave_mask(oct_a, oct_b, tol=1):
    return torch.abs(oct_a[:, None] - oct_b[None, :]) <= tol


def top2(d):
    """Best, second best and argbest per row, as ``lax.top_k(-d, 2)`` gives
    them, ties included: ``argmin`` returns the first minimum, and the second
    best is the minimum once that one column is masked."""
    idx = torch.argmin(d, dim=1, keepdim=True)
    best = torch.gather(d, 1, idx)[:, 0]
    second = torch.amin(torch.scatter(d, 1, idx, BIG), dim=1)
    return best, second, idx[:, 0].to(torch.int32)


def top2_start(n, device):
    """(best, second, argbest) before any column is seen: 1e9, 1e9, -1."""
    return (torch.full((n,), BIG, dtype=torch.float32, device=device),
            torch.full((n,), BIG, dtype=torch.float32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device))


def merge_top2(state, part):
    """Merge of two partial (best, second, argbest) triples, ``state`` from
    lower column indices than ``part``: strict ``<`` keeps the lower index on
    a tie."""
    best, second, idx = state
    cb, cs, ci = part
    second = torch.minimum(torch.minimum(second, cs), torch.maximum(best, cb))
    return torch.minimum(best, cb), second, torch.where(cb < best, ci, idx)


def match(dist, valid_a, valid_b, *, mask=None, max_dist=TH_LOW, ratio=0.9,
          cross_check=False):
    """Best-match selection from a distance matrix.

    Args:
      dist: [Na, Nb] distances.  valid_a / valid_b: validity masks.
      mask: optional [Na, Nb] bool of allowed pairs.
      max_dist: absolute acceptance threshold.
      ratio: Lowe ratio, best < ratio * second best.
      cross_check: also require a to be b's best match.

    Returns:
      idx_b: [Na] int32 — matched column per row, -1 if none.
      mdist: [Na] float32 — distance of the accepted match (inf if none).
    """
    allowed = valid_a[:, None] & valid_b[None, :]
    if mask is not None:
        allowed = allowed & mask
    d = torch.where(allowed, dist, BIG)
    best, second, idx = top2(d)
    ok = (best <= max_dist) & (best < ratio * second) & valid_a
    if cross_check:
        col_best = torch.argmin(d, dim=0)
        ok = ok & (col_best[idx.long()] == torch.arange(d.shape[0], device=d.device))
    return (torch.where(ok, idx, -1),
            torch.where(ok, best, float("inf")))


def match_chunked(desc_a, valid_a, desc_b, valid_b, *, n_chunks: int,
                  max_dist=TH_LOW, ratio=0.9):
    """Best-match selection against a large descriptor bank in ``n_chunks``
    row blocks of ``desc_b``, carrying the running (best, second, argbest)
    per query row, so that no [Na, Nb] matrix is formed.

    Returns (idx_b [Na] int32 global column, -1 if none; mdist [Na]).
    """
    Nb = desc_b.shape[0]
    if Nb % n_chunks:
        raise ValueError(f"match_chunked: {Nb} rows do not split into {n_chunks} chunks")
    Cb = Nb // n_chunks
    a = unpack_pm1(desc_a).to(torch.float32)
    state = top2_start(desc_a.shape[0], desc_a.device)
    for c in range(n_chunks):
        b = unpack_pm1(desc_b[c * Cb:(c + 1) * Cb]).to(torch.float32)
        d = (256.0 - a @ b.T) * 0.5
        d = torch.where(valid_a[:, None] & valid_b[None, c * Cb:(c + 1) * Cb], d, BIG)
        cb, cs, ci = top2(d)
        state = merge_top2(state, (cb, cs, ci + c * Cb))
    best, second, bidx = state
    ok = (best <= max_dist) & (best < ratio * second) & valid_a
    return torch.where(ok, bidx, -1), torch.where(ok, best, float("inf"))


def rotation_consistency(idx_b, angle_a, angle_b, keep_top=3):
    """Keep only matches whose angle difference falls in the ``keep_top`` most
    popular of 30 histogram bins, each holding at least 10% of the best."""
    matched = idx_b >= 0
    dang = angle_a - angle_b[idx_b.clamp_min(0).long()]
    dang = torch.remainder(dang, 2 * math.pi)
    bins = torch.clamp((dang * (HISTO_BINS / (2 * math.pi))).to(torch.int32), 0, HISTO_BINS - 1)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=idx_b.device).index_add_(
        0, bins.long(), matched.to(torch.int32))
    top_vals, top_bins = top_k(hist, keep_top)
    good_bin = top_vals >= torch.clamp_min((0.1 * top_vals[0]).to(torch.int32), 1)
    in_top = torch.any((bins.long()[:, None] == top_bins[None, :]) & good_bin[None, :], dim=-1)
    return torch.where(matched & in_top, idx_b, -1)


def match_descriptors(feats_a, feats_b, *, mask=None, max_dist=TH_LOW, ratio=0.9,
                      cross_check=False, check_rotation=True):
    """``match`` over two ``Features`` sets, then the rotation filter."""
    dist = hamming_matrix(feats_a.desc, feats_b.desc)
    idx, mdist = match(dist, feats_a.valid, feats_b.valid, mask=mask,
                       max_dist=max_dist, ratio=ratio, cross_check=cross_check)
    if check_rotation:
        idx = rotation_consistency(idx, feats_a.angle, feats_b.angle)
        mdist = torch.where(idx >= 0, mdist, float("inf"))
    return idx, mdist
