"""Batched Hamming descriptor matching, plain PyTorch (port of the slice's
part of ``rumi_slam_tpu/ops/matcher.py``: ``unpack_pm1``, ``hamming_matrix``,
``hamming_matrix_popcount``, ``radius_mask``, ``match``).

Descriptors are int32 ``[N, 8]`` words with the uint32 bit pattern of the JAX
package's descriptors.  ``ham(a, b) = (256 - a.b) / 2`` over ±1 vectors is a
float32 matmul whose every partial sum is an integer <= 256, so it is exact.
"""

from __future__ import annotations

import numpy as np
import torch

TH_LOW = 50.0    # reference ORBmatcher.h TH_LOW
TH_HIGH = 100.0  # reference ORBmatcher.h TH_HIGH

_BIG = 1e9


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


def match(dist, valid_a, valid_b, *, mask=None, max_dist=TH_LOW, ratio=0.9):
    """Best-match selection from a distance matrix (``cross_check`` is not
    ported).

    Best and second best per row follow ``lax.top_k(-d, 2)``, ties included:
    ``argmin`` returns the first minimum, and the second best is the minimum
    once that one column is masked.

    Returns:
      idx_b: [Na] int32 — matched column per row, -1 if none.
      mdist: [Na] float32 — distance of the accepted match (inf if none).
    """
    allowed = valid_a[:, None] & valid_b[None, :]
    if mask is not None:
        allowed = allowed & mask
    d = torch.where(allowed, dist, _BIG)
    idx = torch.argmin(d, dim=1, keepdim=True)
    best = torch.gather(d, 1, idx)[:, 0]
    second = torch.amin(torch.scatter(d, 1, idx, _BIG), dim=1)
    idx = idx[:, 0].to(torch.int32)
    ok = (best <= max_dist) & (best < ratio * second) & valid_a
    return (torch.where(ok, idx, -1),
            torch.where(ok, best, float("inf")))
