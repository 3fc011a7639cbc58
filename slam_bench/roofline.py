"""The table of peaks of one H100 and the least time of the fused matcher.

Copied from ``chip_smoke.py`` at commit 359566b (``PEAK_*``, ``bound_ms``
and the gated kernel's counts in ``phase_kernel``).  The counts are taken
for each call's own F, P, valid rows and pairs inside the radius.
"""

from __future__ import annotations

import torch

from .reference import matcher

# NVIDIA's data sheet for the H100 SXM: 67 TFLOP/s float32 outside the tensor
# cores is 33.5e12 lane instructions a second (128 lanes a clock on each of
# 132 SMs); __popc runs on 16 lanes a clock an SM, an eighth of that; HBM3
# at 3.35 TB/s.
PEAK_FP32_LANE_PER_S = 33.5e12
PEAK_POPC_PER_S = PEAK_FP32_LANE_PER_S / 8
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(n_fp32_lane, n_popc, n_bytes):
    """The least time the card could take: the larger of the operations over
    their peak rate (the float32 and the popcount pipes run side by side) and
    the bytes over the memory rate.  Returns (ms, which bounds it)."""
    ops = max(n_fp32_lane / PEAK_FP32_LANE_PER_S, n_popc / PEAK_POPC_PER_S)
    byts = n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(ops, byts), "operations" if ops >= byts else "bytes"


def fused_match_counts(uv_q, uv_p, radius, valid_q, valid_p):
    """(fp32 lane instructions, popcounts, bytes) of one gated call: 6 lane
    instructions for every valid pair's radius gate, 8 popcounts for every
    pair inside the gate, 41 bytes a query and a point row read once (32 of
    descriptor, 8 of pixel, 1 of validity) and 8 a query written."""
    F, P = uv_q.shape[0], uv_p.shape[0]
    n_pairs = int(valid_q.sum()) * int(valid_p.sum())
    n_pass = int((matcher.radius_mask(uv_q, uv_p, radius)
                  & valid_q[:, None] & valid_p[None, :]).sum())
    return 6 * n_pairs, 8 * n_pass, 41 * (F + P) + 8 * F


def fused_match_bound_ms(uv_q, uv_p, radius, valid_q, valid_p):
    with torch.no_grad():
        return bound_ms(*fused_match_counts(uv_q, uv_p, radius, valid_q, valid_p))[0]
