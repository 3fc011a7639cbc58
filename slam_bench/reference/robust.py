# Frozen copy of rumi_slam_tpu_torch/optim/robust.py at commit 359566b (plain PyTorch,
# no kernel): the benchmark's reference.  Imports made relative; no other change.
"""Robust-loss weights for iteratively-reweighted least squares (port of
``rumi_slam_tpu/optim/robust.py``)."""

from __future__ import annotations

import numpy as np
import torch


def huber_weight(chi2, delta2):
    """IRLS weight for the Huber loss on squared error ``chi2`` with squared
    threshold ``delta2`` (mono reprojection edges use delta2 = 5.991)."""
    chi2 = torch.clamp_min(chi2, 1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / chi2))


def huber_cost(chi2, delta2):
    if isinstance(delta2, torch.Tensor):   # per-row thresholds (mixed mono/stereo)
        delta = torch.sqrt(delta2.to(chi2.dtype))
    else:
        delta = float(np.sqrt(np.float32(delta2)))  # float32 sqrt, as in JAX
    e = torch.sqrt(torch.clamp_min(chi2, 0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * e - delta2)
