"""Oriented-BRIEF (ORB-style) feature extraction (port of
``rumi_slam_tpu/ops/orb.py``).

The constants — sampling pattern, the 30 rotated index tables, the ±1
difference sampling matrix and the orientation masks — are regenerated here
with the same numpy code and seed as the JAX package, so both packages
describe a patch with the same bits.  ``ORBExtractor`` keeps the device copies
as buffers; ``ORBExtractor(...).to(device)(img)`` is the counterpart of the
JAX ``extract_orb(img, ...)``.

Descriptors are int32 ``[N, 8]`` holding the uint32 bit pattern of the JAX
package's ``[N, 8]`` uint32 words (``>>`` on a torch uint32 tensor raises).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import fast, image, select

PATCH_R = 19  # gather radius: covers rotated pattern (|p|<=13 -> 13*sqrt(2)~18.4)
PATCH = 2 * PATCH_R + 1
PATTERN_R = 13
N_BITS = 256
N_ROT_BINS = 30  # 12-degree rotation bins (OpenCV ORB uses the same)

_rng = np.random.default_rng(20230817)
PATTERN = np.clip(
    _rng.normal(scale=PATTERN_R / 2.0, size=(N_BITS, 2, 2)), -PATTERN_R, PATTERN_R
).astype(np.float32)  # [256, 2(points), 2(y,x)]


def _build_rotation_tables():
    """Per-bin flattened patch indices [N_ROT_BINS, 512] and the ±1
    difference sampling matrix [PATCH*PATCH, N_ROT_BINS*256]: column
    (b*256 + k) holds +1 at bin b's rotated index of pattern point 1 of bit k
    and -1 at point 0, so ``patch @ D > 0`` is the BRIEF test."""
    tabs = []
    for b in range(N_ROT_BINS):
        th = 2.0 * np.pi * b / N_ROT_BINS
        c, s = np.cos(th), np.sin(th)
        py, px = PATTERN[:, :, 0], PATTERN[:, :, 1]
        ry = px * s + py * c
        rx = px * c - py * s
        iy = np.clip(np.round(ry).astype(np.int64) + PATCH_R, 0, PATCH - 1)
        ix = np.clip(np.round(rx).astype(np.int64) + PATCH_R, 0, PATCH - 1)
        tabs.append((iy * PATCH + ix).reshape(-1))  # [512]
    tab = np.stack(tabs)  # [30, 512] (pairs interleaved: bit k -> 2k, 2k+1)
    D = np.zeros((PATCH * PATCH, N_ROT_BINS * N_BITS), np.float32)
    cols = np.arange(N_BITS)
    for b in range(N_ROT_BINS):
        np.add.at(D, (tab[b, 0::2], b * N_BITS + cols), -1.0)  # point 0
        np.add.at(D, (tab[b, 1::2], b * N_BITS + cols), +1.0)  # point 1
    return tab, D


ROT_TABLE, _SAMPLING = _build_rotation_tables()

# circular mask for the intensity-centroid orientation (radius 15)
_ORI_R = 15
_oy, _ox = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
ORI_MASK = ((_oy**2 + _ox**2) <= _ORI_R**2).astype(np.float32)
ORI_Y = (_oy * ORI_MASK).astype(np.float32)
ORI_X = (_ox * ORI_MASK).astype(np.float32)


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (SoA)."""

    uv: torch.Tensor        # [N, 2] float32 — (x, y) in level-0 pixels
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    octave: torch.Tensor    # [N] int32
    desc: torch.Tensor      # [N, 8] int32 — uint32 bit pattern, 256 BRIEF bits
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self):
        return self.uv.shape[0]


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Per-level keypoint budgets proportional to level area."""
    inv = [1.0 / (scale_factor ** (2 * i)) for i in range(n_levels)]
    total = sum(inv)
    raw = [max(8, int(round(n_features * v / total))) for v in inv]
    raw[0] += n_features - sum(raw)
    return raw


def pack_bits(bits):
    """[N, 256] bool -> [N, 8] int32 words (bit j of word w = bit 32w+j)."""
    n = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(n, 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


class ORBExtractor(nn.Module):
    """Multi-scale ORB extraction on one image; ``forward(img) -> Features``.

    The keyword arguments are those of the JAX ``extract_orb``;
    ``orientation``, ``descriptors`` and ``forward`` are the counterparts of
    its ``_orientation``, ``_descriptors`` and ``extract_orb``.  Both FAST
    thresholds' score maps come from one shared circle-difference pass and
    the strong one wins per pixel by a large score bonus — no data-dependent
    control flow.
    """

    def __init__(self, *, n_features: int = 1024, n_levels: int = 8,
                 scale_factor: float = 1.2, threshold: float = 20.0,
                 min_threshold: float = 7.0, cell: int = 32, k_cell: int = 5):
        super().__init__()
        self.n_features, self.n_levels = n_features, n_levels
        self.scale_factor = scale_factor
        self.threshold, self.min_threshold = threshold, min_threshold
        self.cell, self.k_cell = cell, k_cell
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        # ±1/0 entries: the bf16 cast is exact
        self.register_buffer("sampling", torch.from_numpy(_SAMPLING).to(torch.bfloat16),
                             persistent=False)
        self.register_buffer("ori_y", torch.from_numpy(ORI_Y), persistent=False)
        self.register_buffer("ori_x", torch.from_numpy(ORI_X), persistent=False)

    def orientation(self, patches):
        """Intensity-centroid angle per patch [N, P, P] -> [N] radians."""
        m01 = torch.einsum("nij,ij->n", patches, self.ori_y)
        m10 = torch.einsum("nij,ij->n", patches, self.ori_x)
        return torch.atan2(m01, m10)

    def descriptors(self, patches, angles):
        """Rotation-binned BRIEF via one ±1-difference matmul.

        patches: [N, P, P] (blurred); angles: [N].  Returns [N, 8] int32.
        Patches are cast to bf16 as in the JAX package.  Each column of the
        sampling matrix has one +1 and one -1, so each product is a
        difference of two bf16 pixels: its sign, the BRIEF bit, is exact
        whatever the accumulation order or output rounding.
        """
        n = patches.shape[0]
        bins = torch.round(angles * (N_ROT_BINS / (2.0 * math.pi))).to(torch.int32)
        bins = torch.remainder(bins, N_ROT_BINS)
        flat = patches.reshape(n, PATCH * PATCH).to(torch.bfloat16)
        diffs = (flat @ self.sampling).reshape(n, N_ROT_BINS, N_BITS)
        vals = torch.gather(diffs, 1, bins.long()[:, None, None].expand(n, 1, N_BITS))[:, 0]
        return pack_bits(vals > 0)

    def forward(self, img) -> Features:
        pyr = image.build_pyramid(img, self.n_levels, self.scale_factor)
        uvs, resps, octs, valids, patch_list, blur_list = [], [], [], [], [], []
        for lvl in range(self.n_levels):
            il = pyr[lvl]
            strong, weak = fast.fast_score_pair(il, self.threshold, self.min_threshold)
            strong = fast.nms3x3(strong)
            weak = fast.nms3x3(weak)
            bonus = 1e6
            score = torch.where(strong > 0, strong + bonus, weak)
            yx, resp, valid = select.select_keypoints(
                score, self.budgets[lvl], cell=self.cell, k_cell=self.k_cell
            )
            resp = torch.where(resp > bonus / 2, resp - bonus, resp)
            both = image.gather_patches_multi(
                torch.stack([il, image.gaussian_blur(il)]), yx, PATCH_R
            )
            patch_list.append(both[0])
            blur_list.append(both[1])

            s = self.scale_factor ** lvl
            # pixel-centre-aligned upscale to level-0 coordinates
            uv0 = (torch.stack([yx[:, 1], yx[:, 0]], -1).to(torch.float32) + 0.5) * s - 0.5
            uvs.append(uv0)
            resps.append(resp)
            octs.append(torch.full((self.budgets[lvl],), lvl, dtype=torch.int32,
                                   device=img.device))
            valids.append(valid)

        angles = self.orientation(torch.cat(patch_list, 0))
        desc = self.descriptors(torch.cat(blur_list, 0), angles)
        return Features(
            uv=torch.cat(uvs, 0),
            response=torch.cat(resps, 0),
            angle=angles,
            octave=torch.cat(octs, 0),
            desc=desc,
            valid=torch.cat(valids, 0),
        )


def descriptors_at(img, uv, valid):
    """Orientation and BRIEF descriptors for keypoints the caller gives
    (level-0 pixels ``uv`` [N, 2]) — the reference's
    CloudFrameComputeDescriptors (ORBextractor.cc:989: descriptors for
    cloud-map keyframes whose keypoints came over the wire without them).

    Returns (desc [N, 8] int32, angle [N]); invalid rows are zero."""
    extractor = ORBExtractor().to(img.device)      # the sampling tables
    yx = torch.stack([torch.round(uv[:, 1]), torch.round(uv[:, 0])], -1).to(torch.int64)
    h, w = img.shape
    yx = torch.minimum(torch.clamp_min(yx, 0), torch.tensor([h - 1, w - 1], device=img.device))
    # blur once at image level (cheaper than per-patch, and border-correct)
    both = image.gather_patches_multi(torch.stack([img, image.gaussian_blur(img)]), yx, PATCH_R)
    angles = extractor.orientation(both[0])
    desc = extractor.descriptors(both[1], angles)
    return (torch.where(valid[:, None], desc, torch.zeros_like(desc)),
            torch.where(valid, angles, torch.zeros_like(angles)))
