"""Image primitives: pyramid, separable blur, patch gather (port of
``rumi_slam_tpu/ops/image.py``).  Images are ``float32 [H, W]`` in [0, 255].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(img, new_hw):
    """``jax.image.resize(method="linear")`` counterpart.  JAX's linear resize
    antialiases when it downscales (a triangle kernel widened by the scale);
    ``antialias=True`` is the same filter, differing only in summation order
    (about 4e-3 at pyramid level 1 on a 480x640 image)."""
    return F.interpolate(img[None, None], size=tuple(new_hw), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def sep_conv2d(img, k1d):
    """Separable 2D convolution with reflect padding, [H, W] float32, as
    shift-and-add in the JAX package's order (rows, then columns)."""
    r = (len(k1d) - 1) // 2
    k = [float(v) for v in k1d]
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    x = sum(k[i] * x[i:i + h, :] for i in range(2 * r + 1))
    x = F.pad(x[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    x = sum(k[i] * x[:, i:i + w] for i in range(2 * r + 1))
    return x


def gaussian_blur(img, sigma=2.0, radius=3):
    return sep_conv2d(img, gaussian_kernel1d(sigma, radius))


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of images; level i has shape floor(shape / scale^i)."""
    h, w = img.shape
    pyr = [img]
    for i in range(1, n_levels):
        s = scale_factor ** i
        pyr.append(resize_bilinear(img, (max(8, int(h / s)), max(8, int(w / s)))))
    return pyr


def max_pool3x3(x):
    """3x3 max filter, same shape (pads with -inf, like ``reduce_window``)."""
    return F.max_pool2d(x[None, None], 3, 1, 1)[0, 0]


def _patch_index(centers_yx, size: int):
    ar = torch.arange(size, device=centers_yx.device)
    rows = centers_yx[:, 0, None].long() + ar          # [N, size]
    cols = centers_yx[:, 1, None].long() + ar
    return rows[:, :, None], cols[:, None, :]


def gather_patches(img, centers_yx, patch_radius: int):
    """Square patches [N, 2r+1, 2r+1] around integer (y, x) centers, read from
    a reflect-padded canvas (one advanced-index gather)."""
    r = patch_radius
    padded = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    rows, cols = _patch_index(centers_yx, 2 * r + 1)
    return padded[rows, cols]


def gather_patches_multi(imgs, centers_yx, patch_radius: int):
    """gather_patches over C stacked images [C, H, W] sharing the same
    centers; returns [C, N, 2r+1, 2r+1]."""
    r = patch_radius
    padded = F.pad(imgs[None], (r, r, r, r), mode="reflect")[0]
    rows, cols = _patch_index(centers_yx, 2 * r + 1)
    return padded[:, rows, cols]
