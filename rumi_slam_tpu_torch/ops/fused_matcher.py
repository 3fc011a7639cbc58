"""Fused radius-gated Hamming matcher: the counterpart of
``rumi_slam_tpu/ops/pallas_matcher.py``.

``fused_match`` answers the contract of ``matcher.match`` with
``mask=radius_mask(uv_q, uv_p, radius)`` without forming any ``[F, P]``
array.  On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_match.cu``, built with ``nvcc`` on first use into ``build/`` at
the repository root and loaded with ctypes.  On a CPU tensor it runs
``fused_match_plain``, the same function in plain PyTorch, which is also the
reference the kernel is checked against on the card.  Any other device, a
missing ``nvcc`` or a failed launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from . import matcher

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_match.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
build_log = ""  # nvcc's output (register and shared-memory use) of the last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if nvcc is None or not nvcc.exists():
        raise RuntimeError(
            "fused_match: cannot build csrc/fused_match.cu: nvcc not found "
            "(put the CUDA toolkit's nvcc on PATH or set CUDA_HOME)")
    return str(nvcc)


def build_library():
    """Compile ``csrc/fused_match.cu`` (once per source content) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    nvcc = _nvcc()
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_match_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"fused_match: nvcc failed (rc {proc.returncode}):\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_match_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, cf, cf, cf, vp, vp, vp]
    lib.fused_match_launch.restype = ci
    lib.fused_match_error_string.argtypes = [ci]
    lib.fused_match_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def fused_match_plain(desc_q, desc_p, uv_q, uv_p, radius, valid_q, valid_p, *,
                      max_dist=80.0, ratio=0.9):
    """Plain PyTorch version: ±1 float32 matmul, radius mask, argmin and
    masked argmin.  Forms the [F, P] distance matrix."""
    return matcher.match(
        matcher.hamming_matrix(desc_q, desc_p), valid_q, valid_p,
        mask=matcher.radius_mask(uv_q, uv_p, radius),
        max_dist=max_dist, ratio=ratio,
    )


def _check(desc_q, desc_p, uv_q, uv_p, valid_q, valid_p):
    n_q, n_p = desc_q.shape[0], desc_p.shape[0]
    expect = {
        "desc_q": (desc_q, torch.int32, (n_q, 8), 16),
        "desc_p": (desc_p, torch.int32, (n_p, 8), 16),
        "uv_q": (uv_q, torch.float32, (n_q, 2), 8),
        "uv_p": (uv_p, torch.float32, (n_p, 2), 8),
        "valid_q": (valid_q, torch.bool, (n_q,), 1),
        "valid_p": (valid_p, torch.bool, (n_p,), 1),
    }
    for name, (t, dtype, shape, align) in expect.items():
        if t.device != desc_q.device:
            raise ValueError(f"fused_match: {name} is on {t.device}, desc_q on {desc_q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"fused_match: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"fused_match: {name} must be contiguous and "
                             f"{align}-byte aligned")


def fused_match(desc_q, desc_p, uv_q, uv_p, radius, valid_q, valid_p, *,
                max_dist=80.0, ratio=0.9):
    """Masked best match under a projection-radius window.

    Args:
      desc_q: [F, 8] int32; desc_p: [P, 8] int32 (uint32 bit patterns).
      uv_q: [F, 2] query pixels; uv_p: [P, 2] projected point pixels.
      radius: window radius in pixels (Python number).
      valid_q / valid_p: [F] / [P] bool.
    Returns (idx [F] int32, -1 none; dist [F] float32, inf none).
    ``fused_match.launches`` counts kernel launches.
    """
    dev = desc_q.device
    if dev.type == "cpu":
        return fused_match_plain(desc_q, desc_p, uv_q, uv_p, radius, valid_q,
                                 valid_p, max_dist=max_dist, ratio=ratio)
    if dev.type != "cuda":
        raise ValueError(f"fused_match: unsupported device {dev}")
    _check(desc_q, desc_p, uv_q, uv_p, valid_q, valid_p)
    lib = build_library()
    n_q, n_p = desc_q.shape[0], desc_p.shape[0]
    idx = torch.empty((n_q,), dtype=torch.int32, device=dev)
    dist = torch.empty((n_q,), dtype=torch.float32, device=dev)
    if n_q == 0:
        return idx, dist
    with torch.cuda.device(dev):
        err = lib.fused_match_launch(
            desc_q.data_ptr(), desc_p.data_ptr(), uv_q.data_ptr(), uv_p.data_ptr(),
            valid_q.data_ptr(), valid_p.data_ptr(), n_q, n_p,
            matcher.radius2(radius), float(max_dist), float(ratio),
            idx.data_ptr(), dist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.fused_match_error_string(err).decode()
        raise RuntimeError(f"fused_match: kernel launch failed: {msg} ({err})")
    fused_match.launches += 1
    return idx, dist


fused_match.launches = 0
