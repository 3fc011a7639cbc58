"""Fused Hamming matcher: the counterpart of
``rumi_slam_tpu/ops/pallas_matcher.py``.

``fused_match`` answers the contract of ``matcher.match`` with
``mask=radius_mask(uv_q, uv_p, radius)`` without forming any ``[F, P]``
array.  ``match_bank`` answers the contract of ``matcher.match_chunked``
(every valid pair counts, no radius window) the same way.  On CUDA tensors
both launch the hand-written kernel in ``csrc/fused_match.cu`` (its gated and
its gate-off instantiation), built with ``nvcc`` on first use into ``build/``
at the repository root and loaded with ctypes.  On CPU tensors they run
``fused_match_plain`` and ``matcher.match_chunked``, the same functions in
plain PyTorch, which are also the references the kernel is checked against on
the card.  Any other device, a missing ``nvcc`` or a failed launch raises;
nothing falls back.

The kernel splits the points over a second grid dimension and merges the
splits' partial (best, second, argbest) in split order.
``fused_match_plain_split`` is a plain PyTorch model of exactly that, for
tests on a host without a card; nothing on the main path calls it.
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
# The grid plan below and the kernel share these two numbers.
QUERIES_PER_BLOCK = 128
POINTS_PER_TILE = 256
# Blocks the grid aims at for every SM (fewer if the points run out; at most
# one split per point tile, which caps P = 16384 at 4 an SM).  About 10 blocks
# of 128 threads are resident on an SM at the kernel's 39-44 registers, so 32
# is three waves.  Taken from `python3 chip_smoke.py --sweep-blocks-per-sm` on
# an H100 (700 W), 1024 x 262144 with 21504 / all rows in use, device ms:
# 2: 0.597 / 0.881, 4: 0.306 / 0.679, 8: 0.165 / 0.625, 16: 0.102 / 0.595,
# 32: 0.090 / 0.589, 64: 0.100 / 0.598 (the merge pass grows with the splits).
BLOCKS_PER_SM = 32
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
              f"-DQUERIES_PER_BLOCK={QUERIES_PER_BLOCK}", f"-DPOINTS_PER_TILE={POINTS_PER_TILE}"]

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
    lib.fused_match_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       cf, cf, cf, vp, vp, vp, vp]
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


def fused_match_plain_split(desc_q, desc_p, uv_q, uv_p, radius, valid_q, valid_p, *,
                            n_splits, max_dist=80.0, ratio=0.9):
    """Plain PyTorch model of the kernel's split and merge: the top-2 of each
    of ``n_splits`` contiguous runs of the points, merged in split order by
    the kernel's rule (``matcher.merge_top2``).  Equal to
    ``fused_match_plain`` for every ``n_splits``."""
    n_p = desc_p.shape[0]
    state = matcher.top2_start(desc_q.shape[0], desc_q.device)
    run = -(-n_p // n_splits)
    for p0 in range(0, n_p, max(run, 1)):
        sl = slice(p0, min(p0 + run, n_p))
        allowed = (valid_q[:, None] & valid_p[None, sl]
                   & matcher.radius_mask(uv_q, uv_p[sl], radius))
        d = torch.where(allowed, matcher.hamming_matrix(desc_q, desc_p[sl]), matcher.BIG)
        cb, cs, ci = matcher.top2(d)
        # a run with no allowed pair has cb = BIG and is never taken
        state = matcher.merge_top2(state, (cb, cs, ci + p0))
    best, second, idx = state
    ok = (best <= max_dist) & (best < ratio * second) & valid_q & (idx >= 0)
    return torch.where(ok, idx, -1), torch.where(ok, best, float("inf"))


def split_plan(n_q: int, n_p: int, n_sm: int):
    """(n_splits, tiles_per_split) of the kernel's grid: contiguous runs of
    whole point tiles, as many as give every SM ``BLOCKS_PER_SM`` blocks
    (query tiles x splits), at most one split per tile and at least one."""
    tiles = max(1, -(-n_p // POINTS_PER_TILE))
    q_tiles = max(1, -(-n_q // QUERIES_PER_BLOCK))
    want = min(tiles, -(-BLOCKS_PER_SM * n_sm // q_tiles))
    tiles_per_split = -(-tiles // want)
    return -(-tiles // tiles_per_split), tiles_per_split


def _check(name, tensors):
    """``tensors``: {argument: (tensor, dtype, shape, alignment)}; all on the
    device of the first."""
    dev = next(iter(tensors.values()))[0].device
    for arg, (t, dtype, shape, align) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: {arg} must be contiguous and "
                             f"{align}-byte aligned")


def _launch(name, desc_q, desc_p, uv_q, uv_p, valid_q, valid_p, r2, max_dist, ratio):
    """Checks the inputs and launches the kernel: gated when ``uv_q`` is
    given, gate-off when it is None.  Scratch and outputs are allocated here,
    per call (the mapping worker's thread may call while the tracker does)."""
    gated = uv_q is not None
    n_q, n_p = desc_q.shape[0], desc_p.shape[0]
    tensors = {"desc_q": (desc_q, torch.int32, (n_q, 8), 16),
               "desc_p": (desc_p, torch.int32, (n_p, 8), 16),
               "valid_q": (valid_q, torch.bool, (n_q,), 1),
               "valid_p": (valid_p, torch.bool, (n_p,), 1)}
    if gated:
        tensors["uv_q"] = (uv_q, torch.float32, (n_q, 2), 8)
        tensors["uv_p"] = (uv_p, torch.float32, (n_p, 2), 8)
    _check(name, tensors)
    lib = build_library()
    dev = desc_q.device
    idx = torch.empty((n_q,), dtype=torch.int32, device=dev)
    dist = torch.empty((n_q,), dtype=torch.float32, device=dev)
    if n_q == 0:
        return idx, dist, False
    n_splits, tiles_per_split = split_plan(
        n_q, n_p, torch.cuda.get_device_properties(dev).multi_processor_count)
    # scratch for the splits' partials; freed on return, and the allocator
    # hands it only to later work on this stream
    partial = torch.empty((n_splits, n_q, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_match_launch(
            desc_q.data_ptr(), desc_p.data_ptr(),
            uv_q.data_ptr() if gated else None, uv_p.data_ptr() if gated else None,
            valid_q.data_ptr(), valid_p.data_ptr(), n_q, n_p, int(gated),
            n_splits, tiles_per_split, r2, float(max_dist), float(ratio),
            partial.data_ptr(), idx.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.fused_match_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    return idx, dist, True


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
    idx, dist, launched = _launch("fused_match", desc_q, desc_p, uv_q, uv_p, valid_q,
                                  valid_p, matcher.radius2(radius), max_dist, ratio)
    fused_match.launches += launched
    return idx, dist


fused_match.launches = 0


def match_bank(desc_a, valid_a, desc_b, valid_b, *, n_chunks: int,
               max_dist=matcher.TH_LOW, ratio=0.9):
    """Best match of every row of ``desc_a`` against a large descriptor bank
    ``desc_b`` with no spatial window: the contract of
    ``matcher.match_chunked``, which is its plain version and what CPU
    tensors get.  CUDA tensors go through the kernel's gate-off
    instantiation, which takes any number of rows and ignores ``n_chunks``.

    Returns (idx_b [Na] int32 row of the bank, -1 if none; mdist [Na]
    float32, inf if none).  ``match_bank.launches`` counts kernel launches.
    """
    dev = desc_a.device
    if dev.type == "cpu":
        return matcher.match_chunked(desc_a, valid_a, desc_b, valid_b, n_chunks=n_chunks,
                                     max_dist=max_dist, ratio=ratio)
    if dev.type != "cuda":
        raise ValueError(f"match_bank: unsupported device {dev}")
    idx, dist, launched = _launch("match_bank", desc_a, desc_b, None, None, valid_a,
                                  valid_b, 0.0, max_dist, ratio)
    match_bank.launches += launched
    return idx, dist


match_bank.launches = 0
