"""ctypes bindings and on-demand build of the native edge runtime (a copy of
``rumi_slam_tpu/runtime/native.py`` for the port).

``edge_runtime.cpp`` is compiled with g++ on first use into ``build/`` at the
repository root (once per source content, as ``ops/fused_matcher.py`` builds
the matcher), never beside the source.  ``available()`` is False when the
build fails (no g++); ``FrameQueue`` and ``TumDataset`` then raise, and
``rss_bytes()`` returns -1.  ``build_log`` keeps the compiler's output of a
failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "edge_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
build_log = ""


def _build() -> Optional[Path]:
    """Compile the runtime into ``build/`` (skipped when this source's library
    is there already); returns its path, or None when g++ fails."""
    global build_log
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libedgert_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = repr(e)
        return None
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.frq_create.restype = ctypes.c_void_p
    lib.frq_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.frq_destroy.argtypes = [ctypes.c_void_p]
    lib.frq_push.restype = ctypes.c_int
    lib.frq_push.argtypes = [ctypes.c_void_p, ctypes.c_double,
                             ctypes.POINTER(ctypes.c_float)]
    lib.frq_pop.restype = ctypes.c_int
    lib.frq_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_float)]
    lib.frq_size.restype = ctypes.c_int
    lib.frq_size.argtypes = [ctypes.c_void_p]
    lib.frq_dropped.restype = ctypes.c_long
    lib.frq_dropped.argtypes = [ctypes.c_void_p]
    lib.tum_open.restype = ctypes.c_void_p
    lib.tum_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tum_size.restype = ctypes.c_int
    lib.tum_size.argtypes = [ctypes.c_void_p]
    lib.tum_timestamp.restype = ctypes.c_double
    lib.tum_timestamp.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tum_read.restype = ctypes.c_int
    lib.tum_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.tum_start_replay.restype = ctypes.c_int
    lib.tum_start_replay.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_double]
    lib.tum_replay_done.restype = ctypes.c_int
    lib.tum_replay_done.argtypes = [ctypes.c_void_p]
    lib.tum_close.argtypes = [ctypes.c_void_p]
    lib.rt_rss_bytes.restype = ctypes.c_long
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable (g++ build failed): {build_log[-500:]}")
    return lib


class FrameQueue:
    """SPSC frame ring buffer (native, drop-oldest when full)."""

    def __init__(self, capacity: int, h: int, w: int):
        self._lib = _require()
        self.h, self.w = h, w
        self._q = self._lib.frq_create(capacity, h, w)

    def push(self, t: float, frame: np.ndarray):
        f = np.ascontiguousarray(frame, np.float32)
        if f.shape != (self.h, self.w):
            raise ValueError(f"frame of shape {f.shape} pushed into a {self.h}x{self.w} queue")
        self._lib.frq_push(
            self._q, float(t), f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def pop(self):
        out = np.empty((self.h, self.w), np.float32)
        t = ctypes.c_double()
        ok = self._lib.frq_pop(
            self._q, ctypes.byref(t),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not ok:
            return None
        return float(t.value), out

    def __len__(self):
        return self._lib.frq_size(self._q)

    @property
    def dropped(self) -> int:
        return self._lib.frq_dropped(self._q)

    def close(self):
        if self._q:
            self._lib.frq_destroy(self._q)
            self._q = None

    # raw handle for tum_start_replay
    @property
    def handle(self):
        return self._q


class TumDataset:
    """Native TUM rgb.txt reader with optional paced background replay."""

    def __init__(self, root: str, index_file: str = "rgb.txt"):
        self._lib = _require()
        self._d = self._lib.tum_open(root.encode(), index_file.encode())
        if not self._d:
            raise FileNotFoundError(f"{root}/{index_file}")

    def __len__(self):
        return self._lib.tum_size(self._d)

    def timestamp(self, i: int) -> float:
        return self._lib.tum_timestamp(self._d, i)

    def read(self, i: int, max_hw=(1024, 1280)):
        maxpix = max_hw[0] * max_hw[1]
        out = np.empty(maxpix, np.float32)
        h = ctypes.c_int()
        w = ctypes.c_int()
        ok = self._lib.tum_read(
            self._d, i, ctypes.byref(h), ctypes.byref(w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), maxpix)
        if not ok:
            return None
        return out[: h.value * w.value].reshape(h.value, w.value)

    def start_replay(self, queue: FrameQueue, pace: float = 1.0):
        self._lib.tum_start_replay(self._d, queue.handle, pace)

    @property
    def replay_done(self) -> bool:
        return bool(self._lib.tum_replay_done(self._d))

    def close(self):
        if self._d:
            self._lib.tum_close(self._d)
            self._d = None


def rss_bytes() -> int:
    lib = get_lib()
    return int(lib.rt_rss_bytes()) if lib else -1
