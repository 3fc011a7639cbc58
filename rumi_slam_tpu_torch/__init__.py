"""rumi_slam_tpu_torch — the PyTorch/CUDA port of ``rumi_slam_tpu``.

Mirrors the JAX package's subpackages and module names; each module is held
against its JAX counterpart by a parity test in ``tests/test_torch_*.py``.
This package imports ``torch`` and numpy only, never ``jax`` or
``rumi_slam_tpu``, so it runs on a host that has no JAX.

The one hand-written kernel (``ops/fused_matcher.py`` +
``csrc/fused_match.cu``) replaces the JAX package's Pallas matcher; the rest
is plain PyTorch kept close to the JAX formulation.
"""

import torch as _torch

# Geometry Jacobians, normal equations and the BRIEF sampling product are
# small float32 matmuls whose accuracy bounds convergence and bit-parity
# (mirrors rumi_slam_tpu/__init__.py): no TF32 anywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
