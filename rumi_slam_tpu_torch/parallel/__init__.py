"""Parallel bundle adjustment: the sharded Schur solvers and the process
group / mesh helpers (port of ``rumi_slam_tpu/parallel``)."""

from . import distributed, sharded_ba  # noqa: F401
