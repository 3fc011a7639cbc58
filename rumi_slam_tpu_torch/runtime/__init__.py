"""The native edge runtime (a copy of ``rumi_slam_tpu/runtime``): ``native``."""
