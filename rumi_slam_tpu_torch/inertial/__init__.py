"""Visual-inertial subsystem (port of ``rumi_slam_tpu/inertial``): IMU
preintegration with bias Jacobians (``preintegration``) and the inertial
initialization / visual-inertial BA solvers (``inertial_ba``).  A library:
the SLAM facade does not call it, as in the JAX package."""

from . import inertial_ba, preintegration  # noqa: F401
