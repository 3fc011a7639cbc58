"""The benchmark of ``rumi_slam_tpu_torch`` on one H100: closed-loop
monocular SLAM over frames rendered from a seeded synthetic world.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``harness.py`` for the run, ``stream.py`` for the traffic, ``check.py``
for what decides ``correct``, and ``control.py`` for the readings its
limits were set from.
"""
