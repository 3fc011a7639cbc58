"""The ATE experiment driver of the JAX package (``examples/ate_experiment.py``)
or of the port (``python -m rumi_slam_tpu_torch.examples.ate_experiment``) on
a handheld sweep written as TUM groundtruth (``torch_harness_drive.
write_groundtruth``): the driver's ``experiment_config()`` and its
``GroundtruthSequence`` defaults (320x240, K from the width) but for the
landmark count, ``N_POINTS`` in place of 2500, set the same way in both
packages (``GroundtruthSequence`` is wrapped while the driver runs).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_ate_drive.py [--port] [--record]
        [--frames N] [--points N] [--gap T0 T1] [--threads N] [--runs gap control paced]

Runs (``RUNS``, ``driver_args``): ``gap``, 2 repeats with frames in ``GAP_S``
rendered degraded, rumination on; ``control``, 1 repeat with no gap and no
rumination; with ``paced``, 1 repeat of the gap run at ``--pace 1.0`` (the
driver then warms up first).  ``--record`` writes JAX's summaries of the
runs it ran into ``tests/torch_ate_floor.json`` (the card host has no JAX);
``chip_smoke.py`` phase 13 (e) runs all three in the port on the card and
holds ``gap`` and ``control`` to them.

Why this scene (each figure below is this script's, with ``--frames``,
``--points``, ``--gap`` and ``--threads``; JAX's on the CPU, the port's on
the CPU unless an H100 is named): ``GroundtruthSequence`` places its
landmarks along the trajectory and the sweep stays over one region, so at
320x240 the driver's 2500 cover every pixel: with no gap the port on the CPU
lost track every 25-40 frames over 180 frames, and JAX made 4 submaps over
180 frames and 7 over 300.  Longer drives at lower densities still lose
track now and then without a gap (1200 landmarks over 150 frames: once in
the port, in one of two worlds, not in JAX), and the coordinator then
ruminates two later submaps, a coin toss (on one repeat JAX's backend failed
and the port on an H100 merged: ATE 0.0127 against 0.1253 m).  And a drive
this small is chaotic: over 90 frames with 700 landmarks the port's no-gap
ATE was 0.0074 m or 0.0918 m depending on the order of float sums (CPU
threads; on an H100 one run in three), JAX's 0.0064 m.  75 frames with 600
landmarks and the gap at 1.5-1.9 s: the port on the CPU gives the same ATE
with 1 to 4 threads (no gap 0.0040-0.0041 m; with the gap, two worlds,
0.0054 and 0.0112 m), tracks every frame but the gap's, and the new submap,
18 frames old at the end, is too young to ruminate (12 keyframes are
needed).

The module imports neither package at the top, so ``chip_smoke.py`` can load
it where JAX is absent.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

FRAMES = 75
N_POINTS = 600
GAP_S = (1.5, 1.9)


def driver_args(name, gap=GAP_S):
    """The driver's arguments for run ``name`` (``RUNS``)."""
    gap_args = ["--gap-starts", str(gap[0]), "--gap-len", str(round(gap[1] - gap[0], 6))]
    return {"gap": ["--repeats", "2"] + gap_args,
            "control": ["--repeats", "1", "--control"],
            "paced": ["--repeats", "1"] + gap_args + ["--pace", "1.0"]}[name]


RUNS = ("gap", "control", "paced")
FLOOR = Path(__file__).resolve().parent / "torch_ate_floor.json"
SUMMARY_KEYS = ("repeats_planned", "repeats_done", "complete", "ate_m", "rate_mean",
                "n_merges_total", "merged_runs")


def _jax_main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    path = Path(__file__).resolve().parent.parent / "examples" / "ate_experiment.py"
    spec = importlib.util.spec_from_file_location("_jax_ate_experiment", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["ate_experiment"] + argv
    try:
        mod.main()
    finally:
        sys.argv = saved


def summary(out: dict) -> dict:
    """The distribution and, per row, what the bounds and the report read."""
    s = {k: out[k] for k in SUMMARY_KEYS}
    s["rows"] = [{k: r.get(k) for k in ("repeat", "gap", "ate", "rate", "n_kf", "n_maps",
                                        "n_merges", "n_loss_events", "drops", "n_tracked",
                                        "runtime_s")}
                 for r in out["rows"]]
    return s


def run(package="rumi_slam_tpu", runs=("gap", "control"), *, frames=FRAMES, points=N_POINTS,
        gap=GAP_S, device="cpu", work_dir=None):
    """Each of ``runs`` through ``package``'s driver; returns {run: summary}."""
    import functools

    from torch_harness_drive import write_groundtruth

    rt = importlib.import_module(f"{package}.io.real_trajectory")
    seq_cls = rt.GroundtruthSequence
    out = {}
    rt.GroundtruthSequence = functools.partial(seq_cls, n_points=points)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(work_dir or tmp)
            gt = write_groundtruth(d / "sweep" / "groundtruth.txt", frames)
            for name in runs:
                path = d / f"{name}.json"
                argv = ["--seq", gt, "--out", str(path)] + driver_args(name, gap)
                if package == "rumi_slam_tpu":
                    _jax_main(argv)
                else:
                    from rumi_slam_tpu_torch.examples import ate_experiment

                    ate_experiment.main(argv + ["--device", device])
                out[name] = summary(json.loads(path.read_text()))
    finally:
        rt.GroundtruthSequence = seq_cls
    return out


if __name__ == "__main__":
    import argparse

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="the port on the CPU")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--points", type=int, default=N_POINTS)
    ap.add_argument("--gap", type=float, nargs=2, default=GAP_S)
    ap.add_argument("--threads", type=int, default=None,
                    help="torch.set_num_threads for the port (its drive depends on the order "
                         "of float sums)")
    ap.add_argument("--runs", nargs="*", default=["gap", "control"], choices=RUNS)
    ap.add_argument("--record", action="store_true",
                    help="write JAX's summaries into tests/torch_ate_floor.json")
    a = ap.parse_args()
    scene = dict(frames=a.frames, points=a.points, gap=tuple(a.gap))
    if a.record and scene != dict(frames=FRAMES, points=N_POINTS, gap=GAP_S):
        ap.error("--record writes the floor of the default scene only")
    if a.threads:
        import torch

        torch.set_num_threads(a.threads)
    t0 = time.perf_counter()
    res = run("rumi_slam_tpu_torch" if a.port else "rumi_slam_tpu", a.runs, **scene)
    res["frames"] = a.frames
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    if a.record and not a.port:
        floor = json.loads(FLOOR.read_text()) if FLOOR.exists() else {}
        floor.update(res)
        FLOOR.write_text(json.dumps(floor, indent=1) + "\n")
