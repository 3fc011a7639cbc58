"""The rumination end-to-end scenario (loss -> back submap -> double merge),
in the JAX package and in the port.

A handheld sweep (``SyntheticSequence(trajectory="sweep", seed=11,
n_points=2000, patch=4, lost_span=(45, 51))``, 110 frames) loses tracking on
six featureless frames; with ``reloc_window_s=0.1`` the system opens a second
submap, the coordinator assembles the upload bundle once that submap has
matured, a backend builds the back submap, and the double merge (cloud ->
front, back -> front) plus a dense global BA leave one map.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_rumination_drive.py
        [--port] [--full] [--async] [--own-backend] [--seed N] [--frames N]
        [--n-first N] [--default-k] [--overlapped]

* default: the JAX package at ``tiny_config()`` (320x240); ``--port`` runs the
  port on the CPU instead.  The scene is rendered with the configuration's
  intrinsics.  ``--default-k`` renders it as ``tests/test_rumination_e2e.py``
  does, with the sequence's own default intrinsics (0.8 x width: fx 256, where
  ``tiny_config()`` tells the system 260); the JAX package then takes one frame
  more to start the new submap and records 8 lost frames, not 7.
* ``--full``: ``Config()`` widths (640x480, 8 levels, 1024 features, ``max_kf``
  256, ``max_pt`` 16384) with the time/count gates of ``tiny_config()``, which
  are depths: a 110-frame drive cannot meet the defaults' 40 keyframes and 3 s.
* default backend: the *clear-view* backend, a subclass of the package's
  ``RuminationBackend`` whose ``build()`` swaps every bundle image for the clean
  rendering at the same timestamp (same seed, ``lost_span=None``) and then calls
  the parent.  The synthetic loss renders a flat image, which no backend can see
  through; a dense backend sees degraded frames, and this stands in for it.
* ``--own-backend``: the package's backend unchanged; the run stops at the
  first ``history`` row.
* ``--async``: the build goes through ``AsyncRuminationShard``.
* ``--overlapped``: the live system's local mapping runs on its worker thread
  (``Config()``'s own setting); the default maps synchronously.  The port's
  backend always maps inline; the JAX package's inherits the setting, and its
  offline system then outruns its own worker and loses track
  (``backend_failed``), so with ``--overlapped`` the drive hands the JAX
  backend inline mapping too.

It prints one JSON object: the state string (one letter per frame: N not
initialised, O ok, R recently lost, L lost), ``stats``, the coordinator's
``history``, keyframes per map, the keyframe ATE of the merged map, and the
backend's own state string and ``last_weld_tries``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time

import numpy as np

SEED = 11
N_FRAMES = 110
LOST_SPAN = (45, 51)
FPS = 30.0
_LETTER = {"NOT_INITIALIZED": "N", "OK": "O", "RECENTLY_LOST": "R", "LOST": "L"}


def scenario_config(cfg_mod, full: bool, n_first=None, overlapped=False):
    """The scenario's configuration in either package (``cfg_mod`` is its
    ``config`` module): ``tiny_config()``, or ``Config()`` with tiny's depth
    gates when ``full``; always ``reloc_window_s=0.1`` and loop closing on;
    local mapping on the worker thread when ``overlapped``, else synchronous."""
    tiny = cfg_mod.tiny_config()
    if full:
        base = cfg_mod.Config()
        cfg = dataclasses.replace(
            base,
            mapping=dataclasses.replace(base.mapping, overlapped=False),
            tracking=dataclasses.replace(
                base.tracking, new_map_min_kf=tiny.tracking.new_map_min_kf,
                new_map_min_duration_s=tiny.tracking.new_map_min_duration_s),
            sampler=dataclasses.replace(
                base.sampler, n_track_last=tiny.sampler.n_track_last,
                n_new_track_first=tiny.sampler.n_new_track_first,
                min_time_s=tiny.sampler.min_time_s, min_bundle=tiny.sampler.min_bundle),
            merge=dataclasses.replace(base.merge, max_match_kf=tiny.merge.max_match_kf),
        )
    else:
        cfg = tiny
    cfg = dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, reloc_window_s=0.1))
    if n_first is not None:
        cfg = dataclasses.replace(
            cfg, sampler=dataclasses.replace(cfg.sampler, n_new_track_first=n_first))
    return dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, overlapped=overlapped))


def make_sequence(syn_mod, cfg, *, seed=SEED, frames=N_FRAMES, lost_span=LOST_SPAN,
                  config_k=True, **kw):
    """The scenario's sequence; ``config_k`` False renders it with the
    sequence's own default intrinsics, as ``tests/test_rumination_e2e.py`` does."""
    c = cfg.camera
    return syn_mod.SyntheticSequence(
        n_frames=frames, width=c.width, height=c.height,
        K=cfg.intrinsics() if config_k else None,
        n_points=2000, seed=seed, patch=4, lost_span=lost_span, trajectory="sweep", **kw)


def clear_view_backend(backend_cls, clean_seq, sampler_mod):
    """``backend_cls`` with a ``build()`` that first swaps each bundle image for
    ``clean_seq``'s rendering at the same timestamp, then calls the parent."""

    class ClearViewBackend(backend_cls):
        def build(self, bundle, anchor_times=(), anchor_split=None):
            clean = []
            for f in bundle:
                i = int(round(f.time * FPS))
                assert abs(clean_seq.times[i] - f.time) < 1e-6
                clean.append(sampler_mod.RecordedFrame(f.time, np.asarray(
                    _to_numpy(clean_seq.frame(i)[0]))))
            return super().build(clean, anchor_times=anchor_times,
                                 anchor_split=anchor_split)

    return ClearViewBackend


def _to_numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def record_backend_states(backend_mod):
    """Wrap the ``SlamSystem`` that ``backend_mod`` builds so that each offline
    build appends its state string to the returned list."""
    real = backend_mod.SlamSystem
    runs = []

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._states = []
            runs.append(self._states)

        def track_monocular(self, img, t):
            st = super().track_monocular(img, t)
            self._states.append(_LETTER[st.name])
            return st

    backend_mod.SlamSystem = Recording

    def restore():
        backend_mod.SlamSystem = real

    return runs, restore


def run(package="rumi_slam_tpu", *, full=False, use_async=False, own_backend=False,
        seed=SEED, frames=N_FRAMES, lost_span=LOST_SPAN, n_first=None, config_k=True,
        overlapped=False, device="cpu"):
    """Drive the scenario in ``package``; returns the summary dict.  With
    ``own_backend`` the run stops at the first ``history`` row.  ``config_k``
    False renders with the sequence's default intrinsics (``make_sequence``)."""
    port = package.endswith("_torch")
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    cfg_mod, syn_mod, sys_mod = mod("config"), mod("io.synthetic"), mod("system")
    backend_mod, coord_mod = mod("rumination.backend"), mod("rumination.coordinator")
    sampler_mod, remote_mod = mod("rumination.sampler"), mod("rumination.remote")
    M, ate = mod("mapstate.map_state"), mod("evaluation.ate")

    cfg = scenario_config(cfg_mod, full, n_first, overlapped)
    dev_kw = {"device": device} if port else {}
    seq = make_sequence(syn_mod, cfg, seed=seed, frames=frames, lost_span=lost_span,
                        config_k=config_k, **dev_kw)
    if own_backend:
        backend_cls = backend_mod.RuminationBackend
    else:
        clean = make_sequence(syn_mod, cfg, seed=seed, frames=frames, lost_span=None,
                              config_k=config_k, **dev_kw)
        backend_cls = clear_view_backend(backend_mod.RuminationBackend, clean, sampler_mod)

    backend_runs, restore = record_backend_states(backend_mod)
    try:
        slam = sys_mod.SlamSystem(cfg, **dev_kw)
        backend = backend_cls(cfg, **dev_kw)
        if overlapped and not port:
            backend.cfg = dataclasses.replace(backend.cfg, mapping=dataclasses.replace(
                backend.cfg.mapping, overlapped=False))
        shard = (remote_mod.AsyncRuminationShard(cfg, backend=backend, **dev_kw)
                 if use_async else None)
        coord = coord_mod.RuminationCoordinator(
            slam, cfg, backend=None if use_async else backend, async_shard=shard)
        states, in_flight = [], 0
        try:
            for i in range(len(seq)):
                img, t = seq.frame(i)
                states.append(_LETTER[slam.track_monocular(img, t).name])
                if shard is not None and shard.busy:
                    in_flight += 1
                coord.maybe_ruminate()
                if own_backend and coord.history:
                    break
            if shard is not None:
                deadline = time.time() + 1800
                while (shard.busy or coord._pending is not None) and time.time() < deadline:
                    coord.maybe_ruminate()
                    time.sleep(0.05)
            slam.sync_mapping()
        finally:
            if slam.mapper is not None:
                slam.mapper.shutdown()
            if shard is not None:
                shard.shutdown()
    finally:
        restore()

    ms = slam.ms
    counts = [int(M.map_kf_count(ms, m)) for m in range(int(ms.n_maps))]
    out = {
        "package": package, "full": full, "async": use_async, "own_backend": own_backend,
        "overlapped": overlapped,
        "seed": seed, "frames": frames, "lost_span": list(lost_span), "config_k": config_k,
        "n_new_track_first": cfg.sampler.n_new_track_first,
        "states": "".join(states),
        "ok_share": states.count("O") / max(len(states), 1),
        "stats": dict(slam.stats),
        "history": coord.history,
        "kf_per_map": counts,
        "backend_states": ["".join(s) for s in backend_runs],
        "last_weld_tries": getattr(backend, "last_weld_tries", None),
        "frames_tracked_in_flight": in_flight,
    }
    if shard is not None and port:
        out["shard_error"] = repr(shard.last_error) if shard.last_error else None
    merged = any(h.get("result") == "merged" for h in coord.history)
    if merged:
        kt, kp = slam.keyframe_trajectory()
        gt = np.stack([_to_numpy(p) for p in seq.poses_gt])
        m = ate.evaluate_trajectory(kt, kp, np.asarray(seq.times), gt)
        out["kf_ate"] = float(m["ate"])
        out["kf_span"] = [float(kt.min()), float(kt.max())]
        out["n_kf_traj"] = int(len(kt))
    return out


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="run the port on the CPU instead of the JAX package")
    ap.add_argument("--full", action="store_true", help="Config() widths (640x480)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="build through AsyncRuminationShard")
    ap.add_argument("--own-backend", action="store_true",
                    help="the package's own backend; stop at the first history row")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--n-first", type=int, default=None,
                    help="override sampler.n_new_track_first")
    ap.add_argument("--default-k", action="store_true",
                    help="render with the sequence's default intrinsics (0.8 x width)")
    ap.add_argument("--overlapped", action="store_true",
                    help="live local mapping on the worker thread")
    a = ap.parse_args()
    t0 = time.perf_counter()
    res = run("rumi_slam_tpu_torch" if a.port else "rumi_slam_tpu", full=a.full,
              use_async=a.use_async, own_backend=a.own_backend, seed=a.seed,
              frames=a.frames, n_first=a.n_first, config_k=not a.default_k,
              overlapped=a.overlapped)
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(_jsonable(res)), flush=True)
