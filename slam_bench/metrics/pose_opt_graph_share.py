"""How much of motion-only pose optimisation ran as a CUDA graph: the share
of the program's ``pose_opt`` stages held by the ``track`` stages that
``track_ms`` counts which hold a ``pose_opt_graph`` stage (a call that
``optim/pose_opt.pose_optimization`` answered by replaying a captured
graph).  A program without that stage reads nothing.  Moves
``frames_per_s``."""

LAYER = "motion-only pose optimisation"
MOVES = "frames_per_s"


def tracked(run):
    """(start, end) of the tracking thread's ``track`` stages in the window,
    outside the profiled span (those of ``run.stage_durations("track")``)."""
    out = []
    for n, s, e, tid in run.spans:
        if n != "track" or tid != run.main_thread or s < run.t0 or e > run.t1:
            continue
        if run.span is not None and e >= run.span[0] and s <= run.span[1]:
            continue
        out.append((s, e))
    return out


def read(run):
    mine = [(n, s, e) for n, s, e, tid in run.spans if tid == run.main_thread]
    graphs = [(s, e) for n, s, e in mine if n == "pose_opt_graph"]
    if not graphs:
        return None
    frames = tracked(run)
    opts = [(s, e) for n, s, e in mine
            if n == "pose_opt" and any(a <= s and e <= b for a, b in frames)]
    if not opts:
        return None
    held = sum(1 for s, e in opts if any(s <= a and b <= e for a, b in graphs))
    return held / len(opts)
