"""Tracking's projection match (``tracking/tracker.match_projected``: the
projection, the fused matcher and its post-filters): the program's
``track_match`` stages held by the ``track`` stages that ``track_ms``
counts, ms summed over those tracked frames a frame (a frame that retries
with the wide window adds its second match).  Moves ``frames_per_s``."""

LAYER = "tracking projection match"
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
    frames = tracked(run)
    held = [e - s for n, s, e, tid in run.spans
            if n == "track_match" and tid == run.main_thread
            and any(a <= s and e <= b for a, b in frames)]
    return 1e3 * sum(held) / len(frames) if held else None
