"""How often tracking matches a frame: the program's ``track_match`` and
``track_ref_kf`` stages held by the ``track`` stages that ``track_ms``
counts, over those tracked frames.  1.0: no frame fell back; a frame that
falls back to its reference keyframe counts 2, one that then retries with
the wide window 3.  Moves ``frames_per_s``."""

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
    calls = sum(1 for n, s, e, tid in run.spans
                if n in ("track_match", "track_ref_kf") and tid == run.main_thread
                and any(a <= s and e <= b for a, b in frames))
    return calls / len(frames) if calls else None
