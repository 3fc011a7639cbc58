"""ORB extraction (``ops/orb.py``, ``image``, ``fast``, ``select``): the
program's ``orb_extract`` stage, mean ms a frame, on the tracking thread,
over the window outside the profiled span.  Moves ``frames_per_s``."""

LAYER = "ORB extraction"
MOVES = "frames_per_s"


def read(run):
    xs = run.stage_durations("orb_extract")
    return 1e3 * sum(xs) / len(xs) if xs else None
