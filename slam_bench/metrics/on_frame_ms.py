"""The rumination coordinator's per-frame recording
(``rumination/coordinator.on_frame``: the frame's copy to the host, which
waits for the work queued before it, into the ring): the program's
``on_frame`` stage, mean ms a frame, outside the profiled span.  Moves
``frames_per_s``."""

LAYER = "rumination frame recording"
MOVES = "frames_per_s"


def read(run):
    xs = run.stage_durations("on_frame")
    return 1e3 * sum(xs) / len(xs) if xs else None
