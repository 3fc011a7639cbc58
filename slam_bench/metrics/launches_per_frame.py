"""Host dispatch: CUDA kernel launches in the profiled span over the frames
that returned in it.  Moves ``frames_per_s``."""

LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t["n_device_ops"]:
        return None
    n = sum(1 for _, a, b, _ in run.frames if a >= run.span[0] and b <= run.span[1])
    return t["launches"] / n if n else None
