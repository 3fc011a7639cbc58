"""The device: the share of the profiled span (a few seconds in the middle
of the window, between two synchronisations) in which no operation ran on
the card, in %.  Moves ``frames_per_s``."""

LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t["n_device_ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
