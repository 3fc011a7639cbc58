"""The 95th percentile (numpy's linear rule) over all frames of the window
of the host time from handing a frame in to the return of
``maybe_ruminate``, in ms."""

import numpy as np


def read(run):
    lat = [1e3 * (b - a) for _, a, b, _ in run.frames]
    return float(np.percentile(lat, 95)) if lat else None
