"""Frames that returned in the window over the window's seconds."""


def read(run):
    return len(run.frames) / run.window_s if run.frames and run.window_s else None
