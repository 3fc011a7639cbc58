"""The overlapped local-mapping round (``tracking/mapping_worker.py``:
``run_mapping_round`` and the wait for its CUDA event on the worker's
thread): the program's ``mapping_round`` stages on threads other than the
tracking thread, in the window and outside the profiled span, mean ms a
round.  Moves ``frame_ms_p95``."""

LAYER = "local mapping round"
MOVES = "frame_ms_p95"


def read(run):
    xs = []
    for n, s, e, tid in run.spans:
        if n != "mapping_round" or tid == run.main_thread or s < run.t0 or e > run.t1:
            continue
        if run.span is not None and e >= run.span[0] and s <= run.span[1]:
            continue
        xs.append(e - s)
    return 1e3 * sum(xs) / len(xs) if xs else None
