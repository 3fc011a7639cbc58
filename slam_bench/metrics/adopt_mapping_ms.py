"""The mapping round's adoption on the tracking thread
(``tracking/mapping_worker.py`` -> ``system._apply_mapping``): the program's
``adopt_mapping`` stage, mean ms an adoption, outside the profiled span.
Moves ``frame_ms_p95``."""

LAYER = "mapping round adoption"
MOVES = "frame_ms_p95"


def read(run):
    xs = run.stage_durations("adopt_mapping")
    return 1e3 * sum(xs) / len(xs) if xs else None
