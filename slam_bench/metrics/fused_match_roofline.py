"""The fused matcher kernel (``csrc/fused_match.cu``, gated): the least time
of the span's gated calls (``roofline.fused_match_bound_ms``, each call's
own F, P, valid rows and pairs in the gate) over their partial and merge
kernels' device time under ``torch.profiler``, in %.  Moves
``frames_per_s``."""

LAYER = "kernel"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t["gated_match_kernels"] or not run.match_bounds_ms:
        return None
    return 100.0 * sum(run.match_bounds_ms) / (1e3 * t["fused_match_device_s"])
