"""The preconditioner's share of its roofline: the summed least times of
the traced steps' preconditioner calls (`work.py`: the larger of bytes over
3.35 TB/s and FLOPs over 67 TFLOP/s, from each function's minimal work)
over their device time in the preconditioner spans, in %."""


def read(r):
    ms = r.trace.device_ms("precond")
    if not ms or r.precond_bound_ms is None:
        return None
    return 100.0 * r.precond_bound_ms / ms
