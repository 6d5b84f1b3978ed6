"""Device ms a step launched inside the preconditioner spans
(`kron.update_multi`, `kron.apply`, `lra.update_apply`, `lra.apply`)."""


def read(r):
    ms = r.trace.device_ms("precond")
    return None if ms is None or not r.trace.steps else ms / r.trace.steps
