"""Device ms a step of the collectives' kernels (NCCL's, found by name)."""


def read(r):
    ms = r.trace.device_ms_named("nccl")
    return ms / r.trace.steps if ms and r.trace.steps else None
