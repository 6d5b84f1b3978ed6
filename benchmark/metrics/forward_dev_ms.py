"""Device ms a step launched inside the program's `psgd_forward` spans: the
model's forward passes (two on an FD update step, one on a gradient-only
step)."""
from benchmark import phases


def read(r):
    return phases.Phases(r.trace).device_ms(["psgd_forward"])
