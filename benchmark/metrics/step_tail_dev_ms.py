"""Device ms a step launched inside the program's `psgd_step` span and
outside its six phase spans: ravel, casts, slices, unravel, clipping, the
descent and the aux norms."""
from benchmark import phases


def read(r):
    return phases.Phases(r.trace).device_ms(["psgd_step"], phases.NAMES[1:])
