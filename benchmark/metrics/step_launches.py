"""Device operations (kernels, copies, fills) launched a step inside the
program's `psgd_step` span."""
from benchmark import phases


def read(r):
    ph = phases.Phases(r.trace)
    return ph.per_step(float(len(ph.launched(["psgd_step"])))) if ph.has("psgd_step") else None
