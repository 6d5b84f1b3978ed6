"""Device ms a step launched inside the program's `psgd_grad` or `psgd_hvp`
spans and outside `psgd_forward`: the backward passes, plus the FD's
perturbation and difference."""
from benchmark import phases


def read(r):
    ph = phases.Phases(r.trace)
    if not ph.has("psgd_forward"):
        return None
    return ph.device_ms(["psgd_grad", "psgd_hvp"], ["psgd_forward"])
