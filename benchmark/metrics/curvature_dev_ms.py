"""Device ms a step launched inside the curvature spans (`hvp.finite_diff`,
`hvp.grad_only`): the model's gradients and the FD Hvp."""


def read(r):
    ms = r.trace.device_ms("curvature")
    return None if ms is None or not r.trace.steps else ms / r.trace.steps
