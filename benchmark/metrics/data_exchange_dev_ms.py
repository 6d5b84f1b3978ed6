"""Device ms a step launched inside the program's `psgd_exchange` spans: the
data all-reduce of loss, gradients and Hvps, and the gather of P g over
`shard` (NCCL's kernels, their wait for the peer included)."""
from benchmark import phases


def read(r):
    return phases.Phases(r.trace).device_ms(["psgd_exchange"])
