"""Device ms a step launched inside the program's `model_mamba` spans: the
Mamba-2 mixers (projections, convolution, scan, gated norm), forward and
backward, on whichever thread launched them."""
from benchmark.model_spans import ModelSpans


def read(r):
    return ModelSpans(r.trace, "model_mamba").device_ms()
