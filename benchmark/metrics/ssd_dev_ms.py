"""Device ms a step launched inside the program's `model_ssd` spans: the
chunked scans, forward and backward (the backward recomputes the forward
inside its span)."""
from benchmark.model_spans import ModelSpans


def read(r):
    return ModelSpans(r.trace, "model_ssd").device_ms()
