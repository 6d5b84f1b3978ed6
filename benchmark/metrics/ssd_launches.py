"""Device operations (kernels, copies, fills) launched a step inside the
program's `model_ssd` spans: the count a scan kernel would cut."""
from benchmark.model_spans import ModelSpans


def read(r):
    return ModelSpans(r.trace, "model_ssd").launches()
