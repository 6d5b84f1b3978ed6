"""The scan's share of its roofline, in %: the least time of the traced
scan calls over their device time inside the `model_spans` ranges. A
forward call (a `model_ssd` range on the step's thread) and a backward
call (one on autograd's) each take the work of the model adapter's
`ssd_work` (x, B, C, dt and A read once and y written once; the
recurrence's 4 P N FLOPs a head and token forward, twice that backward),
at 3.35 TB/s or 67 TFLOP/s (`work.bound_ms`), for the configuration and
traffic whose batches the run drew. None without the spans, or where the
configuration recorded is not a Granite one."""
from pathlib import Path

from benchmark import spec
from benchmark.model_spans import ModelSpans

ROOT = Path(__file__).resolve().parents[2]


def read(r):
    spans = ModelSpans(r.trace, "model_ssd")
    if not spans.found or not spans.ops:
        return None
    model = spec.part("models", "granite_hybrid", ROOT)
    cfg, traffic = model.current(), model.current_traffic()
    if cfg is None or traffic is None or cfg.get("model") != "granite_hybrid":
        return None
    bound = model.ssd_bound_ms(cfg, traffic, spans.forward_calls, spans.backward_calls)
    return 100.0 * bound / (sum(spans.ops) / 1e3)
