#!/usr/bin/env python3
"""Where the time of one delayed-XOR RNN + lra step goes on the card.

    python3 tools/profile_torch_rnn_lra.py

Run from the root of the repository on a machine with one CUDA card. It
builds the port's kernels, sets up `rnn_xor_lra`'s step at the reference
widths (SimpleRNN hidden 30, 1,021 parameters, rank 10, batch 128,
sequences of 16, exact Hvp, clip 1.0), warms up, then measures:

  - the step time: host clock around single synchronised steps (median of
    30), and CUDA events over 100 chained steps, with the kernels and
    under `hopper.disabled()`;
  - K13's call (`lra.update_apply`): its host time per call, and within it
    the host time of the three C entry points; the rest is the rank-space
    algebra and the d' update in torch (median of 200 calls, no sync);
  - `torch.profiler` over 20 chained steps: the device's busy time per step
    (the union of the kernels' intervals), its idle share of the wall,
    K13's kernels' device time per step, and the kernel launches per step.

It exits non-zero when there is no CUDA device. Output: one line per
measurement, then one JSON line with all of them, then the card's name and
power limit.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository root

WARMUP = 50
SYNC_STEPS = 30
CHAINED_STEPS = 100
CALLS = 200
PROFILED_STEPS = 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from psgd_tf_tpu_torch import PSGD, lra
    from psgd_tf_tpu_torch.data import xor
    from psgd_tf_tpu_torch.models import rnn
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, lra_upd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    params = rnn.init(g)
    opt = PSGD(preconditioner="lra", rank=10, lr_params=0.01, lr_preconditioner=0.01,
               grad_clip_max_norm=1.0)
    state = opt.init(params)
    batches = [xor.batch(g, 128, 16) for _ in range(8)]
    out: dict[str, float] = {}

    def step(k):
        nonlocal params, state
        params, state, _ = opt.step(rnn.loss, params, state, g, *batches[k % len(batches)])

    for k in range(WARMUP):
        step(k)

    # step time, synchronised and chained, kernels and plain
    for mode in ("kernel", "plain"):
        with hopper.disabled() if mode == "plain" else contextlib.nullcontext():
            times = []
            for k in range(SYNC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(k)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for k in range(CHAINED_STEPS):
                step(k)
            b.record()
            b.synchronize()
        out[f"step_sync_ms_{mode}"] = statistics.median(times)
        out[f"step_chained_ms_{mode}"] = a.elapsed_time(b) / CHAINED_STEPS
        print(f"step ({mode}): synchronised {out[f'step_sync_ms_{mode}']:.3f} ms (median of "
              f"{SYNC_STEPS}), chained {out[f'step_chained_ms_{mode}']:.3f} ms", flush=True)

    # K13's host time, and its C entry points' share of it
    n = sum(p.numel() for p in params)
    v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
    in_c = [0.0]
    originals = {}
    for name in ("stage1", "stage3", "stage4"):
        fn = getattr(lra_upd._Kernels, name)
        originals[name] = fn

        def timed(self, *a, _fn=fn, **k):
            t0 = time.perf_counter()
            r = _fn(self, *a, **k)
            in_c[0] += time.perf_counter() - t0
            return r

        setattr(lra_upd._Kernels, name, timed)
    calls, c_parts = [], []
    for k in range(CALLS):
        in_c[0] = 0.0
        t0 = time.perf_counter()
        lra.update_apply(state.precond, v, h, gr, 0.01, (k % 100 == 0, k % 2 == 0))
        calls.append((time.perf_counter() - t0) * 1e3)
        c_parts.append(in_c[0] * 1e3)
        if k % 20 == 19:
            torch.cuda.synchronize()
    for name, fn in originals.items():
        setattr(lra_upd._Kernels, name, fn)
    out["k13_call_host_ms"] = statistics.median(calls)
    out["k13_c_entry_host_ms"] = statistics.median(c_parts)
    out["k13_algebra_host_ms"] = statistics.median(a - b for a, b in zip(calls, c_parts))
    print(f"k13 call: host {out['k13_call_host_ms']:.3f} ms, of it the three C entry points "
          f"{out['k13_c_entry_host_ms']:.3f} ms and the rank-space algebra and d' in torch "
          f"{out['k13_algebra_host_ms']:.3f} ms (medians of {CALLS})", flush=True)

    # the profiler over chained steps
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(PROFILED_STEPS):
            step(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    k13_us = sum(e.time_range.end - e.time_range.start for e in kernels
                 if e.name.startswith("lra_"))
    out["profiled_wall_ms_per_step"] = wall_ms / PROFILED_STEPS
    out["device_busy_ms_per_step"] = busy_us / 1e3 / PROFILED_STEPS
    out["device_idle_share"] = 1.0 - busy_us / 1e3 / wall_ms
    out["k13_device_ms_per_step"] = k13_us / 1e3 / PROFILED_STEPS
    out["launches_per_step"] = len(kernels) / PROFILED_STEPS
    print(f"profiler, {PROFILED_STEPS} chained steps: wall {out['profiled_wall_ms_per_step']:.3f} "
          f"ms per step, device busy {out['device_busy_ms_per_step']:.4f} ms per step (idle "
          f"{out['device_idle_share']:.4f} of the wall), K13 kernels "
          f"{out['k13_device_ms_per_step']:.4f} ms per step, "
          f"{out['launches_per_step']:.0f} kernel launches per step", flush=True)
    top = prof.key_averages().table(sort_by="device_time_total", row_limit=12)
    print(top, flush=True)
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
