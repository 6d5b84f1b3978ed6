"""One run of one cell: set-up, the measured window, the check, the line.

Set-up makes the weights on the card from the seed, builds the program's
optimizer and state (`psgd_tf_tpu_torch.PSGD`; on a mesh its sharded step,
`parallel.build_sharded_step`), and drives that same step through its
first four steps on the traffic's own batches: the first three are the
ones the reference follows, the fourth warms what is left. Where the
preconditioner updates on only some steps, the optimizer's fixed seed
(`traffic.OPTIMIZER_SEED`) puts both kinds of step among those four.
Nothing builds or compiles after set-up.

The window issues steps back to back, with no host sync inside a step, and
records a CUDA event after each; it ends with the first step issued after
`--seconds` on the host's clock. Step times are the gaps between
consecutive step-end events, read after the window. A traced run
(`--trace 1`) instead profiles the traffic's `trace_steps` steps with the
benchmark's spans installed and reads the per-layer metrics from the trace.

After the window the program's state is freed and the plain reference
follows the first three steps; `check.py` decides `correct`.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from benchmark import check, spec, work
from benchmark import trace as trace_mod
from benchmark.traffic import OPTIMIZER_SEED, Traffic, sub_seed, update_flags

FORBIDDEN = ("jax", "jaxlib", "flax", "psgd_tf_tpu")
FIRST = 3          # the steps the reference follows
RANK_TIMEOUT_S = 240


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list[str]:
    """The top-level names, whole, of the loaded modules (or of `names`)
    that are JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ the program

class Program:
    """The system under test on one rank: the weights, the optimizer, its
    state and the step the window drives."""

    def __init__(self, cell: spec.Cell, seed: int, device, mesh=None):
        from psgd_tf_tpu_torch import PSGD

        cfg, opt = cell.config, cell.config["optimizer"]
        model = cell.model
        gen = torch.Generator(device).manual_seed(sub_seed(seed, 0))
        self.p0 = model.weights(gen, cfg)
        kw = cell.family.program_kwargs(cfg, model)
        self.opt = PSGD(preconditioner=opt["preconditioner"], lr_params=opt["lr_params"],
                        lr_preconditioner=opt["lr_preconditioner"],
                        grad_clip_max_norm=opt["grad_clip_max_norm"],
                        preconditioner_update_probability=float(
                            cell.traffic["update_probability"]),
                        exact_hessian_vector_product=opt["hvp"] == "exact",
                        init_scale=float(opt.get("init_scale", 1.0)), **kw)
        self.opt_seed = OPTIMIZER_SEED
        state = self.opt.init(self.p0, seed=self.opt_seed)
        loss = model.program_loss()
        if mesh is None:
            self.state = state
            self._step = lambda params, st, batch, probes, coins: self.opt.step(
                loss, params, st, None, *batch, probes=probes, coins=coins)
        else:
            from psgd_tf_tpu_torch.parallel import build_sharded_step, policies

            self.state = policies.shard_state(mesh, state)
            sharded = build_sharded_step(self.opt, loss, mesh, state, self.p0)
            self._step = lambda params, st, batch, probes, coins: sharded(
                params, st, None, *batch, probes=probes, coins=coins)
        del state
        self.params = self.p0

    def step(self, batch, probes, coins):
        self.params, self.state, aux = self._step(self.params, self.state, batch, probes, coins)
        return aux


class Capture:
    """Keeps (loss, gradients) of the curvature call made inside it: the
    gradient as the optimizer gets it on one rank."""

    def __init__(self):
        self.got, self._saved = None, []

    def __enter__(self):
        for mod, name in trace_mod.curvature_targets():
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            self._saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                self.got = (out[0], list(out[1]))
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


# ------------------------------------------------------------------ per rank

class Reading:
    """What a per-layer metric reader gets from one rank."""

    def __init__(self, trace, device_trace, memory_peak_bytes, precond_bound_ms,
                 host_ms_per_step):
        self.trace = trace                  # the spans' window (host and card)
        self.device_trace = device_trace    # a window of the card alone
        self.memory_peak_bytes = memory_peak_bytes
        self.precond_bound_ms = precond_bound_ms
        self.host_ms_per_step = host_ms_per_step


def first_steps(prog: "Program", feed: Traffic, mesh=None) -> dict:
    """The program's first FIRST steps through the window's own call and
    feed: each step's loss, step 1's gradient as the optimizer gets it,
    and the parameters after each step."""
    losses, params = [], []
    with Capture() as cap:
        losses.append(prog.step(*feed.next())["loss"])
    if cap.got is None:
        raise RuntimeError("no curvature call (hvp.finite_diff / hvp.grad_only) seen in step 1")
    grads = cap.got[1]
    if mesh is not None:
        # the optimizer gets the mean over the data ranks; the shard ranks of
        # one data rank hold the same gradient, so the mean over all is it
        world = torch.distributed.get_world_size()
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat)
        grads = [x.reshape(g.shape) for x, g in
                 zip(torch.split(flat / world, [g.numel() for g in grads]), grads)]
    params.append(list(prog.params))
    for _ in range(FIRST - 1):
        losses.append(prog.step(*feed.next())["loss"])
        params.append(list(prog.params))
    return {"losses": [float(x) for x in losses], "grads": grads, "params": params,
            "p0": prog.p0, "opt_seed": prog.opt_seed}


def run_rank(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             mesh=None, ctl=None, fault=None) -> dict:
    """Set-up, window and traced reading on one rank. Returns this rank's
    summary; rank 0's also carries what the reference needs (`snap`).
    `fault` (tests only) breaks the program underneath before set-up."""
    device = torch.device(device)
    rank = 0 if mesh is None else torch.distributed.get_rank()
    p = float(cell.traffic["update_probability"])
    if p < 1.0 and len(set(update_flags(OPTIMIZER_SEED, p, FIRST + 1))) < 2:
        raise RuntimeError(f"set-up's {FIRST + 1} steps at update probability {p} do not warm "
                           "both an update step and a gradient-only step")
    prog = Program(cell, seed, device, mesh)
    if fault is not None:
        fault(prog)
    feed = Traffic(cell, seed, device)
    snap = first_steps(prog, feed, mesh)
    prog.step(*feed.next())
    _sync(device)
    if rank != 0:
        snap = None
    setup_s = time.time() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the window's own peak from here
    out = {"rank": rank, "setup_s": setup_s, "snap": snap}

    if not traced:
        out.update(_window(prog, feed, seconds, device, ctl))
    else:
        out.update(_traced(cell, prog, feed, device, mesh))
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                if device.type == "cuda" else 0)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(prog, feed, seconds, device, ctl) -> dict:
    cuda = device.type == "cuda"
    ev = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else None
    _sync(device)
    start = ev() if cuda else None
    ends, losses = [], []
    t0 = time.perf_counter()
    if cuda:
        start.record()
    while True:
        losses.append(prog.step(*feed.next())["loss"])
        if cuda:
            e = ev()
            e.record()
            ends.append(e)
        else:
            ends.append(time.perf_counter())
        go = time.perf_counter() - t0 < seconds
        if ctl is not None:
            flag = torch.tensor([int(go)])
            torch.distributed.broadcast(flag, 0, group=ctl)
            go = bool(flag.item())
        if not go:
            break
    _sync(device)
    if cuda:
        marks = [0.0] + [start.elapsed_time(e) for e in ends]
    else:
        marks = [0.0] + [(t - t0) * 1e3 for t in ends]
    step_ms = [b - a for a, b in zip(marks, marks[1:])]
    nonfinite = int((~torch.isfinite(torch.stack([x.detach().float() for x in losses]))).sum())
    return {"steps": len(step_ms), "step_ms": step_ms, "window_s": marks[-1] / 1e3,
            "nonfinite": nonfinite}


def _traced(cell, prog, feed, device, mesh) -> dict:
    """`trace_steps` steps each issued from an idle card and timed on the
    host's clock until the step's call returns (the host's work to issue
    it, with no launch waiting on a full queue), then as many under the
    profiler with the spans installed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = int(cell.traffic["trace_steps"])
    losses, host_s = [], 0.0
    for _ in range(n):
        batch, probes, coins = feed.next()
        _sync(device)
        if mesh is not None:
            torch.distributed.barrier()
        t = time.perf_counter()
        losses.append(prog.step(batch, probes, coins)["loss"])
        host_s += time.perf_counter() - t
    _sync(device)
    host_ms = host_s * 1e3 / n
    device_tr = None
    if device.type == "cuda":
        # the card alone first: the profiler's per-operation host cost
        # would otherwise read as idle time of the card
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                losses.append(prog.step(*feed.next())["loss"])
            _sync(device)
        device_tr = _read(prof)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with trace_mod.Spans(cell.family) as spans:
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    with record_function("bench.step"):
                        losses.append(prog.step(*feed.next())["loss"])
                _sync(device)
    tr = _read(prof)
    bound = cell.family.bound_ms(cell.config, cell.model, spans.calls, tr.steps, mesh)
    nonfinite = int((~torch.isfinite(torch.stack([x.detach().float() for x in losses]))).sum())
    return {"steps": tr.steps, "trace": tr, "device_trace": device_tr or tr,
            "calls": dict(spans.calls), "precond_bound_ms": bound, "host_ms_per_step": host_ms,
            "nonfinite": nonfinite}


def _read(prof) -> trace_mod.Trace:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return trace_mod.Trace(path)


def read_layers(cell: spec.Cell, summary: dict) -> dict:
    """This rank's per-layer readings by metric name (None: nothing read)."""
    r = Reading(summary["trace"], summary["device_trace"], summary["memory_peak_bytes"],
                summary["precond_bound_ms"], summary["host_ms_per_step"])
    return {m["name"]: spec.reader(m["name"], cell.root).read(r) for m in cell.per_layer}


def rank_summary(cell, s: dict, traced: bool) -> dict:
    """The part of a rank's summary that travels to rank 0."""
    out = {k: s[k] for k in ("rank", "setup_s", "steps", "nonfinite", "memory_peak_bytes")}
    if traced:
        dev = s["device_trace"]
        out.update(layers=read_layers(cell, s), busy_s=dev.busy_s, window_s=dev.window_s)
        if s["rank"] == 0:
            out["breakdown"] = {"device_ops": [list(x) for x in dev.top_device_ops()],
                                "idle_gaps": [list(x) for x in s["trace"].idle_gaps()]}
    else:
        out.update(step_ms=s["step_ms"], window_s=s["window_s"])
    return out


# ------------------------------------------------------------------ the reference

def reference(cell: spec.Cell, seed: int, snap: dict, device, tf32: bool = False,
              half_batch: bool = False, reorder: bool = False) -> dict:
    """The plain reference's readings of the first three steps, from the
    same weights, batches, probes and coins. `tf32` and `half_batch` make
    the control and a planted fault, `reorder` a sound run with other
    round-off: every batch's rows in another order (`control.py`)."""
    from benchmark.reference.psgd import Trainer

    cfg, model = cell.config, cell.model
    feed = Traffic(cell, seed, device)
    flags = update_flags(snap["opt_seed"], cell.traffic["update_probability"], FIRST)
    loss_fn = model.reference_loss()
    shuffle = torch.Generator(device).manual_seed(sub_seed(seed, 4))
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        trainer = Trainer(cfg["optimizer"], snap["p0"], cell.reference_family,
                          seed=snap["opt_seed"], **cell.family.reference_kwargs(cfg, model))
        params, losses, grads, after = list(snap["p0"]), [], None, []
        for i in range(FIRST):
            batch, probes, coins = feed.next()
            if half_batch:
                batch = tuple(x[: x.shape[0] // 2] for x in batch)
            if reorder:
                rows = torch.randperm(batch[0].shape[0], generator=shuffle, device=device)
                batch = tuple(x[rows] for x in batch)
            params, loss, g = trainer.step(loss_fn, params, batch, probes, flags[i], coins)
            losses.append(float(loss))
            grads = g if grads is None else grads
            after.append(params)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"losses": losses, "grads": grads, "params": after}


# ------------------------------------------------------------------ the result

def _card(device) -> tuple[str, str]:
    if device.type != "cuda":
        return "cpu", "none"
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                "-i", str(device.index or 0)], capture_output=True, text=True,
                               timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def result(cell: spec.Cell, traced: bool, ranks: list[dict], snap: dict, device,
           numbers: dict) -> dict:
    """The last line's object. `ranks` is every rank's summary, rank 0 first."""
    r0 = ranks[0]
    correct_nums, checks = check.judge(numbers, cell.limits)
    nonfinite = sum(r["nonfinite"] for r in ranks)
    peak = max(r["memory_peak_bytes"] for r in ranks)
    name, limit = _card(device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": name,
           "count": cell.chips, "memory_peak_bytes": peak, "power_limit": limit}
    metrics = {}
    if not traced:
        steps, window_s = r0["steps"], r0["window_s"]
        tok = cell.model.tokens_per_step(cell.traffic)
        flags = update_flags(snap["opt_seed"], cell.traffic["update_probability"],
                             FIRST + 1 + steps)[FIRST + 1:]
        flops = sum(step_flops(cell, f) for f in flags)
        values = {
            "train_tokens_per_s": steps * tok / window_s,
            "step_ms_p95": (statistics.quantiles(r0["step_ms"], n=20, method="inclusive")[18]
                            if steps >= 2 else r0["step_ms"][0]),
            "step_mfu": 100.0 * flops / (window_s * work.FP32_FLOPS * cell.chips),
            "setup_s": r0["setup_s"],
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            vals = [r["layers"][m["name"]] for r in ranks if r["layers"].get(m["name"]) is not None]
            if not vals:
                continue
            how = getattr(spec.reader(m["name"], cell.root), "COMBINE", "mean")
            v = max(vals) if how == "max" else sum(vals) / len(vals)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        dev["window_s"] = r0["window_s"]
    out = {"correct": bool(correct_nums and nonfinite == 0), "attempted": r0["steps"],
           "failed": nonfinite, "metrics": metrics, "device": dev}
    if traced and "breakdown" in r0:
        out["breakdown"] = r0["breakdown"]
    out["checks"] = checks
    return out


# forward passes a step, in units of the model's forward FLOPs: a gradient
# is a forward and a backward (3); the FD Hvp adds a second gradient
CURVATURE_PASSES = {"finite_diff": 6}


def step_flops(cell: spec.Cell, update: bool) -> float:
    """Model FLOPs of one step over the global batch, plus the
    preconditioner's minimal FLOPs."""
    hvp = cell.config["optimizer"]["hvp"]
    if hvp not in CURVATURE_PASSES:
        raise ValueError(f"no FLOP count for the Hvp {hvp!r}")
    fwd = cell.model.forward_flops(cell.config, cell.traffic)
    upd, app = cell.family.step_flops(cell.config, cell.model)
    return CURVATURE_PASSES[hvp] * fwd + upd if update else 3 * fwd + app


def emit(res: dict) -> None:
    """The checks as the last lines on stderr, the object as the last line
    on stdout."""
    m = res["metrics"]
    log("metrics: " + ", ".join(f"{k} {v['value']!r} {v['unit']}" for k, v in m.items()))
    log(f"device: {json.dumps(res['device'])}")
    log(f"correct {res['correct']} (attempted {res['attempted']}, failed {res['failed']})")
    for k, v in res["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(res), flush=True)


# ------------------------------------------------------------------ one process, many ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join_ranks(cell, seed, seconds, traced, rank, world, port, device_kind, t0, fault=None):
    """Join the job as `rank` and run this rank; returns (its run, every rank's summary)."""
    import torch.distributed as dist

    from psgd_tf_tpu_torch.parallel import make_mesh

    backend = "nccl" if device_kind == "cuda" else "gloo"
    device = torch.device("cuda", rank) if device_kind == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    ctl = dist.new_group(backend="gloo")
    mesh = make_mesh(data=cell.mesh["data"], shard=cell.mesh["shard"], device=device)
    s = run_rank(cell, seed, seconds, traced, device, t0, mesh=mesh, ctl=ctl, fault=fault)
    summary = rank_summary(cell, s, traced)
    gathered = [None] * world
    dist.all_gather_object(gathered, summary, group=ctl)
    return s, gathered


def _child(cell, seed, seconds, traced, rank, world, port, device_kind, fault=None):
    """A spawned rank other than 0: its summary goes to rank 0 by the
    job's gather; it exits 1 on any error."""
    import torch.distributed as dist

    set_precision()
    torch.set_num_threads(4)
    try:
        _join_ranks(cell, seed, seconds, traced, rank, world, port, device_kind, time.time(),
                    fault)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.exit(1)


def run_mesh(cell, seed, seconds, traced, t0, device_kind="cuda", fault=None, child_fault=None):
    """Rank 0 here, ranks 1.. spawned; returns (rank summaries, rank 0's run)."""
    import multiprocessing as mp

    import torch.distributed as dist

    world = cell.mesh["data"] * cell.mesh["shard"]
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(cell, seed, seconds, traced, r, world,
                                               port, device_kind, child_fault))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        s, gathered = _join_ranks(cell, seed, seconds, traced, 0, world, port, device_kind, t0,
                                  fault)
        dist.barrier()
        dist.destroy_process_group()
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"a rank ended with exit codes {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return gathered, s


# ------------------------------------------------------------------ main

def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool, t0: float, device=None,
            fault=None, child_fault=None) -> dict:
    """One run of `cell`: the result object (not printed)."""
    device = torch.device(device or "cuda")
    set_precision()
    if cell.mesh is None:
        s = run_rank(cell, seed, seconds, traced, device, t0, fault=fault)
        ranks = [rank_summary(cell, s, traced)]
    else:
        ranks, s = run_mesh(cell, seed, seconds, traced, t0, device.type, fault, child_fault)
        device = torch.device("cuda", 0) if device.type == "cuda" else device
    snap = s.pop("snap")
    s.clear()
    del s
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog_side = {k: snap[k] for k in ("losses", "grads", "params")}
    ref = reference(cell, seed, snap, device)
    numbers = check.gaps(prog_side, ref, snap["p0"], check.change_steps(cell.limits))
    return result(cell, traced, ranks, snap, device, numbers)


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no run")
        return 2
    torch.set_num_threads(4)
    from psgd_tf_tpu_torch.ops.hopper import _build

    _build.lib()
    res = measure(cell, args.seed, args.seconds, bool(args.trace), t0)
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules that must not be: {bad}; no result")
        return 3
    emit(res)
    return 0
