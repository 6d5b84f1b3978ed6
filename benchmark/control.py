"""The readings a cell's limits are set from, taken on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program]
        [--variants tf32 half_batch reordered]

For each seed, the plain reference at the cell's own sizes is put in the
program's place and compared with itself, in each variant asked for:
computed with TF32 on (`tf32`, the control: the nearest precision below
the configuration's float32 with TF32 off); with half of every batch left
out, the mean taken over the rest (`half_batch`, a planted fault; also
what a data rank computes when the exchange between cards is left out);
with every batch's rows in another order (`reordered`, a sound run whose
fp32 round-off differs from the reference's, as a program that reorders
or fuses its reductions would). A state left unchanged reads 1 as
`change_gap` without a run. With `--program`, the program's own first
steps too, every seed in one process (on a mesh, one job of ranks), as a
run takes them: the sound readings. Each reading gives the three numbers
of `check.gaps` under the cell's `change_steps` and, for the look, the
worst leaf's change gap of each step. Prints one JSON line a seed and the
minima and maxima last. The benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


VARIANTS = {"tf32": {"tf32": True}, "half_batch": {"half_batch": True},
            "reordered": {"reorder": True}}


def _numbers(cell, side: dict, ref: dict, p0) -> dict:
    from benchmark import check

    out = check.gaps(side, ref, p0, check.change_steps(cell.limits))
    keep = check.kept_leaves(ref["grads"])
    out["change_by_step"] = [max(g) for g in check.change_gaps(side, ref, p0, keep)]
    return out


def readings(cell, seed: int, device, batch: int | None = None, program: dict | None = None,
             variants=tuple(VARIANTS)):
    """One seed's readings; `program` is its first steps (`harness.first_steps`)."""
    import torch

    from benchmark import harness
    from benchmark.traffic import OPTIMIZER_SEED, sub_seed

    if batch is not None:
        cell.traffic = dict(cell.traffic, batch=batch)
    if program is None:
        gen = torch.Generator(device).manual_seed(sub_seed(seed, 0))
        snap = {"p0": cell.model.weights(gen, cell.config), "opt_seed": OPTIMIZER_SEED}
    else:
        snap = program
    ref = harness.reference(cell, seed, snap, device)
    out = {"seed": seed}
    if program is not None:
        out["program"] = _numbers(cell, program, ref, snap["p0"])
    for name in variants:
        side = harness.reference(cell, seed, snap, device, **VARIANTS[name])
        out[name] = _numbers(cell, side, ref, snap["p0"])
    return out


def _program_steps(cell, seed, device, mesh=None) -> dict:
    from benchmark import harness
    from benchmark.traffic import Traffic

    prog = harness.Program(cell, seed, device, mesh)
    feed = Traffic(cell, seed, device)
    return harness.first_steps(prog, feed, mesh)


def _rank(cell, seeds, rank, world, port, device_kind="cuda", variants=tuple(VARIANTS)):
    """One rank of a mesh cell: every seed's first steps; rank 0 also reads."""
    import datetime

    import torch
    import torch.distributed as dist

    from benchmark import harness
    from psgd_tf_tpu_torch.parallel import make_mesh

    harness.set_precision()
    cuda = device_kind == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    ctl = dist.new_group(backend="gloo")
    mesh = make_mesh(data=cell.mesh["data"], shard=cell.mesh["shard"], device=device)
    rows = []
    for seed in seeds:
        t = time.time()
        steps = _program_steps(cell, seed, device, mesh)
        harness._sync(device)
        if rank == 0:
            rows.append(readings(cell, seed, device, program=steps, variants=variants))
            print(json.dumps(rows[-1]), f"# {time.time() - t:.1f} s", flush=True)
        del steps
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier(group=ctl)
    dist.destroy_process_group()
    return rows


def _spawn(cell, seeds, device_kind="cuda", variants=tuple(VARIANTS)):
    import multiprocessing as mp

    from benchmark import harness

    world = cell.mesh["data"] * cell.mesh["shard"]
    port = harness._free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(cell, seeds, r, world, port, device_kind, variants))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        rows = _rank(cell, seeds, 0, world, port, device_kind, variants)
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--variants", nargs="*", choices=tuple(VARIANTS), default=list(VARIANTS))
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness, spec

    cell = spec.load(args.workload)
    need = cell.chips if args.program else 1  # the reference alone runs on one card
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"control.py reads {need} CUDA card(s): not found", file=sys.stderr)
        return 2
    harness.set_precision()
    if args.program:
        from psgd_tf_tpu_torch.ops.hopper import _build

        _build.lib()
    if args.program and cell.mesh is not None:
        rows = _spawn(cell, args.seeds, variants=args.variants)
    else:
        rows, dev = [], torch.device("cuda")
        for seed in args.seeds:
            t = time.time()
            steps = _program_steps(cell, seed, dev) if args.program else None
            rows.append(readings(cell, seed, dev, program=steps, variants=args.variants))
            print(json.dumps(rows[-1]), f"# {time.time() - t:.1f} s", flush=True)
            del steps
    summary = {k: {n: [min(r[k][n] for r in rows), max(r[k][n] for r in rows)]
                   for n in ("loss_gap", "grad_gap", "change_gap")}
               for k in rows[0] if k != "seed"}
    for k in summary:
        summary[k]["change_by_step_max"] = [max(r[k]["change_by_step"][i] for r in rows)
                                            for i in range(len(rows[0][k]["change_by_step"]))]
    print(json.dumps({"workload": cell.name, "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
