"""Worker processes for the port's sharded-step tests (`test_torch_parallel*.py`).

`run` spawns one process per rank of a gloo job on the CPU, joined through
a `FileStore` under the test's own directory (no TCP port, so concurrent
test workers never collide), and runs a job function on every rank. Jobs
take and return numpy arrays and import nothing of JAX. A worker that dies,
raises or outlives the time limit fails the test, which never hangs.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback


def _entry(job, rank, world, store_path, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            results.put((rank, "ok", job(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, "error", traceback.format_exc()))


def run(job, world: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """[job(rank, world, *args) for each rank], from `world` spawned ranks."""
    return join(start(job, world, tmp_path, *args, timeout=timeout))


def start(job, world: int, tmp_path, *args, timeout: float = 120.0):
    """Spawns the ranks of one job and returns at once; `join` waits for
    them. Jobs started together run side by side, each with its own store."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{job.__name__}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_entry, args=(job, rank, world, store, args, results), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    return job, world, procs, results, time.monotonic() + timeout, timeout


def join(started) -> list:
    """[job(rank, world, *args) for each rank] of a job from `start`."""
    job, world, procs, results, deadline, timeout = started
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{job.__name__}: {world - len(out)} rank(s) did not finish "
                                   f"in {timeout} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(f"{job.__name__}: a rank died (exit codes {dead})")
                continue
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{job.__name__} failed:\n" + "\n".join(errors))
    finally:
        stop(started)
    return [out[r] for r in range(world)]


def stop(started) -> None:
    """Waits briefly for a job's ranks and kills those still running."""
    for p in started[2]:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()


# ------------------------------------------------------------------ jobs

def job_many(rank, world, jobs):
    """[job(rank, world, *args) for job, args in jobs], in one spawn: each
    spawn pays the ranks' start once."""
    return [job(rank, world, *args) for job, args in jobs]


def _t(x):
    import numpy as np
    import torch

    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.detach().cpu().numpy()


def job_kernels(rank, world, shards, lra_cases, pipe_case, splu_cases, states):
    """K14 (plain, pipelined), the sharded K16, the ring reductions, the
    state round trips and make_mesh's validation, on meshes (world / S, S)."""
    import torch

    from psgd_tf_tpu_torch import interop
    from psgd_tf_tpu_torch.groups import lra, splu
    from psgd_tf_tpu_torch.ops.hopper import lra_upd, splu_upd
    from psgd_tf_tpu_torch.parallel import make_mesh, overlap, policies

    out = {}
    try:
        make_mesh(data=world + 1, shard=3, device="cpu")
    except ValueError as e:
        out["mesh_error"] = str(e)
    for S in shards:
        mesh = make_mesh(data=world // S, shard=S, device="cpu")
        out[("layout", S)] = (mesh.data_rank, mesh.shard_rank, mesh.backend)
        for key, (UV, d, v, h, g, coins) in lra_cases.items():
            n = d.shape[0]
            loc = policies.shard_state(mesh, lra.LRAState(_t(UV), _t(d)))
            vl, hl, gl = (policies.slice_vec(mesh, loc, _t(x)) for x in (v, h, g))
            st = lra.LRAState(*lra_upd.fused_update_sharded(loc.UV, loc.d, vl, hl, 0.05, coins,
                                                            mesh))
            full = policies.gather_state(mesh, st, n)
            uv2, d2, pre = lra_upd.fused_update_apply_sharded(loc.UV, loc.d, vl, hl, gl, 0.05,
                                                              coins, mesh)
            full2 = policies.gather_state(mesh, lra.LRAState(uv2, d2), n)
            out[("lra", S, key)] = (_np(full.UV), _np(full.d), _np(full2.UV), _np(full2.d),
                                    _np(policies.gather_vec(mesh, loc, pre, n)))
            # the direct form on the slice (other dtypes under the context)
            st = lra.LRAState(*lra_upd.update_plain(loc.UV, loc.d, vl, hl, 0.05, coins,
                                                    psum=mesh.psum, pmax=mesh.pmax))
            full = policies.gather_state(mesh, st, n)
            pre = lra_upd.apply_plain(st.UV, st.d, gl, psum=mesh.psum)
            out[("direct", S, key)] = (_np(full.UV), _np(full.d),
                                       _np(policies.gather_vec(mesh, loc, pre, n)))
        UV, d, v, h, coins = pipe_case
        n = d.shape[0]
        loc = policies.shard_state(mesh, lra.LRAState(_t(UV), _t(d)))
        vl, hl = (policies.slice_vec(mesh, loc, _t(x)) for x in (v, h))
        # the pipelined mode over either transport (`lra_upd._ring` picks
        # the ring for CPU tensors, the async all-reduces for CUDA ones
        # under gloo)
        pick = lra_upd._ring
        try:
            for mode in ("plain", "async", "ring"):
                lra_upd._ring = lambda m, x, ring=(mode == "ring"): ring
                st = lra.LRAState(*lra_upd.fused_update_sharded(
                    loc.UV, loc.d, vl, hl, 0.05, coins, mesh, pipelined=mode != "plain"))
                full = policies.gather_state(mesh, st, n)
                out[("pipe", S, mode)] = (_np(full.UV), _np(full.d))
        finally:
            lra_upd._ring = pick
        out[("ring pick", S)] = pick(mesh, loc.UV)
        for key, (Lt, l3, U12, u3, v, h, g) in splu_cases.items():
            n = Lt.shape[1]
            loc = policies.shard_state(mesh, splu.SpLUState(*map(_t, (Lt, l3, U12, u3))))
            vl, hl, gl = (policies.slice_vec(mesh, loc, _t(x)) for x in (v, h, g))
            res = splu_upd.fused_update_sharded(loc.Lt, loc.l3, loc.U12, loc.u3, vl, hl, 0.05,
                                                mesh, loc.tail_valid, gl)
            full = policies.gather_state(mesh, splu.SpLUState(*res[:4]), n)
            res0 = splu_upd.fused_update_sharded(loc.Lt, loc.l3, loc.U12, loc.u3, vl, hl, 0.05,
                                                 mesh, loc.tail_valid)
            full0 = policies.gather_state(mesh, splu.SpLUState(*res0[:4]), n)
            out[("splu", S, key)] = ([_np(x) for x in (full.Lt, full.l3, full.U12, full.u3)],
                                     _np(policies.gather_vec(mesh, loc, res[4], n)),
                                     [_np(x) for x in (full0.Lt, full0.l3, full0.U12, full0.u3)])
        x = torch.arange(32, dtype=torch.float32).reshape(4, 8) + mesh.shard_rank
        x = x * (1.0 + 0.1 * mesh.shard_rank) - 3.0 * (mesh.shard_rank % 2)
        grp = mesh.shard_group
        out[("ring", S)] = (
            _np(overlap.ring_reduce(x, grp, S, mesh.shard_rank) - mesh.psum(x)),
            _np(overlap.ring_max(x, grp, S, mesh.shard_rank) - mesh.pmax(x)))
        for name, (st, n) in states.items():
            local = interop.local_state(mesh, _build_state(name, st))
            out[("roundtrip", S, name)] = (
                interop.global_arrays(mesh, local, n) if name != "kron"
                else [(_np(k.ql), _np(k.qr), k.fmt) for k in policies.gather_state(mesh, local, n)])
    return out


def _build_state(name, arrays):
    from psgd_tf_tpu_torch import interop

    build = {"dense": interop.dense_state, "diag": interop.diag_state, "lra": interop.lra_state,
             "splu": interop.splu_state, "xmat": interop.xmat_state,
             "xmat_odd": interop.xmat_state, "shift": interop.shift_state,
             "shift_odd": interop.shift_state}
    if name == "kron":
        return interop.kron_states(arrays, device="cpu")
    return build[name](*arrays, device="cpu")


def mlp_loss(ws, x):
    """The three-layer tanh MLP of `tests/test_parallel.py:105-141`."""
    import torch

    y = x
    for w in ws:
        y = torch.tanh(y @ w)
    return torch.mean(torch.sum(y * y, dim=-1))


def mean_sq_loss(ws, x):
    """The three-layer tanh MLP of `tests/test_parallel.py:304-354`."""
    import torch

    y = x
    for w in ws:
        y = torch.tanh(y @ w)
    return torch.mean(y ** 2)


def row_loss(ws, x):
    """One (out, in) layer read as rows, `tests/test_parallel.py:404-444`."""
    import torch

    y = torch.tanh(x @ ws[0].T)
    return torch.mean(torch.sum(y * y, dim=-1))


def linear_loss(p, x):
    import torch

    return torch.sum((x @ p[0]) ** 2)


def _loss(name):
    from psgd_tf_tpu_torch.models import nmt

    return {"nmt": nmt.loss, "mlp": mlp_loss, "mean_sq": mean_sq_loss, "row": row_loss,
            "linear": linear_loss}[name]


def job_train(rank, world, data, shard, runs):
    """Each run: a PSGD with `opt` kwargs on a model (`loss`: 'nmt', 'mlp',
    'mean_sq', 'row' or 'linear'), through `build_sharded_step` on mesh
    (data, shard) from the given params, batches and per-step probes and
    coins, with the run's tensor-parallel `specs` if it has them (the step
    then takes and returns this rank's slices). Returns per run the losses,
    the final params (gathered), the shapes of the params the step
    returned, the gathered flat family state and how often each sharded
    wrapper was called."""
    from psgd_tf_tpu_torch import PSGD, interop
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import lra_upd, splu_upd
    from psgd_tf_tpu_torch.optim.psgd import KronPrecond
    from psgd_tf_tpu_torch.parallel import build_sharded_step, make_mesh, policies

    mesh = make_mesh(data=data, shard=shard, device="cpu")
    calls = {"lra_sharded": 0, "splu_sharded": 0}
    orig = (lra_upd.fused_update_apply_sharded, splu_upd.fused_update_sharded)

    def spy_lra(*a, **k):
        calls["lra_sharded"] += 1
        return orig[0](*a, **k)

    def spy_splu(*a, **k):
        calls["splu_sharded"] += 1
        return orig[1](*a, **k)

    lra_upd.fused_update_apply_sharded, splu_upd.fused_update_sharded = spy_lra, spy_splu
    out = []
    try:
        for run in runs:
            calls.update(lra_sharded=0, splu_sharded=0)
            params = [_t(w) for w in run["params"]]
            opt = PSGD(**run["opt"])
            state = opt.init(params, seed=run.get("seed", 0))
            if "precond" in run:
                state = state.replace(precond=_build_state(*run["precond"]))
            specs = run.get("specs")
            step = build_sharded_step(opt, _loss(run["loss"]), mesh, state, params,
                                      param_specs=specs)
            state = policies.shard_state(mesh, state)
            if specs is not None:
                params = policies.shard_params(mesh, params, specs)
            losses = []
            for batch, probes, coins in zip(run["batches"], run["probes"], run["coins"]):
                batch = [_t(b).long() if b.dtype.kind == "i" else _t(b) for b in batch]
                probes = None if probes is None else [_t(p) for p in probes]
                params, state, aux = step(params, state, None, *batch, probes=probes,
                                          coins=coins)
                losses.append(aux["loss"].item())
            shapes = [tuple(p.shape) for p in params]
            if specs is not None:
                params = policies.gather_params(mesh, params, specs)
            n = sum(p.numel() for p in params)
            flat = not isinstance(state.precond, (list, KronPrecond))
            out.append(dict(losses=losses, params=[_np(p) for p in params], shapes=shapes,
                            precond=interop.global_arrays(mesh, state.precond, n) if flat
                            else None, calls=dict(calls), counts=dict(hopper.counts)))
    finally:
        lra_upd.fused_update_apply_sharded, splu_upd.fused_update_sharded = orig
    return out


def job_dense_over_cap(rank, world, Q, v, h, g):
    """dense.update_apply under the sharding context: Q replicates."""
    from psgd_tf_tpu_torch.groups import dense
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=1, shard=world, device="cpu")
    with hopper.sharding(mesh):
        st, pre = dense.update_apply(dense.DenseState(Q=_t(Q)), _t(v), _t(h), _t(g), step=0.05)
    return _np(st.Q), _np(pre)


def job_nmt_run(rank, world, data, shard, steps):
    """nmt_attention.run on mesh (data, shard); rank 0 also runs run()
    without a mesh (None on the other ranks)."""
    from psgd_tf_tpu_torch.parallel import make_mesh
    from psgd_tf_tpu_torch.workloads import nmt_attention

    mesh = make_mesh(data=data, shard=shard, device="cpu")
    sharded = nmt_attention.run(steps=steps, mesh=mesh)
    return sharded, nmt_attention.run(steps=steps, device="cpu") if rank == 0 else None


def job_errors(rank, world):
    """build_sharded_step's refusals: tensor-parallel specs that split a
    dimension the degree of its entry does not divide (one axis, or a tuple
    of both), that do not align with the params, that name an axis twice or
    an axis the mesh lacks; a ragged batch. And one step of a spec over
    `data` on (world, 1): this rank's returned block and the same step in
    one process on the full batch's first row (every row is the same)."""
    import torch

    from psgd_tf_tpu_torch import PSGD
    from psgd_tf_tpu_torch.parallel import build_sharded_step, make_mesh, policies

    mesh = make_mesh(data=world, shard=1, device="cpu")
    tp = make_mesh(data=1, shard=world, device="cpu")
    params = [torch.zeros(4)]
    opt = PSGD(preconditioner="diag")
    state = opt.init(params)
    out = {}
    odd = [torch.zeros(3, 5)]
    for key, m, ps, specs in [("indivisible", tp, odd, [(None, "shard")]),
                              ("tuple_indivisible", mesh, odd, [(("data", "shard"), None)]),
                              ("misaligned", tp, params, [None, ("shard",)]),
                              ("twice", tp, odd, [("shard", "shard")]),
                              ("twice_in_tuple", mesh, odd, [(("data", "data"),)]),
                              ("unknown", tp, params, [("model",)])]:
        try:
            build_sharded_step(opt, linear_loss, m, opt.init(ps), ps, param_specs=specs)
        except ValueError as e:
            out[key] = str(e)
    p = [torch.linspace(-1.0, 1.0, 4)]
    x = torch.ones(world, 4)
    probes = [torch.linspace(0.5, -0.5, 4)]
    step = build_sharded_step(opt, linear_loss, mesh, state, p, param_specs=[("data",)])
    block, _, aux = step(policies.shard_params(mesh, p, [("data",)]),
                         policies.shard_state(mesh, state), None, x, probes=probes)
    ref, _, ref_aux = opt.step(linear_loss, p, state, None, x[:1], probes=probes)
    out["data"] = dict(data_rank=mesh.data_rank, block=_np(block[0]), full=_np(ref[0]),
                       loss=aux["loss"].item(), ref_loss=ref_aux["loss"].item())
    step = build_sharded_step(opt, linear_loss, mesh, state, params)
    try:
        step(params, policies.shard_state(mesh, state), torch.Generator(), torch.ones(3, 4))
    except ValueError as e:
        out["batch"] = str(e)
    return out


def job_tp_roundtrip(rank, world, meshes, leaves):
    """`policies.shard_params` then `gather_params` on each mesh (data,
    shard) over all the leaves at once. Returns per mesh this rank's data
    and shard coordinates, each local block, each gathered leaf and whether
    each replicated leaf came back as the same tensor."""
    from psgd_tf_tpu_torch.parallel import make_mesh, policies

    out = {}
    for data, shard in meshes:
        mesh = make_mesh(data=data, shard=shard, device="cpu")
        full = [_t(x) for x, _ in leaves]
        specs = [spec for _, spec in leaves]
        local = policies.shard_params(mesh, full, specs)
        back = policies.gather_params(mesh, local, specs)
        out[(data, shard)] = dict(
            data_rank=mesh.data_rank, shard_rank=mesh.shard_rank, local=[_np(x) for x in local],
            full=[_np(x) for x in back],
            same=[spec is not None or (a is b is c) for a, b, c, spec in
                  zip(full, local, back, specs)])
    return out


def job_tp_payload(rank, world, data, shard, runs):
    """One TP step of each run (as `job_train` takes them) on mesh (data,
    shard), with `_collectives` wrapped to count the elements this rank
    receives in the gathers (`all_gather_dims`) over `shard` and over
    `data`, and the elements it all-reduces over `data` (`data_mean`, the
    loss aside)."""
    from psgd_tf_tpu_torch import PSGD
    from psgd_tf_tpu_torch.parallel import _collectives, build_sharded_step, make_mesh, policies

    mesh = make_mesh(data=data, shard=shard, device="cpu")
    moved = {"shard": 0, "data": 0, "data gather": 0}
    orig = (_collectives.all_gather_dims, _collectives.data_mean)

    def gather(xs, dims, group, size, rank_):
        key = "shard" if group is mesh.shard_group else "data gather"
        moved[key] += (size - 1) * sum(x.numel() for x in xs)
        return orig[0](xs, dims, group, size, rank_)

    def mean(mesh, tensors):
        if mesh is not None and mesh.data > 1:
            assert tensors[0].numel() == 1  # the loss
            moved["data"] += sum(t.numel() for t in tensors[1:])
        return orig[1](mesh, tensors)

    out = []
    for run in runs:
        params = [_t(w) for w in run["params"]]
        opt = PSGD(**run["opt"])
        state = opt.init(params)
        if "precond" in run:
            state = state.replace(precond=_build_state(*run["precond"]))
        step = build_sharded_step(opt, _loss(run["loss"]), mesh, state, params,
                                  param_specs=run["specs"])
        state = policies.shard_state(mesh, state)
        params = policies.shard_params(mesh, params, run["specs"])
        moved.update({"shard": 0, "data": 0, "data gather": 0})
        _collectives.all_gather_dims, _collectives.data_mean = gather, mean
        try:
            step(params, state, None, *[_t(b) for b in run["batches"][0]],
                 probes=[_t(p) for p in run["probes"][0]], coins=run["coins"][0])
        finally:
            _collectives.all_gather_dims, _collectives.data_mean = orig
        out.append(dict(moved))
    return out
