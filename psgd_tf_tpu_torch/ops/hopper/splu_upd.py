"""K16: the sparse-LU family's streaming update, and the chain K15 shares.

Replaces `psgd_tf_tpu/ops/pallas/splu_upd.py` `_update_impl` (:636),
reached through `fused_update_stream` (:861) and `fused_update` (:913),
with its routed `pallas_call`s at :686 (`_stage1_kernel`, the packed
Gram), :749 (`_stage2_kernel`, the tail images and exact maxima) and :787
(`_stage3_kernel`, the rewrite). The corner algebra between those stages
is `jnp` in JAX; here it runs in single-warp kernels on the device (one
block, its vectors strided over the threads, past rank 32: the
rank-generic chain of `csrc/splu.cu`, any rank), so the chain waits for
the host nowhere.

With `g`, `fused_update` is JAX's fused apply entry (`fused_update(...,
g=g)` :913): its `pallas_call`s at :814 (`_stage3_apply_kernel` :258,
stage 3 with the apply Gram of the new factors) and :843
(`_stage4_apply_kernel` :287, the tail of P' g) are the chain's stage 3
with g, its corner C and stage 4, counted as `splu_upd_apply`.
`fused_update_apply_mono` replaces JAX's one-launch schedule
(`fused_update_apply_mono` :533 → :582, `_mono_kernel` :301): the same
stage and corner bodies in one launch at any rank (`splu_upd_mono`,
`launch_mono`, which K15 shares with or without g), equal to the chain's
result bit for bit. Neither is routed: JAX's
`groups/splu.update_apply` runs the streaming update and then the apply
(`psgd_tf_tpu/groups/splu.py:384-409`), and so does the port's.

The state stays at its logical shapes, which the kernels read in place:
Lt (r, n) = [L1^T | L2^T], U12 (r, n) = [U1 | U2], l3 and u3 (n - r,);
the tail is lanes r.. of every row, and the ragged last tile is masked.
Up to rank 32 each streaming stage copies tiles of 256 lanes of every row
into shared memory in the widest pieces the row's own alignment allows,
all in flight at once, and writes the new tail back in 16-byte stores.
The chain (`csrc/splu.cu`, one C entry point, all on one stream):

  stage 1   Gram Y Y^T of Y = [L2^T; U2 w; dx2 w; l3 u3 dg2], w =
            1/(l3 u3), in 4 x 4 tiles of its upper triangle, as per-block
            partials summed in a fixed order; max l3, max u3. The
            algebra's U2 dg2 is read as (U2 w) . (l3 u3 dg2), equal to
            rounding (JAX's Z also holds the rows U2 and dg2)
  corner A  the four r x r triangular solves and the rank-space vectors
            (Ug1, Qg1, iUtx1, iQtx1, LtQg1, Pg1, iLiQtx1, iPx1), max|gl1|,
            max|gu1|, the balance rho from the signed maxima
  stage 2   the tail images and max|gl2|, max|gl3|, max|gu2|, max|gu3|
  corner B  the step scales sl, su (saturating, `linalg.step_scale`), the
            stage-3 coefficients, and the corner rewrite L1', U1'
  stage 3   L2^T', U2', l3', u3'; with g also the apply Gram of
            [L2^T'; U2'; l3' u3' g2; g2]
  corner C  with g: the apply's rank-space vectors and P' g on the corner
  stage 4   with g: the tail of P' g

Balancing (L / rho, U * rho) leaves Q = L U, every probe image and both
step scales unchanged, so it folds into the stage-3 outputs and the
corner rewrite (JAX :765-784): the result equals the direct form, which
balances up front, to rounding. K16 runs stages 1-3 (`groups/splu`
applies the updated state in torch after it, as JAX's `_apply_stream`
does); K15 (`splu_one`) runs the whole chain.

Each stage has a plain torch version below: the chain of them is what a
wrapper runs for CPU tensors and inside `hopper.disabled()`, so that the
algebra runs, and is held to the JAX package, without a card. The direct
form (`groups/splu.update_plain`) is the independent oracle.

The sharded K16 (`fused_update_sharded`, JAX `fused_update(mesh=...)`
:914) runs the same kernels on each rank's slice of the tail through four
C entry points, split where the chain reduces over the tail: stage 1 ->
sum the Gram, max the tail maxima over the shard ranks -> corner A and
stage 2 -> max the stage-2 maxima -> corner B and stage 3 (with g the
apply Gram) -> sum the apply Gram -> corner C and stage 4. The corners
replicate: every rank computes the same corner algebra from the same sums.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build

# the one launch's schedules (csrc/splu.cu, SpluSched): the host's pick by the
# work's size, or one forced (`launch_mono(..., schedule=...)`)
SCHEDULES = {"auto": -1, "grid": 0, "cluster": 1}
_scratch_floats: dict[tuple[int, int], int] = {}  # the chain's scratch per (n, r)


# ------------------------------------------------------------ the stages, plain

def _tail_images(L2t, U2, l3, u3, dx2, dg2, coef):
    """(qg2, iqtx2, pg2, ipx2) per lane from coef columns 0-3 (Ug1, iUtx1,
    LtQg1, iLiQtx1)."""
    lu = l3 * u3
    w = 1.0 / lu
    qg2 = coef[:, 0] @ L2t + lu * dg2
    iqtx2 = w * (dx2 - coef[:, 1] @ U2)
    pg2 = coef[:, 2] @ U2 + lu * qg2
    ipx2 = w * (iqtx2 - coef[:, 3] @ L2t)
    return qg2, iqtx2, pg2, ipx2


def _max0(x: torch.Tensor) -> torch.Tensor:
    return x.max() if x.numel() else x.new_full((), -torch.inf)


def stage1_plain(Lt, l3, U12, u3, v, h, nvalid=None):
    """(Y Y^T, [max l3, max u3]) with Y = [L2^T; U2 w; dx2 w; l3 u3 dg2];
    the maxima over the first `nvalid` tail lanes (all by default)."""
    r = U12.shape[0]
    lu = l3 * u3
    w = 1.0 / lu
    y = torch.cat([Lt[:, r:], U12[:, r:] * w, (v[r:] * w)[None], (lu * h[r:])[None]])
    return y @ y.T, torch.stack([_max0(l3[:nvalid]), _max0(u3[:nvalid])])


def corner_a_plain(Lt, U12, v, h, gram, maxs3):
    """The corner solves and rank-space vectors: (rs (r, 10) = [Ug1, iUtx1,
    LtQg1, iLiQtx1, Qg1, iQtx1, Pg1, dx1, iPx1, dg1], [rho, max|gl1|, max|gu1|])."""
    r = U12.shape[0]
    L1, U1 = Lt[:, :r].T, U12[:, :r]
    dx1, dg1 = v[:r], h[:r]
    iL, iW, iX, iG = slice(0, r), slice(r, 2 * r), 2 * r, 2 * r + 1
    G_LW, G_LL, G_WW = gram[iL, iW], gram[iL, iL], gram[iW, iW]

    Ug1 = U1 @ dg1 + gram[iW, iG]  # U2 dg2 as (U2 w) . (l3 u3 dg2)
    Qg1 = L1 @ Ug1
    iUtx1 = linalg.solve_ut_t(U1, dx1)
    iQtx1 = linalg.solve_lt_t(L1, iUtx1 - (gram[iL, iX] - G_LW @ iUtx1))
    LtQg1 = L1.T @ Qg1 + (G_LL @ Ug1 + gram[iL, iG])
    Pg1 = U1.T @ LtQg1
    iLiQtx1 = linalg.solve_lt(L1, iQtx1)
    iPx1 = linalg.solve_ut(U1, iLiQtx1 - ((gram[iW, iX] - G_WW @ iUtx1) - G_LW.T @ iLiQtx1))

    gl1 = torch.tril(torch.outer(Qg1, Qg1) - torch.outer(iQtx1, iQtx1))
    gu1 = torch.triu(torch.outer(Pg1, dg1) - torch.outer(dx1, iPx1))
    max_l = torch.maximum(torch.diagonal(L1).max(), maxs3[0])
    max_u = torch.maximum(torch.diagonal(U1).max(), maxs3[1])
    rs = torch.stack([Ug1, iUtx1, LtQg1, iLiQtx1, Qg1, iQtx1, Pg1, dx1, iPx1, dg1], 1)
    return rs, torch.stack([torch.sqrt(max_l / max_u), linalg.max_abs(gl1), linalg.max_abs(gu1)])


def stage2_plain(Lt, l3, U12, u3, v, h, coef):
    """[max(|gl2|, |gl3|), max(|gu2|, |gu3|)] over the tail; coef (r, 8) =
    [Ug1, iUtx1, LtQg1, iLiQtx1, Qg1, iQtx1, Pg1, dx1]."""
    r = U12.shape[0]
    dx2, dg2 = v[r:], h[r:]
    qg2, iqtx2, pg2, ipx2 = _tail_images(Lt[:, r:], U12[:, r:], l3, u3, dx2, dg2, coef)
    gl3 = qg2 * qg2 - iqtx2 * iqtx2
    gu3 = pg2 * dg2 - dx2 * ipx2
    gl2 = coef[:, 4, None] * qg2 - coef[:, 5, None] * iqtx2
    gu2 = coef[:, 6, None] * dg2 - coef[:, 7, None] * ipx2
    return torch.stack([torch.maximum(linalg.max_abs(gl2), linalg.max_abs(gl3)),
                        torch.maximum(linalg.max_abs(gu2), linalg.max_abs(gu3))])


def corner_b_plain(Lt, U12, rs, cs, maxs2, step):
    """(coef3 (r, 8), [sl, su, 1/rho, rho], L1', U1'): the step scales, the
    stage-3 coefficients and the balanced corner rewrite."""
    r = U12.shape[0]
    f32 = torch.float32
    L1, U1 = Lt[:, :r].T, U12[:, :r]
    Qg1, iQtx1, Pg1, dx1, iPx1, dg1 = rs[:, 4], rs[:, 5], rs[:, 6], rs[:, 7], rs[:, 8], rs[:, 9]
    rho = cs[0]
    inv_rho = 1.0 / rho
    sl = linalg.step_scale(step, torch.maximum(cs[1], maxs2[0]), f32)
    su = linalg.step_scale(step, torch.maximum(cs[2], maxs2[1]), f32)
    gl1 = torch.tril(torch.outer(Qg1, Qg1) - torch.outer(iQtx1, iQtx1))
    gu1 = torch.triu(torch.outer(Pg1, dg1) - torch.outer(dx1, iPx1))
    new_l1 = torch.tril(inv_rho * (L1 - sl * (gl1 @ L1)))
    new_u1 = torch.triu(rho * (U1 - su * (U1 @ gu1)))
    coef3 = torch.cat([rs[:, :4], torch.stack([sl * (L1.T @ Qg1), sl * (L1.T @ iQtx1),
                                               su * (U1 @ Pg1), su * (U1 @ dx1)], 1)], 1)
    return coef3, torch.stack([sl, su, inv_rho, rho]), new_l1, new_u1


def stage3_plain(Lt, l3, U12, u3, v, h, coef, scal, g=None):
    """(L2^T', U2', l3', u3', apply Gram or None): the tail rewrite; with g
    also the Gram of [L2^T'; U2'; l3' u3' g2; g2]."""
    r = U12.shape[0]
    L2t, U2 = Lt[:, r:], U12[:, r:]
    dx2, dg2 = v[r:], h[r:]
    sl, su, inv_rho, rho = scal
    qg2, iqtx2, pg2, ipx2 = _tail_images(L2t, U2, l3, u3, dx2, dg2, coef)
    gl3 = qg2 * qg2 - iqtx2 * iqtx2
    gu3 = pg2 * dg2 - dx2 * ipx2
    new_l2t = inv_rho * (L2t - (coef[:, 4, None] * qg2 - coef[:, 5, None] * iqtx2) - sl * gl3 * L2t)
    new_u2 = rho * (U2 - (coef[:, 6, None] * dg2 - coef[:, 7, None] * ipx2) - su * gu3 * U2)
    new_l3 = inv_rho * (l3 - sl * gl3 * l3)
    new_u3 = rho * (u3 - su * gu3 * u3)
    if g is None:
        return new_l2t, new_u2, new_l3, new_u3, None
    g2 = g[r:]
    z2 = torch.cat([new_l2t, new_u2, (new_l3 * new_u3 * g2)[None], g2[None]])
    return new_l2t, new_u2, new_l3, new_u3, z2 @ z2.T


def corner_c_plain(new_l1, new_u1, g1, gram2):
    """(P' g on the corner, coef4 (r, 2) = [Ug1', LtQg1'])."""
    r = new_l1.shape[0]
    iL = slice(0, r)
    ug1 = new_u1 @ g1 + gram2[r:2 * r, 2 * r + 1]
    qg1 = new_l1 @ ug1
    ltqg1 = new_l1.T @ qg1 + gram2[iL, iL] @ ug1 + gram2[iL, 2 * r]
    return new_u1.T @ ltqg1, torch.stack([ug1, ltqg1], 1)


def stage4_plain(new_l2t, new_u2, new_l3, new_u3, g2, coef4):
    """The tail of P' g: U2'^T LtQg1' + l3' u3' (L2' Ug1' + l3' u3' g2)."""
    lu = new_l3 * new_u3
    return coef4[:, 1] @ new_u2 + lu * (coef4[:, 0] @ new_l2t + lu * g2)


def _identity(x):
    return x


def chain_plain(Lt, l3, U12, u3, v, h, step, g=None, nvalid=None, psum=_identity,
                pmax=_identity):
    """The stages in torch: (Lt', l3', U12', u3', P' g or None). With
    `psum`/`pmax`, on this rank's slice of the tail (its first `nvalid`
    lanes real, the rest padding), the three reductions taken over the
    shard ranks."""
    r = U12.shape[0]
    gram, maxs3 = stage1_plain(Lt, l3, U12, u3, v, h, nvalid)
    gram, maxs3 = psum(gram), pmax(maxs3)
    rs, cs = corner_a_plain(Lt, U12, v, h, gram, maxs3)
    maxs2 = pmax(stage2_plain(Lt, l3, U12, u3, v, h, rs[:, :8]))
    coef3, scal, new_l1, new_u1 = corner_b_plain(Lt, U12, rs, cs, maxs2, step)
    new_l2t, new_u2, new_l3, new_u3, gram2 = stage3_plain(Lt, l3, U12, u3, v, h, coef3, scal, g)
    out = (torch.cat([new_l1.T, new_l2t], 1), new_l3, torch.cat([new_u1, new_u2], 1), new_u3)
    if g is None:
        return out + (None,)
    pre1, coef4 = corner_c_plain(new_l1, new_u1, g[:r], psum(gram2))
    return out + (torch.cat([pre1, stage4_plain(new_l2t, new_u2, new_l3, new_u3, g[r:], coef4)]),)


# ------------------------------------------------------------ the chain, kernels

def _check(name, Lt, l3, U12, u3, v, h, g):
    r, n = U12.shape
    if r < 1:
        raise ValueError(f"{name}: rank {r} must be at least 1")
    if n - r < 1:
        raise ValueError(f"{name}: needs n - r >= 1, got n = {n}, r = {r}")
    vecs = [v, h] + ([g] if g is not None else [])
    if (Lt.shape != (r, n) or l3.shape != (n - r,) or u3.shape != (n - r,)
            or any(x.shape != (n,) for x in vecs)):
        raise ValueError(f"{name}: operand shapes do not agree")
    hopper.check_operands(name, Lt, l3, U12, u3, *vecs)


def _scratch(lib, n: int, r: int, device) -> torch.Tensor:
    floats = _scratch_floats.get((n, r))
    if floats is None:
        floats = _scratch_floats[(n, r)] = lib.psgd_splu_scratch_floats(n, r)
    return torch.empty(floats, dtype=torch.float32, device=device)


def launch(name: str, Lt, l3, U12, u3, v, h, step, g=None):
    """The chain of `csrc/splu.cu` on CUDA tensors: (Lt', l3', U12', u3',
    P' g or None). Counts one launch of `name`; a launch the card refuses
    raises."""
    _check(name, Lt, l3, U12, u3, v, h, g)
    r, n = U12.shape
    lib = _build.lib()
    new_lt, new_l3, new_u12, new_u3 = (torch.empty_like(x) for x in (Lt, l3, U12, u3))
    pre = torch.empty_like(v) if g is not None else None
    scratch = _scratch(lib, n, r, Lt.device)
    rc = lib.psgd_splu_update(
        n, r, Lt.data_ptr(), l3.data_ptr(), U12.data_ptr(), u3.data_ptr(), v.data_ptr(),
        h.data_ptr(), g.data_ptr() if g is not None else None, float(step), new_lt.data_ptr(),
        new_l3.data_ptr(), new_u12.data_ptr(), new_u3.data_ptr(),
        pre.data_ptr() if pre is not None else None, scratch.data_ptr(),
        torch.cuda.current_stream(Lt.device).cuda_stream,
    )
    _build.check(rc, f"{name} kernel launch")
    hopper.counts[name] += 1
    return new_lt, new_l3, new_u12, new_u3, pre


def launch_mono(name: str, Lt, l3, U12, u3, v, h, step, g=None, *, schedule: str = "auto"):
    """The same update (and with g, P' g) in one launch of `csrc/splu.cu`'s
    one-launch kernels (`psgd_splu_mono`), at any rank, bit-equal to
    `launch`: (Lt', l3', U12', u3', P' g or None). The outputs are views of
    one allocation; the schedule is the library's pick ('auto') or the one
    named ('grid', 'cluster': the A/B of the schedules, and the card tests'
    check that both give the same bits). Counts one launch of `name`; a
    launch the card refuses raises."""
    _check(name, Lt, l3, U12, u3, v, h, g)
    sched = _schedule(schedule)
    r, n = U12.shape
    nt = n - r
    lib = _build.lib()
    out = torch.empty(2 * r * n + 2 * nt + (n if g is not None else 0), dtype=torch.float32,
                      device=Lt.device)
    new_lt, new_u12 = out[:2 * r * n].view(2, r, n).unbind()
    new_l3, new_u3 = out[2 * r * n:2 * r * n + 2 * nt].view(2, nt).unbind()
    pre = out[2 * r * n + 2 * nt:] if g is not None else None
    scratch = _scratch(lib, n, r, Lt.device)
    rc = lib.psgd_splu_mono(
        n, r, Lt.data_ptr(), l3.data_ptr(), U12.data_ptr(), u3.data_ptr(), v.data_ptr(),
        h.data_ptr(), g.data_ptr() if g is not None else None, float(step), new_lt.data_ptr(),
        new_l3.data_ptr(), new_u12.data_ptr(), new_u3.data_ptr(),
        pre.data_ptr() if pre is not None else None, scratch.data_ptr(), sched,
        torch.cuda.current_stream(Lt.device).cuda_stream,
    )
    _build.check(rc, f"{name} kernel launch")
    hopper.counts[name] += 1
    return new_lt, new_l3, new_u12, new_u3, pre


def _schedule(name: str) -> int:
    if name not in SCHEDULES:
        raise ValueError(f"splu one launch: schedule {name!r} not in {sorted(SCHEDULES)}")
    return SCHEDULES[name]


def run(name: str, Lt, l3, U12, u3, v, h, step, g=None):
    """(Lt', l3', U12', u3', P' g or None): the plain chain for CPU tensors
    and inside `hopper.disabled()`, the kernels, counted as `name`, for
    CUDA tensors."""
    if not hopper.use_kernel(Lt):
        return chain_plain(Lt, l3, U12, u3, v, h, step, g)
    return launch(name, Lt, l3, U12, u3, v, h, step, g)


def fused_update(Lt, l3, U12, u3, v, h, step, g=None):
    """One streaming update: (Lt', l3', U12', u3'), counted as `splu_upd`;
    with `g` also P' g of the updated state as a fifth output, counted as
    `splu_upd_apply` (JAX's keyword, `splu_upd.py:913`). No route takes
    the fused apply: `groups/splu.update_apply` runs this update without
    g and then `splu.apply`, as JAX's streaming `update_apply` does."""
    if g is None:
        return run("splu_upd", Lt, l3, U12, u3, v, h, step)[:4]
    return run("splu_upd_apply", Lt, l3, U12, u3, v, h, step, g)


# ------------------------------------------------------- the one-launch kernel

def fused_update_apply_mono_plain(Lt, l3, U12, u3, v, h, g, step):
    """The plain version of the one-launch kernel: the chain's plain stages
    with g, (Lt', l3', U12', u3', P' g)."""
    return chain_plain(Lt, l3, U12, u3, v, h, step, g)


def mono_grid(n: int, r: int, g: bool = True, *, schedule: str = "auto") -> dict:
    """The one launch `launch_mono` makes for a rank-r state over n
    parameters (with or without g, under `schedule`) on the current card:
    its schedule, its grid, the CTAs a SM holds at its shared memory (grid)
    or the largest cluster the card holds (cluster), the SMs and the
    registers a thread."""
    out = _build.int_array([0] * 5)
    _build.check(_build.lib().psgd_splu_mono_grid(n, r, int(g), _schedule(schedule), out),
                 "splu one launch grid")
    names = {v: k for k, v in SCHEDULES.items()}
    return dict(zip(("grid", "per_sm", "sms", "regs"), out[:4]), schedule=names[out[4]])


def fused_update_apply_mono(Lt, l3, U12, u3, v, h, g, step):
    """One update and P' g of the updated state in one launch: (Lt', l3',
    U12', u3', P' g), JAX's contract (`splu_upd.py:533-537`), at any rank.
    The plain version for CPU tensors and inside `hopper.disabled()`; for
    CUDA tensors one launch (`launch_mono`), counted as `splu_upd_mono`,
    which raises if the card refuses it. No path routes it, as in the JAX
    package."""
    if not hopper.use_kernel(Lt):
        return fused_update_apply_mono_plain(Lt, l3, U12, u3, v, h, g, step)
    return launch_mono("splu_upd_mono", Lt, l3, U12, u3, v, h, step, g)


# ------------------------------------------------------------ the sharded K16

def launch_sharded(Lt, l3, U12, u3, v, h, step, nvalid, mesh, g=None):
    """The sharded K16 on CUDA tensors: the chain's four C entry points
    (`csrc/splu.cu`, `psgd_splu_sharded_stage1..4`) with the Gram summed
    and the maxima maxed over the shard ranks between them, as JAX psums
    and pmaxes them (`splu_upd.py:694, 757, 830`). Counts one launch of
    `splu_upd_sharded`."""
    name = "splu_upd_sharded"
    _check(name, Lt, l3, U12, u3, v, h, g)
    r, n = U12.shape
    lib = _build.lib()
    f = dict(dtype=torch.float32, device=Lt.device)
    stream = torch.cuda.current_stream(Lt.device).cuda_stream
    scratch = _scratch(lib, n, r, Lt.device)
    z = 2 * r + 2
    gram1, max1, max2 = torch.empty(z, z, **f), torch.empty(2, **f), torch.empty(2, **f)
    p = lambda x: x.data_ptr() if x is not None else None
    state = [p(x) for x in (Lt, l3, U12, u3, v, h)]
    _build.check(lib.psgd_splu_sharded_stage1(n, r, nvalid, *state, p(gram1), p(max1), p(scratch),
                                              stream), f"{name} stage 1")
    gram1, max1 = mesh.psum(gram1), mesh.pmax(max1)
    _build.check(lib.psgd_splu_sharded_stage2(n, r, *state, p(gram1), p(max1), p(max2), p(scratch),
                                              stream), f"{name} stage 2")
    max2 = mesh.pmax(max2)
    new_lt, new_l3, new_u12, new_u3 = (torch.empty_like(x) for x in (Lt, l3, U12, u3))
    gram2 = torch.empty(z, z, **f) if g is not None else None
    _build.check(lib.psgd_splu_sharded_stage3(
        n, r, *state, p(g), float(step), p(max2), p(new_lt), p(new_l3), p(new_u12), p(new_u3),
        p(gram2), p(scratch), stream), f"{name} stage 3")
    pre = None
    if g is not None:
        gram2 = mesh.psum(gram2)
        pre = torch.empty_like(v)
        _build.check(lib.psgd_splu_sharded_stage4(
            n, r, p(new_lt), p(new_l3), p(new_u12), p(new_u3), p(g), p(gram2), p(pre), p(scratch),
            stream), f"{name} stage 4")
    hopper.counts[name] += 1
    return new_lt, new_l3, new_u12, new_u3, pre


def fused_update_sharded(Lt, l3, U12, u3, v, h, step, mesh, nvalid=None, g=None):
    """The sharded K16 (JAX `splu_upd.fused_update(mesh=...)` :914): one
    update on this rank's slice of the state, laid out as a state of
    r + (its tail lanes) parameters: the corner [:, :r] of Lt and U12
    replicated, then this rank's tail columns, padded with zero columns
    and l3 = u3 = 1 (`parallel/policies.shard_state`); v, h and g alike
    (`policies.slice_vec`). `nvalid` counts the tail lanes that are not
    padding (all by default): the balance's maxima leave the rest out.
    Returns (Lt', l3', U12', u3', this rank's P' g or None); the corner
    results are the same on every rank. The plain chain with the same
    reductions for CPU tensors and inside `hopper.disabled()`."""
    nvalid = l3.shape[0] if nvalid is None else nvalid
    if not hopper.use_kernel(Lt):
        return chain_plain(Lt, l3, U12, u3, v, h, step, g, nvalid, mesh.psum, mesh.pmax)
    return launch_sharded(Lt, l3, U12, u3, v, h, step, nvalid, mesh, g)
