"""K13: the low-rank (UVd) family's update and fused apply (`csrc/lra.cu`).

Replaces `psgd_tf_tpu/ops/pallas/lra_upd.py` `fused_update` (:458) and
`fused_update_apply` (:543) → `_update_impl` (:217) → its `pallas_call`s at
:281 (stage 1), :389 (stage 3), :416 (stage 3 with the apply Gram) and
:443 (stage 4), with the rank-space algebra between them (:307-385,
:430-440). The factors stay packed: UV (2r, n) = [U; V], d (n,).

  stage 1   one Gram Z Z^T of Z = [U; V; d h; v / d], with max|U|, max|V|
  corner A  the rebalance (cu, cv), the two r x r Woodbury solves, the norm
            of the branch `update_u` names and its step scale: the stage-3
            coefficients coef (r, 10) and scal = (cu, cv)
  stage 3   U', V' and nablaD per lane; with g also the Gram of
            [U'; V'; d g; d g nablaD]
  corner B  mu_d from max|nablaD|; with g the apply's (t1, t2) = coef4
  stage 4   d' = d - mu_d d nablaD; with g P' g = d' (d' g + t1 U' + t2 V')

On a CUDA tensor the whole chain is one C call (`psgd_lra_update`): the
stages streaming staged tiles over a grid sized by the card, the corners
as single-block kernels, a reduce launch after each streaming Gram where
more than one block took the lanes (five launches at the RNN's n, seven
at 2^20), nothing between them on the host; past rank 32 the corners run
block-wide and past 128 the Grams go through the grouped GEMM
(`csrc/rank_space.cuh`), so any rank takes a kernel, as in the JAX
package. The JAX function draws the rebalance and U-vs-V coins from a key;
here they arrive as host booleans `coins = (balance, update_u)` and go to
the corner as ints; the U-vs-V choice reaches stage 3 as zeroed
coefficients, as in JAX. One difference from the Pallas kernels: the step
scales saturate at the fp32 max (`linalg.step_scale`), as the XLA path does.
A NaN or inf in the state or a probe propagates as in the plain chain (a
NaN maximum or norm gives a NaN step scale), and faults no kernel.

Each stage and corner has a plain torch version here (`_Plain`), and the
kernels' entries are on `_Kernels`. On CPU tensors (and inside
`hopper.disabled()`) `fused_update(_apply)` runs the plain chain, so the
chain's algebra is held to the JAX package's interpret mode without a card;
on the card the plain chain is the kernels' oracle. `update_plain` is the
direct form (the JAX XLA path): what `groups/lra` runs for dtypes other
than fp32, and the independent oracle the chain is held to.

K14 (`fused_update_sharded`, `fused_update_apply_sharded`; JAX :487, :554,
:467) runs the same kernels one entry at a time on each rank's slice of
the lanes: the stage-1 Gram and maxima, max|nablaD| (folded by the stage-3
entry: one float) and the apply Gram are all-reduced over the mesh's shard
ranks between them, where JAX psums and pmaxes them, and the corners run
alike on every rank. Its pipelined mode runs stage 1 on lane chunks (the
kernels take a row stride and rows at any 4-byte offset) and reduces each
chunk as soon as it is launched. The scratch is made once per shape.
"""
from __future__ import annotations

import functools

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build

CHUNKS = 4  # lane chunks of K14's pipelined stage 1


# ------------------------------------------------------------ the stages, plain

def stage1_plain(UV, d, h, v, lo=0, hi=None):
    """(Z Z^T, [max|U|, max|V|]) with Z = [U; V; d h; v / d] over lanes [lo, hi)."""
    r = UV.shape[0] // 2
    UV, d, h, v = UV[:, lo:hi], d[lo:hi], h[lo:hi], v[lo:hi]
    z = torch.cat([UV, (d * h)[None], (v / d)[None]])
    return z @ z.T, torch.stack([UV[:r].abs().amax(), UV[r:].abs().amax()])


def _probe_images(UV, d, h, v, coef):
    """(qh, b, nablaD, av, bv) per lane from the coefficients (r, 10)."""
    r = UV.shape[0] // 2
    U, V = UV[:r], UV[r:]
    qh = d * h + coef[:, 0] @ U
    b = v / d - coef[:, 1] @ V
    ph = d * (qh + coef[:, 2] @ V)
    ipv = (b - coef[:, 3] @ U) / d
    nd = ph * h - v * ipv
    return qh, b, nd, qh + coef[:, 8] @ V, b + coef[:, 9] @ V


def stage3_plain(UV, d, h, v, coef, scal, g=None):
    """(UV', nablaD, Gram of [U'; V'; d g; d g nablaD] or None)."""
    r = UV.shape[0] // 2
    qh, b, nd, av, bv = _probe_images(UV, d, h, v, coef)
    new_u = scal[0] * UV[:r] - (coef[:, 4, None] * qh - coef[:, 5, None] * b)
    new_v = scal[1] * UV[r:] - (coef[:, 6, None] * av - coef[:, 7, None] * bv)
    new_uv = torch.cat([new_u, new_v])
    if g is None:
        return new_uv, nd, None
    y0 = d * g
    z2 = torch.cat([new_uv, y0[None], (y0 * nd)[None]])
    return new_uv, nd, z2 @ z2.T


def stage4_plain(UV, d, nd, mu_d, g=None, coef4=None):
    """(d', P' g or None): d' = d - mu_d d nablaD, P' g = d' (d' g + t1 U +
    t2 V) with (t1, t2) the columns of coef4 (r, 2)."""
    r = UV.shape[0] // 2
    new_d = d - mu_d * d * nd
    if g is None:
        return new_d, None
    return new_d, new_d * (new_d * g + coef4[:, 0] @ UV[:r] + coef4[:, 1] @ UV[r:])


# ------------------------------------------------------------ the corners, plain

def corner_a_plain(gram, maxs, step, coins):
    """(coef (r, 10), scal = [cu, cv]) from the stage-1 Gram of
    Z = [U; V; x; w] and maxs = [max|U|, max|V|]: the rebalance, the
    Woodbury algebra on the r x r system and the step scale of the branch
    `coins[1]` (update_u) names."""
    balance, update_u = coins
    r = (gram.shape[0] - 2) // 2
    f32, dev = torch.float32, gram.device
    max_u, max_v = maxs[0], maxs[1]

    # unpack Z Z^T, Z = [U; V; x; w]
    iu, iv, ix, iw = slice(0, r), slice(r, 2 * r), 2 * r, 2 * r + 1
    Gu, Gv, G = gram[iu, iu], gram[iv, iv], gram[iv, iu]  # G = V U^T
    s0, p0, t0, q0 = gram[iu, ix], gram[iu, iw], gram[iv, ix], gram[iv, iw]
    xx, ww, xw = gram[ix, ix], gram[iw, iw], gram[ix, iw]

    # the rebalance (cu * cv = 1 leaves G unchanged)
    if balance:
        rho = torch.sqrt(max_u / max_v)
        cu, cv = 1.0 / rho, rho
        t, s, p, q = cv * t0, cu * s0, cu * p0, cv * q0
        Gup, Gvp = cu * cu * Gu, cv * cv * Gv
        scal = torch.stack([cu, cv])
    else:
        cu = cv = 1.0
        t, s, p, q, Gup, Gvp = t0, s0, p0, q0, Gu, Gv
        scal = torch.ones(2, dtype=f32, device=dev)

    # the Woodbury algebra on the r x r system
    IpVtU = torch.eye(r, dtype=f32, device=dev) + G
    a1 = linalg.solve_small(IpVtU.T, p)
    a2 = linalg.solve_small(IpVtU, q - Gvp @ a1)
    atU = s + Gup @ t  # U' a, a = Qh
    aa = xx + 2.0 * (s @ t) + t @ (Gup @ t)
    bb = ww - 2.0 * (a1 @ q) + a1 @ (Gvp @ a1)
    ab = xw - a1 @ t + t @ p - t @ (G.T @ a1)
    btU = p - G.T @ a1
    zero = torch.zeros(r, dtype=f32, device=dev)
    if update_u:
        atV = t + G @ t
        btV = q - Gvp @ a1
        norm = torch.sqrt(torch.abs(aa * (atV @ (Gvp @ atV)) + bb * (btV @ (Gvp @ btV))
                                    - 2.0 * ab * (atV @ (Gvp @ btV))))
        mu = linalg.step_scale(step, norm, f32)
        e1, e2, f1, f2 = mu * (IpVtU.T @ atV), mu * (IpVtU.T @ btV), zero, zero
    else:
        norm = torch.sqrt(torch.abs((atU @ (Gup @ atU)) * aa + (btU @ (Gup @ btU)) * bb
                                    - 2.0 * (atU @ (Gup @ btU)) * ab))
        mu = linalg.step_scale(step, norm, f32)
        e1, e2, f1, f2 = zero, zero, mu * atU, mu * btU
    coef = torch.stack([t0, cv * a1, cv * atU, cu * a2, e1, e2, f1, f2, cv * atU, cv * btU], 1)
    return coef.contiguous(), scal


def corner_b_plain(ndmax, step, gram2=None):
    """(mu_d, coef4 (r, 2) or None): mu_d = step / (max|nablaD| + tiny),
    saturated; with the apply Gram of [U'; V'; y0; y1] the apply's
    t1 = V' y and t2 = U'(y + U'^T t1), y = d' g = y0 - mu_d y1."""
    mu_d = linalg.step_scale(step, ndmax, torch.float32)
    if gram2 is None:
        return mu_d, None
    r = (gram2.shape[0] - 2) // 2
    iu, iv, iy0, iy1 = slice(0, r), slice(r, 2 * r), 2 * r, 2 * r + 1
    t1 = gram2[iv, iy0] - mu_d * gram2[iv, iy1]                    # V' y
    t2 = gram2[iu, iy0] - mu_d * gram2[iu, iy1] + gram2[iu, iu] @ t1  # U'(y + U'^T t1)
    return mu_d, torch.stack([t1, t2], 1).contiguous()


# ------------------------------------------------------------ the stages, kernels

@functools.lru_cache(maxsize=4)
def _scratch(n, r, device):
    """The C chain's scratch for (2r, n) on `device`, made once per shape:
    its size follows the card's SMs (the streaming grids), and a scratch
    for n lanes serves any stage over at most n (K14's pipelined chunks)."""
    return torch.empty(_build.lib().psgd_lra_scratch_floats(n, r), dtype=torch.float32,
                       device=device)


class _Kernels:
    """The C entry points of `csrc/lra.cu` on one (2r, n) problem: the
    whole chain in one call (`update`), or one stage or corner a call (K14,
    with the host all-reducing between them)."""

    def __init__(self, UV, d, v, h, g):
        r2, n = UV.shape
        if r2 % 2 or r2 < 2:
            raise ValueError(f"lra_upd: UV must be (2r, n) with r >= 1, got {tuple(UV.shape)}")
        vecs = [d, v, h] + ([g] if g is not None else [])
        if any(x.shape != (n,) for x in vecs):
            raise ValueError("lra_upd: operand shapes do not agree")
        hopper.check_operands("lra_upd", UV, *vecs)
        self.lib = _build.lib()
        self.n, self.r = n, r2 // 2
        self.f = dict(dtype=torch.float32, device=UV.device)
        self.scratch = _scratch(n, self.r, UV.device)
        self.stream = torch.cuda.current_stream(UV.device).cuda_stream

    def update(self, UV, d, v, h, step, coins, g=None):
        """(UV', d', P' g or None): stage 1, corner A, stage 3, corner B and
        stage 4 in one call, nothing between the launches."""
        new_uv, new_d = torch.empty_like(UV), torch.empty_like(d)
        pre = torch.empty_like(d) if g is not None else None
        rc = self.lib.psgd_lra_update(
            self.n, self.r, UV.data_ptr(), d.data_ptr(), v.data_ptr(), h.data_ptr(),
            g.data_ptr() if g is not None else None, float(step), int(coins[0]), int(coins[1]),
            new_uv.data_ptr(), new_d.data_ptr(), pre.data_ptr() if g is not None else None,
            self.scratch.data_ptr(), self.stream)
        _build.check(rc, "lra_upd")
        return new_uv, new_d, pre

    def stage1(self, UV, d, h, v, lo=0, hi=None):
        """Over lanes [lo, hi) (rows at any 4-byte offset); the entry sums
        its block partials into `gram` before it returns, so chunks share
        the scratch."""
        hi = self.n if hi is None else hi
        zdim = 2 * self.r + 2
        gram, maxs = torch.empty(zdim, zdim, **self.f), torch.empty(2, **self.f)
        at = lambda x: x.data_ptr() + 4 * lo
        rc = self.lib.psgd_lra_stage1(hi - lo, self.n, self.r, at(UV), at(d), at(h), at(v),
                                      gram.data_ptr(), maxs.data_ptr(), self.scratch.data_ptr(),
                                      self.stream)
        _build.check(rc, "lra_upd stage 1")
        return gram, maxs

    def corner_a(self, gram, maxs, step, coins):
        coef, scal = torch.empty(self.r, 10, **self.f), torch.empty(2, **self.f)
        rc = self.lib.psgd_lra_corner_a(self.r, gram.contiguous().data_ptr(),
                                        maxs.contiguous().data_ptr(), float(step),
                                        int(coins[0]), int(coins[1]), coef.data_ptr(),
                                        scal.data_ptr(), self.scratch.data_ptr(), self.stream)
        _build.check(rc, "lra_upd corner A")
        return coef, scal

    def stage3(self, UV, d, h, v, coef, scal, g=None):
        """(UV', nablaD, the apply Gram or None, max|nablaD|): the kernel
        folds its blocks' maxima, so the host reduces one float."""
        zdim = 2 * self.r + 2
        new_uv, nd, ndmax = torch.empty_like(UV), torch.empty_like(d), torch.empty((), **self.f)
        gram2 = torch.empty(zdim, zdim, **self.f) if g is not None else None
        rc = self.lib.psgd_lra_stage3(
            self.n, self.n, self.r, UV.data_ptr(), d.data_ptr(), h.data_ptr(), v.data_ptr(),
            g.data_ptr() if g is not None else None, coef.data_ptr(), scal.data_ptr(),
            new_uv.data_ptr(), nd.data_ptr(), gram2.data_ptr() if g is not None else None,
            ndmax.data_ptr(), self.scratch.data_ptr(), self.stream)
        _build.check(rc, "lra_upd stage 3")
        return new_uv, nd, gram2, ndmax

    def corner_b(self, ndmax, step, gram2=None):
        mu_d = torch.empty((), **self.f)
        coef4 = torch.empty(self.r, 2, **self.f) if gram2 is not None else None
        rc = self.lib.psgd_lra_corner_b(
            self.r, ndmax.contiguous().data_ptr(),
            gram2.contiguous().data_ptr() if gram2 is not None else None, float(step),
            mu_d.data_ptr(), coef4.data_ptr() if gram2 is not None else None,
            self.scratch.data_ptr(), self.stream)
        _build.check(rc, "lra_upd corner B")
        return mu_d, coef4

    def stage4(self, UV, d, nd, mu_d, g=None, coef4=None):
        new_d = torch.empty_like(d)
        pre = torch.empty_like(d) if g is not None else None
        rc = self.lib.psgd_lra_stage4(
            self.n, self.n, self.r, UV.data_ptr(), d.data_ptr(), nd.data_ptr(),
            g.data_ptr() if g is not None else None, mu_d.data_ptr(),
            coef4.data_ptr() if g is not None else None, new_d.data_ptr(),
            pre.data_ptr() if g is not None else None, self.stream)
        _build.check(rc, "lra_upd stage 4")
        return new_d, pre


def _stage3_plain_max(UV, d, h, v, coef, scal, g=None):
    """stage3_plain with max|nablaD|, as the kernel's entry returns it."""
    new_uv, nd, gram2 = stage3_plain(UV, d, h, v, coef, scal, g)
    return new_uv, nd, gram2, linalg.max_abs(nd)


class _Plain:
    stage1 = staticmethod(stage1_plain)
    corner_a = staticmethod(corner_a_plain)
    stage3 = staticmethod(_stage3_plain_max)
    corner_b = staticmethod(corner_b_plain)
    stage4 = staticmethod(stage4_plain)


# ------------------------------------------------------------ the chain

def _identity(x):
    return x


def _ring(mesh, x) -> bool:
    """The pipelined reduction's transport: the ring of `parallel/overlap`,
    as JAX's `_ring_combine`, where its hops need no host memory; async
    all-reduces where they would (gloo with CUDA tensors: every hop would
    cross the host twice, while gloo all-reduces CUDA tensors directly)."""
    from psgd_tf_tpu_torch.parallel import _collectives

    return not _collectives.stages_on_host(mesh.shard_group, x)


def _stage1_chunked(st, UV, d, h, v, mesh):
    """Stage 1 in CHUNKS lane chunks, each chunk's Gram and maxima
    reduced over the shard ranks as soon as it is launched (`_ring`
    picks how), before the next chunk's launch; the reduced partials
    summed in chunk order."""
    from psgd_tf_tpu_torch.parallel import _collectives, overlap

    n = UV.shape[1]
    grp, size, rank = mesh.shard_group, mesh.shard, mesh.shard_rank
    ring = _ring(mesh, UV)
    bounds = [n * k // CHUNKS for k in range(CHUNKS + 1)]
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        gram, maxs = st.stage1(UV, d, h, v, lo, hi)
        if ring:
            parts.append((overlap.ring_reduce(gram, grp, size, rank), None,
                          overlap.ring_max(maxs, grp, size, rank), None))
        else:
            parts.append(_collectives.psum_async(gram, grp, size)
                         + _collectives.psum_async(maxs, grp, size, op=_collectives.MAX))
    for _, w1, _, w2 in parts:
        for w in (w1, w2):
            if w is not None:
                w.wait()
    gram, maxs = parts[0][0], parts[0][2]
    for g_k, _, m_k, _ in parts[1:]:
        gram, maxs = gram + g_k, torch.maximum(maxs, m_k)
    return gram, maxs


def _update(UV, d, v, h, step, coins, g=None, mesh=None, pipelined=False):
    """The chain; with `mesh`, on this rank's lanes with the rank-space
    reductions taken over its shard ranks (K14)."""
    kernel = hopper.use_kernel(UV)
    if kernel and mesh is None:
        out = _Kernels(UV, d, v, h, g).update(UV, d, v, h, step, coins, g)
        hopper.counts["lra_upd"] += 1
        return out
    st = _Kernels(UV, d, v, h, g) if kernel else _Plain
    psum, pmax = (mesh.psum, mesh.pmax) if mesh is not None else (_identity, _identity)
    if mesh is not None and pipelined and UV.shape[1] >= CHUNKS:
        gram, maxs = _stage1_chunked(st, UV, d, h, v, mesh)
    else:
        gram, maxs = st.stage1(UV, d, h, v)
        gram, maxs = psum(gram), pmax(maxs)
    coef, scal = st.corner_a(gram, maxs, step, coins)
    new_uv, nd, gram2, ndmax = st.stage3(UV, d, h, v, coef, scal, g)
    # max|nablaD| over every lane before the d' AXPY
    mu_d, coef4 = st.corner_b(pmax(ndmax), step, psum(gram2) if g is not None else None)
    new_d, pre = st.stage4(new_uv, d, nd, mu_d, g, coef4)
    if kernel:
        hopper.counts["lra_upd_sharded"] += 1
    return new_uv, new_d, pre


def fused_update(UV, d, v, h, step, coins):
    """One lra update; returns (UV', d'). `coins = (balance, update_u)`."""
    new_uv, new_d, _ = _update(UV, d, v, h, step, coins)
    return new_uv, new_d


def fused_update_apply(UV, d, v, h, g, step, coins):
    """One lra update and P' g of the UPDATED state; returns (UV', d', P' g)."""
    return _update(UV, d, v, h, step, coins, g=g)


# ------------------------------------------------------------ K14: sharded

def fused_update_sharded(UV, d, v, h, step, coins, mesh, pipelined=False):
    """K14: one lra update on this rank's lanes, (UV', d') of them.

    UV (2r, c), d, v, h (c,) are this rank's slice of the lanes over
    `mesh`'s shard ranks, padded as `parallel/policies` pads them (d = 1,
    zeros elsewhere: the pad lanes stay inert). The stage-1 Gram and
    maxima, max|nablaD| and the apply Gram are all-reduced over the shard
    ranks where JAX psums/pmaxes them (`lra_upd.py:293-305, 407, 430`); the
    rank-space algebra then runs the same on every rank, whose coins agree.
    `pipelined` runs stage 1 in CHUNKS lane chunks and reduces each chunk
    as soon as it is launched: over the ring of `parallel/overlap` (JAX
    `_ring_combine`), or by async all-reduces where the ring's hops would
    go through host memory (`_ring`)."""
    new_uv, new_d, _ = _update(UV, d, v, h, step, coins, mesh=mesh, pipelined=pipelined)
    return new_uv, new_d


def fused_update_apply_sharded(UV, d, v, h, g, step, coins, mesh, pipelined=False):
    """K14 with the fused apply: (UV', d', this rank's lanes of P' g)."""
    return _update(UV, d, v, h, step, coins, g=g, mesh=mesh, pipelined=pipelined)


# ------------------------------------------------------------ the direct form

def update_plain(UV, d, v, h, step, coins, psum=_identity, pmax=_identity):
    """The direct form of the update (the JAX package's XLA path,
    `groups/lra.py:114-198`), with the coins given: (UV', d'). With
    `psum`/`pmax`, on this rank's lanes, every reduction over the lanes
    taken over the shard ranks."""
    balance, update_u = coins
    r = UV.shape[0] // 2
    dtype = d.dtype
    if balance:
        rho = torch.sqrt(pmax(linalg.max_abs(UV[:r])) / pmax(linalg.max_abs(UV[r:])))
        UV = torch.cat([UV[:r] / rho, UV[r:] * rho])
    U, V = UV[:r], UV[r:]
    mv = lambda m, x: psum(m @ x)  # a rank vector: (r, lanes) @ (lanes,)

    Qh = d * h + mv(V, d * h) @ U
    Ph = d * (Qh + mv(U, Qh) @ V)
    IpVtU = torch.eye(r, dtype=dtype, device=d.device) + psum(V @ U.T)
    invQtv = v / d
    invQtv = invQtv - linalg.solve_small(IpVtU.T, mv(U, invQtv)) @ V
    invPv = (invQtv - linalg.solve_small(IpVtU, mv(V, invQtv)) @ U) / d
    nablaD = Ph * h - v * invPv
    new_d = d - linalg.step_scale(step, pmax(linalg.max_abs(nablaD)), dtype) * d * nablaD

    a, b = Qh, invQtv
    a32, b32 = a.float(), b.float()
    dot = lambda x, y: psum(x @ y)
    if update_u:
        atV, btV = mv(V, a), mv(V, b)
        x32, y32 = (atV @ V).float(), (btV @ V).float()
        norm = torch.sqrt(torch.abs(dot(a32, a32) * dot(x32, x32) + dot(b32, b32) * dot(y32, y32)
                                    - 2.0 * dot(a32, b32) * dot(x32, y32)))
        mu = linalg.step_scale(step, norm, dtype)
        U = U - mu * (torch.outer(IpVtU.T @ atV, a) - torch.outer(IpVtU.T @ btV, b))
    else:
        atU, btU = mv(U, a), mv(U, b)
        x32, y32 = (atU @ U).float(), (btU @ U).float()
        norm = torch.sqrt(torch.abs(dot(x32, x32) * dot(a32, a32) + dot(y32, y32) * dot(b32, b32)
                                    - 2.0 * dot(x32, y32) * dot(a32, b32)))
        mu = linalg.step_scale(step, norm, dtype)
        V = V - mu * (torch.outer(atU, a + atU @ V) - torch.outer(btU, b + btU @ V))
    return torch.cat([U, V]), new_d


def apply_plain(UV, d, g, psum=_identity):
    """P g = d (I + V U^T)(I + U V^T)(d g); with `psum`, on this rank's lanes."""
    r = UV.shape[0] // 2
    U, V = UV[:r], UV[r:]
    x = d * g
    x = x + psum(V @ x) @ U
    return d * (x + psum(U @ x) @ V)
