"""K13: the low-rank (UVd) family's update and fused apply (`csrc/lra.cu`).

Replaces `psgd_tf_tpu/ops/pallas/lra_upd.py` `fused_update` (:458) and
`fused_update_apply` (:543) → `_update_impl` (:217) → its `pallas_call`s at
:281 (stage 1), :389 (stage 3), :416 (stage 3 with the apply Gram) and
:443 (stage 4). The factors stay packed: UV (2r, n) = [U; V], d (n,).

  stage 1   one Gram Z Z^T of Z = [U; V; d h; v / d], with max|U|, max|V|
  algebra   the Woodbury solves on the r x r system, the balance scales
            cu, cv, the stage-3 coefficients: plain torch on the device
            (~40 tiny ops), as they are jnp in the JAX package
  stage 3   U', V' and nablaD per lane; with g also the Gram of
            [U'; V'; d g; d g nablaD]
  d'        d - mu_d d nablaD, mu_d from max|nablaD|: torch
  stage 4   P' g = d' (d' g + t1 U' + t2 V')

The JAX function draws the rebalance and U-vs-V coins from a key; here
they arrive as host booleans `coins = (balance, update_u)`, so the
rank-space algebra branches on the host and never waits for the device.
The U-vs-V choice arrives in stage 3 as zeroed coefficients, as in JAX.
One difference from the Pallas kernels: the step scales saturate at the
fp32 max (`linalg.step_scale`), as the XLA path does.

Each stage has a plain torch version here. `fused_update(_apply)` runs the
stages' kernels for CUDA tensors and their plain versions for CPU tensors
(and inside `hopper.disabled()`), with the same algebra between them: the
plain stages exist so that the rank-space algebra runs, and is held to
the JAX package's interpret mode, without a card. `update_plain` is the
direct form (the JAX XLA path): what `groups/lra` runs for dtypes other
than fp32, and the independent oracle the chain is held to.

K14 (`fused_update_sharded`, `fused_update_apply_sharded`; JAX :487, :554,
:467) is the same chain on each rank's slice of the lanes: the stage-1
Gram and maxima, max|nablaD| and the apply Gram are all-reduced over the
mesh's shard ranks where JAX psums and pmaxes them, and the rank-space
algebra runs alike on every rank. Its pipelined mode runs stage 1 on lane
chunks (the kernels take a row stride) and reduces each chunk as soon as
it is launched.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build

MAX_RANK = 32  # LRA_MAX_RANK in csrc/lra.cu: the Grams' pairs per thread
CHUNKS = 4     # lane chunks of K14's pipelined stage 1


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


def stage4_plain(UV, d, g, coef4):
    """d (d g + t1 U + t2 V) with (t1, t2) the columns of coef4 (r, 2)."""
    r = UV.shape[0] // 2
    return d * (d * g + coef4[:, 0] @ UV[:r] + coef4[:, 1] @ UV[r:])


# ------------------------------------------------------------ the stages, kernels

class _Kernels:
    """The three C entry points of `csrc/lra.cu` on one (2r, n) problem."""

    def __init__(self, UV, d, v, h, g):
        r2, n = UV.shape
        if r2 % 2 or r2 // 2 > MAX_RANK:
            raise ValueError(f"lra_upd: rank {r2 // 2} must be in [1, {MAX_RANK}]")
        vecs = [d, v, h] + ([g] if g is not None else [])
        if any(x.shape != (n,) for x in vecs):
            raise ValueError("lra_upd: operand shapes do not agree")
        hopper.check_operands("lra_upd", UV, *vecs)
        self.lib = _build.lib()
        self.n, self.r = n, r2 // 2
        self.f = dict(dtype=torch.float32, device=UV.device)
        self.scratch = torch.empty(self.lib.psgd_lra_scratch_floats(n, self.r), **self.f)
        self.stream = torch.cuda.current_stream(UV.device).cuda_stream

    def stage1(self, UV, d, h, v, lo=0, hi=None):
        """Over lanes [lo, hi); a chunk gets its own scratch, so that its
        block partials survive the next chunk's launch."""
        hi = self.n if hi is None else hi
        zdim = 2 * self.r + 2
        gram, maxs = torch.empty(zdim, zdim, **self.f), torch.empty(2, **self.f)
        whole = (lo, hi) == (0, self.n)
        scratch = self.scratch if whole else torch.empty(
            self.lib.psgd_lra_scratch_floats(hi - lo, self.r), **self.f)
        at = lambda x: x.data_ptr() + 4 * lo
        rc = self.lib.psgd_lra_stage1(hi - lo, self.n, self.r, at(UV), at(d), at(h), at(v),
                                      gram.data_ptr(), maxs.data_ptr(), scratch.data_ptr(),
                                      self.stream)
        _build.check(rc, "lra_upd stage 1")
        return gram, maxs

    def stage3(self, UV, d, h, v, coef, scal, g=None):
        zdim = 2 * self.r + 2
        new_uv, nd = torch.empty_like(UV), torch.empty_like(d)
        gram2 = torch.empty(zdim, zdim, **self.f) if g is not None else None
        rc = self.lib.psgd_lra_stage3(
            self.n, self.n, self.r, UV.data_ptr(), d.data_ptr(), h.data_ptr(), v.data_ptr(),
            g.data_ptr() if g is not None else None, coef.data_ptr(), scal.data_ptr(),
            new_uv.data_ptr(), nd.data_ptr(), gram2.data_ptr() if g is not None else None,
            self.scratch.data_ptr(), self.stream)
        _build.check(rc, "lra_upd stage 3")
        return new_uv, nd, gram2

    def stage4(self, UV, d, g, coef4):
        out = torch.empty_like(d)
        rc = self.lib.psgd_lra_stage4(self.n, self.n, self.r, UV.data_ptr(), d.data_ptr(),
                                      g.data_ptr(), coef4.data_ptr(), out.data_ptr(), self.stream)
        _build.check(rc, "lra_upd stage 4")
        return out


class _Plain:
    stage1 = staticmethod(stage1_plain)
    stage3 = staticmethod(stage3_plain)
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
    balance, update_u = coins
    kernel = hopper.use_kernel(UV)
    st = _Kernels(UV, d, v, h, g) if kernel else _Plain
    psum, pmax = (mesh.psum, mesh.pmax) if mesh is not None else (_identity, _identity)
    r = UV.shape[0] // 2
    f32 = torch.float32
    tiny = linalg.tiny(f32)
    if mesh is not None and pipelined and UV.shape[1] >= CHUNKS:
        gram, maxs = _stage1_chunked(st, UV, d, h, v, mesh)
    else:
        gram, maxs = st.stage1(UV, d, h, v)
        gram, maxs = psum(gram), pmax(maxs)
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
        scal = torch.ones(2, dtype=f32, device=UV.device)

    # the Woodbury algebra on the r x r system
    IpVtU = torch.eye(r, dtype=f32, device=UV.device) + G
    a1 = linalg.solve_small(IpVtU.T, p)
    a2 = linalg.solve_small(IpVtU, q - Gvp @ a1)
    s2 = s + Gup @ t
    aa = xx + 2.0 * (s @ t) + t @ (Gup @ t)
    bb = ww - 2.0 * (a1 @ q) + a1 @ (Gvp @ a1)
    ab = xw - a1 @ t + t @ p - t @ (G.T @ a1)
    atU = s + Gup @ t
    btU = p - G.T @ a1
    zero = torch.zeros(r, dtype=f32, device=UV.device)
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
    coef = torch.stack([t0, cv * a1, cv * s2, cu * a2, e1, e2, f1, f2, cv * atU, cv * btU], 1)

    new_uv, nd, gram2 = st.stage3(UV, d, h, v, coef.contiguous(), scal, g)
    # max|nablaD| over every lane before the d' AXPY
    mu_d = linalg.step_scale(step, pmax(linalg.max_abs(nd)), f32)
    new_d = d - mu_d * d * nd
    if g is None:
        pre = None
    else:
        # y = d' g = y0 - mu_d y1: recombine the Gram's y0/y1 columns
        gram2 = psum(gram2)
        iy0, iy1 = 2 * r, 2 * r + 1
        t1 = gram2[iv, iy0] - mu_d * gram2[iv, iy1]                    # V' y
        t2 = gram2[iu, iy0] - mu_d * gram2[iu, iy1] + gram2[iu, iu] @ t1  # U'(y + U'^T t1)
        pre = st.stage4(new_uv, new_d, g, torch.stack([t1, t2], 1).contiguous())
    if kernel:
        hopper.counts["lra_upd" if mesh is None else "lra_upd_sharded"] += 1
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
