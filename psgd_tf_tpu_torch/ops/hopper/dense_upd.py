"""K11: the dense-family rank-2 update, n <= MAX_N (`csrc/dense.cu`).

Replaces `psgd_tf_tpu/ops/pallas/dense_upd.py` `fused_update` (:136) and
`fused_update_apply` (:149) → `_call` (:90) → `pallas_call` (:116,
`_kernel` :39). For Q (n, n) upper triangular:

  a = Q h,  b = Q^{-T} v,  G = triu(a a^T - b b^T)
  Q' = Q - step / (max|G| + tiny) * G Q,  and optionally P' g = Q'^T Q' g

The TPU kernel holds Q resident in VMEM up to MAX_N = 1536 (9.4 MB), far
past a Hopper block's 227 KB of shared memory but inside the card's 50 MB
L2. K11 and K12 (`dense_big`) run the same phases of `csrc/dense.cu` over
PANEL x PANEL blocks: K11 in ONE cooperative launch, K12 in four (the
schedule, its ticket orders and its fixed summation orders are
`pass1_tickets`, `pass2_tickets` and `update_apply_blocked_plain`, which
executes them in torch). The two entry points and the JAX caps stay, so
routes and launch counts read as in the JAX package. No padding: the
kernels mask the ragged edge, which gives what the TPU kernel's identity
extension gives. One difference from the Pallas kernel: the step scale
saturates at the fp32 max (`linalg.step_scale`), so a zero gradient gives
a zero update, not NaN.

The plain versions here are the JAX package's XLA path (the rank-2 reverse
cumsum form); the wrappers take them for CPU tensors, and on a CUDA tensor
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build, tri

# psgd_tf_tpu/ops/pallas/dense_upd.py MAX_N: the JAX package's VMEM cap,
# kept as the routing cap between K11 and K12
MAX_N = 1536
PANEL = 128  # DP in csrc/dense.cu: rows of a panel, the side of a diagonal block
DCHK = 8     # csrc/dense.cu: pass 2's carries chain through every DCHK-th panel


def update_plain(q, v, h, step):
    """Q' by the rank-2 form: O(n^2), no n x n gradient."""
    a = q @ h
    b = linalg.solve_ut_t(q, v)
    step0 = linalg.step_scale(step, linalg.triu_outer_diff_maxabs(a, b), q.dtype)
    return q - step0 * linalg.triu_outer_diff_matmul(a, b, q)


def update_apply_plain(q, v, h, g, step):
    """(Q', P' g) with P' g = Q'^T (Q' g) of the updated Q."""
    new_q = update_plain(q, v, h, step)
    return new_q, new_q.T @ (new_q @ g)


def pass1_tickets(nb: int) -> list[tuple[int, int]]:
    """Pass 1's work items in ticket order, as (panel p, item k): k = 0 is
    D(p) (blocks p and p + 1: b_p and the look-ahead contribution to panel
    p + 1), k >= 1 is R(p, k) (blocks p + 2k and p + 2k + 1). D(p + 1) takes
    its ticket before R(p, *). Every item waits only on items of lower
    tickets."""
    items = [(0, 0)]
    for p in range(nb):
        if p + 1 < nb:
            items.append((p + 1, 0))
        items += [(p, k) for k in range(1, (nb - p + 1) // 2)]
    return items


def pass2_tickets(nb: int) -> list[tuple[int, int]]:
    """Pass 2's blocks (p, c), p <= c, in ticket order, panels from the
    bottom. Block (p, c) waits on blocks (q, c) below it, q <= p + DCHK
    (their column sums, and the next checkpoint's carry), and writes the
    zeros of block (c, p)."""
    return [(p, c) for p in range(nb - 1, -1, -1) for c in range(p, nb)]


def update_apply_blocked_plain(q, v, h, g, step, panel: int = PANEL):
    """`csrc/dense.cu`'s schedule executed in torch: (Q', P' g or None).

    prep: the diagonal blocks' inverses by K3's schedule
    (`tri.inverse_upper_blocked_plain`). Pass 1, items in ticket order:
    R items take b_p and add their contributions Q_{pc}^T b_p to the
    running sum of each column over the panels above; D(p) takes the
    running sum at panel p - 2, adds D(p - 1)'s look-ahead, forms
    b_p = Dinv_p^T (v_p - that) and b_p's contribution to panel p + 1. The
    rows' partials of Q h and Q g are summed per panel in item order. Then s0,
    and u = Q' g = Qg - s0 (a * RA - b * RB) with RA, RB the reverse
    cumulative sums of a * Qg and b * Qg. Pass 2, blocks in ticket order:
    each takes the carry of the block below it (the sums of a * Q and b * Q
    over the panels below), adds its own column sums (its two halves in
    half order) to publish its carry, rewrites itself with its reverse
    running sums, and stores its column partial of Q'^T u; P' g sums them
    in panel order. Reading a value not yet published raises KeyError: the
    ticket orders are checked as they run."""
    n, dt = q.shape[0], q.dtype
    nb = (n + panel - 1) // panel
    half = panel // 2

    def sl(k):
        return slice(k * panel, min(n, (k + 1) * panel))

    def block(p, c):
        x = q[sl(p), sl(c)]
        return torch.triu(x) if p == c else x

    dinv = tri.inverse_upper_blocked_plain([block(p, p) for p in range(nb)])
    running, lookahead, bvec, apart, gpart = {}, {}, {}, {}, {}
    for p, k in pass1_tickets(nb):
        cols = [c for c in (p + 2 * k, p + 2 * k + 1) if c < nb]
        apart[p, k] = sum(block(p, c) @ h[sl(c)] for c in cols)
        if g is not None:
            gpart[p, k] = sum(block(p, c) @ g[sl(c)] for c in cols)
        if k == 0:
            acc = running[p - 2, p] if p >= 2 else torch.zeros_like(v[sl(p)])
            if p >= 1:
                acc = acc + lookahead[p - 1]
            bvec[p] = dinv[p].T @ (v[sl(p)] - acc)
            if len(cols) > 1:
                lookahead[p] = block(p, cols[1]).T @ bvec[p]
            continue
        for c in cols:
            own = block(p, c).T @ bvec[p]
            running[p, c] = running[p - 1, c] + own if p else own
    items = [(nb - p + 1) // 2 for p in range(nb)]
    a = torch.cat([sum(apart[p, k] for k in range(items[p])) for p in range(nb)])
    b = torch.cat([bvec[p] for p in range(nb)])
    s0 = linalg.step_scale(step, linalg.triu_outer_diff_maxabs(a, b), dt)
    u = None
    if g is not None:
        qg = torch.cat([sum(gpart[p, k] for k in range(items[p])) for p in range(nb)])
        rev = lambda x: torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))
        u = qg - s0 * (a * rev(a * qg) - b * rev(b * qg))
    out = torch.zeros_like(q)
    carry, pgpart = {}, {}
    for p, c in pass2_tickets(nb):
        x, ap, bp = block(p, c), a[sl(p)], b[sl(p)]
        wa, wb = ap[:, None] * x, bp[:, None] * x
        ex_a, ex_b = carry[p + 1, c] if c > p else (torch.zeros_like(x[0]), torch.zeros_like(x[0]))
        carry[p, c] = (ex_a + (wa[:half].sum(0) + wa[half:].sum(0)),
                       ex_b + (wb[:half].sum(0) + wb[half:].sum(0)))
        sa = ex_a + torch.flip(torch.cumsum(torch.flip(wa, (0,)), 0), (0,))
        sb = ex_b + torch.flip(torch.cumsum(torch.flip(wb, (0,)), 0), (0,))
        y = x - s0 * (ap[:, None] * sa - bp[:, None] * sb)
        y = torch.triu(y) if p == c else y
        out[sl(p), sl(c)] = y
        if u is not None:
            pgpart[p, c] = y.T @ u[sl(p)]
    if u is None:
        return out, None
    pre = []
    for c in range(nb):
        s = torch.zeros_like(pgpart[0, c])
        for p in range(c + 1):
            s = s + pgpart[p, c]
        pre.append(s)
    return out, torch.cat(pre)


def launch(name: str, cap: int, q, v, h, g, step):
    """The phases of `csrc/dense.cu` on CUDA tensors: (Q', P' g or None).
    `dense_upd` (K11) runs them in one cooperative launch, K3's phases
    inside it; `dense_big` (K12) in four launches, the first of them K3's
    (counted as one `tri` launch)."""
    n = q.shape[0]
    if n > cap:
        raise ValueError(f"{name}: n = {n} exceeds its cap {cap}")
    vecs = [v, h] + ([g] if g is not None else [])
    if q.shape != (n, n) or any(x.shape != (n,) for x in vecs):
        raise ValueError(f"{name}: operand shapes do not agree")
    hopper.check_operands(name, q, *vecs)
    mono = name == "dense_upd"
    lib = _build.lib()
    new_q = torch.empty_like(q)
    pre = torch.empty_like(v) if g is not None else None
    scratch = torch.empty(lib.psgd_dense_scratch_floats(n), dtype=torch.float32, device=q.device)
    rc = lib.psgd_dense_update(
        n, q.data_ptr(), v.data_ptr(), h.data_ptr(), g.data_ptr() if g is not None else None,
        float(step), new_q.data_ptr(), pre.data_ptr() if pre is not None else None,
        scratch.data_ptr(), int(mono), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"{name} kernel" if mono else f"{name} kernel chain")
    hopper.counts[name] += 1
    if not mono:
        hopper.counts["tri"] += 1
    return new_q, pre


def fused_update(q, v, h, step):
    """Q' for n <= MAX_N: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if not hopper.use_kernel(q):
        return update_plain(q, v, h, step)
    return launch("dense_upd", MAX_N, q, v, h, None, step)[0]


def fused_update_apply(q, v, h, g, step):
    """(Q', P' g) for n <= MAX_N, P' g of the UPDATED Q."""
    if not hopper.use_kernel(q):
        return update_apply_plain(q, v, h, g, step)
    return launch("dense_upd", MAX_N, q, v, h, g, step)
