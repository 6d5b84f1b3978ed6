"""K6, K7/K8, K9 and K10: the streaming sparse-format Kronecker updates, for
layers past `kron_sparse.fits` (embedding and vocabulary-sized probes); K17
and K18: the streamed applies of an arrow left factor.

Replaces `psgd_tf_tpu/ops/pallas/kron_sparse_big.py`:
  - K6, `fused_update_ns` (:377 → `pallas_call` :412, `_kernel_ns_big`
    :172): (norm, scale), n padded to 128 up to MAX_LANES. The whole
    update, the tail the JAX package leaves to XLA included, is one C call
    (`csrc/kron_sparse_big.cu`, `psgd_kron_ns_update`): one pass over
    (dX, dG), the second dX pass, the step scales and the balanced
    rewrites, all on the device.
  - K7, `_fused_update_ns_wide2` (:456 → :494, `_kernel_ns_wide2` :197), and
    K8, `_fused_update_ns_wide_xla` (:524 → :558, `_kernel_ns_wide` :265):
    the same update for scale sides past MAX_LANES, up to MAX_LANES_NS,
    the same C call with the wide pass in place of K6's and K6's device
    tail. One CUDA kernel serves both; its launches are counted under the
    JAX function that the width would take (WIDE2_MAX_LANES).
  - K9, `fused_update_nd` (:598 → `pallas_call` :634, `_kernel_nd_big`
    :298): (norm, dense), n <= MAX_DENSE. The kernel part is A = Ql dG Qr^T
    and Bt = Ql^{-T} dX Qr^{-1} with row m-1 masked (by K3's exact inverse,
    the arrow's rows applied after each product), their row sums diag0 and
    biasa, corr, and the upper triangle of the Gram difference
    A^T A - Bt^T Bt; its tail (two triangular solves, the second dX pass,
    `_norm_post`) stays torch.
  - K10, `fused_update_ds` (:711 → `pallas_call` :740, `_kernel_ds_big`
    :675): (dense, scale), m <= MAX_DENSE. The whole update is one C call
    (`psgd_kron_ds_update`): K3's inverse, A = Ql dG qr and Bt = Ql^{-T} dX
    / qr with the column sums of their squares in the products' epilogue,
    the upper tiles of A A^T - Bt Bt^T, the step scales and the balanced
    factors, all on the device.
  - K17, `fused_apply_ns` (:848) and `fused_apply_nd` (:928) →
    `_apply_norm_call` (:807 → `pallas_call` :830, `_kernel_apply_norm`
    :768), and K18, `fused_apply_ns_wide` (:893 → :912,
    `_kernel_apply_ns_wide` :853): P G = Ql^T ((Ql G) R) in one pass over
    G, R = diag(qr^2) or Qr^T Qr (a torch product here, as JAX forms it
    outside its kernel). Unrouted, as in the JAX package: `groups/kron.apply`
    keeps the plain chain for every pair, and these are entry points of
    their own. One CUDA kernel serves K17's (norm, scale) case and K18,
    unpadded; the (norm, dense) case is a GEMM kernel of its own with the
    arrow in its operand load and its epilogue.

Each update returns what the JAX function returns: the balanced, updated
factors. One difference, shared with K1/K2: the step scales saturate at the
fp32 max (`linalg.step_scale`), so a zero gradient gives a zero update, not
NaN. The one-call updates (K6, K7/K8, K10) balance in their finish: rho
cancels in every gradient term, so they run on the unbalanced factors and
their rounding differs from the plain versions' at the 1e-7 level.

Each update has a plain torch version here (`update_ns_plain`,
`update_ds_plain`, and K9's kernel part `nd_reductions_plain`), which the
wrappers take for CPU tensors; on a CUDA tensor they launch the kernels or
raise. Probes that arrive transposed (a mirrored layer's dX.T) are read in
place by every kernel.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import _build, kron_sparse

# the JAX package's routing caps (kron_sparse_big.py:60-76)
MAX_LANES = 131072        # 1-D-grid (norm, scale) kernel: lanes padded to 128
WIDE2_MAX_LANES = 2 << 20  # the single-pass wide kernel (K7); wider takes K8
MAX_LANES_NS = 1 << 23    # the wide (norm, scale) path's cap (K7/K8)
MAX_DENSE = 1024          # dense-factor side of the streaming nd/ds kernels


def _lanes(n: int) -> int:
    """n padded to 128, as the JAX routes measure a scale side."""
    return -(-n // 128) * 128


def fits_grid(kind: str, m: int, n: int) -> bool:
    """Shapes the JAX package's streaming kernels accept."""
    if kind == "ns":
        return _lanes(n) <= MAX_LANES_NS
    if kind == "nd":
        return n <= MAX_DENSE
    if kind == "ds":
        return m <= MAX_DENSE
    raise ValueError(kind)


def _as_row_major(x):
    """(tensor, transposed): a transposed view of a contiguous tensor is
    passed as that tensor with a flag (the mirrored layers arrive as dX.T),
    anything else is made contiguous."""
    if x.is_contiguous():
        return x, 0
    if x.T.is_contiguous():
        return x.T, 1
    return x.contiguous(), 0


# ----------------------------------------------------------------- (norm, scale)

def ns_reductions_plain(dX, dG, ql0, ql1, w, qr, dgl, al):
    """K6's (and K7/K8's) pass, plain: (diag0, biasa, corr, colsum) with row
    m-1 masked out of diag0, biasa and colsum (`_kernel_ns_big`)."""
    m = dX.shape[0]
    keep = (torch.arange(m, device=dX.device) != m - 1)[:, None]
    dxm = torch.where(keep, dX, 0.0)
    dgm = torch.where(keep, dG, 0.0)
    a = (ql0[:, None] * dgm + ql1[:, None] * dgl[None, :]) * qr[None, :]
    bt = dxm / ql0[:, None] / qr[None, :]
    d2 = a * a - bt * bt
    return d2.sum(1), (a * al[None, :]).sum(1), (w[:, None] * dX).sum(0), d2.sum(0)


def ns_wide_counter(n: int) -> str:
    """The launch counter of the wide kernel at n lanes: the JAX function
    that width takes, K7 up to WIDE2_MAX_LANES and K8 past it."""
    wide2 = _lanes(n) <= WIDE2_MAX_LANES
    return "kron_sparse_big_ns_wide2" if wide2 else "kron_sparse_big_ns_wide_xla"


def _norm_post(ql0, ql1, diag, bias, grad2, step, qr, dense):
    """The arrow and right-factor rewrites (the JAX package's `_norm_post`,
    with the saturating step scales)."""
    step1 = linalg.step_scale(
        step, torch.maximum(linalg.max_abs(diag), linalg.max_abs(bias)), ql0.dtype
    )
    new0 = ql0 - step1 * diag * ql0
    new1 = ql1 - step1 * (diag * ql1 + ql0[-1] * bias)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), qr.dtype)
    newqr = qr - step2 * (grad2 @ qr) if dense else qr - step2 * grad2 * qr
    return torch.stack([new0, new1]), newqr


def _patch_last(v, last):
    """v with its last entry replaced by `last` (row m-1's own terms)."""
    return torch.cat([v[:-1], last.reshape(1).to(v.dtype)])


def update_ns_plain(ql, qr, dX, dG, step):
    """K6/K7/K8's plain version: the (norm, scale) update as the JAX
    function computes it (balance, the pass, the XLA tail)."""
    rho = torch.sqrt(ql[0].amax() / qr.amax())
    ql = ql / rho
    qr_b = rho * qr
    ql0, ql1 = ql[0], ql[1]
    dX_last, dG_last = dX[-1], dG[-1]
    A_last = ql0[-1] * dG_last * qr_b
    w = ql1 / (ql0 * ql0[-1])  # w[-1] = 0
    diag0, biasa, corr, colsum = ns_reductions_plain(dX, dG, ql0, ql1, w, qr_b, dG_last, A_last)

    B_last = (dX_last / ql0[-1] - corr) / qr_b
    diag = _patch_last(diag0, torch.sum(A_last**2 - B_last**2))
    btdot = (dX @ (B_last / qr_b)) / ql0  # the second dX pass
    bias = _patch_last(biasa - btdot, biasa.new_zeros(()))
    grad2 = colsum + A_last**2 - B_last**2
    return _norm_post(ql0, ql1, diag, bias, grad2, step, qr_b, dense=False)


def _ns_call(ql, qr, dX, dG, step):
    """K6 (up to MAX_LANES) or K7/K8's update in one C call: allocations
    and the call, no torch compute op and no host sync."""
    m, n = dX.shape
    if _lanes(n) > MAX_LANES_NS:
        raise ValueError(f"kron_sparse_big_ns: {n} lanes exceed MAX_LANES_NS={MAX_LANES_NS}")
    if ql.shape != (2, m) or qr.shape != (n,) or dG.shape != (m, n):
        raise ValueError("kron_sparse_big_ns: operand shapes do not agree")
    (x, t), (g, tg) = _as_row_major(dX), _as_row_major(dG)
    if tg != t:  # one layout for the pair (no path gives two)
        g = dG.T.contiguous() if t else dG.contiguous()
    wide = _lanes(n) > MAX_LANES
    counter = ns_wide_counter(n) if wide else "kron_sparse_big_ns"
    hopper.check_operands(counter, ql, qr, x, g)
    lib = _build.lib()
    f = dict(dtype=torch.float32, device=dX.device)
    out_ql, out_qr = torch.empty(2, m, **f), torch.empty(n, **f)
    scratch = torch.empty(lib.psgd_kron_ns_update_scratch_floats(m, n, t, int(wide)), **f)
    rc = lib.psgd_kron_ns_update(
        m, n, ql.data_ptr(), qr.data_ptr(), x.data_ptr(), g.data_ptr(), t, int(wide), float(step),
        out_ql.data_ptr(), out_qr.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dX.device).cuda_stream)
    _build.check(rc, f"{counter} kernel chain")
    hopper.counts[counter] += 1
    return out_ql, out_qr


def fused_update_ns(ql, qr, dX, dG, step):
    """(norm, scale) streaming update; ql (2, m), qr (n,): K6 up to
    MAX_LANES, K7/K8 past it, as `kron_sparse_big.fused_update_ns` routes.
    Returns the balanced, updated (ql', qr'): the plain version for CPU
    tensors, one C call for CUDA ones (dX and dG may be transposed views)."""
    if not hopper.use_kernel(dX):
        return update_ns_plain(ql, qr, dX, dG, step)
    return _ns_call(ql, qr, dX, dG, step)


# ---------------------------------------------------------------- (norm, dense)

def nd_reductions_plain(dX, dG, ql, w, Qr, u):
    """K9's kernel part, plain: (diag0, biasa, corr, triu(A^T A - Bt^T Bt))
    with A = (q0 dGm + q1 dG_last) Qr^T and Bt = (dXm / q0) Qr^{-1}, ql the
    (2, m) arrow [q0; q1], row m-1 masked out of dXm and dGm, corr = w^T dX,
    biasa = A A_last with A_last = q0[-1] u, u = dG_last Qr^T
    (`_kernel_nd_big`)."""
    m = dX.shape[0]
    ql0, ql1 = ql[0], ql[1]
    keep = (torch.arange(m, device=dX.device) != m - 1)[:, None]
    A = (ql0[:, None] * torch.where(keep, dG, 0.0) + ql1[:, None] * dG[-1][None, :]) @ Qr.T
    Bt = linalg.solve_ut_t(Qr, (torch.where(keep, dX, 0.0) / ql0[:, None]).T).T
    return ((A * A - Bt * Bt).sum(1), A @ (ql0[-1] * u), w @ dX,
            linalg.triu(A.T @ A - Bt.T @ Bt))


def nd_reductions(dX, dG, ql, w, Qr, u):
    """K9's kernel part: the plain version for CPU tensors, the CUDA chain
    (`csrc/kron_sparse_big.cu`: K3, the two products with the arrow in
    their operand load, row sums, corr partials, split-K Gram) for CUDA
    tensors. dX and dG may be transposed views."""
    if not hopper.use_kernel(dX):
        return nd_reductions_plain(dX, dG, ql, w, Qr, u)
    m, n = dX.shape
    if n > MAX_DENSE:
        raise ValueError(f"kron_sparse_big_nd: dense side {n} exceeds MAX_DENSE={MAX_DENSE}")
    ql, w, u = ql.contiguous(), w.contiguous(), u.contiguous()
    if (dG.shape != (m, n) or Qr.shape != (n, n) or ql.shape != (2, m) or w.shape != (m,)
            or u.shape != (n,)):
        raise ValueError("kron_sparse_big_nd: operand shapes do not agree")
    (x, xt), (g, gt) = _as_row_major(dX), _as_row_major(dG)
    hopper.check_operands("kron_sparse_big_nd", x, g, ql, w, Qr, u)
    lib = _build.lib()
    f = dict(dtype=torch.float32, device=dX.device)
    outs = [torch.empty(m, **f), torch.empty(m, **f), torch.empty(n, **f), torch.empty(n, n, **f)]
    scratch = torch.empty(lib.psgd_kron_nd_big_scratch_floats(m, n), **f)
    rc = lib.psgd_kron_nd_big(
        m, n, x.data_ptr(), xt, g.data_ptr(), gt,
        *[t.data_ptr() for t in (ql, w, Qr, u, *outs, scratch)],
        torch.cuda.current_stream(dX.device).cuda_stream,
    )
    _build.check(rc, "kron_sparse_big_nd kernel chain")
    hopper.counts["kron_sparse_big_nd"] += 1
    hopper.counts["tri"] += 1  # the chain's first step is K3
    return tuple(outs)


def fused_update_nd(ql, Qr, dX, dG, step):
    """K9: (norm, dense) streaming update; ql (2, m), Qr (n, n)
    upper-triangular with n <= MAX_DENSE. Returns the balanced, updated
    (ql', Qr'), as `kron_sparse_big.fused_update_nd`."""
    rho = torch.sqrt(ql[0].amax() / torch.diagonal(Qr).amax())
    ql = ql / rho
    Qr_b = rho * Qr
    ql0, ql1 = ql[0], ql[1]
    dX_last, dG_last = dX[-1], dG[-1]
    u = dG_last @ Qr_b.T
    A_last = ql0[-1] * u
    w = ql1 / (ql0 * ql0[-1])  # w[-1] = 0
    diag0, biasa, corr, gram = nd_reductions(dX, dG, ql, w, Qr_b, u)

    # the O(m + n^2) tail and the second dX pass (XLA in the JAX package)
    B_last = linalg.solve_ut_t(Qr_b, dX_last / ql0[-1] - corr)  # z Qr^{-1}
    diag = _patch_last(diag0, torch.sum(A_last**2 - B_last**2))
    btdot = (dX @ linalg.solve_ut(Qr_b, B_last)) / ql0
    bias = _patch_last(biasa - btdot, biasa.new_zeros(()))
    grad2 = linalg.triu(gram + torch.outer(A_last, A_last) - torch.outer(B_last, B_last))
    return _norm_post(ql0, ql1, diag, bias, grad2, step, Qr_b, dense=True)


# ---------------------------------------------------------------- (dense, scale)

def ds_reductions_plain(Ql, qr, dX, dG):
    """K10's products and Gram, plain: (grad2, A A^T - Bt Bt^T) with
    A = Ql dG qr and Bt = Ql^{-T} dX / qr (`_kernel_ds_big`)."""
    A = (Ql @ dG) * qr[None, :]
    Bt = linalg.solve_ut_t(Ql, dX) / qr[None, :]
    return (A * A - Bt * Bt).sum(0), A @ A.T - Bt @ Bt.T


def update_ds_plain(Ql, qr, dX, dG, step):
    """K10's plain version: the (dense, scale) update as the JAX function
    computes it (balance, the products and Gram, the XLA tail)."""
    rho = torch.sqrt(torch.diagonal(Ql).amax() / qr.amax())
    Ql_b = Ql / rho
    qr_b = rho * qr
    grad2, gram = ds_reductions_plain(Ql_b, qr_b, dX, dG)
    grad1 = linalg.triu(gram)
    step1 = linalg.step_scale(step, linalg.max_abs(grad1), Ql.dtype)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), qr.dtype)
    return Ql_b - step1 * (grad1 @ Ql_b), qr_b - step2 * grad2 * qr_b


def _ds_call(Ql, qr, dX, dG, step):
    """K10's update in one C call: allocations and the call, no torch
    compute op and no host sync."""
    m, n = dX.shape
    if m > MAX_DENSE:
        raise ValueError(f"kron_sparse_big_ds: dense side {m} exceeds MAX_DENSE={MAX_DENSE}")
    if Ql.shape != (m, m) or qr.shape != (n,) or dG.shape != (m, n):
        raise ValueError("kron_sparse_big_ds: operand shapes do not agree")
    (x, xt), (g, gt) = _as_row_major(dX), _as_row_major(dG)
    hopper.check_operands("kron_sparse_big_ds", Ql, qr, x, g)
    lib = _build.lib()
    f = dict(dtype=torch.float32, device=dX.device)
    out_ql, out_qr = torch.empty(m, m, **f), torch.empty(n, **f)
    scratch = torch.empty(lib.psgd_kron_ds_update_scratch_floats(m, n), **f)
    rc = lib.psgd_kron_ds_update(
        m, n, Ql.data_ptr(), qr.data_ptr(), x.data_ptr(), xt, g.data_ptr(), gt, float(step),
        out_ql.data_ptr(), out_qr.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dX.device).cuda_stream)
    _build.check(rc, "kron_sparse_big_ds kernel chain")
    hopper.counts["kron_sparse_big_ds"] += 1
    hopper.counts["tri"] += 1  # the chain's first step is K3
    return out_ql, out_qr


def fused_update_ds(Ql, qr, dX, dG, step):
    """K10: (dense, scale) streaming update; Ql (m, m) upper-triangular with
    m <= MAX_DENSE, qr (n,). Returns the balanced, updated (Ql', qr'), as
    `kron_sparse_big.fused_update_ds`: the plain version for CPU tensors,
    one C call for CUDA ones (dX and dG may be transposed views)."""
    if not hopper.use_kernel(dX):
        return update_ds_plain(Ql, qr, dX, dG, step)
    return _ds_call(Ql, qr, dX, dG, step)


# ------------------------------------------------------- the arrow applies

def apply_ns_plain(ql, qr, G):
    """(norm, scale) P G = Ql^T ((Ql G) diag(qr^2)), the XLA chain of the
    JAX package (`groups/kron.py` `_apply_ns`): K17/K18's plain version."""
    return kron_sparse.norm_t_matmul(ql, kron_sparse.norm_matmul(ql, G) * (qr * qr)[None, :])


def apply_nd_plain(ql, Qr, G):
    """(norm, dense) P G = Ql^T ((Ql G) Qr^T Qr), the XLA chain of the JAX
    package (`groups/kron.py` `_apply_nd`, its product order by shape):
    K17's plain version."""
    preG = kron_sparse.norm_matmul(ql, G)
    if preG.shape[0] < preG.shape[1]:
        preG = (preG @ Qr.T) @ Qr
    else:
        preG = preG @ (Qr.T @ Qr)
    return kron_sparse.norm_t_matmul(ql, preG)


def _apply(kind, ql, q, G, counter):
    """Launch the streamed apply (`csrc/kron_sparse_big.cu`) of kind 'ns'
    (q = qr, (n,)) or 'nd' (q = R = Qr^T Qr, (n, n)) on CUDA tensors."""
    m, n = G.shape
    if ql.shape != (2, m) or q.shape != ((n,) if kind == "ns" else (n, n)):
        raise ValueError(f"{counter}: shapes ql {tuple(ql.shape)}, "
                         f"{'qr' if kind == 'ns' else 'R'} {tuple(q.shape)}, G {(m, n)} "
                         "do not agree")
    hopper.check_operands(counter, G, ql, q)
    lib = _build.lib()
    out = torch.empty_like(G)
    scratch = torch.empty(lib.psgd_kron_apply_scratch_floats(m, n, int(kind == "nd")),
                          dtype=torch.float32, device=G.device)
    fn = lib.psgd_kron_apply_ns if kind == "ns" else lib.psgd_kron_apply_nd
    rc = fn(m, n, G.data_ptr(), ql.data_ptr(), q.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(G.device).cuda_stream)
    _build.check(rc, f"{counter} kernel")
    hopper.counts[counter] += 1
    return out


def fused_apply_ns(ql, qr, G):
    """K17: (norm, scale) P G in one streamed pass; ql (2, m), qr (n,),
    G (m, n). The plain version for CPU tensors, the kernel for CUDA ones."""
    if not hopper.use_kernel(G):
        return apply_ns_plain(ql, qr, G)
    return _apply("ns", ql, qr, G, "kron_sparse_big_apply_ns")


def fused_apply_ns_wide(ql, qr, G):
    """K18: the (norm, scale) P G for scale sides past MAX_LANES (any width
    here): K17's kernel on a wider grid, G and the output unpadded."""
    if not hopper.use_kernel(G):
        return apply_ns_plain(ql, qr, G)
    return _apply("ns", ql, qr, G, "kron_sparse_big_apply_ns_wide")


def fused_apply_nd(ql, Qr, G):
    """K17: (norm, dense) P G; ql (2, m), Qr (n, n) upper-triangular,
    G (m, n). R = Qr^T Qr is one torch product (O(n^3), off the streaming
    path, as JAX forms it outside its kernel); then two launches
    (`csrc/kron_sparse_big.cu`, `apply_nd_kernel`): the product Z = (Ql G) R
    with Ql's rows formed in its operand load and out_i = q0_i z_i with the
    arrow's column sums in its epilogue, and the sums added to row m - 1."""
    if not hopper.use_kernel(G):
        return apply_nd_plain(ql, Qr, G)
    return _apply("nd", ql, Qr.T @ Qr, G, "kron_sparse_big_apply_nd")
