"""The yardstick: peaks, least times, and the work of each function.

Frozen copies of `psgd_tf_tpu_torch/bench.py`'s `_bound`, `kron_work`,
`splu_work` and `family_work` (the minimal work of a function: each input
read once, each output written once, a triangle's upper half, a triangular
product half a dense one), the applies alone on the same counts, and the
NMT model's matmul FLOPs. They depend on shapes only, so a redesign of a
kernel cannot move its own denominator.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores (TF32 is off)


def bound_ms(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS) -> float:
    """The least time for the work on one card, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s) * 1e3


def bound_by(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS) -> str:
    """'bytes' or 'operations': which of the two sets `bound_ms`."""
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / flops_per_s else "operations"


_SIDE_FLOATS = {"dense": lambda k: k * (k + 1) / 2 + k * k, "scale": lambda k: 2 * k,
                "norm": lambda k: 4 * k}


def kron_work(fmt, shape, apply: bool = False):
    """(bytes, FLOPs) of one Kronecker factor update of an (m, n) layer:
    dX, dG and both factors read once, both factors written once. Per dense
    side of size k (the other side o): the two products through its
    triangular factor and its inverse (o k^2 each), the upper triangle of
    its Gram difference (2 o k^2), the inverse and triu(grad) Q (k^3 / 3
    each); per sparse side ~6 k o. With `apply`, the apply of the updated
    factors to dG as well: P dG written once (m n), per dense side Q^T Q
    through two triangular products (2 o k^2), per sparse side ~4 k o."""
    m, n = shape
    nbytes = 4 * (2 * m * n + _SIDE_FLOATS[fmt[0]](m) + _SIDE_FLOATS[fmt[1]](n))
    flops = 0.0
    for f, k, o in ((fmt[0], m, n), (fmt[1], n, m)):
        flops += 4 * k * k * o + 2 * k**3 / 3 if f == "dense" else 6 * k * o
    if apply:
        nbytes += 4 * m * n
        for f, k, o in ((fmt[0], m, n), (fmt[1], n, m)):
            flops += 2 * k * k * o if f == "dense" else 4 * k * o
    return nbytes, flops


def kron_apply_work(fmt, shape):
    """(bytes, FLOPs) of P G alone on the same counts: G and both factors
    read once, P G written once; per dense side 2 o k^2, per sparse side
    ~4 k o."""
    m, n = shape
    nbytes = 4 * (2 * m * n + _SIDE_FLOATS[fmt[0]](m) + _SIDE_FLOATS[fmt[1]](n))
    flops = 0.0
    for f, k, o in ((fmt[0], m, n), (fmt[1], n, m)):
        flops += 2 * k * k * o if f == "dense" else 4 * k * o
    return nbytes, flops


def splu_work(n, r=10, apply=True):
    """(bytes, FLOPs) of one sparse-LU update (+ apply)."""
    nt = n - r
    if apply:
        flops = 2.0 * (2 * r * r + 5 * r + r * (r + 1) / 2 + 2 * r) * nt + 40 * r * nt
        return 4 * (4 * r * n + 8 * n), flops
    return 4 * (4 * r * n + 6 * n), 2.0 * (2 * r * r + 5 * r) * nt + 32 * r * nt


def family_work(family: str, n: int, rank: int = 10):
    """(bytes, FLOPs) of one fp32 update + apply pair of a flat family over
    n parameters: the state, v, h and g read once, the new state and P' g
    written once.

      diag        : 6n floats; ~10 n FLOPs
      xmat, shift : 8n floats; ~30 n FLOPs
      lra         : UV (2rn), d, v, h, g in, UV', d', P' g out; two Grams
                    of 2r + 2 rows and ~30 r n for the projections
      splu        : `splu_work`
      dense       : Q's upper triangle, v, h, g in, Q' and P' g out; ~8 n^2
    """
    fam, r = family.split("_")[0], rank
    if fam == "splu":
        return splu_work(n, r)
    if fam == "lra":
        z = 2 * r + 2
        return 4 * (4 * r * n + 6 * n), 2 * 2 * z * z * n + 30 * r * n
    if fam == "dense":
        return 4 * (n * (n + 1) / 2 + n * n + 4 * n), 8.0 * n * n
    if fam == "diag":
        return 4 * 6 * n, 10.0 * n
    if fam in ("xmat", "shift"):
        return 4 * 8 * n, 30.0 * n
    raise ValueError(f"unknown family {family!r}")


def lra_apply_work(n: int, rank: int = 10):
    """(bytes, FLOPs) of lra's P g alone: UV and d and g read once, P g
    written once; four (r, n) projections or expansions, 2 r n each."""
    return 4 * (2 * rank * n + 3 * n), 8.0 * rank * n + 4.0 * n


def nmt_forward_flops(vocab_tgt: int, embed: int, units: int, attn: int, src_len: int,
                      tgt_len: int) -> float:
    """Matmul FLOPs of one sentence's teacher-forced forward pass of the NMT
    model as `models/nmt.py` writes it: the encoder RNN at each source
    position; at each of the tgt_len - 1 decoder positions the attention's
    two projections (the encoder states' one recomputed there), its score
    row and its context sum, the decoder RNN and the output layer."""
    enc = src_len * 2 * (embed + units) * units
    dec_pos = (2 * units * attn + src_len * 2 * units * attn + src_len * 2 * attn
               + src_len * 2 * units + 2 * (2 * units + embed) * units + 2 * units * vocab_tgt)
    return float(enc + (tgt_len - 1) * dec_pos)
