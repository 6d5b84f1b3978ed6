#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (psgd_tf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a). It builds the Hopper kernels from
`psgd_tf_tpu_torch/csrc/` (into `psgd_tf_tpu_torch/_build/`), checks each
against its plain PyTorch version at the shapes its path gives it (and the
flat families' kernels at the JAX bench's sizes, with K13's host time a
call; K4 also at the JAX package's batching crossover and at the side
cap; K3 also at the ragged sides 1, 31, 33, 255, 257, 513 and 1025; K1's
chain forced onto each of its two routes, the chain of launches and the
one cooperative launch, bit for bit, through K1, K2, K4, K5 and K20, each
timed both ways and plain, and a forced one launch that must be refused;
K6, K7/K8 and K10, each one C call with its tail on the device, through
`kron.update` at the reference NMT's layers and the bench's wide shapes,
a mirrored (scale, norm) layer, n % 4 = 1 and two-row layers, each
repeated bit for bit, with zero probes, and timed chained, on the device
(queued) and on the host; F4: K13 and K14 on an lra state or probe
holding one NaN or inf and 1,000 K13 calls fed their own P' v past the
overflow, through `tools/nan_probe.py` in child processes, every output
non-finite where the plain chain's is and no device fault), then drives
the port's
paths, each with the launch counts set to 0 just before it and read just
after:

  - the sparse-LU family's fused apply entry (`splu_upd.fused_update(g=...)`,
    the chain with g) and its one-launch kernel (`fused_update_apply_mono`,
    one launch at any rank), which no optimizer routes, through their own
    entry points at n = 400, 65,536, 100,003 and 2^20 (r = 10), 100,003
    at r = 1, 32 and 64 and 6,000 at r = 256: each against the plain chain
    and the direct form followed by `splu.apply`, mono against the chain
    bit for bit, timed beside the routed pair (`splu.update_apply`) and
    the plain chain;
  - LeNet5 with five (dense, dense) Kronecker preconditioners, exact Hvp,
    batch 64, the `mnist_lenet5` hyperparameters, on procedural digits
    (K1 with kind dd, K3); then 20 steps of the same with a bf16 Kronecker
    state, which takes the plain updates (no launch);
  - the NMT model at the reference widths (12,424,273 parameters) with
    its mixed formats, FD Hvp, random tokens as the JAX package's bench
    draws them (K10, K6, K2, K3);
  - the same model and recipe under PSGD's default Kronecker formats
    ('auto'): five (norm, dense) layers (K9 with its K3), the fc
    (norm, scale) (K6) and the (1, 10) row (K2);
  - the kron capacity envelope through `kron.update`, as the JAX bench
    drives its kron_nd and kron_ns_wide rows: (131072, 512) (norm, dense)
    (K9), (512, 1,000,000) (norm, scale) (K7) and (64, 3,000,017) past
    2^21 lanes (K8), five steps each;
  - the NMT model at embed 16, units 32 (vocabularies 1100 and 1030) under
    PSGD's defaults, exact Hvp, batch 64: its four (dense, dense) layers
    share a (128, 128) bucket and are stacked (K4 with its K3), the
    embeddings take K9, the fc K10; 30 steps with the kernels and under
    `disabled()`;
  - the NMT model's attention kernels (`ops/hopper/attention.py`, which
    replace no TPU kernel: a forward and a backward launch a decoder
    position, the encoder states' gradient once a gradient pass) at toy
    widths, a ragged U at the A limit and the benchmark cells' 4,096 x 18
    x 1,024 with A = 10 and 12 positions, against their plain versions,
    rerun bit for bit, and timed at the cells' shape; every FD path of the
    NMT model above and below counts their launches with its own;
  - Granite-4.0-H Micro's first ten layers at its published widths
    (951,991,232 parameters, the benchmark cell granite_h_kron.seq2k's):
    K6 at each of its (norm, scale) leaf shapes, K10 at each of its
    (scale, dense) ones, K4 on the bucket of its 27 (64, 1) per-head
    vectors, each one call against the plain update and again bit for bit;
    then one `PSGD.step` at 2 x 2,048 tokens (K6 x41, K10 x50, one K4
    chain, K3 x51 and no other launch), its Q update, apply and descent
    replayed plain on the step's own gradient and Hvp;
  - `lstm_xor` at its reference widths (hidden 30, 7,591 parameters,
    batch 128, sequences of 100): its two (dense, dense) layers ride K1
    with two layers (and K3); a 20-step loss trace with the kernels and
    under `disabled()`, then 50 steps of `lstm_xor.run()` with the kernels;
  - the Kronecker family's unrouted kernels through their own entry
    points, as the JAX package's tests reach them: the streamed arrow
    applies (K17) on the reference NMT's three (norm, scale) layers and its
    five (norm, dense) layers under 'auto', at (131072, 512) and
    (65536, 8192), the wide apply (K18) at (512, 1,000,000),
    (64, 3,000,017) and (70, 140,000); the triangular solve (K19) on
    LeNet5's walked factors with probes as right-hand sides in all four
    orientations, at the JAX test cases and at n = 2048, nrhs = 512; the
    (dense, dense) list update (K20) on LeNet5's five layers and on 18
    layers; then K19 at n = 2048, nrhs = 512 in all four orientations,
    each timed beside one `torch.linalg.solve_triangular` of the same
    system;
  - the NMT workload at its toy widths, as `nmt_attention.run()` runs it:
    1000 steps to a held-out token accuracy above 0.75 (K1 with mixed
    kinds, K3);
  - `hello_psgd.run()`: Rosenbrock with the dense family, 500 steps to a
    loss below 1e-4 (K11, one launch a step with K3's phases inside it);
  - `rnn_xor_lra.run()` at the reference widths (SimpleRNN, hidden 30,
    1,021 parameters, rank 10, batch 128, sequences of 16) with the switch
    to the FD Hvp at step 1000, to a train loss below 0.1 (K13);
  - the `UVd` class on the same RNN, 200 steps, switching the Hvp and the
    parameter lr on the way (K13);
  - the dense family on the same RNN at hidden 60 (3,841 parameters), a
    size the JAX package routes to its streaming dense kernel (K12, whose
    first launch is K3's);
  - `all_preconditioners`: the tensor decomposition (400 parameters) under
    each of the seven families, 100 steps each, every one to a loss below
    a tenth of its first (K15 for splu, K11 for dense, K13 for lra, K1 for
    kron, no kernel for diag, xmat and shift);
  - the sparse-LU family on the NMT model at the reference widths (rank
    10, FD Hvp, lr 0.02), 10 steps, past K15's cap (K16); then K16, the
    fused apply entry and the one-launch kernel on that run's last state
    and probes;
  - the NMT workload's corpus mode, `nmt_attention.run(data_path=...)`,
    at the reference widths (embed 256, units 1024) on an 8,000-line
    corpus in the spa-eng format written from a seed (Zipf-drawn words
    over 9,400 Spanish and 4,900 English forms, both fitted vocabularies
    past 512 words): one epoch of 100 steps (K10 x3, K6 x3, K2, K3), then
    20 of its steps with the kernels and under `disabled()`, the first 3
    losses held within 5e-4;
  - LeNet5 on MNIST-sized IDX files (60,000 + 10,000 images rendered
    from `synthetic_hard`, the train files gzipped): the native decoder
    built with g++ and held against the Python decode, then
    `mnist_lenet5.run(data_dir=...)`, 50 steps (K1, K3);
  - checkpoint resume on the card (`utils.checkpoint`): 5 steps, save,
    restore into a fresh init on the card, 5 more, against 10
    uninterrupted steps, for LeNet5 under kron (K1, K3; its convolutions
    with cuDNN's deterministic algorithms, the default's spread printed)
    and the K4 path's NMT model (K4);
  - the CLI: `python -m psgd_tf_tpu_torch list`, and `run hello_psgd
    --set steps=120` on the card (K11) through `runpy`, as `-m` runs it;
  - the CLI's `bench` (`psgd_tf_tpu_torch.bench`) in-process, every row at
    a short chain of two and one rep: the flat families at the JAX bench's
    n (K13, K15, K16, K12 with its K3; none for diag, xmat, shift and the
    bf16 lra state), the kron envelope (K9, K6, K7, K10), the toy NMT step
    (K1), the reference NMT's phases (K10 x3, K6 x3, K2, K3) and LeNet5
    (K1, K3); each row's launches a chained iteration, its figures, and
    the headline line's form;
  - S1: K14 (the lane-sharded lra update + apply) on a one-rank NCCL
    group at n = 2^20, r = 10, pipelined off and on, against its plain
    chain and K13, timed beside both and its bound (the kernel line's K14
    time), at r = 64 the same beside phase 8d's K13, and the sharded K16
    there against K16's fused apply, each timed;
  - S2, two gloo ranks sharing the card (spawned; NCCL refuses two ranks
    on one device): K14 at n = 2^20 and 1,000,003 and the sharded K16 at
    2^20 and 100,003, r = 10, gathered and held against the single-process
    kernels; under gloo, all_reduce takes the CUDA tensors, and only the
    ring's send/recv hops stage their payload through host memory;
  - S3, the sharded step (`parallel.build_sharded_step`) on those ranks:
    the NMT model at the reference widths on mesh (data=1, shard=2) under
    lra (10 steps: K14) and splu (5 steps: the sharded K16), each against
    the same run in one process; then the toy NMT workload on
    (data=2, shard=1), 20 steps against `run()` (K1, the batch over data);
  - S4, tensor-parallel parameters (`build_sharded_step(param_specs=...)`)
    on those ranks: the same model with its embeddings and RNN weights
    split over shard (7,345,408 of its parameters; each rank holds and
    returns its slices), under kron with the hand formats (K10 x3, K6 x3,
    K2, K3 a step on each rank) and lra (K14), 10 steps each, against the
    same steps in one process; the payload of the collectives per step by
    axis beside `overlap.comm_model`'s, and steps/s with the split and
    without it;
  - S5, parameters split over `data`, alone or with `shard`, on four gloo
    ranks sharing the card, mesh (data=2, shard=2): the same model with
    every spec form (`("data", "shard")`, `(None, ("data", "shard"))`,
    `("data", None)`, `(None, ("shard", "data"))`, `(None, "data")`:
    7,365,888 parameters split), batch 64 as 32 a data rank, under kron
    with the hand formats (K10 x3, K6 x3, K2, K3 a step on each rank) and
    lra (K14), 10 steps each, against the same steps in one process; the
    returned blocks, the same losses on all four ranks, the bytes each
    rank receives a step by axis beside `overlap.comm_model`'s and the
    port's own arithmetic, the bytes of parameters a rank holds, steps/s.

It exits non-zero, printing no result, when there is no CUDA device or any
phase fails. TF32 is off for matmuls and convolutions, so every comparison
is in full fp32.

Output: one line per phase; then a JSON line with every ported kernel
(launches on the paths, max abs error against the plain version, ms per
call with the kernel and with the plain version, the bound: the least time
the card could take for the same work, the larger of its bytes over
3.35 TB/s and its FLOPs over the 67 TFLOP/s fp32 peak, with which one
bounds it, and the time of one PyTorch call computing the same function
where there is one); then the card's name and power limit; then, last, the
line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

LENET_STEPS = 200
WARMUP = 20
NMT_REF_STEPS = 30
NMT_REF_WARMUP = 5
LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
TOL_K3 = 1e-5    # max |X - X_plain| / max |X_plain|: both exact fp32 inverses
K3_RAGGED = [1, 31, 33, 255, 257, 513, 1025]  # sides past, at and short of K3's 32-row leaves
TOL_K1 = 1e-4    # one update: GEMM sums in other orders, explicit inverse vs trsm
TOL_TRAJ = 5e-4  # 20 chained updates: ROADMAP's trajectory bound
# the tensor decomposition's n, the RNN's, and bench.py:610
LRA_SIZES = [400, 1021, 1 << 20]
# hello_psgd's n, the tensor decomposition's (three full 128-row panels and
# a 16-row one), the RNN's, dense_upd.MAX_N
DENSE_K11 = [2, 400, 1021, 1536]
# the dense RNN's n (hidden 60: 30 full 128-row panels and a one-row
# panel), then bench.py:617-619
DENSE_K12 = [3841, 4096, 8192, 16384]
# one row, one full block (K11's one-block grid), one row past it
DENSE_EDGE = [1, 128, 129]
COINS = [(False, False), (False, True), (True, False), (True, True)]  # (balance, update_u)
RNN_MAX_ITERS = 20000
UVD_STEPS = 200
DENSE_RNN_STEPS = 50
SPLU_K15 = [400, 1 << 16]        # the tensor decomposition's n, and bench.py:615
SPLU_K16 = [100_003, 1 << 20]    # a ragged n past K15's cap, and bench.py:616
SPLU_NMT_STEPS = 10
# K16 at ragged n on both sides of the rank-32 kernels' staged tiles (odd
# n: each row of Lt and U12 starts at each 16-byte alignment in turn)
SPLU_RAGGED = [(100_001, 1), (100_001, 3), (131_071, 32), (100_002, 33)]
# the fused apply entry and the one-launch kernel (phase 8c): K15's n,
# bench.py's 65,536 and 2^20 and a ragged n at r = 10, then r = 1 and 32
SPLU_APPLY = [(400, 10), (1 << 16, 10), (100_003, 10), (1 << 20, 10), (100_003, 1),
              (100_003, 32), (100_003, 64), (6_000, 256)]
# K15's A/B (phase 8b): bench.py:615's n, the tensor decomposition's and
# past rank 32, update + apply under each schedule of the one launch
K15_AB = [(400, 10), (1 << 16, 10), (400, 64)]
K9_BENCH = (131072, 512)        # bench.py:678-683, the kron_nd row
K9_MIRROR = (700, 1500)         # a (dense, norm) layer: K9 gets dX^T
# (format, shape, counter): bench.py's kron_ns_wide row, a ragged mirrored
# layer, and a ragged width past WIDE2_MAX_LANES
WIDE_NS = [(("norm", "scale"), (512, 1_000_000), "kron_sparse_big_ns_wide2"),
           (("scale", "norm"), (140_001, 70), "kron_sparse_big_ns_wide2"),
           (("norm", "scale"), (64, 3_000_017), "kron_sparse_big_ns_wide_xla")]
ENVELOPE_STEPS = 5
# K6 and K10 beside the NMT layers (phase 6): a mirrored (scale, norm) layer
# (the decoder RNN's, transposed: K6 reads dX^T), n % 4 = 1, arrows and a
# dense side of two rows, a ragged mirrored K10 layer
STREAM_EDGE = [(("scale", "norm"), (1024, 2305)), (("norm", "scale"), (700, 1029)),
               (("norm", "scale"), (2, 5000)), (("dense", "scale"), (2, 5000)),
               (("scale", "dense"), (4097, 130))]
# K4's stacks: the ragged bucket of tests/test_kron_batched.py, the JAX
# package's crossover stacks (psgd_tf_tpu/optim/psgd.py:113-120), four
# layers at the side cap, and BERT-base's query, key, value and attention
# output layers, 12 of each (K1 unbatched takes them in three chains)
K4_BUCKETS = [("ragged", [(26, 6), (121, 84), (85, 10), (100, 128)]),
              ("B=6 (200, 256)", [(200, 256)] * 6), ("B=24 (200, 256)", [(200, 256)] * 24),
              ("B=4 (1000, 1000)", [(1000, 1000)] * 4), ("B=48 (768, 768)", [(768, 768)] * 48)]
# the NMT model at the widths where its four (dense, dense) layers share a
# (128, 128) bucket under PSGD's defaults (tests/test_torch_nmt.py's config)
K4_NMT = dict(vocab_src=1100, vocab_tgt=1030, embed=16, units=32)
K4_PATH_STEPS = 30
LSTM_TRACE_STEPS = 20
LSTM_STEPS = 50
BF16_STEPS = 20
# the sharded phases: K14 at bench.py:610's n and a ragged one, the sharded
# K16 at bench.py:616's n and a ragged one, r = 10; the sharded step at the
# reference widths on mesh (data=1, shard=2); the toy NMT workload on
# (data=2, shard=1)
SHARD_LRA = [1 << 20, 1_000_003]
SHARD_SPLU = [1 << 20, 100_003]
SHARD_LRA_STEPS = 10
SHARD_SPLU_STEPS = 5
SHARD_NMT_STEPS = 20
# the sharded step's last state against one process's, per family
SHARD_FIELDS = {"lra": ("UV", "d"), "splu": ("Lt", "l3", "U12", "u3")}
TOL_SHARD_NMT = 5e-4
# S4, tensor-parallel parameters on the same ranks: the reference NMT's
# embeddings and RNN weights split over `shard` (7,345,408 of its 12,424,273
# parameters); attention and the fc (1025, 4935), which shard = 2 divides
# on neither side, replicate. kron (the hand formats) and lra, rank 10
TP_SPECS = [("shard", None), (None, "shard"), None, None, (None, "shard"), (None, "shard"), None]
TP_STEPS = 10
TP_FIELDS = {"kron": ("ql", "qr"), "lra": ("UV", "d")}
# the launches a tensor-parallel step makes on each rank, per family
TP_PER_STEP = {"kron": {"kron_sparse_big_ds": 3, "kron_sparse_big_ns": 3, "kron_dd": 1},
               "lra": {"lra_upd_sharded": 1}}
# S5, parameters split over `data`, alone or with `shard`, on four gloo ranks
# sharing the card, mesh (data=2, shard=2): the reference NMT with every spec
# form (7,365,888 of its 12,424,273 parameters split; the attention output
# and the fc, which 4 divides on neither side, replicate), batch 64 split
# 32 / 32 over data; kron (the hand formats) and lra, rank 10. The layer
# order of `models/nmt.py`: encoder embedding, encoder RNN, attention in and
# out, decoder embedding, decoder RNN, fc
S5_SPECS = [("data", "shard"), (None, ("data", "shard")), ("data", None), None,
            (None, ("shard", "data")), (None, "data"), None]
S5_MESH = {"data": 2, "shard": 2}
S5_STEPS = 10
WORKER_TIMEOUT = 600
# the unrouted Kronecker kernels (K17-K20) beyond the paths' shapes: the
# (norm, scale) apply at bench.py's (65536, 8192) kron_ns row, the wide
# apply at (512, 10^6), past 2^21 lanes and at a ragged shape; the solve at
# the JAX package's test cases (tests/test_pallas.py:19-30; nrhs 0 is a
# 1-D b) and at a size past its cap; K20 on 18 layers (two chains)
APPLY_NS_BENCH = (65536, 8192)
APPLY_WIDE = [(512, 1_000_000), (64, 3_000_017), (70, 140_000)]
SOLVE_JAX = [(128, 128, False, True), (300, 64, False, True), (512, 256, False, False),
             (257, 0, True, False), (640, 200, True, True)]
SOLVE_BENCH = (2048, 512, False, False)
MULTI_18 = LENET5 * 3 + [(1, 10), (300, 7), (64, 64)]
# past the rank-32 kernels (phase 8d): lra (K13) at a ragged n of several
# Gram chunks, splu at the tensor decomposition's n (K15) and the same
# ragged n past K15's cap (K16), and PSGD on the tensor decomposition (lra,
# and splu through K15) and on LeNet5 (splu through K16), at each rank; K13 and K16 timed at bench.py:610/616's n; the reference-width
# NMT under lra and splu at one rank (phase 17b)
RANKS_PAST_32 = [33, 64, 128, 256]
RANK_N = 100_003
RANK_BENCH = (1 << 20, 64)
RANK_DECOMP_STEPS = 20
NMT_RANK = 64
NMT_RANK_STEPS = 5
# the staged-data paths (phases 17c-17f): a spa-eng-format corpus of 8,000
# lines (one epoch of 100 steps at batch 64), a loss trace of 20 of its steps
# each way, LeNet5 on MNIST-sized IDX files
STAGED_NMT_LINES = 8000
STAGED_NMT_TRACE = 20
IDX_STEPS = 50
# the CLI's `bench` (phase 17g): every row's short chain
BENCH_ITERS = 2
# the NMT model's attention kernels (`ops/hopper/attention.py`, phase 10f):
# (B, S, U, A, T) at toy widths (float4 rows), a ragged U at the A limit
# (float rows) and the benchmark cells' shapes, the last one timed
ATTN_SHAPES = [(6, 7, 16, 4, 5), (5, 9, 13, 32, 3), (4096, 18, 1024, 10, 12)]
TOL_ATTN = 1e-4  # fp32 sums of S, U and B x S terms in other orders
# Granite-4.0-H Micro at its published widths, its first ten layers (phase
# 10g: the benchmark cell granite_h_kron.seq2k's leaves and step, 2 x 2,048
# tokens). Per step under the hand formats: K6 on its 41 (norm, scale)
# leaves, K10 (each with its K3) on its 50 (scale, dense) ones, one K4 chain
# (with its stacked K3) on the bucket of its 27 (64, 1) per-head vectors
GRANITE_LAYERS = 10
GRANITE_TOKENS = (2, 2048)
GRANITE_PER_STEP = {"kron_sparse_big_ns": 41, "kron_sparse_big_ds": 50, "kron_dd_batched": 1,
                    "tri": 51}


def _attn_launches(positions: int, passes: int) -> dict:
    """The attention kernels' launches of `passes` gradient passes of the
    NMT model over `positions` decoder positions: a forward and a backward
    a position, the encoder states' gradient once a pass (none under the
    exact Hvp, whose jvp takes the plain ops)."""
    return {"attn_fwd": positions * passes, "attn_bwd": positions * passes,
            "attn_enc_grad": passes}


def attention_phase(torch, dev, check) -> dict:
    """Phase 10f: the attention's three launches against their plain
    versions at ATTN_SHAPES (masked tails, d ctx as a slice of a wider
    gradient, as `torch.cat`'s backward gives it), each rerun bit for bit,
    then timed chained at the cells' shape beside its plain version and its
    bound. Returns {counter: (max abs err, ms, plain ms, (bound ms, by))}."""
    from psgd_tf_tpu_torch.bench import _bound
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import attention

    g = torch.Generator(device=dev).manual_seed(29)
    errs = {"attn_fwd": 0.0, "attn_bwd": 0.0, "attn_enc_grad": 0.0}
    for b, s, u, a, t in ATTN_SHAPES:
        r = lambda *shape: torch.randn(shape, generator=g, device=dev)
        enc, hw, ow, v = r(b, s, u), r(b, a), r(b, s, a), r(a)
        mask = torch.ones(b, s, dtype=torch.bool, device=dev)
        for row in range(0, b, 3):
            mask[row, max(1, s - 1 - row % s):] = False
        dctx = r(b, 2 * u + 8)[:, :u]
        weights, dctxs, d_ow, w_enc = torch.softmax(r(b, t, s), 2), r(b, t, u), r(b, s, a), r(u, a)
        slot, out = torch.empty(b, t, s, device=dev)[:, 1], torch.empty(b, t, u, device=dev)[:, 2]
        before = dict(hopper.counts)
        ctx = attention.attend(hw, ow, v, mask, enc, slot)
        bwd = attention.attend_backward(dctx, enc, slot, hw, ow, v, mask, out)
        d_enc = attention.enc_grad(weights, dctxs, d_ow, w_enc)
        bwd2 = attention.attend_backward(dctx, enc, slot, hw, ow, v, mask, out)
        d_enc2 = attention.enc_grad(weights, dctxs, d_ow, w_enc)
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in hopper.counts.items() if n != before[k]}
        ref_ctx, ref_w = attention.attend_plain(hw, ow, v, mask, enc)
        ref_bwd = attention.attend_backward_plain(dctx, enc, slot, hw, ow, v, mask)
        ref_enc = attention.enc_grad_plain(weights, dctxs, d_ow, w_enc)
        rel = max(_rel(ctx, ref_ctx), _rel(slot, ref_w), *(_rel(x, y) for x, y in zip(bwd, ref_bwd)),
                  _rel(d_enc, ref_enc))
        errs["attn_fwd"] = max(errs["attn_fwd"], _abs(ctx, ref_ctx), _abs(slot, ref_w))
        errs["attn_bwd"] = max(errs["attn_bwd"], *(_abs(x, y) for x, y in zip(bwd, ref_bwd)))
        errs["attn_enc_grad"] = max(errs["attn_enc_grad"], _abs(d_enc, ref_enc))
        same = all(torch.equal(x, y) for x, y in zip(bwd, bwd2)) and torch.equal(d_enc, d_enc2)
        print(f"attention: (B, S, U, A, T) = {(b, s, u, a, t)}: max rel err {rel:.3e} (tol "
              f"{TOL_ATTN:.0e}), d ctx stashed exactly {torch.equal(out, dctx)}, reruns bit-equal "
              f"{same}", flush=True)
        check(rel < TOL_ATTN and same and torch.equal(out, dctx)
              and moved == {"attn_fwd": 1, "attn_bwd": 2, "attn_enc_grad": 2},
              f"attention kernels vs plain at {(b, s, u, a, t)}")
    # timed at the cells' shape (the last case's operands); the bound
    # counts each input read once and each output written once
    f4 = 4
    rows = {
        "attn_fwd": (lambda: attention.attend(hw, ow, v, mask, enc, slot),
                     lambda: attention.attend_plain(hw, ow, v, mask, enc),
                     f4 * (b * s * u + 2 * b * s * a + b * a + b * u + 2 * b * s) + b * s,
                     2 * b * s * u + 4 * b * s * a),
        "attn_bwd": (lambda: attention.attend_backward(dctx, enc, slot, hw, ow, v, mask, out),
                     lambda: attention.attend_backward_plain(dctx, enc, slot, hw, ow, v, mask),
                     f4 * (b * s * u + 2 * b * u + 2 * b * s * a + 2 * b * a + b * s) + b * s,
                     2 * b * s * u + 8 * b * s * a),
        "attn_enc_grad": (lambda: attention.enc_grad(weights, dctxs, d_ow, w_enc),
                          lambda: attention.enc_grad_plain(weights, dctxs, d_ow, w_enc),
                          f4 * (b * t * u + b * t * s + b * s * a + u * a + b * s * u),
                          2 * b * s * u * (t + a)),
    }
    result = {}
    for name, (kernel, plain, nbytes, flops) in rows.items():
        ms, plain_ms = _time(torch, kernel, 50), _time(torch, plain, 20)
        bound = _bound(nbytes, flops)
        result[name] = (errs[name], ms, plain_ms, bound)
        print(f"attention time at the cells' shape {ATTN_SHAPES[-1]}: {name} {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
              f"{nbytes / ms / 1e9:.0f} GB/s", flush=True)
    return result


def granite_phase(torch, dev, check) -> dict:
    """Phase 10g: Granite-4.0-H Micro's Kronecker updates at its own
    leaves. K6 at each distinct (norm, scale) leaf shape, K10 at each
    (scale, dense) one (mirrored: K10 gets dX^T), each one call from a
    state walked off 0.8 I against the plain update, the counters it moves,
    a second call bit-equal; K4 on the 27 (64, 1) vectors' bucket, padded
    to a (128, 128) stack, likewise, the padding exact identity. Then one
    `PSGD.step` of the cell's ten layers (FD Hvp, the cell's lr and clip)
    with the counters zeroed just before: GRANITE_PER_STEP's launches and
    no other, PSGD's one bucket of the 27 vectors, and the same step's
    Q update, apply and descent replayed plain on the step's own loss,
    gradient and Hvp. Returns the step's launches."""
    from psgd_tf_tpu_torch import PSGD, hvp, kron
    from psgd_tf_tpu_torch.models import granite_hybrid as gh
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.optim.psgd import KronPrecond

    DD = ("dense", "dense")
    cfg = gh.micro_config(GRANITE_LAYERS)
    shapes, fmts = gh.layer_shapes(cfg), gh.kron_formats(cfg)
    g = torch.Generator(device=dev).manual_seed(27)

    def probes(ss):
        return ([torch.randn(s, generator=g, device=dev) for s in ss],
                [torch.randn(s, generator=g, device=dev) for s in ss])

    def moved_since(before):
        torch.cuda.synchronize()
        return {k: n - before[k] for k, n in hopper.counts.items() if n != before[k]}

    for fmt, shape in sorted({(f, s) for f, s in zip(fmts, shapes) if f != DD}):
        ns = "norm" in fmt
        name = "kron_sparse_big_ns" if ns else "kron_sparse_big_ds"
        want = {name: 1} if ns else {name: 1, "tri": 1}
        route = "kron_sparse_big:ns" if ns else "kron_sparse_big:ds"
        check(kron.route(fmt, shape, dev) == route, f"granite {name} route at {fmt} {shape}")
        st = kron.init(shape, fmt=fmt, init_scale=0.8, device=dev)
        with hopper.disabled():
            for _ in range(2):
                (dx,), (dg,) = probes([shape])
                st = kron.update(st, dx, dg, step=0.1)
        (dx,), (dg,) = probes([shape])
        before = dict(hopper.counts)
        got = kron.update(st, dx, dg, step=0.1)
        moved = moved_since(before)
        with hopper.disabled():
            ref = kron.update(st, dx, dg, step=0.1)
        rel = max(_rel(got.ql, ref.ql), _rel(got.qr, ref.qr))
        again = kron.update(st, dx, dg, step=0.1)
        same = torch.equal(again.ql, got.ql) and torch.equal(again.qr, got.qr)
        finite = bool(torch.isfinite(got.ql).all() and torch.isfinite(got.qr).all())
        print(f"granite {name}: {fmt} {shape} max rel err {rel:.3e} (tol {TOL_K1:.0e}), launches "
              f"{moved}, bit-equal again {same}, finite {finite}", flush=True)
        check(moved == want and rel < TOL_K1 and finite, f"granite {name} vs plain at {shape}")
        check(same, f"granite {name} two calls bit-equal at {shape}")
        del st, dx, dg, got, ref, again
    torch.cuda.empty_cache()

    bucket = [s for f, s in zip(fmts, shapes) if f == DD]
    check(bucket == [(cfg.ssm_heads, 1)] * 27, f"granite: 27 (64, 1) vectors in (dense, dense)")
    bst = kron.init_batched(bucket, init_scale=0.8, device=dev)
    with hopper.disabled():
        for _ in range(3):
            bst = kron.update_batched(bst, *probes(bucket), step=0.1)
    dxs, dgs = probes(bucket)
    before = dict(hopper.counts)
    got = kron.update_batched(bst, dxs, dgs, step=0.1)
    moved = moved_since(before)
    with hopper.disabled():
        ref = kron.update_batched(bst, dxs, dgs, step=0.1)
    rel = max(_rel(got.ql, ref.ql), _rel(got.qr, ref.qr))
    again = kron.update_batched(bst, dxs, dgs, step=0.1)
    same = torch.equal(again.ql, got.ql) and torch.equal(again.qr, got.qr)
    exact = True
    for q, d in ((got.ql, cfg.ssm_heads), (got.qr, 1)):
        want = torch.eye(q.shape[1], device=dev).expand(q.shape[0], -1, -1).clone()
        want[:, :d, :d] = q[:, :d, :d]
        exact = exact and torch.equal(q, want)
    print(f"granite kron_dd_batched: 27 x {bucket[0]}, stacks {tuple(got.ql.shape)} "
          f"{tuple(got.qr.shape)}, max rel err {rel:.3e} (tol {TOL_K1:.0e}), launches {moved}, "
          f"padding exact {exact}, bit-equal again {same}", flush=True)
    check(tuple(got.ql.shape) == tuple(got.qr.shape) == (27, 128, 128),
          "granite K4: a (128, 128) stack of 27")
    check(moved == {"kron_dd_batched": 1, "tri": 1} and rel < TOL_K1 and exact,
          "granite K4 vs plain on the 27 vectors' bucket")
    check(same, "granite K4 two calls bit-equal")
    del bst, got, ref, again

    # the step: the cell's optimizer settings, fixed probes, random ids
    params = gh.init(g, cfg)
    opt = PSGD(preconditioner="kron", lr_params=0.02, lr_preconditioner=0.02,
               grad_clip_max_norm=1.0, exact_hessian_vector_product=False,
               preconditioner_update_probability=1.0, kron_formats=fmts)
    state = opt.init(params)
    pc = state.precond
    heads = [i for i, s in enumerate(shapes) if s == (cfg.ssm_heads, 1)]
    layout = (pc.batched_idx, pc.single_idx) if isinstance(pc, KronPrecond) else None
    check(layout is not None and [list(b) for b in layout[0]] == [heads]
          and sorted(layout[1]) == sorted(set(range(len(shapes))) - set(heads)),
          f"granite PSGD: one bucket of the 27 vectors, {len(shapes) - 27} single factors")
    tokens = torch.randint(0, cfg.vocab, GRANITE_TOKENS, generator=g, device=dev)
    v = [torch.randn(s, generator=g, device=dev) for s in shapes]
    loss_fn = lambda p, t: gh.loss(p, t, cfg)
    seen = {}
    fd = hvp.finite_diff

    def captured(*a, **k):
        seen["out"] = fd(*a, **k)
        return seen["out"]

    torch.cuda.synchronize()
    hopper.reset_counts()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    hvp.finite_diff = captured
    try:
        ev0.record()
        new, new_state, aux = opt.step(loss_fn, params, state, None, tokens, probes=v)
        ev1.record()
    finally:
        hvp.finite_diff = fd
    torch.cuda.synchronize()
    counts = dict(hopper.counts)
    step_ms = ev0.elapsed_time(ev1)
    change = [a - b for a, b in zip(new, params)]
    del new
    # the same step's Q update, apply and descent, plain, on its own (loss, g, Hv)
    hvp.finite_diff = lambda *a, **k: seen["out"]
    try:
        with hopper.disabled():
            plain, plain_state, plain_aux = opt.step(loss_fn, params, state, None, tokens,
                                                     probes=v)
    finally:
        hvp.finite_diff = fd
    q_rel = 0.0
    for a, b in zip([*new_state.precond.batches, *new_state.precond.singles],
                    [*plain_state.precond.batches, *plain_state.precond.singles]):
        q_rel = max(q_rel, _rel(a.ql, b.ql), _rel(a.qr, b.qr))
    # each leaf's change against the plain step's: the update's own error
    # (TOL_K1 of the leaf's largest change) and, since each side rounds p - u
    # to fp32, a spacing of fp32 at the leaf's largest |p| (two roundings of
    # half a spacing; the norm weights, dt_bias, A_log and D sit at 1-4 and
    # move by ~1e-6 a step)
    eps = torch.finfo(torch.float32).eps
    worst, worst_leaf = 0.0, None
    for name, c, p, q in zip(gh.leaf_names(cfg), change, plain, params):
        d = p - q
        ratio = ((c - d).abs().max() / (TOL_K1 * d.abs().max() + eps * q.abs().max())).item()
        if ratio >= worst:
            worst, worst_leaf = ratio, (name, _rel(c, d))
    finite = all(bool(torch.isfinite(c).all()) for c in change)
    print(f"granite step: {GRANITE_LAYERS} layers, {sum(math.prod(s) for s in shapes):,} "
          f"parameters, tokens {GRANITE_TOKENS}, loss {aux['loss'].item():.4f}, {step_ms:.1f} ms "
          f"(the first step), launches {({k: c for k, c in counts.items() if c})}; replayed "
          f"plain: Q max rel err {q_rel:.3e} (tol {TOL_K1:.0e}), the changes' gap at most "
          f"{worst:.3f} of TOL_K1 of a leaf's change plus a spacing of fp32 at its largest |p| "
          f"({worst_leaf[0]}, {worst_leaf[1]:.3e} of its change), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    check(counts == {k: GRANITE_PER_STEP.get(k, 0) for k in counts},
          f"granite step: launches {GRANITE_PER_STEP} and no other")
    check(q_rel < TOL_K1 and worst <= 1.0 and finite
          and plain_aux["loss"].item() == aux["loss"].item(),
          "granite step vs the same step plain")
    del params, state, change, plain, new_state, plain_state, seen, v
    torch.cuda.empty_cache()
    return counts


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _abs(a, b) -> float:
    return (a - b).abs().max().item()


def _time(torch, fn, reps):
    """ms per call of fn() from CUDA events over `reps` chained calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _time_median(torch, fn, reps, windows=3):
    """The median of `windows` `_time` windows: the small chains' chained
    time is set by the host, which drifts between windows."""
    return sorted(_time(torch, fn, reps) for _ in range(windows))[windows // 2]


def _host_ms(torch, fn, reps):
    """ms of host time per call of fn(): the host clock around `reps`
    calls with no synchronise between them (what the caller waits for
    before its next enqueue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _time_queued(torch, fn, reps):
    """Device ms per call of fn(): `reps` calls enqueued behind a spinning
    kernel (~20 ms), the events recorded after it, so the card runs them
    back to back whatever the host's enqueue costs."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _time_ab(torch, hopper, fn, reps):
    """ms per call of fn() with the kernels and under hopper.disabled(),
    in turns plain, kernel, kernel, plain."""
    ms = {"kernel": [], "plain": []}
    for mode in ("plain", "kernel", "kernel", "plain"):
        if mode == "plain":
            with hopper.disabled():
                ms[mode].append(_time(torch, fn, reps))
        else:
            ms[mode].append(_time(torch, fn, reps))
    return sum(ms["kernel"]) / 2, sum(ms["plain"]) / 2


def _flat_tensors(out):
    """The tensors of an update's result (KronStates, a stacked state,
    tuples and lists of factors), flattened in order."""
    if hasattr(out, "ql"):
        return [out.ql, out.qr]
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _flat_tensors(x)]
    return [out]


def _chain_list(kron, fmts, shapes):
    """(kinds, m, n) of a layer list as K1's chain takes it: mirrors
    transposed into their sibling."""
    kinds, ms, ns = [], [], []
    for fmt, (m, n) in zip(fmts, shapes):
        kind, mirrored = kron._canon(fmt)
        kinds.append(kind)
        ms.append(n if mirrored else m)
        ns.append(m if mirrored else n)
    return kinds, ms, ns


def _state_errs(got, ref):
    """(max relative, max absolute) difference over a list of KronStates."""
    pairs = [(a.ql, b.ql) for a, b in zip(got, ref, strict=True)]
    pairs += [(a.qr, b.qr) for a, b in zip(got, ref, strict=True)]
    return max(_rel(a, b) for a, b in pairs), max(_abs(a, b) for a, b in pairs)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _worker_entry(job, rank, world, port, args, results):
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        try:
            results.put((rank, "ok", job(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _spawn(job, world, *args):
    """[job(rank, world, *args) for each rank] from `world` spawned gloo
    ranks sharing card 0. A rank that raises, dies or outlives
    WORKER_TIMEOUT raises here; every process is stopped before return."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker_entry, args=(job, r, world, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + WORKER_TIMEOUT
    try:
        while len(out) + len(errors) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job.__name__}: ranks did not finish in {WORKER_TIMEOUT} s")
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and results.empty():
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError(f"{job.__name__}: a rank died "
                                           f"{[p.exitcode for p in procs]}")
                continue
            (out.__setitem__(rank, value) if status == "ok"
             else errors.append(f"rank {rank}:\n{value}"))
        if errors:
            raise RuntimeError(f"{job.__name__} failed:\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def _nmt_ref_run(fam, steps, mesh=None, rank=10, specs=None, around=contextlib.nullcontext):
    """`steps` steps of the NMT model at the reference widths under `fam`
    (rank 10 unless given; kron with the reference's hand formats), FD Hvp,
    random ids, batch 64, lr 0.02, clip 1.0, from seed 0:
    with a mesh through `build_sharded_step` (with `specs` as its
    tensor-parallel `param_specs`: the step takes and returns this rank's
    slices), else `PSGD.step` on card 0; `around()` is a context entered
    for the steps alone.
    Returns (losses, the launch counts of the run, steps/s after two, the
    parameters' change over the run as one flat vector, the largest
    |parameter| at the start, the last state: this rank's slice of it with
    a mesh, the shapes of the parameters the last step returned)."""
    import torch

    from psgd_tf_tpu_torch import PSGD
    from psgd_tf_tpu_torch.data import translation
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.parallel import (build_sharded_step, gather_params, shard_params,
                                            shard_state)

    dev = mesh.device if mesh is not None else torch.device("cuda")
    cfg = nmt.ref_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = nmt.init(gen, cfg)
    first = torch.cat([p.flatten() for p in params])
    opt = PSGD(preconditioner=fam, rank=rank, lr_params=0.02, lr_preconditioner=0.02,
               grad_clip_max_norm=1.0, exact_hessian_vector_product=False,
               kron_formats=nmt.kron_formats(cfg))
    state = opt.init(params)
    if mesh is not None:
        step = build_sharded_step(opt, nmt.loss, mesh, state, params, param_specs=specs)
        state = shard_state(mesh, state)
        if specs is not None:
            params = shard_params(mesh, params, specs)
    else:
        step = lambda *a: opt.step(nmt.loss, *a)
    batches = [translation.random_tokens(gen, cfg.vocab_src, cfg.vocab_tgt) for _ in range(steps)]
    losses = []
    torch.cuda.synchronize()
    hopper.reset_counts()
    with around():
        for i, (src, tgt) in enumerate(batches):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            params, state, aux = step(params, state, gen, src, tgt)
            losses.append(aux["loss"])
        torch.cuda.synchronize()
    rate = (steps - 2) / (time.perf_counter() - t0)
    counts = dict(hopper.counts)
    shapes = [tuple(p.shape) for p in params]
    if specs is not None:
        params = gather_params(mesh, params, specs)
    delta = torch.cat([p.flatten() for p in params]) - first
    return ([float(x) for x in losses], counts, rate, delta, first.abs().max().item(), state,
            shapes)


def _spec_axes(spec):
    """Per entry of a tensor-parallel spec, the mesh axes it names."""
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec or ()]


def _block_shapes(shapes, specs, mesh_shape):
    """The block of each leaf that a rank holds under `specs`: each
    dimension divided by the degrees of its entry's axes."""
    out = []
    for shape, spec in zip(shapes, specs):
        shape = list(shape)
        for k, axes in enumerate(_spec_axes(spec)):
            shape[k] //= math.prod(mesh_shape[a] for a in axes)
        out.append(tuple(shape))
    return out


@contextlib.contextmanager
def _counted_collectives(mesh, moved):
    """Inside it `_collectives` counts in `moved`, by axis, the elements this
    rank receives in the gathers of split leaves (`all_gather_dims`, over
    `shard` or `data`) and all-reduces over `data` (`data_mean`, the loss
    aside), and the flat family's rank-space all-reduces and lane gathers
    over `shard`."""
    from psgd_tf_tpu_torch.parallel import _collectives

    real = {k: getattr(_collectives, k) for k in ("all_gather_dims", "data_mean", "psum",
                                                   "pmax", "psum_async", "all_gather_lanes")}

    def counting(name, count):
        def call(*a, **k):
            key, n = count(*a)
            if key is not None:
                moved[key] = moved.get(key, 0) + n
            return real[name](*a, **k)
        return call

    def rank_space(x, grp, *rest):
        # data_mean's own all-reduce over `data` is counted as data_mean
        return ("shard, rank space" if grp is mesh.shard_group else None), x.numel()

    counters = {
        "all_gather_dims": counting("all_gather_dims", lambda xs, dims, grp, size, rk: (
            "shard, split leaves" if grp is mesh.shard_group else "data, split leaves",
            (size - 1) * sum(x.numel() for x in xs))),
        "data_mean": counting("data_mean", lambda m, ts: (
            "data", 0 if m is None or m.data == 1 else sum(t.numel() for t in ts[1:]))),
        "psum": counting("psum", rank_space), "pmax": counting("pmax", rank_space),
        "psum_async": counting("psum_async", rank_space),
        "all_gather_lanes": counting("all_gather_lanes", lambda x, grp, size, rk: (
            "shard, lanes", (size - 1) * x.numel()))}
    for name, fn in counters.items():
        setattr(_collectives, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(_collectives, name, fn)


def _tp_run(rank, mesh, fam, specs, steps):
    """`steps` steps of the reference NMT under `fam` with tensor-parallel
    `specs` on `mesh` (`_nmt_ref_run`), its collectives counted by axis
    (bytes a step and rank, `_counted_collectives`) beside
    `overlap.comm_model`'s; on rank 0 also the same steps in one process
    (the other ranks wait in their next collective meanwhile) and the run's
    distance from it: the parameters' change and the gathered last state.
    Each step rounds p + u to fp32, so the two parameter changes may differ
    by up to a spacing of fp32 at the largest |p| a step."""
    import torch

    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.parallel import overlap, policies

    moved = {}
    losses, counts, rate, delta, p_max, local, shapes = _nmt_ref_run(
        fam, steps, mesh, specs=specs, around=lambda: _counted_collectives(mesh, moved))
    full = policies.gather_state(mesh, local, delta.numel()).precond
    del local
    res = dict(losses=losses, counts=counts, rate=rate, shapes=shapes,
               moved={k: 4 * v / steps for k, v in moved.items()},
               model=overlap.comm_model(fam, rank=10,
                                        param_shapes=nmt.layer_shapes(nmt.ref_config()),
                                        param_specs=specs, mesh_shape=mesh.shape))
    if rank == 0:
        torch.cuda.empty_cache()
        ref_losses, ref_counts, ref_rate, ref_delta, _, ref_state, _ = _nmt_ref_run(fam, steps)
        spacing = 2.0 ** math.ceil(math.log2(p_max)) * torch.finfo(torch.float32).eps
        pairs = (list(zip(full, ref_state.precond)) if fam == "kron"
                 else [(full, ref_state.precond)])
        res.update(ref=(ref_losses, ref_counts, ref_rate), delta_err=_abs(delta, ref_delta),
                   delta_tol=steps * spacing, delta_max=ref_delta.abs().max().item(),
                   state_rel=max(_rel(getattr(a, f), getattr(b, f))
                                 for a, b in pairs for f in TP_FIELDS[fam]))
        del ref_delta, ref_state
    del delta, full
    torch.cuda.empty_cache()
    return res


def _tp_checks(torch, fam, res_ranks, want_shapes, launches):
    """(loss trace max rel diff against one process, launches per rank,
    whether the launches, the trace, the parameters, the state, the losses
    on every rank and the returned blocks are as they must be) of one
    family's `_tp_run` results on every rank; adds their launches to
    `launches`."""
    res = res_ranks[0]
    counts = [r["counts"] for r in res_ranks]
    for c in counts:
        for name, n in c.items():
            launches[name] += n
    trace = _rel(torch.tensor(res["losses"]), torch.tensor(res["ref"][0]))
    steps = len(res["losses"])
    want = {k: n * steps for k, n in TP_PER_STEP[fam].items()}
    ok_launch = all({k: c[k] for k in want} == want for c in counts) and (
        fam != "kron" or all(c == res["ref"][1] for c in counts))
    ok = (ok_launch and max(trace, res["state_rel"]) <= TOL_TRAJ
          and res["delta_err"] <= res["delta_tol"]
          and all(r["losses"] == res["losses"] for r in res_ranks)
          and all(r["shapes"] == want_shapes for r in res_ranks))
    return trace, [{k: v for k, v in c.items() if v} for c in counts], ok


def _s4(rank, mesh, out):
    """S4 on one of the two gloo ranks of `_sharded_job`: the reference NMT
    with TP_SPECS (this rank holds its slices of the split leaves), under
    kron and lra (`_tp_run`), and kron on the mesh without specs (S3 runs
    lra so). Fills out["tp_kron_rep"], out["tp_kron"] and out["tp_lra"]."""
    import torch

    rep = _nmt_ref_run("kron", TP_STEPS, mesh)
    out["tp_kron_rep"] = dict(losses=rep[0], counts=rep[1], rate=rep[2])
    del rep
    torch.cuda.empty_cache()
    for fam in TP_FIELDS:
        out[f"tp_{fam}"] = _tp_run(rank, mesh, fam, TP_SPECS, TP_STEPS)


def _s4_report(torch, ranks, check, launches, smi):
    """Prints S4's results from `_sharded_job`'s ranks, checks them and adds
    their launches to `launches`. With data = 1 a rank's gradient and Hvp
    are already the means: the step gathers the split parameters alone, one
    of the three gathers a split leaf that comm_model charges a mesh with
    data > 1."""
    from psgd_tf_tpu_torch.models import nmt

    r0 = ranks[0]
    for r in ranks:
        for name, n in r["tp_kron_rep"]["counts"].items():
            launches[name] += n
    tp_shapes = _block_shapes(nmt.layer_shapes(nmt.ref_config()), TP_SPECS,
                              {"data": 1, "shard": 2})
    for fam in TP_FIELDS:
        res_ranks = [r[f"tp_{fam}"] for r in ranks]
        res = res_ranks[0]
        losses, ref, model, moved = res["losses"], res["ref"], res["model"], res["moved"]
        trace, counts, ok = _tp_checks(torch, fam, res_ranks, tp_shapes, launches)
        no_tp = r0["tp_kron_rep"]["rate"] if fam == "kron" else r0["nmt_lra"]["rate"]
        split_bytes = model["tp_gather_bytes_per_step"] / 3
        print(f"s4: NMT reference widths, {fam}, {len(TP_SPECS) - TP_SPECS.count(None)} of 7 "
              f"leaves split over shard ({model['n_params']} parameters; each rank holds "
              f"{sum(math.prod(s) for s, sp in zip(tp_shapes, TP_SPECS) if sp)} elements of the "
              f"split ones), mesh (data=1, shard=2), {TP_STEPS} steps: "
              f"launches per rank {counts}; "
              f"returned slices {res['shapes']}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"against one process: loss trace max rel diff {trace:.3e}, {fam} state max rel "
              f"diff {res['state_rel']:.3e} (tol {TOL_TRAJ:.0e} each), parameter change max abs "
              f"diff {res['delta_err']:.3e} (tol {res['delta_tol']:.3e}; the largest change "
              f"{res['delta_max']:.3e})", flush=True)
        print(f"s4: {fam} payload per step and rank, bytes: {moved}; comm_model "
              f"(data=1, shard=2): dp_bytes_per_step "
              f"{model['dp_bytes_per_step']}, tp_gather_bytes_per_step "
              f"{model['tp_gather_bytes_per_step']} (the parameters' gather alone "
              f"{split_bytes:.0f}), shard_bytes_per_step {model['shard_bytes_per_step']}; "
              f"{res['rate']:.2f} steps/s with TP, {no_tp:.2f} on the same mesh without "
              f"({'the replicated kron run' if fam == 'kron' else 'S3'}), {ref[2]:.2f} in one "
              f"process; {smi}", flush=True)
        if fam == "kron":
            rep_trace = _rel(torch.tensor(r0["tp_kron_rep"]["losses"]), torch.tensor(ref[0]))
            print(f"s4: kron on the same mesh without specs: loss trace max rel diff against "
                  f"one process {rep_trace:.3e} (tol {TOL_TRAJ:.0e})", flush=True)
            check(rep_trace <= TOL_TRAJ and all(r["tp_kron_rep"]["counts"] == ref[1]
                                                for r in ranks),
                  "s4: the replicated kron step on the mesh: its launches and trace")
        check(ok and moved.get("shard, split leaves") == split_bytes and not moved.get("data"),
              f"s4: the TP {fam} step: its launches on each rank ({TP_PER_STEP[fam]} a step, "
              f"as in one process), the trace, the parameters and the state as in one "
              f"process, the returned slices and one gather of the split parameters a step")


def _s5_job(rank, world):
    """S5 on one of four gloo ranks sharing the card: the reference NMT with
    S5_SPECS on mesh (data=2, shard=2) under kron and lra (`_tp_run`)."""
    from psgd_tf_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=S5_MESH["data"], shard=S5_MESH["shard"], device="cuda:0")
    out = {"backend": mesh.backend, "coords": (mesh.data_rank, mesh.shard_rank)}
    for fam in TP_FIELDS:
        out[fam] = _tp_run(rank, mesh, fam, S5_SPECS, S5_STEPS)
    return out


def _s5_payload(shapes, specs, mesh_shape):
    """The elements a rank receives a step, by axis, as the port's
    collectives move them: the all-reduce over `data` carries of each
    gradient and Hvp the part its data group holds (a leaf's block, times
    the `data` degree where `data` splits it); the gathers over `shard`
    receive (shard - 1) blocks of each parameter that names `shard` and
    (shard - 1) parts of its gradient and Hvp; the gather over `data` the
    parameters' remaining (data - 1) parts (a block, times the `shard`
    degree where `shard` splits it too)."""
    D, S = mesh_shape["data"], mesh_shape["shard"]
    out = {"data": 0, "shard, split leaves": 0, "data, split leaves": 0}
    for block, spec in zip(_block_shapes(shapes, specs, mesh_shape), specs):
        names = {a for axes in _spec_axes(spec) for a in axes}
        n = math.prod(block)
        part = n * (D if "data" in names else 1)
        out["data"] += 2 * part if D > 1 else 0
        if "shard" in names:
            out["shard, split leaves"] += (S - 1) * (n + (2 * part if D > 1 else 0))
        if "data" in names:
            out["data, split leaves"] += (D - 1) * n * (S if "shard" in names else 1)
    return {k: v for k, v in out.items() if v}


def _s5_report(torch, ranks, check, launches, smi, s4_rates, seconds):
    """Prints S5's results from `_s5_job`'s four ranks, checks them and adds
    their launches to `launches`."""
    from psgd_tf_tpu_torch.models import nmt

    shapes = nmt.layer_shapes(nmt.ref_config())
    blocks = _block_shapes(shapes, S5_SPECS, S5_MESH)
    held = sum(math.prod(b) for b in blocks)
    n_split = sum(math.prod(s) for s, sp in zip(shapes, S5_SPECS) if sp)
    want_moved = {k: 4 * v for k, v in _s5_payload(shapes, S5_SPECS, S5_MESH).items()}
    coords = [r["coords"] for r in ranks]
    print(f"s5: four gloo ranks sharing the card ({ranks[0]['backend']}), mesh (data=2, "
          f"shard=2), ranks at {coords}, {seconds:.1f} s with the ranks' start", flush=True)
    for fam in TP_FIELDS:
        res_ranks = [r[fam] for r in ranks]
        res = res_ranks[0]
        losses, ref, model, moved = res["losses"], res["ref"], res["model"], res["moved"]
        trace, counts, ok = _tp_checks(torch, fam, res_ranks, blocks, launches)
        gathers = moved.get("shard, split leaves", 0) + moved.get("data, split leaves", 0)
        print(f"s5: NMT reference widths, {fam}, {len(S5_SPECS) - S5_SPECS.count(None)} of 7 "
              f"leaves split over data, shard or both ({n_split} of {model['n_params']} "
              f"parameters), batch 64 as 32 a data rank, {S5_STEPS} steps: launches per rank "
              f"{counts}; returned blocks {res['shapes']}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, the same on all four ranks: "
              f"{all(r['losses'] == losses for r in res_ranks)}; against one process: loss "
              f"trace max rel diff {trace:.3e}, {fam} state max rel diff {res['state_rel']:.3e} "
              f"(tol {TOL_TRAJ:.0e} each), parameter change max abs diff {res['delta_err']:.3e} "
              f"(tol {res['delta_tol']:.3e}; the largest change {res['delta_max']:.3e})",
              flush=True)
        print(f"s5: {fam} bytes each rank receives a step, by axis: {moved} (the port's "
              f"collectives predict {want_moved} for the split leaves and data); comm_model "
              f"(data=2, shard=2): dp_bytes_per_step {model['dp_bytes_per_step']} (the port's "
              f"all-reduce over data {moved.get('data', 0):.0f}, "
              f"{moved.get('data', 0) - model['dp_bytes_per_step']:+.0f}: of a leaf split over "
              f"data it carries every data rank's block, as no reduce-scatter runs), "
              f"tp_gather_bytes_per_step {model['tp_gather_bytes_per_step']} (the port's "
              f"gathers {gathers:.0f}, {gathers - model['tp_gather_bytes_per_step']:+.0f}: the "
              f"parameters' gathers move comm_model's {model['tp_gather_bytes_per_step'] / 3:.0f}"
              f"; the gradient and the Hvp need no gather over data after that all-reduce, "
              f"and their gathers over shard carry its parts; in all "
              f"{moved.get('data', 0) + gathers:.0f} against comm_model's "
              f"{model['dp_bytes_per_step'] + model['tp_gather_bytes_per_step']}), "
              f"shard_bytes_per_step {model['shard_bytes_per_step']}; {smi}", flush=True)
        print(f"s5: {fam} {res['rate']:.2f} steps/s after two steps on the four ranks, S4's "
              f"{s4_rates[fam]:.2f} on two, {ref[2]:.2f} in one process; parameters held at "
              f"rest by each rank {4 * held} bytes against {4 * model['n_params']} replicated; "
              f"{smi}", flush=True)
        check(ok and all(r["moved"].get(k, 0) == v for r in res_ranks
                         for k, v in want_moved.items()),
              f"s5: the {fam} step on (data=2, shard=2): its launches on each rank "
              f"({TP_PER_STEP[fam]} a step, as in one process), the trace, the parameters and "
              f"the state as in one process, the same losses on all four ranks, the returned "
              f"blocks and the bytes by axis")


def _sharded_job(rank, world):
    """The two-rank phases, on gloo ranks sharing the card: K14 and the
    sharded K16 against their plain chains with the same reductions and
    against the single-process kernels (S2), the sharded step at the
    reference widths under lra and splu against the same run in one
    process, which rank 0 makes after the sharded one (S3), the same with
    tensor-parallel parameters under kron and lra (S4), and the toy NMT
    workload with its batch over `data`."""
    import torch

    from psgd_tf_tpu_torch.groups import lra, splu
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import lra_upd, splu_upd
    from psgd_tf_tpu_torch.parallel import _collectives, make_mesh, overlap, policies
    from psgd_tf_tpu_torch.workloads import nmt_attention

    mesh = make_mesh(data=1, shard=world, device="cuda:0")
    dev = mesh.device
    out = {"backend": mesh.backend, "lra": {}, "splu": {}}
    fields = lambda st: (st.Lt, st.l3, st.U12, st.u3)
    sl = lambda loc, x: policies.slice_vec(mesh, loc, x)

    # S2: K14, update + apply, the four coin pairs, pipelined off and on,
    # gathered, against the plain chain (the same call under disabled())
    # and K13
    for n in SHARD_LRA:
        gen = torch.Generator(device=dev).manual_seed(n)
        st = lra.init(gen, n, rank=10, init_scale=0.8, device=dev)
        st = lra.pack(3.0 * st.U, st.V, st.d)  # imbalanced: a rebalance moves it
        v, h, gr = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
        loc = policies.shard_state(mesh, st)
        vl, hl, gl = sl(loc, v), sl(loc, h), sl(loc, gr)

        def call(coins, **kw):
            return lra_upd.fused_update_apply_sharded(loc.UV, loc.d, vl, hl, gl, 0.05, coins,
                                                      mesh, **kw)

        def gathered(res):
            full = policies.gather_state(mesh, lra.LRAState(res[0], res[1]), n)
            return full.UV, full.d, policies.gather_vec(mesh, loc, res[2], n)

        rel = rel_plain = err = 0.0
        for coins in COINS:
            ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, coins)
            for pipelined in (False, True):
                got = gathered(call(coins, pipelined=pipelined))
                with hopper.disabled():
                    plain = gathered(call(coins, pipelined=pipelined))
                rel = max([rel] + [_rel(a, b) for a, b in zip(got, ref)])
                rel_plain = max([rel_plain] + [_rel(a, b) for a, b in zip(got, plain)])
                err = max([err] + [_abs(a, b) for a, b in zip(got, plain)])
        ms = _time(torch, lambda: call((False, True)), 20)
        ms_pipe = _time(torch, lambda: call((False, True), pipelined=True), 20)
        with hopper.disabled():
            plain_ms = _time(torch, lambda: call((False, True)), 10)
        out["lra"][n] = dict(rel=rel, rel_plain=rel_plain, err=err, ms=ms, ms_pipe=ms_pipe,
                             plain_ms=plain_ms)
        del st, loc, v, h, gr, vl, hl, gl
    # S2: the sharded K16 with the apply, gathered, against the plain
    # chain with the same reductions and the unsharded K16 chain
    for n in SHARD_SPLU:
        gen = torch.Generator(device=dev).manual_seed(n)
        st = splu.walked_state(n, 10, gen, dev)
        v, h, gr = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
        ref = splu_upd.launch("splu_upd", *fields(st), v, h, 0.05, gr)
        loc = policies.shard_state(mesh, st)
        vl, hl, gl = sl(loc, v), sl(loc, h), sl(loc, gr)

        def call():
            return splu_upd.fused_update_sharded(*fields(loc), vl, hl, 0.05, mesh,
                                                 loc.tail_valid, gl)

        def gathered(res):
            full = policies.gather_state(mesh, splu.SpLUState(*res[:4]), n)
            return fields(full) + (policies.gather_vec(mesh, loc, res[4], n),)

        got = gathered(call())
        with hopper.disabled():
            plain = gathered(call())
        L1, U1 = got[0][:, :10].T, got[2][:, :10]
        tri_ok = bool(torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1)))
        ms = _time(torch, call, 20)
        with hopper.disabled():
            plain_ms = _time(torch, call, 5)
        out["splu"][n] = dict(rel=max(_rel(a, b) for a, b in zip(got, ref)),
                              rel_plain=max(_rel(a, b) for a, b in zip(got, plain)),
                              err=max(_abs(a, b) for a, b in zip(got, plain)), tri_ok=tri_ok,
                              ms=ms, plain_ms=plain_ms)
        del st, loc, v, h, gr, vl, hl, gl, got, plain, ref
    out["s2_counts"] = dict(hopper.counts)
    torch.cuda.empty_cache()

    # S3: the sharded step at the reference widths; rank 0 then runs the
    # same steps in one process and holds the parameters' change and the
    # gathered last state against it (the other rank waits in its next
    # collective meanwhile). Each step rounds p + u to fp32, so the two
    # parameter changes may differ by up to a spacing of fp32 at the
    # largest |p| a step (two roundings of half a spacing), and little else.
    for fam, steps in (("lra", SHARD_LRA_STEPS), ("splu", SHARD_SPLU_STEPS)):
        losses, counts, rate, delta, p_max, local, _ = _nmt_ref_run(fam, steps, mesh)
        full = policies.gather_state(mesh, local, delta.numel()).precond
        del local
        res = dict(losses=losses, counts=counts, rate=rate)
        if rank == 0:
            torch.cuda.empty_cache()
            ref_losses, ref_counts, ref_rate, ref_delta, _, ref_state, _ = _nmt_ref_run(fam, steps)
            spacing = 2.0 ** math.ceil(math.log2(p_max)) * torch.finfo(torch.float32).eps
            res.update(ref=(ref_losses, ref_counts, ref_rate), delta_err=_abs(delta, ref_delta),
                       delta_tol=steps * spacing, delta_max=ref_delta.abs().max().item(),
                       state_rel=max(_rel(getattr(full, f), getattr(ref_state.precond, f))
                                     for f in SHARD_FIELDS[fam]))
            del ref_delta, ref_state
        out[f"nmt_{fam}"] = res
        del delta, full
        torch.cuda.empty_cache()
    _s4(rank, mesh, out)
    dp = make_mesh(data=world, shard=1, device="cuda:0")
    hopper.reset_counts()
    out["toy_dp"] = nmt_attention.run(steps=SHARD_NMT_STEPS, mesh=dp)
    out["toy_dp_counts"] = dict(hopper.counts)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    import numpy as np

    from psgd_tf_tpu_torch import PSGD, UVd, bench, dense, kron, lra, splu
    from psgd_tf_tpu_torch.bench import _bound, family_work, kron_work, splu_work
    from psgd_tf_tpu_torch.data import mnist, native, spa_eng, translation, xor
    from psgd_tf_tpu_torch.models import lenet5, lstm, nmt, rnn, tensor_decomp
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import (_build, dense_big, dense_upd, kron_dd, kron_multi,
                                              kron_sparse, kron_sparse_big, lra_upd, splu_one,
                                              splu_upd, tri)
    from psgd_tf_tpu_torch.optim.psgd import KronPrecond
    from psgd_tf_tpu_torch.utils import _tree, checkpoint
    from psgd_tf_tpu_torch.workloads import (all_preconditioners, hello_psgd, lstm_xor,
                                             mnist_lenet5, nmt_attention, rnn_xor_lra)

    # the staged files' writers the port's tests use (spa-eng-format
    # corpora, MNIST's IDX files)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_staged_files import corpus_lines, write_idx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    launches = {name: 0 for name in hopper.counts}  # summed over the three paths

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"FAIL {what}", flush=True)

    def path_counts() -> None:
        for name, n in hopper.counts.items():
            launches[name] += n

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # every phase reseeds the shared generator with its own number, so its
    # inputs do not depend on what the phases before it drew
    g = torch.Generator(device=dev).manual_seed(0)

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    def walked_states(fmts, shapes, steps=3):
        """KronStates walked `steps` plain updates off 0.8 I."""
        states = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        with hopper.disabled():
            for _ in range(steps):
                states = kron.update_multi(states, *probes(shapes), step=0.1)
        return states

    def kernel_part(st, dx, dg, reps):
        """(ms with the kernel, ms plain) of the kernel part alone of a
        (norm, dense) layer's update (`nd_reductions`, no torch tail), on
        its unbalanced state."""
        ql0, ql1 = st.ql[0], st.ql[1]
        w = ql1 / (ql0 * ql0[-1])
        u = dg[-1] @ st.qr.T
        return _time_ab(torch, hopper, lambda: kron_sparse_big.nd_reductions(
            dx, dg, st.ql, w, st.qr, u), reps)

    def one_call(fmt, shape, st, dx, dg, names):
        """One `kron.update` of a layer that takes K6, K7/K8 or K10's one C
        call: (result, plain result, max rel err, max abs err, whether its
        launches moved `names` by one each and nothing else, whether a
        second call gave the same bits)."""
        before = dict(hopper.counts)
        got = kron.update(st, dx, dg, step=0.1)
        torch.cuda.synchronize()
        moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
        with hopper.disabled():
            ref = kron.update(st, dx, dg, step=0.1)
        rel, err = _state_errs([got], [ref])
        again = kron.update(st, dx, dg, step=0.1)
        same = torch.equal(again.ql, got.ql) and torch.equal(again.qr, got.qr)
        exact = all(q[1, -1].item() == 0.0 if f == "norm" else
                    (torch.equal(q, torch.triu(q)) if f == "dense" else True)
                    for q, f in zip((got.ql, got.qr), fmt))
        finite = bool(torch.isfinite(got.ql).all() and torch.isfinite(got.qr).all())
        return got, ref, rel, err, moved == {k: 1 for k in names} and exact and finite, same

    # the kron list all_preconditioners gives K1 and K3: one factor pair per
    # factor matrix of the tensor decomposition
    decomp_pre = PSGD(preconditioner="kron").init(tensor_decomp.init(g)).precond
    decomp_fmts = [st.fmt for st in decomp_pre]
    decomp_shapes = [(st.ql.shape[-1], st.qr.shape[-1]) for st in decomp_pre]

    # 2. K3 at LeNet5's ten factor sides, the tensor decomposition's six, at
    #    1024 and at the ragged sides K3_RAGGED
    def triu_factor(n):
        u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
        return u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev))

    g.manual_seed(2)
    lenet_us = [triu_factor(n) for s in LENET5 for n in s]
    us = (lenet_us + [triu_factor(n) for s in decomp_shapes for n in s] + [triu_factor(1024)]
          + [triu_factor(n) for n in K3_RAGGED])
    before = hopper.counts["tri"]
    got = tri.inverse_upper(us)
    torch.cuda.synchronize()
    check(hopper.counts["tri"] == before + 1, "k3: one launch for the whole list")
    ref = tri.inverse_upper_plain(us)
    k3_rel = max(_rel(a, b) for a, b in zip(got, ref))
    k3_abs = max(_abs(a, b) for a, b in zip(got, ref))
    print(f"k3: sides {[u.shape[0] for u in us]} max rel err {k3_rel:.3e} "
          f"(tol {TOL_K3:.0e}) max abs err {k3_abs:.3e}", flush=True)
    k3_zero = all(torch.count_nonzero(torch.tril(x, -1)).item() == 0 for x in got)
    check(k3_rel < TOL_K3 and k3_zero, "k3 vs plain, strictly lower part zero")
    k3_ms, k3_plain_ms = _time_ab(torch, hopper, lambda: tri.inverse_upper(lenet_us), 200)
    # one library call: the ten factors identity-padded to the largest side,
    # stacked, solved against the identity
    side = max(u.shape[0] for u in lenet_us)
    stack = torch.eye(side, device=dev).repeat(len(lenet_us), 1, 1)
    for k, u in enumerate(lenet_us):
        stack[k, :u.shape[0], :u.shape[0]] = u
    eye = torch.eye(side, device=dev).expand_as(stack)
    k3_lib_ms = _time(torch, lambda: torch.linalg.solve_triangular(stack, eye, upper=True), 200)
    # each factor's upper triangle read, its whole inverse written
    k3_bound = _bound(sum(4 * (k * (k + 1) / 2 + k * k) for k in (u.shape[0] for u in lenet_us)),
                      sum(u.shape[0] ** 3 / 3 for u in lenet_us))
    print(f"k3 time, LeNet5's ten factors: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms, "
          f"one solve_triangular of the stacked padded factors {k3_lib_ms:.4f} ms", flush=True)

    # 3. K1 (kind dd) on LeNet5's five layers, K2 on one (1024, 1024) and
    #    one (1, 10) layer, and a 20-step chained K1 trajectory
    g.manual_seed(3)
    dd = [("dense", "dense")] * len(LENET5)
    states = walked_states(dd, LENET5)
    dxs, dgs = probes(LENET5)
    got = kron.update_multi(states, dxs, dgs, step=0.1)
    torch.cuda.synchronize()
    with hopper.disabled():
        ref = kron.update_multi(states, dxs, dgs, step=0.1)
    k1_rel, k1_abs = _state_errs(got, ref)
    print(f"k1: LeNet5 layers max rel err {k1_rel:.3e} (tol {TOL_K1:.0e}) "
          f"max abs err {k1_abs:.3e}", flush=True)
    check(k1_rel < TOL_K1 and all(torch.isfinite(s.ql).all() and torch.isfinite(s.qr).all()
                                  for s in got), "k1 vs plain")
    k1_lenet_ms, k1_lenet_plain_ms = _time_ab(
        torch, hopper, lambda: kron.update_multi(states, dxs, dgs, step=0.1), 200)
    print(f"k1 time, LeNet5's five layers: kernel {k1_lenet_ms:.4f} ms, "
          f"plain {k1_lenet_plain_ms:.4f} ms", flush=True)

    k2_rel = k2_abs = 0.0
    for shape in [(1024, 1024), (1, 10)]:
        (st,) = walked_states([("dense", "dense")], [shape], steps=2)
        (dx,), (dg,) = probes([shape])
        a, b = kron_dd.fused_update(st.ql, st.qr, dx, dg, 0.1)
        torch.cuda.synchronize()
        ra, rb = kron_dd.update_plain(st.ql, st.qr, dx, dg, 0.1)
        rel, err = max(_rel(a, ra), _rel(b, rb)), max(_abs(a, ra), _abs(b, rb))
        k2_rel, k2_abs = max(k2_rel, rel), max(k2_abs, err)
        print(f"k2: {shape} layer max rel err {rel:.3e} (tol {TOL_K1:.0e})", flush=True)
    k2_ms, k2_plain_ms = _time_ab(
        torch, hopper, lambda: kron_dd.fused_update(st.ql, st.qr, dx, dg, 0.1), 200)
    k2_bound = _bound(*kron_work(("dense", "dense"), (1, 10)))
    print(f"k2 time, (1, 10) layer: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms",
          flush=True)
    check(k2_rel < TOL_K1, "k2 vs plain")

    def trajectory(fmts, shapes):
        """20 chained kernel updates (`update_multi`) against a plain replay
        from 0.8 I."""
        kst = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        pst = kst
        for _ in range(20):
            dxs, dgs = probes(shapes)
            kst = kron.update_multi(kst, dxs, dgs, step=0.1)
            with hopper.disabled():
                pst = kron.update_multi(pst, dxs, dgs, step=0.1)
        return _state_errs(kst, pst)[0]

    traj_rel = trajectory(dd, LENET5)
    print(f"k1 trajectory: LeNet5, 20 steps max rel err {traj_rel:.3e} (tol {TOL_TRAJ:.0e})",
          flush=True)
    check(traj_rel < TOL_TRAJ, "k1 20-step trajectory vs plain")

    # 3b. K1 on the tensor decomposition's list, and a 20-step trajectory
    g.manual_seed(31)
    states = walked_states(decomp_fmts, decomp_shapes)
    dxs, dgs = probes(decomp_shapes)
    before = hopper.counts["kron_multi"]
    got = kron.update_multi(states, dxs, dgs, step=0.1)
    torch.cuda.synchronize()
    check(hopper.counts["kron_multi"] == before + 1, "decomposition list takes one K1 call")
    with hopper.disabled():
        ref = kron.update_multi(states, dxs, dgs, step=0.1)
    dec_rel, dec_abs = _state_errs(got, ref)
    dec_traj = trajectory(decomp_fmts, decomp_shapes)
    print(f"k1: tensor decomposition {decomp_fmts} {decomp_shapes} max rel err {dec_rel:.3e} "
          f"(tol {TOL_K1:.0e}) max abs err {dec_abs:.3e}; 20 steps max rel err {dec_traj:.3e} "
          f"(tol {TOL_TRAJ:.0e})", flush=True)
    check(dec_rel < TOL_K1 and all(torch.isfinite(s.ql).all() and torch.isfinite(s.qr).all()
                                   for s in got), "k1 vs plain on the decomposition list")
    check(dec_traj < TOL_TRAJ, "k1 20-step trajectory on the decomposition list")

    # 3c. K4 on stacked (dense, dense) buckets (K4_BUCKETS and the K4 path's
    #     bucket): one update from a walked stack against the plain version,
    #     one chain and one K3 a call at every B, the inputs unchanged, a
    #     20-step trajectory from 0.8 I, the padding exact identity; timed
    #     through kron.update_batched with the kernel and plain, as K1 over
    #     the same layers unbatched (kron.update_multi), and the wrapper alone
    g.manual_seed(32)
    DD = ("dense", "dense")
    k4_cfg = nmt.Config(**K4_NMT)
    k4_path_bucket = [s for s in nmt.layer_shapes(k4_cfg) if kron.auto_format(s) == DD]

    def padding_exact(q, sides):
        """True when every slot of the stack q is identity beyond its corner."""
        for i, d in enumerate(sides):
            want = torch.eye(q.shape[1], device=dev)
            want[:d, :d] = q[i, :d, :d]
            if not torch.equal(q[i], want):
                return False
        return True

    k4_err = 0.0
    for name, shapes in K4_BUCKETS + [("K4 path's bucket", k4_path_bucket)]:
        ms, ns = [m for m, _ in shapes], [n for _, n in shapes]
        bst = kron.init_batched(shapes, init_scale=0.8, device=dev)
        with hopper.disabled():
            for _ in range(3):
                bst = kron.update_batched(bst, *probes(shapes), step=0.1)
        dxs, dgs = probes(shapes)
        ql0, qr0 = bst.ql.clone(), bst.qr.clone()
        before = dict(hopper.counts)
        got = kron.update_batched(bst, dxs, dgs, step=0.1)
        torch.cuda.synchronize()
        moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
        check(moved == {"kron_dd_batched": 1, "tri": 1},
              f"k4 {name}: one chain and one K3 a call: {moved}")
        with hopper.disabled():
            ref = kron.update_batched(bst, dxs, dgs, step=0.1)
        rel = max(_rel(got.ql, ref.ql), _rel(got.qr, ref.qr))
        err = max(_abs(got.ql, ref.ql), _abs(got.qr, ref.qr))
        k4_err = max(k4_err, err)
        exact = padding_exact(got.ql, ms) and padding_exact(got.qr, ns)
        kept = torch.equal(bst.ql, ql0) and torch.equal(bst.qr, qr0)
        check(rel < TOL_K1 and exact and kept, f"k4 vs plain at {name}, inputs unchanged {kept}")
        del ql0, qr0
        kb = pb = kron.init_batched(shapes, init_scale=0.8, device=dev)
        for _ in range(20):
            dx_, dg_ = probes(shapes)
            kb = kron.update_batched(kb, dx_, dg_, step=0.1)
            with hopper.disabled():
                pb = kron.update_batched(pb, dx_, dg_, step=0.1)
        traj = max(_rel(kb.ql, pb.ql), _rel(kb.qr, pb.qr))
        traj_exact = all(padding_exact(b.ql, ms) and padding_exact(b.qr, ns) for b in (kb, pb))
        check(traj < TOL_TRAJ and traj_exact, f"k4 20-step trajectory at {name}")
        reps = 20 if max(max(s) for s in shapes) > 512 else 100
        ms_k, ms_p = _time_ab(torch, hopper, lambda: kron.update_batched(bst, dxs, dgs, step=0.1),
                              reps)
        singles = kron.unbatch(bst)
        k1_ms = _time(torch, lambda: kron.update_multi(singles, dxs, dgs, step=0.1), reps)
        dx, dg = (kron.stack_padded(x, bst.ql.shape[1], bst.qr.shape[1]) for x in (dxs, dgs))
        alone = _time(torch, lambda: kron_dd.fused_update_batched(bst.ql, bst.qr, dx, dg, ms, ns,
                                                                  0.1), reps)
        work = [kron_work(DD, s) for s in shapes]
        bound = _bound(sum(w[0] for w in work), sum(w[1] for w in work))
        k4_launches = kron_dd.batched_launches(ms, ns, bst.ql.shape[1], bst.qr.shape[1], dev)
        print(f"kron_dd_batched: {name}, stacks {tuple(bst.ql.shape)} {tuple(bst.qr.shape)}, max "
              f"rel err {rel:.3e} (tol {TOL_K1:.0e}) max abs err {err:.3e}, padding exact "
              f"{exact}, inputs unchanged {kept}; 20 steps max rel err {traj:.3e} (tol "
              f"{TOL_TRAJ:.0e}), padding exact {traj_exact}; update_batched kernel {ms_k:.4f} ms, "
              f"plain {ms_p:.4f} ms, K1 unbatched {k1_ms:.4f} ms, the wrapper alone {alone:.4f} "
              f"ms ({k4_launches} launches a call), bound {bound[0]:.4f} ms ({bound[1]})",
              flush=True)
        if shapes is k4_path_bucket:
            k4_ms, k4_plain_ms, k4_bound = ms_k, ms_p, bound
        del bst, got, ref, kb, pb, singles, dx, dg
    torch.cuda.empty_cache()

    # 4. K1 with mixed kinds on the toy NMT list: [ds, ns, ds, dd, ds, ns, ns]
    g.manual_seed(4)
    toy = nmt.Config()
    nmt_fmts, toy_shapes = nmt.kron_formats(toy), nmt.layer_shapes(toy)
    toy_routes = [kron.route(f, s, dev) for f, s in zip(nmt_fmts, toy_shapes)]
    check(toy_routes == ["kron_sparse:ds", "kron_sparse:ns", "kron_sparse:ds", "kron_dd",
                         "kron_sparse:ds", "kron_sparse:ns", "kron_sparse:ns"],
          f"toy NMT routes {toy_routes}")
    states = walked_states(nmt_fmts, toy_shapes)
    dxs, dgs = probes(toy_shapes)
    before = hopper.counts["kron_multi"]
    got = kron.update_multi(states, dxs, dgs, step=0.1)
    torch.cuda.synchronize()
    check(hopper.counts["kron_multi"] == before + 1, "toy NMT list takes one K1 call")
    with hopper.disabled():
        ref = kron.update_multi(states, dxs, dgs, step=0.1)
    mix_rel, mix_abs = _state_errs(got, ref)
    arrows_ok = all(q[1, -1].item() == 0.0 for s in got for q, f in zip((s.ql, s.qr), s.fmt)
                    if f == "norm")
    print(f"k1 mixed: toy NMT layers max rel err {mix_rel:.3e} (tol {TOL_K1:.0e}) "
          f"max abs err {mix_abs:.3e}, arrow ql[1][-1] == 0: {arrows_ok}", flush=True)
    check(mix_rel < TOL_K1 and arrows_ok, "k1 mixed kinds vs plain")
    k1_ms, k1_plain_ms = _time_ab(
        torch, hopper, lambda: kron.update_multi(states, dxs, dgs, step=0.1), 200)
    k1_work = [kron_work(f, sh) for f, sh in zip(nmt_fmts, toy_shapes)]
    k1_bound = _bound(sum(w[0] for w in k1_work), sum(w[1] for w in k1_work))
    print(f"k1 time, toy NMT's seven layers: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms",
          flush=True)
    mix_traj = trajectory(nmt_fmts, toy_shapes)
    print(f"k1 mixed trajectory: toy NMT, 20 steps max rel err {mix_traj:.3e} "
          f"(tol {TOL_TRAJ:.0e})", flush=True)
    check(mix_traj < TOL_TRAJ, "k1 mixed 20-step trajectory vs plain")

    # 5. K5: one (norm, scale), (dense, scale) and (norm, dense) layer at (130, 65)
    g.manual_seed(5)
    k5_rel = k5_abs = 0.0
    k5_times = {}
    for kind, fmt in [("ns", ("norm", "scale")), ("ds", ("dense", "scale")),
                      ("nd", ("norm", "dense"))]:
        (st,) = walked_states([fmt], [(130, 65)])
        (dx,), (dg,) = probes([(130, 65)])
        fn = kron_sparse.FUSED_UPDATE[kind]
        before = hopper.counts["kron_sparse"]
        a, b = fn(st.ql, st.qr, dx, dg, 0.1)
        torch.cuda.synchronize()
        check(hopper.counts["kron_sparse"] == before + 1, f"k5 {kind} launched")
        ra, rb = kron_sparse.PLAIN[kind](st.ql, st.qr, dx, dg, 0.1)
        rel, err = max(_rel(a, ra), _rel(b, rb)), max(_abs(a, ra), _abs(b, rb))
        k5_rel, k5_abs = max(k5_rel, rel), max(k5_abs, err)
        arrow_ok = kind == "ds" or a[1, -1].item() == 0.0
        check(rel < TOL_K1 and arrow_ok, f"k5 {kind} vs plain")
        k5_times[kind] = _time_ab(torch, hopper, lambda: fn(st.ql, st.qr, dx, dg, 0.1), 200)
        print(f"k5 {kind}: (130, 65) max rel err {rel:.3e} (tol {TOL_K1:.0e}), arrow ok "
              f"{arrow_ok}, kernel {k5_times[kind][0]:.4f} ms, plain {k5_times[kind][1]:.4f} ms",
              flush=True)
    k5_ms = sum(t[0] for t in k5_times.values()) / 3
    k5_plain_ms = sum(t[1] for t in k5_times.values()) / 3
    k5_work = [kron_work(f, (130, 65)) for f in [("norm", "scale"), ("dense", "scale"),
                                                  ("norm", "dense")]]
    k5_bound = _bound(sum(w[0] for w in k5_work) / 3, sum(w[1] for w in k5_work) / 3)

    # 5b. K1's chain on its two routes, forced (kron_dd.forced_route): the
    #     chain of grouped launches and the one cooperative launch, bit for
    #     bit, through each entry point (K1, K2, K5, K20; K4's stacked chain
    #     takes no route), each against plain and timed three ways; a
    #     forced one launch on a list whose products take the 128 x 128
    #     tiles raises
    g.manual_seed(52)
    route_lists = [("K1 LeNet5", "multi", [DD] * 5, LENET5),
                   ("K1 toy NMT", "multi", nmt_fmts, toy_shapes),
                   ("K1 decomposition", "multi", decomp_fmts, decomp_shapes),
                   ("K20 16 layers", "k20", [DD] * 16, MULTI_18[:16]),
                   ("K2 (1, 10)", "k2", [DD], [(1, 10)])]
    route_lists += [(f"K5 {kind} (130, 65)", kind, [fmt], [(130, 65)]) for kind, fmt in
                    [("ns", ("norm", "scale")), ("ds", ("dense", "scale")), ("nd", ("norm", "dense"))]]
    route_err = 0.0
    route_times = {}
    for name, entry_kind, fmts, shapes in route_lists:
        sts = walked_states(fmts, shapes)
        dxs, dgs = probes(shapes)
        if entry_kind == "multi":
            fn = lambda sts=sts, dxs=dxs, dgs=dgs: kron.update_multi(sts, dxs, dgs, step=0.1)
            counter = "kron_multi"
        elif entry_kind == "k20":
            fn = lambda sts=sts, dxs=dxs, dgs=dgs: kron_dd.fused_update_multi(
                [s.ql for s in sts], [s.qr for s in sts], dxs, dgs, 0.1)
            counter = "kron_dd_multi"
        elif entry_kind == "k2":
            fn = lambda st=sts[0], dx=dxs[0], dg=dgs[0]: kron_dd.fused_update(
                st.ql, st.qr, dx, dg, 0.1)
            counter = "kron_dd"
        else:
            fn = lambda st=sts[0], dx=dxs[0], dg=dgs[0], f=kron_sparse.FUSED_UPDATE[entry_kind]: f(
                st.ql, st.qr, dx, dg, 0.1)
            counter = "kron_sparse"
        outs, moved = {}, {}
        for route in ("chain", "mono"):
            with kron_dd.forced_route(route):
                before = dict(hopper.counts)
                outs[route] = _flat_tensors(fn())
                torch.cuda.synchronize()
                moved[route] = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
        with hopper.disabled():
            ref = _flat_tensors(fn())
        bit = all(torch.equal(a, b) for a, b in zip(outs["chain"], outs["mono"]))
        rel = max(_rel(a, b) for a, b in zip(outs["mono"], ref))
        err = max(_abs(a, b) for a, b in zip(outs["mono"], ref))
        route_err = max(route_err, err)
        has_dense = any(f == "dense" for fmt in fmts for f in fmt)
        counts_ok = (moved["mono"].get("kron_mono", 0) >= 1 and "tri" not in moved["mono"]
                     and "kron_mono" not in moved["chain"]
                     and moved["chain"].get("tri", 0) == (moved["chain"][counter] if has_dense else 0))
        check(bit and rel < TOL_K1 and counts_ok,
              f"one launch vs chain at {name}: bit-equal {bit}, rel err {rel:.3e}, launches {moved}")
        reps = 100
        with kron_dd.forced_route("chain"):
            chain_ms = _time_median(torch, fn, reps)
        with kron_dd.forced_route("mono"):
            mono_ms = _time_median(torch, fn, reps)
        with hopper.disabled():
            plain_ms = _time(torch, fn, reps)
        route_times[name] = (mono_ms, chain_ms, plain_ms)
        print(f"k1 routes: {name} one launch bit-equal to the chain {bit}, max rel err {rel:.3e} "
              f"(tol {TOL_K1:.0e}) max abs err {err:.3e}; chain {chain_ms:.4f} ms, one launch "
              f"{mono_ms:.4f} ms, plain {plain_ms:.4f} ms; the route picks "
              f"{kron_dd.route(*_chain_list(kron, fmts, shapes))}", flush=True)
    big_dd = walked_states([DD], [(2176, 2176)], steps=0)[0]
    (bdx,), (bdg,) = probes([(2176, 2176)])
    before = dict(hopper.counts)
    try:
        with kron_dd.forced_route("mono"):
            kron_dd.fused_update(big_dd.ql, big_dd.qr, bdx, bdg, 0.1)
        refused = False
    except RuntimeError:
        refused = True
    check(refused and hopper.counts == before,
          "a forced one launch on a list of 128 x 128 tiles (2176, 2176) raises, launching nothing")
    print(f"k1 routes: forced one launch at (2176, 2176) raises {refused}", flush=True)
    del big_dd, bdx, bdg
    torch.cuda.empty_cache()
    toy_work = [kron_work(f, sh) for f, sh in zip(nmt_fmts, toy_shapes)]
    mono_bound = _bound(sum(w[0] for w in toy_work), sum(w[1] for w in toy_work))

    # 6. K6 and K10 at the reference NMT layers, through kron.update (the
    #    (scale, dense) embeddings and attention are mirrored: K10 gets dX^T):
    #    each one C call (one count, K3's for K10, nothing else), against
    #    the plain update, two calls bit-equal, with the host's ms a call
    #    and the device's (queued); then the same at a mirrored (scale, norm)
    #    layer (K6 reads dX^T in place), at ragged shapes (n % 4 = 1, two
    #    rows) and with zero probes (finite factors)
    g.manual_seed(6)
    ref_cfg = nmt.ref_config()
    ref_shapes = nmt.layer_shapes(ref_cfg)
    # per kernel: max abs error, and ms with the kernel and plain summed over
    # its three layers (one reference-width step's worth)
    big = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0.0}
           for name in ("kron_sparse_big_ns", "kron_sparse_big_ds")}
    ref_cases = [(f, sh) for f, sh in zip(nmt_fmts, ref_shapes) if f != DD]
    for fmt, shape in ref_cases + STREAM_EDGE:
        name = "kron_sparse_big_ns" if "norm" in fmt else "kron_sparse_big_ds"
        names = [name] + ([] if "norm" in fmt else ["tri"])
        route = "kron_sparse_big:ns" if "norm" in fmt else "kron_sparse_big:ds"
        check(kron.route(fmt, shape, dev) == route, f"{name} route at {fmt} {shape}")
        (st,) = walked_states([fmt], [shape], steps=2)
        (dx,), (dg,) = probes([shape])
        got, ref, rel, err, one, same = one_call(fmt, shape, st, dx, dg, names)
        check(one and rel < TOL_K1, f"{name} one call vs plain at {fmt} {shape}")
        check(same, f"{name} two calls bit-equal at {fmt} {shape}")
        call = lambda: kron.update(st, dx, dg, step=0.1)
        ms, plain_ms = _time_ab(torch, hopper, call, 50)
        host = _host_ms(torch, call, 50)
        queued = _time_queued(torch, call, 40)
        z = torch.zeros(shape, device=dev)
        zero = kron.update(st, z, z, step=0.1)
        zero_ok = bool(torch.isfinite(zero.ql).all() and torch.isfinite(zero.qr).all())
        check(zero_ok, f"{name} zero probes give finite factors at {fmt} {shape}")
        acc = big[name]
        acc["err"] = max(acc["err"], err)
        if (fmt, shape) in ref_cases:
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            nbytes, flops = kron_work(fmt, shape)
            acc["bytes"] += nbytes
            acc["flops"] += flops
        print(f"{name}: {fmt} {shape} max rel err {rel:.3e} (tol {TOL_K1:.0e}) max abs err "
              f"{err:.3e}, one call {one}, bit-equal again {same}, zero probes finite {zero_ok}; "
              f"kernel {ms:.4f} ms chained, {queued:.4f} ms on the device (queued), host "
              f"{host * 1e3:.1f} us a call; plain {plain_ms:.4f} ms", flush=True)
        del st, dx, dg, got, ref, z, zero
    torch.cuda.empty_cache()
    for name, acc in big.items():
        print(f"{name}: the three NMT layers summed, kernel {acc['ms']:.4f} ms, plain "
              f"{acc['plain_ms']:.4f} ms", flush=True)

    # 6b. K9 at the five (norm, dense) layers PSGD's default formats give
    #     the reference NMT model, at bench.py's (131072, 512) and on a
    #     mirrored (dense, norm) layer (K9 gets dX^T), through kron.update;
    #     20-step trajectories at two of the NMT layers
    g.manual_seed(61)
    auto_fmts = [kron.auto_format(s) for s in ref_shapes]
    nd_shapes = [s for f, s in zip(auto_fmts, ref_shapes) if f == ("norm", "dense")]
    check(len(nd_shapes) == 5, f"five (norm, dense) NMT layers under auto: {nd_shapes}")
    k9 = {"err": 0.0, "nmt_ms": 0.0, "nmt_plain_ms": 0.0}
    k9_cases = [(("norm", "dense"), sh) for sh in nd_shapes + [K9_BENCH]]
    for fmt, shape in k9_cases + [(("dense", "norm"), K9_MIRROR)]:
        check(kron.route(fmt, shape, dev) == "kron_sparse_big:nd", f"k9 route at {fmt} {shape}")
        (st,) = walked_states([fmt], [shape], steps=2)
        (dx,), (dg,) = probes([shape])
        before = dict(hopper.counts)
        got = kron.update(st, dx, dg, step=0.1)
        torch.cuda.synchronize()
        check(hopper.counts["kron_sparse_big_nd"] == before["kron_sparse_big_nd"] + 1
              and hopper.counts["tri"] == before["tri"] + 1, f"k9 and K3 launched at {shape}")
        with hopper.disabled():
            ref = kron.update(st, dx, dg, step=0.1)
        rel, err = _state_errs([got], [ref])
        arrow, dq = (got.qr, got.ql) if fmt[0] == "dense" else (got.ql, got.qr)
        exact = arrow[1, -1].item() == 0.0 and torch.equal(dq, torch.triu(dq))
        check(rel < TOL_K1 and exact, f"k9 vs plain at {fmt} {shape}")
        k9["err"] = max(k9["err"], err)
        ms, plain_ms = _time_ab(torch, hopper, lambda: kron.update(st, dx, dg, step=0.1),
                                10 if shape == K9_BENCH else 50)
        if shape in nd_shapes:
            k9["nmt_ms"] += ms
            k9["nmt_plain_ms"] += plain_ms
        bound = _bound(*kron_work(fmt, shape))
        if shape == K9_BENCH:
            k9.update(ms=ms, plain_ms=plain_ms, bound=bound)
        print(f"kron_sparse_big_nd: {fmt} {shape} max rel err {rel:.3e} (tol {TOL_K1:.0e}) max "
              f"abs err {err:.3e}, arrow and triangle exact {exact}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        if shape == K9_BENCH:
            part, part_plain = kernel_part(st, dx, dg, 10)
            m, n = shape
            print(f"kron_sparse_big_nd: {shape} the kernel part alone (K3, both products, row "
                  f"sums, corr, Gram), kernel {part:.4f} ms ({4 * m * n * n / part / 1e9:.2f} "
                  f"TFLOP/s of its 4 m n^2), plain {part_plain:.4f} ms", flush=True)
        del st, dx, dg, got, ref
    print(f"kron_sparse_big_nd: the five NMT layers summed, kernel {k9['nmt_ms']:.4f} ms, plain "
          f"{k9['nmt_plain_ms']:.4f} ms", flush=True)
    for shape in (nd_shapes[2], nd_shapes[0]):
        k9_traj = trajectory([("norm", "dense")], [shape])
        print(f"kron_sparse_big_nd trajectory: {shape}, 20 steps max rel err {k9_traj:.3e} "
              f"(tol {TOL_TRAJ:.0e})", flush=True)
        check(k9_traj < TOL_TRAJ, f"k9 20-step trajectory vs plain at {shape}")

    # 6c. K7 and K8: the wide (norm, scale) pass and K6's device tail, one C
    #     call, at bench.py's (512, 1,000,000), a ragged mirrored layer
    #     (dX^T), and a ragged width past 2^21 lanes, through kron.update;
    #     the counter of the JAX route moves, and no other; two calls
    #     bit-equal; the device's ms (queued) and the host's
    g.manual_seed(62)
    wide = {}
    for fmt, shape, name in WIDE_NS:
        check(kron.route(fmt, shape, dev) == "kron_sparse_big:ns_wide", f"wide route at {shape}")
        (st,) = walked_states([fmt], [shape], steps=2)
        (dx,), (dg,) = probes([shape])
        got, ref, rel, err, one, same = one_call(fmt, shape, st, dx, dg, [name])
        check(one and rel < TOL_K1, f"{name} alone launched, vs plain at {fmt} {shape}")
        check(same, f"{name} two calls bit-equal at {fmt} {shape}")
        call = lambda: kron.update(st, dx, dg, step=0.1)
        ms, plain_ms = _time_ab(torch, hopper, call, 10)
        queued = _time_queued(torch, call, 10)
        host = _host_ms(torch, call, 10)
        bound = _bound(*kron_work(fmt, shape))
        acc = wide.setdefault(name, {"err": 0.0})
        acc["err"] = max(acc["err"], err)
        m, n = shape
        print(f"{name}: {fmt} {shape} max rel err {rel:.3e} (tol {TOL_K1:.0e}) max abs err "
              f"{err:.3e}, one call {one}, bit-equal again {same}; kernel {ms:.4f} ms chained, "
              f"{queued:.4f} ms on the device (queued: {12 * m * n / queued / 1e9:.3f} TB/s of "
              f"the two passes' 3 m n floats), host {host * 1e3:.1f} us a call; plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        if "ms" not in acc:  # the first row of each counter: bench.py's and the past-2^21 one
            acc.update(ms=ms, plain_ms=plain_ms, bound=bound)
        del st, dx, dg, got, ref
        torch.cuda.empty_cache()

    # 7. K13 at the RNN's n and at bench.py's 2^20, r = 10, under the four
    #    coin pairs: against the chain's plain stages and the direct form
    def lra_case(n, r=10):
        """A state walked three plain updates off its init (U scaled up, so
        a rebalance moves it) and fresh probes."""
        st = lra.init(torch.Generator().manual_seed(n), n, rank=r, init_scale=0.8, device=dev)
        st = lra.pack(3.0 * st.U, st.V, st.d)
        with hopper.disabled():
            for k in range(3):
                st = lra.update(st, torch.randn(n, generator=g, device=dev),
                                torch.randn(n, generator=g, device=dev), 0.05, COINS[k])
        return st, [torch.randn(n, generator=g, device=dev) for _ in range(3)]

    g.manual_seed(7)
    lra_err = lra_rel = 0.0
    lra_times, lra_bounds = {}, {}
    for n in LRA_SIZES:
        st, (v, h, gr) = lra_case(n)
        for coins in COINS:
            before = hopper.counts["lra_upd"]
            uv, d = lra_upd.fused_update(st.UV, st.d, v, h, 0.05, coins)
            uv2, d2, pre = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, coins)
            torch.cuda.synchronize()
            check(hopper.counts["lra_upd"] == before + 2, f"k13 launched at n={n}")
            with hopper.disabled():
                ruv, rd, rpre = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, coins)
            duv, dd_ = lra_upd.update_plain(st.UV, st.d, v, h, 0.05, coins)
            pairs = [(uv, ruv), (d, rd), (uv2, ruv), (d2, rd), (pre, rpre), (uv, duv), (d, dd_)]
            rel = max(_rel(a, b) for a, b in pairs)
            lra_rel, lra_err = max(lra_rel, rel), max(lra_err, max(_abs(a, b) for a, b in pairs))
            check(rel < TOL_K1, f"k13 vs plain at n={n}, coins {coins}")
        call = lambda: lra.update_apply(st, v, h, gr, 0.05, (False, True))
        lra_times[n] = _time_ab(torch, hopper, call, 50 if n > 10**5 else 200)
        lra_host_ms = _host_ms(torch, call, 20)
        # reads UV, d, v, h, g, writes UV', d', P' g; two Grams of 22 rows
        lra_bounds[n] = _bound(*family_work("lra", n))
        print(f"k13: n={n} r=10, four coin pairs, max rel err {lra_rel:.3e} (tol {TOL_K1:.0e}); "
              f"update+apply kernel {lra_times[n][0]:.4f} ms, plain {lra_times[n][1]:.4f} ms, "
              f"bound {lra_bounds[n][0]:.4f} ms ({lra_bounds[n][1]}); host time "
              f"{lra_host_ms:.4f} ms a call (host clock, no synchronise)", flush=True)
    for n in LRA_SIZES[:2]:
        kst, _ = lra_case(n)
        pst = kst
        for k in range(20):
            v, h = (torch.randn(n, generator=g, device=dev) for _ in range(2))
            kst = lra.update(kst, v, h, 0.05, COINS[k % 4])
            with hopper.disabled():
                pst = lra.update(pst, v, h, 0.05, COINS[k % 4])
        lra_traj = max(_rel(kst.UV, pst.UV), _rel(kst.d, pst.d))
        print(f"k13 trajectory: n={n}, 20 steps max rel err {lra_traj:.3e} "
              f"(tol {TOL_TRAJ:.0e})", flush=True)
        check(lra_traj < TOL_TRAJ, f"k13 20-step trajectory vs plain at n={n}")

    # 7b. F4: K13 and K14 on an lra state or probe holding one NaN or inf
    #     (`tools/nan_probe.py --lra-all`: both rank chains, each call held
    #     to the plain chain's non-finite entries), then `--chain`: 1,000
    #     calls of K13 with P' v fed back, past the call where the state
    #     overflows; each in a child process, since a fault would end its
    #     CUDA context
    probe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "nan_probe.py")
    for args, want in ((["--lra-all"], "ok"), (["--chain"], "calls ran without a device error")):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, probe, *args], capture_output=True, text=True,
                             timeout=600)
        lines = [line for line in out.stdout.splitlines() if line.strip()]
        for line in lines:
            print(f"f4: {line}", flush=True)
        print(f"f4: {' '.join(args)} exit code {out.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(out.returncode == 0 and bool(lines) and (
            all(line.endswith(want) for line in lines) if want == "ok"
            else want in lines[-1]), f"f4: nan_probe.py {' '.join(args)}")

    # 8. K11 at hello_psgd's and the RNN's n and its cap, K12 at the bench
    #    rows, both at the edge sizes: update and update+apply against the
    #    plain rank-2 form, two calls bit-equal
    g.manual_seed(8)
    dense_err = {"dense_upd": 0.0, "dense_big": 0.0}
    dense_times, dense_bound = {}, {}
    for n in DENSE_EDGE + DENSE_K11 + DENSE_K12:
        name, mod = ("dense_upd", dense_upd) if n <= dense_upd.MAX_N else ("dense_big", dense_big)
        check(dense.route(n, dev) == name, f"dense route at n={n}")
        q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
        q += 0.8 * torch.eye(n, device=dev)
        with hopper.disabled():
            for _ in range(2):
                q = dense_upd.fused_update(q, *(torch.randn(n, generator=g, device=dev)
                                                for _ in range(2)), 0.1)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        before, before_tri = hopper.counts[name], hopper.counts["tri"]
        got = mod.fused_update(q, v, h, 0.1)
        got_q, got_pre = mod.fused_update_apply(q, v, h, gr, 0.1)
        torch.cuda.synchronize()
        # K3 inverts the 128 x 128 diagonal blocks inside K11's one launch,
        # and as the first of K12's four
        check(hopper.counts[name] == before + 2
              and hopper.counts["tri"] == before_tri + (0 if name == "dense_upd" else 2),
              f"{name} and K3 launched at n={n}")
        again_q, again_pre = mod.fused_update_apply(q, v, h, gr, 0.1)
        bit_ok = torch.equal(again_q, got_q) and torch.equal(again_pre, got_pre)
        ref_q, ref_pre = dense_upd.update_apply_plain(q, v, h, gr, 0.1)
        pairs = [(got, ref_q), (got_q, ref_q), (got_pre, ref_pre)]
        rel = max(_rel(a, b) for a, b in pairs)
        dense_err[name] = max(dense_err[name], max(_abs(a, b) for a, b in pairs))
        tri_ok = torch.count_nonzero(torch.tril(got_q, -1)).item() == 0
        check(rel < TOL_K1 and tri_ok and bit_ok, f"{name} vs plain at n={n}, two calls bit-equal")
        del ref_q, ref_pre, again_q, again_pre
        dense_times[n] = _time_ab(torch, hopper, lambda: dense.update_apply(
            dense.DenseState(Q=q), v, h, gr, 0.1), 5 if n > 8192 else 20)
        # Q's upper triangle read once, Q' written once (out of place, its
        # zeros too), v, h, g read, P' g written; ~8 n^2 FLOPs
        dense_bound[n] = _bound(*family_work("dense", n))
        print(f"{name}: n={n} max rel err {rel:.3e} (tol {TOL_K1:.0e}), lower part exactly 0: "
              f"{tri_ok}, two calls bit-equal: {bit_ok}; update+apply kernel {dense_times[n][0]:.4f} ms, plain "
              f"{dense_times[n][1]:.4f} ms, bound {dense_bound[n][0]:.4f} ms "
              f"({dense_bound[n][1]})", flush=True)
    n = DENSE_K11[1]
    kst = pst = dense.init(n, init_scale=0.8, device=dev)
    for _ in range(20):
        v, h = (torch.randn(n, generator=g, device=dev) for _ in range(2))
        kst = dense.update(kst, v, h, 0.1)
        with hopper.disabled():
            pst = dense.update(pst, v, h, 0.1)
    dense_traj = _rel(kst.Q, pst.Q)
    tri_ok = torch.count_nonzero(torch.tril(kst.Q, -1)).item() == 0
    print(f"dense_upd trajectory: n={n}, 20 steps max rel err {dense_traj:.3e} "
          f"(tol {TOL_TRAJ:.0e}), lower part exactly 0: {tri_ok}", flush=True)
    check(dense_traj < TOL_TRAJ and tri_ok, f"dense_upd 20-step trajectory at n={n}")
    for n, m, mod in [(1021, 1024, dense_upd), (4000, 4096, dense_big)]:
        # the TPU kernels' layout: Q padded with an identity block, zero probes
        q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
        q += 0.8 * torch.eye(n, device=dev)
        v, h = (torch.randn(n, generator=g, device=dev) for _ in range(2))
        qp = torch.eye(m, device=dev)
        qp[:n, :n] = q
        pad = lambda x: torch.cat([x, x.new_zeros(m - n)])
        got = mod.fused_update(qp, pad(v), pad(h), 0.1)
        ext_ok = (torch.equal(got[n:, n:], torch.eye(m - n, device=dev))
                  and torch.count_nonzero(got[:n, n:]).item() == 0)
        rel = _rel(got[:n, :n], mod.fused_update(q, v, h, 0.1))
        print(f"dense padded to {m}: identity extension untouched {ext_ok}, leading block max "
              f"rel err {rel:.3e}", flush=True)
        check(ext_ok and rel < TOL_K1, f"dense identity extension at {n} -> {m}")

    # 8b. K15 at the tensor decomposition's n and bench.py's 65,536, K16 at a
    #     ragged n past the cap and bench.py's 2^20, all r = 10: update and
    #     update+apply against the chain's plain stages and the direct form;
    #     then K16 at SPLU_RAGGED (ranks 1 to 33 at odd n); then K15's one
    #     launch timed at K15_AB under each of its schedules
    def splu_case(n, r=10):
        """A walked state (`splu.walked_state`) and fresh v, h, g."""
        return splu.walked_state(n, r, g, dev), [torch.randn(n, generator=g, device=dev)
                                                 for _ in range(3)]

    def fields(st):
        return st.Lt, st.l3, st.U12, st.u3

    g.manual_seed(81)
    splu_err = {"splu_one": 0.0, "splu_upd": 0.0}
    splu_times, splu_bounds = {}, {}
    for n in SPLU_K15 + SPLU_K16:
        name = "splu_one" if n in SPLU_K15 else "splu_upd"
        check(splu.route(10, n, dev) == name, f"splu route at n={n}")
        st, (v, h, gr) = splu_case(n)
        before = dict(hopper.counts)
        got = splu_upd.fused_update(*fields(st), v, h, 0.05) if name == "splu_upd" else \
            splu_one.fused_update(*fields(st), v, h, 0.05)
        got_st, got_pre = splu.update_apply(st, v, h, gr, 0.05)
        torch.cuda.synchronize()
        check(hopper.counts[name] == before[name] + 2, f"{name} launched at n={n}")
        with hopper.disabled():
            ref = splu_one.fused_update_apply(*fields(st), v, h, gr, 0.05)
            direct = splu.update(st, v, h, 0.05)
        pairs = list(zip(got, ref[:4])) + list(zip(fields(got_st), ref[:4]))
        pairs += [(got_pre, ref[4])] + list(zip(got, fields(direct)))
        rel = max(_rel(a, b) for a, b in pairs)
        splu_err[name] = max(splu_err[name], max(_abs(a, b) for a, b in pairs))
        L1, U1 = got_st.Lt[:, :10].T, got_st.U12[:, :10]
        tri_ok = torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
        check(rel < TOL_K1 and tri_ok, f"{name} vs plain at n={n}")
        reps = 20 if n > 10**5 else 100
        if name == "splu_one":
            splu_times[n] = _time_ab(torch, hopper, lambda: splu_one.fused_update_apply(
                *fields(st), v, h, gr, 0.05), reps)
        else:
            splu_times[n] = _time_ab(torch, hopper, lambda: splu_upd.fused_update(
                *fields(st), v, h, 0.05), reps)
        with hopper.disabled():
            direct_ms = _time(torch, lambda: splu.update_apply(st, v, h, gr, 0.05), reps)
        splu_bounds[n] = _bound(*splu_work(n, apply=name == "splu_one"))
        what = "update+apply" if name == "splu_one" else "update"
        print(f"{name}: n={n} r=10 max rel err {rel:.3e} (tol {TOL_K1:.0e}), corner triangles "
              f"exact: {tri_ok}; {what} kernel {splu_times[n][0]:.4f} ms, plain stages "
              f"{splu_times[n][1]:.4f} ms, bound {splu_bounds[n][0]:.4f} ms "
              f"({splu_bounds[n][1]}); the direct form's update+apply {direct_ms:.4f} ms",
              flush=True)
    # K16 at SPLU_RAGGED: update and update + apply against the plain
    # chain, one count each, bit-repeatable; zero probes on a balanced state
    # (L = U = 0.7 I) leave it exact
    for n, r in SPLU_RAGGED:
        st, (v, h, gr) = splu_case(n, r)
        before = dict(hopper.counts)
        got = splu_upd.fused_update(*fields(st), v, h, 0.05)
        fused = splu_upd.fused_update(*fields(st), v, h, 0.05, g=gr)
        torch.cuda.synchronize()
        moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
        with hopper.disabled():
            ref = splu_upd.fused_update(*fields(st), v, h, 0.05, g=gr)
        pairs = list(zip(got, ref[:4])) + list(zip(fused, ref))
        rel = max(_rel(a, b) for a, b in pairs)
        splu_err["splu_upd"] = max(splu_err["splu_upd"], max(_abs(a, b) for a, b in pairs))
        again = splu_upd.fused_update(*fields(st), v, h, 0.05)
        same = all(torch.equal(a, b) for a, b in zip(again, got))
        zst, z = splu.init(n, rank=r, init_scale=0.7, device=dev), torch.zeros(n, device=dev)
        zero_ok = all(torch.equal(a, b) for a, b in zip(
            splu_upd.fused_update(*fields(zst), z, z, 0.05), fields(zst)))
        print(f"splu_upd ragged: n={n} r={r} update and update+apply max rel err {rel:.3e} "
              f"(tol {TOL_K1:.0e}), launches {moved}, bit-equal again {same}, zero probes leave "
              f"a balanced state exact {zero_ok}", flush=True)
        check(rel < TOL_K1 and same and zero_ok
              and moved == {"splu_upd": 1, "splu_upd_apply": 1},
              f"splu_upd at ragged n={n} r={r}")
        del st, got, fused, ref, again, zst
    # K15's one launch at K15_AB: queued (behind a spinning kernel: the
    # card's own time) and chained, under the library's pick and each
    # forced schedule, all bit-equal to the chain (K16's kernels); the
    # plain chain; host us a call
    for n, r in K15_AB:
        st, (v, h, gr) = splu_case(n, r)
        fn = lambda: splu_one.fused_update_apply(*fields(st), v, h, gr, 0.05)
        chain = splu_upd.launch("splu_upd", *fields(st), v, h, 0.05, gr)
        row, bit = [], True
        for sched in ("auto", "grid", "cluster"):
            one = lambda: splu_upd.launch_mono("splu_one", *fields(st), v, h, 0.05, gr,
                                               schedule=sched)
            bit &= all(torch.equal(a, b) for a, b in zip(one(), chain, strict=True))
            grid = splu_upd.mono_grid(n, r, schedule=sched)
            row.append(f"{sched} ({grid['schedule']}, {grid['grid']} CTAs) queued "
                       f"{_time_queued(torch, one, 20):.4f} chained "
                       f"{_time_median(torch, one, 100):.4f}")
        chain_q = _time_queued(torch, lambda: splu_upd.launch("splu_upd", *fields(st), v, h,
                                                              0.05, gr), 20)
        with hopper.disabled():
            plain_ms = _time(torch, fn, 20)
        host_us = _host_ms(torch, fn, 100) * 1e3
        print(f"splu_one one launch: n={n} r={r} update+apply ms: {'; '.join(row)}; the chain "
              f"of launches queued {chain_q:.4f}; plain {plain_ms:.4f}; host {host_us:.1f} us a "
              f"call; every schedule bit-equal to the chain {bit}", flush=True)
        check(bit, f"splu_one one launch bit-equal to the chain at n={n} r={r}")
        del st, chain
    for n in (SPLU_K15[0], SPLU_K16[0]):
        kst, _ = splu_case(n)
        pst = kst
        for _ in range(20):
            v, h = (torch.randn(n, generator=g, device=dev) for _ in range(2))
            kst = splu.update(kst, v, h, 0.05)
            with hopper.disabled():
                pst = splu.update(pst, v, h, 0.05)
        traj = max(_rel(a, b) for a, b in zip(fields(kst), fields(pst)))
        print(f"{splu.route(10, n, dev)} trajectory: n={n}, 20 steps against the direct form, "
              f"max rel err {traj:.3e} (tol {TOL_TRAJ:.0e})", flush=True)
        check(traj < TOL_TRAJ, f"splu 20-step trajectory at n={n}")

    # 8c. path: the sparse-LU fused apply entry (`splu_upd.fused_update(g=...)`,
    #     the chain with g) and the one-launch kernel (`fused_update_apply_mono`,
    #     one launch, past rank 32 too), which no optimizer routes (as in the JAX
    #     package), through their own entry points at SPLU_APPLY; then each
    #     against the plain chain and the direct form followed by `splu.apply`,
    #     mono against the chain bit for bit, and the timings beside the routed
    #     pair (`splu.update_apply`) and the plain chain
    def hold_fused(st, v, h, gr, step, fused, mono):
        """(max rel err, {name: max abs err}, mono equal to the chain bit for
        bit, both repeat bit for bit, corner triangles exact) of the two
        entries' outputs against the plain chain and the direct form + apply."""
        with hopper.disabled():
            plain = splu_upd.fused_update(*fields(st), v, h, step, g=gr)
        direct = splu.update_plain(st, v, h, step)
        direct = fields(direct) + (splu.apply(direct, gr),)
        rel, errs, tri_ok = 0.0, {}, True
        for name, got in (("splu_upd_apply", fused), ("splu_upd_mono", mono)):
            rel = max([rel] + [_rel(a, b) for a, b in zip(got, plain)]
                      + [_rel(a, b) for a, b in zip(got, direct)])
            errs[name] = max(_abs(a, b) for a, b in zip(got, plain))
            L1, U1 = got[0][:, :st.rank].T, got[2][:, :st.rank]
            tri_ok &= torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
        bit = all(torch.equal(a, b) for a, b in zip(mono, fused, strict=True))
        again = (splu_upd.fused_update(*fields(st), v, h, step, g=gr),
                 splu_upd.fused_update_apply_mono(*fields(st), v, h, gr, step))
        repeat = all(torch.equal(a, b) for got, rep in zip((fused, mono), again)
                     for a, b in zip(got, rep))
        return rel, errs, bit, repeat, tri_ok

    def time_fused(st, v, h, gr, step, reps):
        """ms per call of the fused entry, mono, the routed pair and the plain
        chain, in turns plain, apply, mono, pair, pair, mono, apply, plain."""
        fns = {"apply": lambda: splu_upd.fused_update(*fields(st), v, h, step, g=gr),
               "mono": lambda: splu_upd.fused_update_apply_mono(*fields(st), v, h, gr, step),
               "pair": lambda: splu.update_apply(st, v, h, gr, step)}
        ms = {k: 0.0 for k in ("plain", *fns)}
        for k in ("plain", "apply", "mono", "pair", "pair", "mono", "apply", "plain"):
            if k == "plain":
                with hopper.disabled():
                    ms[k] += _time(torch, fns["apply"], reps) / 2
            else:
                ms[k] += _time(torch, fns[k], reps) / 2
        return ms

    g.manual_seed(83)
    apply_in = [splu_case(n, r) for n, r in SPLU_APPLY]
    torch.cuda.synchronize()
    hopper.reset_counts()
    apply_outs = [(splu_upd.fused_update(*fields(st), v, h, 0.05, g=gr),
                   splu_upd.fused_update_apply_mono(*fields(st), v, h, gr, 0.05))
                  for st, (v, h, gr) in apply_in]
    torch.cuda.synchronize()
    counts = dict(hopper.counts)
    path_counts()
    want = {"splu_upd_apply": len(SPLU_APPLY), "splu_upd_mono": len(SPLU_APPLY)}
    print(f"splu fused apply and mono: {len(SPLU_APPLY)} cases {SPLU_APPLY}, launches "
          f"{({k: c for k, c in counts.items() if c})}", flush=True)
    check(counts == {k: want.get(k, 0) for k in counts},
          f"splu fused apply and mono: launches {want} and no other")
    apply_err = {"splu_upd_apply": 0.0, "splu_upd_mono": 0.0}
    apply_times, apply_bounds = {}, {}
    for (n, r), (st, (v, h, gr)), (fused, mono) in zip(SPLU_APPLY, apply_in, apply_outs):
        rel, errs, bit, repeat, tri_ok = hold_fused(st, v, h, gr, 0.05, fused, mono)
        for name in apply_err:
            apply_err[name] = max(apply_err[name], errs[name])
        check(rel < TOL_K1 and bit and repeat and tri_ok,
              f"splu fused apply and mono vs plain at n={n} r={r}")
        grid = splu_upd.mono_grid(n, r)
        ms = time_fused(st, v, h, gr, 0.05, 20 if n > 10**5 else 100)
        bound = _bound(*splu_work(n, r, apply=True))
        if r == 10:
            apply_times[n], apply_bounds[n] = ms, bound
        print(f"splu fused apply and mono: n={n} r={r} max rel err {rel:.3e} (tol {TOL_K1:.0e}) "
              f"against the plain chain and the direct form + apply, max abs err "
              f"{max(errs.values()):.3e}; mono bit-equal to the chain {bit}, both repeat bit for "
              f"bit {repeat}, corner triangles exact {tri_ok}; mono grid {grid['grid']} CTAs "
              f"({grid['per_sm']} a SM x {grid['sms']} SMs, {grid['regs']} registers a thread); "
              f"fused apply {ms['apply']:.4f} ms, mono {ms['mono']:.4f} ms, routed pair "
              f"({splu.route(r, n, dev)} + apply) {ms['pair']:.4f} ms, plain chain "
              f"{ms['plain']:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    del apply_in, apply_outs

    # 8d. path: lra and splu past the rank-32 kernels (ROADMAP F2, repaired):
    #     K13 under the four coin pairs and K15/K16 at each of
    #     RANKS_PAST_32 against their plain chains and the direct forms,
    #     update and update + apply; K13 and K16 timed at RANK_BENCH; then
    #     PSGD under splu on LeNet5 (K16) and under lra and splu on the
    #     tensor decomposition (K13, K15) at each rank, 20 steps with the
    #     kernels against the same steps under disabled()
    g.manual_seed(84)
    rank_err = {"lra_upd": 0.0, "splu_one": 0.0, "splu_upd": 0.0}
    torch.cuda.synchronize()
    hopper.reset_counts()
    for r in RANKS_PAST_32:
        st, (v, h, gr) = lra_case(RANK_N, r)
        for coins in COINS:
            uv, d = lra_upd.fused_update(st.UV, st.d, v, h, 0.05, coins)
            got = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, coins)
            with hopper.disabled():
                ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, coins)
            duv, dd_ = lra_upd.update_plain(st.UV, st.d, v, h, 0.05, coins)
            pairs = [(uv, ref[0]), (d, ref[1]), *zip(got, ref), (uv, duv), (d, dd_)]
            rel = max(_rel(a, b) for a, b in pairs)
            rank_err["lra_upd"] = max(rank_err["lra_upd"], max(_abs(a, b) for a, b in pairs))
            check(rel < TOL_K1, f"k13 r={r} vs plain at n={RANK_N}, coins {coins}")
        print(f"k13 past rank 32: n={RANK_N} r={r}, four coin pairs, max rel err {rel:.3e} "
              f"(last pair; tol {TOL_K1:.0e})", flush=True)
        del st, uv, d, got, ref, duv, dd_, pairs
        for n in (SPLU_K15[0], RANK_N):
            name = "splu_one" if splu_one.fits(r, n) else "splu_upd"
            check(splu.route(r, n, dev) == name, f"splu route at n={n} r={r}")
            st, (v, h, gr) = splu_case(n, r)
            got = splu_upd.fused_update(*fields(st), v, h, 0.05)
            got_st, got_pre = splu.update_apply(st, v, h, gr, 0.05)
            with hopper.disabled():
                ref = splu_one.fused_update_apply(*fields(st), v, h, gr, 0.05)
            direct = splu.update_plain(st, v, h, 0.05)
            pairs = list(zip(got, ref[:4])) + list(zip(fields(got_st), ref[:4]))
            pairs += [(got_pre, ref[4])] + list(zip(got, fields(direct)))
            rel = max(_rel(a, b) for a, b in pairs)
            rank_err[name] = max(rank_err[name], max(_abs(a, b) for a, b in pairs))
            L1, U1 = got_st.Lt[:, :r].T, got_st.U12[:, :r]
            tri_ok = torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
            print(f"{name} past rank 32: n={n} r={r} max rel err {rel:.3e} (tol {TOL_K1:.0e}), "
                  f"corner triangles exact: {tri_ok}", flush=True)
            check(rel < TOL_K1 and tri_ok, f"{name} r={r} vs plain at n={n}")
            del st, got, got_st, got_pre, ref, direct, pairs
    torch.cuda.synchronize()
    counts = dict(hopper.counts)
    want = {"lra_upd": 8 * len(RANKS_PAST_32), "splu_upd": 2 * len(RANKS_PAST_32),
            "splu_one": sum(splu_one.fits(r, SPLU_K15[0]) for r in RANKS_PAST_32)}
    want["splu_upd"] += 2 * len(RANKS_PAST_32) - want["splu_one"]
    check({k: c for k, c in counts.items() if c} == want,
          f"past rank 32: launches {want}, got {({k: c for k, c in counts.items() if c})}")
    path_counts()
    n, r = RANK_BENCH
    st, (v, h, gr) = lra_case(n, r)
    rank_ms = {"k13": _time_ab(torch, hopper, lambda: lra_upd.fused_update_apply(
        st.UV, st.d, v, h, gr, 0.05, (False, True)), 20)}
    del st
    st, (v, h, gr) = splu_case(n, r)
    rank_ms["k16"] = _time_ab(torch, hopper, lambda: splu_upd.fused_update(*fields(st), v, h,
                                                                           0.05), 20)
    del st
    n15 = SPLU_K15[0]
    st, (v, h, gr) = splu_case(n15, r)
    rank_ms["k15"] = _time_ab(torch, hopper, lambda: splu_one.fused_update_apply(
        *fields(st), v, h, gr, 0.05), 100)
    del st
    lra_b = _bound(*family_work("lra", n, r))  # as phase 7's
    splu_b = _bound(*splu_work(n, r, apply=False))
    k15_b = _bound(*splu_work(n15, r, apply=True))
    print(f"past rank 32, n={n} r={r}: K13 update+apply kernel {rank_ms['k13'][0]:.4f} ms, plain "
          f"{rank_ms['k13'][1]:.4f} ms, bound {lra_b[0]:.4f} ms ({lra_b[1]}); K16 update kernel "
          f"{rank_ms['k16'][0]:.4f} ms, plain {rank_ms['k16'][1]:.4f} ms, bound {splu_b[0]:.4f} "
          f"ms ({splu_b[1]}); K15 update+apply at n={n15} kernel {rank_ms['k15'][0]:.4f} ms, "
          f"plain {rank_ms['k15'][1]:.4f} ms, bound {k15_b[0]:.4f} ms ({k15_b[1]})", flush=True)

    def decomp_run(fam, r):
        """RANK_DECOMP_STEPS PSGD steps on the tensor decomposition (the
        workload's recipe at rank r): the parameters, losses and launches."""
        gen = torch.Generator(device=dev).manual_seed(r)
        target, params = tensor_decomp.make_target(gen), tensor_decomp.init(gen)
        opt = PSGD(preconditioner=fam, rank=r, init_scale=0.1, lr_params=0.1,
                   lr_preconditioner=0.1)
        state = opt.init(params, seed=r)
        losses = []
        torch.cuda.synchronize()
        hopper.reset_counts()
        for _ in range(RANK_DECOMP_STEPS):
            params, state, aux = opt.step(tensor_decomp.loss, params, state, gen, target)
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        return torch.cat([p.flatten() for p in params]), torch.stack(losses), dict(hopper.counts)

    def lenet_run(r):
        """RANK_DECOMP_STEPS PSGD splu steps on LeNet5 (n = 44,426: past
        K15's cap at every rank past 32, so K16), each step's K16 call held
        against the plain chain on that step's own state and probes: the
        largest of those errors, the losses, the launches."""
        gen = torch.Generator(device=dev).manual_seed(90 + r)
        params = lenet5.init(gen)
        opt = PSGD(preconditioner="splu", rank=r, lr_params=0.1, lr_preconditioner=0.1,
                   grad_clip_max_norm=0.1 * math.sqrt(sum(p.numel() for p in params)))
        state = opt.init(params, seed=r)
        batches = [mnist.synthetic_hard(gen, 64) for _ in range(RANK_DECOMP_STEPS)]
        errs, losses = [0.0], []

        def held(st, v, h, gr, step=0.01):
            out = splu_update_apply(st, v, h, gr, step)
            with hopper.disabled():
                ref = splu_upd.fused_update(*fields(st), v, h, step)
            errs.append(max(_rel(a, b) for a, b in zip(fields(out[0]), ref)))
            return out

        splu.update_apply = held
        try:
            torch.cuda.synchronize()
            hopper.reset_counts()
            for x, y in batches:
                params, state, aux = opt.step(lenet5.loss, params, state, gen, x, y)
                losses.append(aux["loss"])
            torch.cuda.synchronize()
        finally:
            splu.update_apply = splu_update_apply
        return max(errs), torch.stack(losses), dict(hopper.counts), state.precond.Lt.shape[1]

    splu_update_apply = splu.update_apply
    for r in RANKS_PAST_32:
        err, kl, counts, n = lenet_run(r)
        path_counts()
        key = splu.route(r, n, dev)
        print(f"psgd splu past rank 32: LeNet5 n={n} r={r}, route {key}, {RANK_DECOMP_STEPS} steps, "
              f"launches {({k: c for k, c in counts.items() if c})}, loss {kl[0].item():.4f} -> "
              f"{kl[-1].item():.4f}; each step's K16 against the plain chain on its state and "
              f"probes, max rel err {err:.3e} (tol {TOL_K1:.0e})", flush=True)
        check(key == "splu_upd" and counts.get(key) == RANK_DECOMP_STEPS and err < TOL_K1
              and bool(torch.isfinite(kl).all()),
              f"psgd splu r={r} on LeNet5: one K16 launch a step, each within {TOL_K1:.0e}")

    for fam, name, tol in [("lra", "lra_upd", 2e-3), ("splu", None, TOL_TRAJ)]:
        for r in RANKS_PAST_32:
            kp, kl, counts = decomp_run(fam, r)
            path_counts()
            with hopper.disabled():
                pp, pl, _ = decomp_run(fam, r)
            key = name or splu.route(r, kp.numel(), dev)
            traj = max(_rel(kp, pp), _rel(kl, pl))
            print(f"psgd {fam} past rank 32: tensor decomposition r={r}, {RANK_DECOMP_STEPS} "
                  f"steps, launches {({k: c for k, c in counts.items() if c})}, loss "
                  f"{kl[0].item():.4f} -> {kl[-1].item():.4f}; parameters and losses against "
                  f"the plain steps max rel err {traj:.3e} (tol {tol:.0e})", flush=True)
            check(counts.get(key) == RANK_DECOMP_STEPS and traj < tol
                  and bool(torch.isfinite(kl).all()),
                  f"psgd {fam} r={r}: one {key} launch a step, trajectory within {tol:.0e}")

    # 9. path: LeNet5, exact Hvp, batch 64
    g.manual_seed(9)
    params = lenet5.init(g)
    n_params = sum(p.numel() for p in params)
    opt = PSGD(preconditioner="kron", kron_formats=dd, lr_params=0.1, lr_preconditioner=0.1,
               grad_clip_max_norm=0.1 * math.sqrt(n_params))
    state = opt.init(params)
    routes = [kron.route(st.fmt, (st.ql.shape[0], st.qr.shape[0]), dev) for st in state.precond]
    check(routes == ["kron_dd"] * 5, f"LeNet5 routes {routes}")
    batches = [mnist.synthetic_hard(g, 64) for _ in range(LENET_STEPS)]
    losses = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    hopper.reset_counts()
    for i, (x, y) in enumerate(batches):
        if i == WARMUP:
            ev0.record()
        params, state, aux = opt.step(lenet5.loss, params, state, g, x, y)
        losses.append(aux["loss"])
    ev1.record()
    ev1.synchronize()
    counts = dict(hopper.counts)
    path_counts()
    steps_per_s = (LENET_STEPS - WARMUP) / (ev0.elapsed_time(ev1) / 1e3)
    losses = torch.stack(losses).cpu()
    first, last20 = losses[0].item(), losses[-20:].mean().item()
    print(f"lenet5: {LENET_STEPS} steps, routes {routes}, launches {counts}, loss {first:.4f} "
          f"-> mean of last 20 {last20:.4f}, {steps_per_s:.1f} steps/s with kernels", flush=True)
    lenet_mono = int(kron_dd.route(*_chain_list(kron, dd, LENET5)) == "mono")
    check(counts["kron_multi"] == LENET_STEPS, "LeNet5: K1 launched once per step")
    check(counts["tri"] == LENET_STEPS * (1 - lenet_mono)
          and counts["kron_mono"] == LENET_STEPS * lenet_mono,
          "LeNet5: K1's chain with its K3, or its one launch, once per step")
    check(bool(torch.isfinite(losses).all()), "LeNet5: finite losses")
    check(last20 < 0.5 * first, "LeNet5: loss falls below half its first value")

    with hopper.disabled():
        for i, (x, y) in enumerate(batches[: WARMUP + 100]):
            if i == WARMUP:
                ev0.record()
            params, state, aux = opt.step(lenet5.loss, params, state, g, x, y)
        ev1.record()
        ev1.synchronize()
    plain_steps_per_s = 100 / (ev0.elapsed_time(ev1) / 1e3)
    print(f"lenet5: {plain_steps_per_s:.1f} steps/s under disabled() (plain versions)",
          flush=True)

    # 9b. path: the same LeNet5 recipe with a bf16 Kronecker state: every
    #     update takes the plain one on the card (the JAX package sends
    #     non-fp32 states to XLA), no kernel launches
    gen = torch.Generator(device=dev).manual_seed(19)
    params = lenet5.init(gen)
    opt = PSGD(preconditioner="kron", kron_formats=dd, lr_params=0.1, lr_preconditioner=0.1,
               grad_clip_max_norm=0.1 * math.sqrt(n_params), dtype=torch.bfloat16)
    state = opt.init(params)
    routes = [kron.route(st.fmt, (st.ql.shape[0], st.qr.shape[0]), dev, torch.bfloat16)
              for st in state.precond]
    torch.cuda.synchronize()
    hopper.reset_counts()
    losses = []
    for _ in range(BF16_STEPS):
        params, state, aux = opt.step(lenet5.loss, params, state, gen,
                                      *mnist.synthetic_hard(gen, 64))
        losses.append(aux["loss"])
    losses = torch.stack(losses).cpu()
    counts = dict(hopper.counts)
    bf16_ok = all(q.dtype == torch.bfloat16 for st in state.precond for q in (st.ql, st.qr))
    print(f"lenet5 bf16 state: {BF16_STEPS} steps, routes {routes}, launches "
          f"{({k: c for k, c in counts.items() if c})}, state bf16 {bf16_ok}, loss "
          f"{losses[0].item():.4f} -> {losses[-1].item():.4f}", flush=True)
    check(routes == ["plain"] * 5 and not any(counts.values()),
          "LeNet5 bf16: every update plain, no kernel launched")
    check(bf16_ok and bool(torch.isfinite(losses).all()), "LeNet5 bf16: bf16 state, finite losses")

    # 10. path: NMT at the reference widths, FD Hvp, lr 0.02, clip 1.0,
    #    random ids per vocabulary (batch 64, source 18, target 13)
    def nmt_ref_run(fmts):
        """(routes, losses, counts, steps/s, Q states after step 1); `fmts`
        None gives PSGD no kron_formats (its default, 'auto')."""
        gen = torch.Generator(device=dev).manual_seed(0)
        params = nmt.init(gen, ref_cfg)
        opt = PSGD(preconditioner="kron", lr_params=0.02, lr_preconditioner=0.02,
                   grad_clip_max_norm=1.0, exact_hessian_vector_product=False,
                   **({} if fmts is None else {"kron_formats": fmts}))
        state = opt.init(params)
        routes = [kron.route(st.fmt, (st.ql.shape[-1], st.qr.shape[-1]), dev)
                  for st in state.precond]
        batches = [translation.random_tokens(gen, ref_cfg.vocab_src, ref_cfg.vocab_tgt)
                   for _ in range(NMT_REF_STEPS)]
        losses = []
        torch.cuda.synchronize()
        hopper.reset_counts()
        for i, (src, tgt) in enumerate(batches):
            if i == NMT_REF_WARMUP:
                ev0.record()
            params, state, aux = opt.step(nmt.loss, params, state, gen, src, tgt)
            losses.append(aux["loss"])
            if i == 0:
                first = state.precond
        ev1.record()
        ev1.synchronize()
        rate = (NMT_REF_STEPS - NMT_REF_WARMUP) / (ev0.elapsed_time(ev1) / 1e3)
        return routes, torch.stack(losses).cpu(), dict(hopper.counts), rate, first

    routes, losses, counts, ref_rate, _ = nmt_ref_run(nmt_fmts)
    path_counts()
    want = ["kron_sparse_big:ds", "kron_sparse_big:ns", "kron_sparse_big:ds", "kron_dd",
            "kron_sparse_big:ds", "kron_sparse_big:ns", "kron_sparse_big:ns"]
    print(f"nmt ref: {NMT_REF_STEPS} steps, {sum(m * n for m, n in ref_shapes)} parameters, "
          f"routes {routes}, launches {counts}, loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f}, {ref_rate:.2f} steps/s with kernels", flush=True)
    check(routes == want, f"NMT reference routes {routes}")
    # the (dense, dense) row's K2: one launch, or the chain with its K3
    (row,) = [sh for f, sh in zip(nmt_fmts, ref_shapes) if f == DD]
    row_mono = int(kron_dd.route(["dd"], [row[0]], [row[1]]) == "mono")
    per_step = {"kron_sparse_big_ds": 3, "kron_sparse_big_ns": 3, "kron_dd": 1,
                "kron_multi": 0, "tri": 4 - row_mono, "kron_mono": row_mono,
                **_attn_launches(12, 2)}
    for name, n in per_step.items():
        check(counts[name] == n * NMT_REF_STEPS, f"NMT reference: {n} {name} launches per step")
    check(bool(torch.isfinite(losses).all()), "NMT reference: finite losses")
    with hopper.disabled():
        _, plain_losses, _, ref_plain_rate, _ = nmt_ref_run(nmt_fmts)
    print(f"nmt ref: {ref_plain_rate:.2f} steps/s under disabled() (plain versions), loss "
          f"{plain_losses[0].item():.4f} -> {plain_losses[-1].item():.4f}", flush=True)

    # 10b. path: the same model and recipe under PSGD's default formats
    routes, losses, counts, auto_rate, auto_first = nmt_ref_run(None)
    path_counts()
    nd, ns = "kron_sparse_big:nd", "kron_sparse_big:ns"
    print(f"nmt ref auto: {NMT_REF_STEPS} steps, formats {auto_fmts}, routes {routes}, launches "
          f"{({k: c for k, c in counts.items() if c})}, loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f}, {auto_rate:.2f} steps/s with kernels", flush=True)
    check(routes == [nd, nd, nd, "kron_dd", nd, nd, ns], f"NMT reference auto routes {routes}")
    # per step: five K9 chains (each with its K3), the fc's K6, the row's K2
    per_step = {"kron_sparse_big_nd": 5, "kron_sparse_big_ns": 1, "kron_dd": 1,
                "tri": 6 - row_mono, "kron_mono": row_mono, **_attn_launches(12, 2)}
    check(counts == {k: per_step.get(k, 0) * NMT_REF_STEPS for k in counts},
          f"NMT reference auto: launches per step {per_step} and no other")
    check(bool(torch.isfinite(losses).all()), "NMT reference auto: finite losses")
    with hopper.disabled():
        _, plain_losses, _, auto_plain_rate, plain_first = nmt_ref_run(None)
    loss_rel = _rel(losses, plain_losses)
    first_rel, _ = _state_errs(auto_first, plain_first)
    print(f"nmt ref auto: {auto_plain_rate:.2f} steps/s under disabled() (plain versions), loss "
          f"{plain_losses[0].item():.4f} -> {plain_losses[-1].item():.4f}; the loss traces differ "
          f"by {loss_rel:.3e} relative (tol {TOL_TRAJ:.0e}), the Q states after step 1 by "
          f"{first_rel:.3e} (tol {TOL_K1:.0e})", flush=True)
    check(loss_rel < TOL_TRAJ, "NMT reference auto: kernel and plain losses agree")
    check(first_rel < TOL_K1, "NMT reference auto: kernel and plain Q states agree after step 1")
    del auto_first, plain_first

    # 10c. path: the kron capacity envelope through kron.update, as
    #      bench.py's bench_kron_sparse_gelem_per_sec drives its kron_nd and
    #      kron_ns_wide rows, plus a width past 2^21 lanes
    envelope = [(("norm", "dense"), K9_BENCH)] + [(f, s) for f, s, _ in WIDE_NS if f[0] == "norm"]
    g.manual_seed(101)
    torch.cuda.synchronize()
    hopper.reset_counts()
    finite = True
    for fmt, shape in envelope:
        st = kron.init(shape, fmt=fmt, init_scale=0.8, device=dev)
        for _ in range(ENVELOPE_STEPS):
            (dx,), (dg,) = probes([shape])
            st = kron.update(st, dx, dg, step=0.02)
        finite = finite and bool(torch.isfinite(st.ql).all() and torch.isfinite(st.qr).all())
        del st, dx, dg
    torch.cuda.synchronize()
    counts = dict(hopper.counts)
    path_counts()
    torch.cuda.empty_cache()
    print(f"kron envelope: {[s for _, s in envelope]}, {ENVELOPE_STEPS} updates each, launches "
          f"{({k: c for k, c in counts.items() if c})}, finite {finite}", flush=True)
    want = {"kron_sparse_big_nd": ENVELOPE_STEPS, "tri": ENVELOPE_STEPS,
            "kron_sparse_big_ns_wide2": ENVELOPE_STEPS,
            "kron_sparse_big_ns_wide_xla": ENVELOPE_STEPS}
    check(counts == {k: want.get(k, 0) for k in counts} and finite,
          "kron envelope: one K9 (+ K3), K7 and K8 launch per update, finite")

    # 10d. path: K4 through PSGD.step, the NMT model at K4_NMT under PSGD's
    #      defaults, exact Hvp, random ids per vocabulary (batch 64)
    def k4_path_run():
        """(KronPrecond layout, losses, counts, steps/s)"""
        gen = torch.Generator(device=dev).manual_seed(0)
        params = nmt.init(gen, k4_cfg)
        opt = PSGD(preconditioner="kron", lr_params=0.05, lr_preconditioner=0.05,
                   grad_clip_max_norm=1.0)
        state = opt.init(params)
        pc = state.precond
        layout = (pc.batched_idx, pc.single_idx) if isinstance(pc, KronPrecond) else None
        batches = [translation.random_tokens(gen, k4_cfg.vocab_src, k4_cfg.vocab_tgt)
                   for _ in range(K4_PATH_STEPS)]
        losses = []
        torch.cuda.synchronize()
        hopper.reset_counts()
        for i, (src, tgt) in enumerate(batches):
            if i == NMT_REF_WARMUP:
                ev0.record()
            params, state, aux = opt.step(nmt.loss, params, state, gen, src, tgt)
            losses.append(aux["loss"])
        ev1.record()
        ev1.synchronize()
        rate = (K4_PATH_STEPS - NMT_REF_WARMUP) / (ev0.elapsed_time(ev1) / 1e3)
        return layout, torch.stack(losses).cpu(), dict(hopper.counts), rate

    layout, losses, counts, k4_rate = k4_path_run()
    path_counts()
    print(f"k4 path: NMT {K4_NMT}, {sum(m * n for m, n in nmt.layer_shapes(k4_cfg))} parameters, "
          f"{K4_PATH_STEPS} steps, KronPrecond (batched, single) {layout}, launches "
          f"{({k: c for k, c in counts.items() if c})}, loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f}, {k4_rate:.2f} steps/s with kernels", flush=True)
    check(layout == (((1, 2, 3, 5),), (0, 4, 6)), f"K4 path: one bucket of four: {layout}")
    # per step: one K4 chain with its K3, two K9 and one K10 (each with its K3)
    per_step = {"kron_dd_batched": 1, "kron_sparse_big_nd": 2, "kron_sparse_big_ds": 1, "tri": 4}
    check(counts == {k: per_step.get(k, 0) * K4_PATH_STEPS for k in counts},
          f"K4 path: launches per step {per_step} and no other")
    check(bool(torch.isfinite(losses).all()), "K4 path: finite losses")
    with hopper.disabled():
        _, plain_losses, _, k4_plain_rate = k4_path_run()
    loss_rel = _rel(losses, plain_losses)
    print(f"k4 path: {k4_plain_rate:.2f} steps/s under disabled() (plain versions), loss "
          f"{plain_losses[0].item():.4f} -> {plain_losses[-1].item():.4f}; the loss traces differ "
          f"by {loss_rel:.3e} relative (tol {TOL_TRAJ:.0e})", flush=True)
    check(loss_rel < TOL_TRAJ, "K4 path: kernel and plain losses agree")

    # 10f. the NMT model's attention kernels (`ops/hopper/attention.py`) at
    #      toy widths, a ragged U at the A limit and the cells' shapes
    hopper.reset_counts()
    attn_rows = attention_phase(torch, dev, check)
    path_counts()

    # 10g. Granite-4.0-H Micro's leaves (K6, K10, K4) and one PSGD.step of
    #      its first ten layers at its published widths
    hopper.reset_counts()
    granite_phase(torch, dev, check)
    path_counts()

    # 10e. path: lstm_xor at its reference widths: a loss trace of its
    #      recipe with the kernels and under disabled() from the same start,
    #      then `lstm_xor.run()` for LSTM_STEPS steps with the kernels
    def lstm_trace():
        """(losses, state, steps/s on the host clock)"""
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lstm.init(gen)
        opt = lstm_xor.optimizer()
        state = opt.init(params)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LSTM_TRACE_STEPS):
            params, state, aux = opt.step(lstm.loss, params, state, gen, *xor.batch(gen, 128, 100))
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        return torch.stack(losses).cpu(), state, LSTM_TRACE_STEPS / (time.perf_counter() - t0)

    hopper.reset_counts()
    losses, state, trace_rate = lstm_trace()
    counts = dict(hopper.counts)
    path_counts()
    with hopper.disabled():
        plain_losses, plain_state, trace_plain_rate = lstm_trace()
    loss_rel = _rel(losses, plain_losses)
    q_rel, _ = _state_errs(state.precond, plain_state.precond)
    print(f"lstm_xor: {LSTM_TRACE_STEPS}-step trace, launches {({k: c for k, c in counts.items() if c})}"
          f", loss {losses[0].item():.4f} -> {losses[-1].item():.4f}; kernel and plain loss traces "
          f"differ by {loss_rel:.3e}, the Q states by {q_rel:.3e} relative (tol {TOL_TRAJ:.0e}); "
          f"{trace_rate:.2f} steps/s with kernels, {trace_plain_rate:.2f} under disabled() (host "
          f"clock)", flush=True)
    lstm_mono = int(kron_dd.route(*_chain_list(
        kron, [st.fmt for st in state.precond],
        [(st.ql.shape[0], st.qr.shape[0]) for st in state.precond])) == "mono")
    per_step = {"kron_multi": 1, "tri": 1 - lstm_mono, "kron_mono": lstm_mono}
    check(counts == {k: per_step.get(k, 0) * LSTM_TRACE_STEPS for k in counts},
          f"lstm_xor: one K1 call (two layers) per step, {per_step}, and no other launch")
    check(loss_rel < TOL_TRAJ and q_rel < TOL_TRAJ, "lstm_xor: kernel and plain traces agree")
    check(bool(torch.isfinite(losses).all()), "lstm_xor: finite losses")

    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    lstm_out = lstm_xor.run(device=dev, max_iters=LSTM_STEPS, check_every=LSTM_STEPS)
    torch.cuda.synchronize()
    lstm_rate = LSTM_STEPS / (time.perf_counter() - t0)
    counts = dict(hopper.counts)
    path_counts()
    print(f"lstm_xor: run() {LSTM_STEPS} steps, launches {({k: c for k, c in counts.items() if c})}, "
          f"train loss at step {LSTM_STEPS} {lstm_out['loss']:.4f} (bar 0.1), {lstm_rate:.2f} "
          f"steps/s with kernels (host clock, init included)", flush=True)
    # run() draws what the trace drew: its first step's loss is the trace's
    check(counts["kron_multi"] == LSTM_STEPS and math.isfinite(lstm_out["loss"])
          and lstm_out["loss"] < losses[0].item(),
          "lstm_xor run(): one K1 chain per step, finite loss below the first step's")

    # 10f. path: the Kronecker family's unrouted kernels through their own
    #      entry points (no optimizer routes them, as in the JAX package):
    #      K17 on the reference NMT's (norm, scale) layers of the mixed
    #      formats and its five (norm, dense) layers under auto, each with a
    #      fresh G, and at the envelope shapes; K18 at the wide shapes; K19 on
    #      LeNet5's walked factors with probes as right-hand sides in all four
    #      orientations, at the JAX package's test cases and at SOLVE_BENCH;
    #      K20 on LeNet5's five layers and on 18 layers (two chains). Then
    #      each result against its plain version (and the applies against
    #      kron.apply, K20 against K1 with kinds dd), and the timings.
    g.manual_seed(102)
    NS, ND = ("norm", "scale"), ("norm", "dense")
    apply_cases = ([("fused_apply_ns", NS, s) for f, s in zip(nmt_fmts, ref_shapes) if f == NS]
                   + [("fused_apply_nd", ND, s) for s in nd_shapes]
                   + [("fused_apply_nd", ND, K9_BENCH), ("fused_apply_ns", NS, APPLY_NS_BENCH)]
                   + [("fused_apply_ns_wide", NS, s) for s in APPLY_WIDE])
    apply_states = [walked_states([f], [s], steps=2)[0] for _, f, s in apply_cases]
    apply_gs = [torch.randn(s, generator=g, device=dev) for _, _, s in apply_cases]
    lenet_states = walked_states(dd, LENET5)
    lenet_dxs, lenet_dgs = probes(LENET5)
    orients = [(lower, trans) for lower in (False, True) for trans in (False, True)]
    solve_cases = []  # (q, b, lower, trans): a lower system's Q is the factor's transpose
    for st, dx in zip(lenet_states, lenet_dxs):
        for q, b in ((st.ql, dx), (st.qr, dx.T.contiguous())):
            solve_cases += [(q.T.contiguous() if lo else q, b, lo, tr) for lo, tr in orients]
    for n, nrhs, lo, tr in SOLVE_JAX + [SOLVE_BENCH]:
        q = triu_factor(n)
        solve_cases.append((q.T.contiguous() if lo else q,
                            torch.randn((n, nrhs) if nrhs else (n,), generator=g, device=dev),
                            lo, tr))
    multi_shapes = [LENET5, MULTI_18]
    multi_layers = [(lenet_states, lenet_dxs, lenet_dgs)]
    multi_layers.append((walked_states([DD] * len(MULTI_18), MULTI_18, steps=2),
                         *probes(MULTI_18)))
    torch.cuda.synchronize()
    hopper.reset_counts()
    apply_outs = [getattr(kron_sparse_big, fn)(st.ql, st.qr, G)
                  for (fn, _, _), st, G in zip(apply_cases, apply_states, apply_gs)]
    solve_outs = [tri.solve_triangular(q, b, lower=lo, trans=tr) for q, b, lo, tr in solve_cases]
    multi_outs = [kron_dd.fused_update_multi([s.ql for s in sts], [s.qr for s in sts], dxs_, dgs_,
                                             0.1) for sts, dxs_, dgs_ in multi_layers]
    torch.cuda.synchronize()
    counts = dict(hopper.counts)
    path_counts()
    # K20: one chain for LeNet5, two for 18 layers, each one launch or with its K3
    k20_monos = sum(kron_dd.route(["dd"] * len(c), [m for m, _ in c], [n for _, n in c]) == "mono"
                    for c in [LENET5, MULTI_18[:16], MULTI_18[16:]])
    want = {"kron_sparse_big_apply_ns": 4, "kron_sparse_big_apply_nd": 6,
            "kron_sparse_big_apply_ns_wide": len(APPLY_WIDE), "tri_solve": len(solve_cases),
            "kron_dd_multi": 3, "tri": 3 - k20_monos, "kron_mono": k20_monos}
    want = {k: v for k, v in want.items() if v}
    print(f"unrouted kron: {len(apply_cases)} applies, {len(solve_cases)} solves, K20 on "
          f"{[len(s) for s in multi_shapes]} layers, launches "
          f"{({k: c for k, c in counts.items() if c})}", flush=True)
    check(counts == {k: want.get(k, 0) for k in counts},
          f"unrouted kron: launches {want} and no other")
    unrouted = {}
    for (fn, fmt, shape), st, G, got in zip(apply_cases, apply_states, apply_gs, apply_outs):
        name = "kron_sparse_big_" + fn.removeprefix("fused_")
        with hopper.disabled():
            ref = getattr(kron_sparse_big, fn)(st.ql, st.qr, G)
        rel, err = _rel(got, ref), _abs(got, ref)
        rel_apply = _rel(got, kron.apply(st, G))
        again = torch.equal(getattr(kron_sparse_big, fn)(st.ql, st.qr, G), got)
        acc = unrouted.setdefault(name, {"err": 0.0, "nmt_ms": 0.0, "nmt_plain_ms": 0.0})
        acc["err"] = max(acc["err"], err)
        check(rel < TOL_K1 and rel_apply < TOL_K1 and again and bool(torch.isfinite(got).all()),
              f"{name} vs plain and kron.apply at {shape}")
        m, n = shape
        reps = 10 if m * n > 10**7 else 100
        ms, plain_ms = _time_ab(torch, hopper, lambda: getattr(kron_sparse_big, fn)(
            st.ql, st.qr, G), reps)
        nq = n * (n + 1) / 2 if fmt == ND else n
        bound = _bound(4 * (2 * m * n + 2 * m + nq),
                       2 * m * n * n + n**3 / 3 + 6 * m * n if fmt == ND else 6 * m * n)
        if shape in (APPLY_NS_BENCH, K9_BENCH, APPLY_WIDE[0]):
            acc.update(ms=ms, plain_ms=plain_ms, bound=bound)
        elif shape in ref_shapes:
            acc["nmt_ms"] += ms
            acc["nmt_plain_ms"] += plain_ms
        extra = ""
        if fmt == ND and shape in (K9_BENCH, *ref_shapes):
            # the product alone in cuBLAS (fp32, TF32 off): a yardstick, no
            # PyTorch call computes the arrow's apply
            R = st.qr.T @ st.qr
            gemm_ms = _time(torch, lambda: torch.mm(G, R), reps)
            extra = f", cuBLAS's product G R alone {gemm_ms:.4f} ms"
            if shape == K9_BENCH:
                acc["gemm_ms"] = gemm_ms
            else:
                acc["nmt_gemm_ms"] = acc.get("nmt_gemm_ms", 0.0) + gemm_ms
        print(f"{name}: {shape} max rel err {rel:.3e} against the plain chain, {rel_apply:.3e} "
              f"against kron.apply (tol {TOL_K1:.0e}), max abs err {err:.3e}, repeats bit for "
              f"bit {again}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}){extra}", flush=True)
    for name in ("kron_sparse_big_apply_ns", "kron_sparse_big_apply_nd"):
        gemm = unrouted[name].get("nmt_gemm_ms")
        print(f"{name}: the NMT layers summed, kernel {unrouted[name]['nmt_ms']:.4f} ms, plain "
              f"{unrouted[name]['nmt_plain_ms']:.4f} ms"
              + (f", cuBLAS's products alone {gemm:.4f} ms" if gemm else ""), flush=True)
    del apply_states, apply_gs, apply_outs
    torch.cuda.empty_cache()

    solve_err = solve_rel = 0.0
    for (q, b, lo, tr), got in zip(solve_cases, solve_outs):
        ref = tri.solve_triangular_plain(q, b, lower=lo, trans=tr)
        solve_rel = max(solve_rel, _rel(got, ref))
        solve_err = max(solve_err, _abs(got, ref))
        check(got.shape == b.shape, f"tri_solve keeps b's rank at {tuple(b.shape)}")
    lenet_solves = solve_cases[:8 * len(LENET5)]
    lenet_ms, lenet_plain_ms = _time_ab(torch, hopper, lambda: [
        tri.solve_triangular(q, b, lower=lo, trans=tr) for q, b, lo, tr in lenet_solves], 50)
    print(f"tri_solve: {len(solve_cases)} systems (LeNet5's ten factors in four orientations "
          f"with the probes as right-hand sides, the JAX cases, {SOLVE_BENCH}) max rel err "
          f"{solve_rel:.3e} (tol {TOL_K3:.0e}, norm-relative) max abs err {solve_err:.3e}; "
          f"LeNet5's {len(lenet_solves)} solves, kernel {lenet_ms / len(lenet_solves):.4f} ms a "
          f"call, plain {lenet_plain_ms / len(lenet_solves):.4f} ms", flush=True)
    check(solve_rel < TOL_K3, "tri_solve vs plain")
    # SOLVE_BENCH in all four orientations, each beside one
    # torch.linalg.solve_triangular of the same system (the plain version
    # is that call behind the wrapper); the kernels line takes the first
    n, nrhs = SOLVE_BENCH[:2]
    solve_bound = _bound(4 * (n * (n + 1) / 2 + 2 * n * nrhs), n * n * nrhs)
    solve_bench = {}
    for lo, tr in orients:
        q = triu_factor(n)
        q = q.T.contiguous() if lo else q
        b = torch.randn(n, nrhs, generator=g, device=dev)
        got = tri.solve_triangular(q, b, lower=lo, trans=tr)
        ref = tri.solve_triangular_plain(q, b, lower=lo, trans=tr)
        rel, err = _rel(got, ref), _abs(got, ref)
        solve_err = max(solve_err, err)
        ms, plain_ms = _time_ab(torch, hopper, lambda: tri.solve_triangular(q, b, lower=lo,
                                                                            trans=tr), 20)
        m = q.T if tr else q
        lib_ms = _time(torch, lambda: torch.linalg.solve_triangular(m, b, upper=lo == tr), 20)
        solve_bench[(lo, tr)] = (ms, plain_ms, lib_ms)
        print(f"tri_solve: n={n} nrhs={nrhs} lower={lo} trans={tr}: max rel err {rel:.3e} (tol "
              f"{TOL_K3:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, one "
              f"torch.linalg.solve_triangular {lib_ms:.4f} ms, bound {solve_bound[0]:.4f} ms "
              f"({solve_bound[1]})", flush=True)
        check(rel < TOL_K3, f"tri_solve vs plain at {SOLVE_BENCH[:2]}, lower={lo}, trans={tr}")
    solve_ms, solve_plain_ms, solve_lib_ms = solve_bench[(False, False)]
    del solve_cases, solve_outs

    multi_err = 0.0
    for shapes, (sts, dxs_, dgs_), (got_qls, got_qrs) in zip(multi_shapes, multi_layers,
                                                             multi_outs):
        qls_, qrs_ = [s.ql for s in sts], [s.qr for s in sts]
        k1 = kron_multi.fused_update_multi(["dd"] * len(shapes), qls_, qrs_, dxs_, dgs_, 0.1)
        with hopper.disabled():
            ref_qls, ref_qrs = kron_dd.fused_update_multi(qls_, qrs_, dxs_, dgs_, 0.1)
        pairs = list(zip(got_qls + got_qrs, ref_qls + ref_qrs))
        rel = max(_rel(a, b) for a, b in pairs)
        multi_err = max(multi_err, max(_abs(a, b) for a, b in pairs))
        bit = all(torch.equal(a, c) and torch.equal(b, d)
                  for a, b, (c, d) in zip(got_qls, got_qrs, k1))
        ms, plain_ms = _time_ab(torch, hopper, lambda: kron_dd.fused_update_multi(
            qls_, qrs_, dxs_, dgs_, 0.1), 100)
        k1_dd_ms = _time(torch, lambda: kron_multi.fused_update_multi(
            ["dd"] * len(shapes), qls_, qrs_, dxs_, dgs_, 0.1), 100)
        work = [kron_work(DD, s) for s in shapes]
        bound = _bound(sum(w[0] for w in work), sum(w[1] for w in work))
        if shapes is LENET5:
            multi = dict(ms=ms, plain_ms=plain_ms, bound=bound)
        print(f"kron_dd_multi: {len(shapes)} layers max rel err {rel:.3e} (tol {TOL_K1:.0e}), "
              f"bit-equal to K1 with kinds dd {bit}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"K1 {k1_dd_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        check(rel < TOL_K1 and bit, f"kron_dd_multi vs plain and K1 at {len(shapes)} layers")
    del multi_layers, multi_outs

    # 11. path: the NMT workload at its toy widths, as nmt_attention.run() runs it
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = nmt_attention.run(device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(hopper.counts)
    path_counts()
    print(f"nmt toy: {out['steps']} steps, launches {counts}, loss {out['first_loss']:.4f} -> "
          f"{out['loss']:.4f}, held-out token accuracy {out['token_accuracy']:.4f} (bar 0.75), "
          f"{out['steps'] / seconds:.1f} steps/s with kernels (host clock, init and eval "
          f"included)", flush=True)
    toy_mono = int(kron_dd.route(*_chain_list(kron, nmt_fmts, toy_shapes)) == "mono")
    check(counts["kron_multi"] == out["steps"]
          and counts["kron_mono"] == out["steps"] * toy_mono
          and counts["tri"] == out["steps"] * (1 - toy_mono),
          "NMT toy: K1 launched once per step (one launch, or the chain with its K3)")
    check(math.isfinite(out["loss"]), "NMT toy: finite loss")
    check(out["token_accuracy"] > 0.75, "NMT toy: token accuracy above 0.75")

    # 12. path: hello_psgd, Rosenbrock with the dense family
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = hello_psgd.run(device=dev)
    seconds = time.perf_counter() - t0
    counts = dict(hopper.counts)
    path_counts()
    print(f"hello_psgd: {out['steps']} steps, launches {counts}, loss {out['loss']:.3e} "
          f"(bar 1e-4), {out['steps'] / seconds:.1f} steps/s (host clock, init included)",
          flush=True)
    check(dense.route(2, dev) == "dense_upd", "hello_psgd routes to K11")
    check(out["success"] and counts["dense_upd"] == out["steps"] == 500 and counts["tri"] == 0,
          "hello_psgd: loss below 1e-4 in 500 steps, one K11 launch per step (K3 inside it)")

    # 13. path: the delayed-XOR RNN with lra at the reference widths, the
    #     switch to the FD Hvp at step 1000
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = rnn_xor_lra.run(device=dev, switch_to_fd_at=1000, max_iters=RNN_MAX_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(hopper.counts)
    path_counts()
    print(f"rnn_xor_lra: {out['steps']} steps (FD Hvp from step 1000), launches {counts}, train "
          f"loss {out['loss']:.4f} (bar 0.1), {out['steps'] / seconds:.1f} steps/s with kernels "
          f"(host clock, init included)", flush=True)
    check(out["success"], "rnn_xor_lra: train loss below 0.1")
    check(counts["lra_upd"] == out["steps"], "rnn_xor_lra: one K13 launch per step")

    def rnn_window(steps=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rnn_xor_lra.run(device=dev, max_iters=steps, check_every=steps)
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0)

    rates = {"kernel": [], "plain": []}
    for mode in ("plain", "kernel", "kernel", "plain"):
        if mode == "plain":
            with hopper.disabled():
                rates[mode].append(rnn_window())
        else:
            rates[mode].append(rnn_window())
    print(f"rnn_xor_lra: 200-step windows, {sum(rates['kernel']) / 2:.1f} steps/s with kernels, "
          f"{sum(rates['plain']) / 2:.1f} under disabled() (plain versions)", flush=True)

    # 14. path: the UVd class on the same RNN; exact -> FD Hvp at step 100,
    #     lr_params halved at step 150
    gen = torch.Generator(device=dev).manual_seed(1)
    opt = UVd(rnn.init(gen), rank_of_modification=10, grad_clip_max_norm=1.0, seed=1,
              generator=gen)
    torch.cuda.synchronize()
    hopper.reset_counts()
    losses = []
    for i in range(UVD_STEPS):
        if i == 100:
            opt.exact_hessian_vector_product = False
        if i == 150:
            opt.lr_params = 0.005
        losses.append(opt.step(rnn.loss, *xor.batch(gen, 128, 16)))
    losses = torch.stack(losses).cpu()
    counts = dict(hopper.counts)
    path_counts()
    print(f"uvd: {UVD_STEPS} steps, launches {counts}, loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f}, lr_params {opt.lr_params}, exact Hvp "
          f"{opt.exact_hessian_vector_product}", flush=True)
    check(bool(torch.isfinite(losses).all()) and counts["lra_upd"] == UVD_STEPS,
          "UVd: finite losses, one K13 launch per step")
    check(opt.lr_params == 0.005 and not opt.exact_hessian_vector_product, "UVd: setters")

    # 15. path: the dense family on the RNN at hidden 60 (3,841 parameters:
    #     the JAX package's streaming dense route)
    gen = torch.Generator(device=dev).manual_seed(2)
    params = rnn.init(gen, hidden=60)
    n_dense = sum(p.numel() for p in params)
    opt = PSGD(preconditioner="dense", lr_params=0.01, lr_preconditioner=0.01,
               grad_clip_max_norm=1.0)
    state = opt.init(params)
    torch.cuda.synchronize()
    hopper.reset_counts()
    losses = []
    for _ in range(DENSE_RNN_STEPS):
        params, state, aux = opt.step(rnn.loss, params, state, gen, *xor.batch(gen, 128, 16))
        losses.append(aux["loss"])
    losses = torch.stack(losses).cpu()
    counts = dict(hopper.counts)
    path_counts()
    print(f"dense rnn: n={n_dense}, route {dense.route(n_dense, dev)}, {DENSE_RNN_STEPS} steps, "
          f"launches {counts}, loss {losses[0].item():.4f} -> {losses[-1].item():.4f}", flush=True)
    check(n_dense == DENSE_K12[0], f"dense RNN: n = {n_dense} is the n K12 was checked at")
    check(dense.route(n_dense, dev) == "dense_big" and counts["dense_big"] == DENSE_RNN_STEPS
          and counts["tri"] == DENSE_RNN_STEPS and bool(torch.isfinite(losses).all()),
          "dense RNN: one K12 and one K3 launch per step, finite")

    # 16. path: all_preconditioners, the tensor decomposition under each
    #     family, 100 steps, each with its counts read alone
    want_kernel = {"splu": "splu_one", "dense": "dense_upd", "lra": "lra_upd",
                   "kron": "kron_multi"}

    def decomp_pass():
        """{family: (result, counts, steps/s)} over one run of every family."""
        outs = {}
        for fam in all_preconditioners.FAMILIES:
            torch.cuda.synchronize()
            hopper.reset_counts()
            t0 = time.perf_counter()
            out = all_preconditioners.run(fam, device=dev)
            torch.cuda.synchronize()
            outs[fam] = (out, dict(hopper.counts), out["steps"] / (time.perf_counter() - t0))
        return outs

    with hopper.disabled():
        plain_outs = decomp_pass()
    outs = decomp_pass()
    for fam, (out, counts, rate) in outs.items():
        for name, k in counts.items():
            launches[name] += k
        kern = want_kernel.get(fam)
        print(f"all_preconditioners {fam}: loss {out['first_loss']:.1f} -> {out['loss']:.1f}, "
              f"success {out['success']}, launches {({k: c for k, c in counts.items() if c})}, "
              f"{rate:.1f} steps/s with kernels, {plain_outs[fam][2]:.1f} under disabled() "
              f"(host clock, init included)", flush=True)
        check(out["success"], f"all_preconditioners {fam}: loss below a tenth of the first")
        if kern is None:
            check(sum(counts.values()) == 0, f"all_preconditioners {fam}: no kernel launched")
        else:
            check(counts[kern] == out["steps"] == 100
                  and (fam != "dense" or counts["tri"] == 0),
                  f"all_preconditioners {fam}: one {kern} launch per step"
                  + (" (K3 inside it)" if fam == "dense" else ""))

    # 17. path: splu on the NMT model at the reference widths (FD Hvp, lr
    #     0.02, clip 1.0, random ids): past K15's cap, so K16. The kernel
    #     run keeps its last step's state and probes (`seen`), on which K16
    #     is then held against the plain chain and the direct form.
    seen = {}
    splu_update_apply = splu.update_apply

    def keep_last(state, v, h, g, step=0.01):
        seen.update(state=state, v=v, h=h, g=g, step=step)
        return splu_update_apply(state, v, h, g, step)

    def nmt_splu_run():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = nmt.init(gen, ref_cfg)
        opt = PSGD(preconditioner="splu", rank=10, lr_params=0.02, lr_preconditioner=0.02,
                   grad_clip_max_norm=1.0, exact_hessian_vector_product=False)
        state = opt.init(params)
        n = state.precond.Lt.shape[1]
        batches = [translation.random_tokens(gen, ref_cfg.vocab_src, ref_cfg.vocab_tgt)
                   for _ in range(SPLU_NMT_STEPS)]
        losses = []
        torch.cuda.synchronize()
        hopper.reset_counts()
        for i, (src, tgt) in enumerate(batches):
            if i == 2:
                ev0.record()
            params, state, aux = opt.step(nmt.loss, params, state, gen, src, tgt)
            losses.append(aux["loss"])
        ev1.record()
        ev1.synchronize()
        rate = (SPLU_NMT_STEPS - 2) / (ev0.elapsed_time(ev1) / 1e3)
        return n, torch.stack(losses).cpu(), dict(hopper.counts), rate

    splu.update_apply = keep_last
    try:
        n_nmt, losses, counts, splu_rate = nmt_splu_run()
    finally:
        splu.update_apply = splu_update_apply
    path_counts()
    print(f"nmt ref splu: n={n_nmt}, route {splu.route(10, n_nmt, dev)}, {SPLU_NMT_STEPS} steps, "
          f"launches {({k: c for k, c in counts.items() if c})}, loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f}, {splu_rate:.2f} steps/s with kernels", flush=True)
    check(splu.route(10, n_nmt, dev) == "splu_upd" and counts["splu_upd"] == SPLU_NMT_STEPS
          and counts["splu_upd_apply"] == counts["splu_upd_mono"] == 0,
          "NMT reference splu: one K16 launch per step, no fused apply, no mono")
    check(bool(torch.isfinite(losses).all()), "NMT reference splu: finite losses")
    st, v, h, step = seen.pop("state"), seen.pop("v"), seen.pop("h"), seen.pop("step")
    gk = seen.pop("g")
    got = splu_upd.fused_update(*fields(st), v, h, step)
    torch.cuda.synchronize()
    with hopper.disabled():
        ref = splu_upd.fused_update(*fields(st), v, h, step)
    pairs = list(zip(got, ref))
    del ref
    pairs += list(zip(got, fields(splu.update_plain(st, v, h, step))))
    rel = max(_rel(a, b) for a, b in pairs)
    splu_err["splu_upd"] = max(splu_err["splu_upd"], max(_abs(a, b) for a, b in pairs))
    L1, U1 = got[0][:, :10].T, got[2][:, :10]
    tri_ok = torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
    print(f"splu_upd: n={n_nmt} r=10, the path's last state and probes, max rel err {rel:.3e} "
          f"(tol {TOL_K1:.0e}) against the plain chain and the direct form, corner triangles "
          f"exact: {tri_ok}", flush=True)
    check(rel < TOL_K1 and tri_ok, f"splu_upd vs plain at n={n_nmt}")
    del got, pairs
    fused = splu_upd.fused_update(*fields(st), v, h, step, g=gk)
    mono = splu_upd.fused_update_apply_mono(*fields(st), v, h, gk, step)
    torch.cuda.synchronize()
    rel, errs, bit, repeat, tri_ok = hold_fused(st, v, h, gk, step, fused, mono)
    del fused, mono
    for name in apply_err:
        apply_err[name] = max(apply_err[name], errs[name])
    check(rel < TOL_K1 and bit and repeat and tri_ok,
          f"splu fused apply and mono vs plain at n={n_nmt}")
    grid = splu_upd.mono_grid(n_nmt, 10)
    ms = time_fused(st, v, h, gk, step, 5)
    bound = _bound(*splu_work(n_nmt, apply=True))
    print(f"splu fused apply and mono: n={n_nmt} r=10, the path's last state and probes, max rel "
          f"err {rel:.3e} (tol {TOL_K1:.0e}), max abs err {max(errs.values()):.3e}; mono "
          f"bit-equal to the chain {bit}, both repeat bit for bit {repeat}, corner triangles "
          f"exact {tri_ok}; mono grid {grid['grid']} CTAs ({grid['per_sm']} a SM); fused apply "
          f"{ms['apply']:.4f} ms, mono {ms['mono']:.4f} ms, routed pair (K16 + apply) "
          f"{ms['pair']:.4f} ms, plain chain {ms['plain']:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})", flush=True)
    del st, v, h, gk
    with hopper.disabled():
        _, plain_losses, _, splu_plain_rate = nmt_splu_run()
    loss_rel = _rel(losses, plain_losses)
    print(f"nmt ref splu: {splu_plain_rate:.2f} steps/s under disabled() (the direct form), loss "
          f"{plain_losses[0].item():.4f} -> {plain_losses[-1].item():.4f}; the two loss traces "
          f"differ by {loss_rel:.3e} relative (tol {TOL_TRAJ:.0e})", flush=True)
    check(loss_rel < TOL_TRAJ, "NMT reference splu: kernel and direct-form losses agree")

    # 17b. path: the NMT model at the reference widths under lra and splu
    #      at rank NMT_RANK (past the rank-32 kernels: the rank-generic
    #      chains, K13 and K16), NMT_RANK_STEPS steps each, against the same
    #      steps under disabled()
    for fam, name in [("lra", "lra_upd"), ("splu", "splu_upd")]:
        torch.cuda.empty_cache()
        losses, counts, rate, _, _, last, _ = _nmt_ref_run(fam, NMT_RANK_STEPS, rank=NMT_RANK)
        path_counts()
        n_state = (last.precond.UV if fam == "lra" else last.precond.Lt).shape[1]
        del last
        torch.cuda.empty_cache()
        with hopper.disabled():
            plain_losses, _, plain_rate, *_ = _nmt_ref_run(fam, NMT_RANK_STEPS, rank=NMT_RANK)
        loss_rel = _rel(torch.tensor(losses), torch.tensor(plain_losses))
        print(f"nmt ref {fam} rank {NMT_RANK}: n={n_state}, {NMT_RANK_STEPS} steps, launches "
              f"{({k: c for k, c in counts.items() if c})}, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, {rate:.2f} steps/s with kernels, {plain_rate:.2f} plain; the "
              f"loss traces differ by {loss_rel:.3e} relative (tol {TOL_TRAJ:.0e})", flush=True)
        check(counts[name] == NMT_RANK_STEPS and loss_rel < TOL_TRAJ
              and all(math.isfinite(x) for x in losses),
              f"NMT reference {fam} rank {NMT_RANK}: one {name} launch a step, losses agree")
    torch.cuda.empty_cache()

    # 17c. path: the NMT workload's corpus mode (`data_path`) at the
    #      reference widths, on a generated corpus in the spa-eng format
    #      (english<TAB>spanish, accents, '¿'/'¡', an attribution column on
    #      some lines; Zipf-drawn words over the reference's vocabulary sizes):
    #      8,000 lines, one epoch of 100 steps at batch 64, then a loss trace
    #      of its first steps with the kernels and under disabled()
    staged = tempfile.TemporaryDirectory(prefix="psgd_staged_")
    corpus = os.path.join(staged.name, "spa.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write("\n".join(corpus_lines(17, STAGED_NMT_LINES, n_spa=9400, n_eng=4900)))
    ds = spa_eng.load(corpus, num_examples=STAGED_NMT_LINES)
    vocab = (len(ds.src_tok.word_index), len(ds.tgt_tok.word_index))
    staged_cfg = nmt_attention.real_config(ds)
    staged_shapes = nmt.layer_shapes(staged_cfg)
    routes = [kron.route(f, s, dev) for f, s in zip(nmt_fmts, staged_shapes)]
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = nmt_attention.run(data_path=corpus, epochs=1, num_examples=STAGED_NMT_LINES, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(hopper.counts)
    path_counts()
    steps = out["steps"]

    def staged_trace(n):
        """The corpus run's first `n` steps, as `run()` takes them: (losses,
        steps/s after NMT_REF_WARMUP on CUDA events)."""
        gen = torch.Generator(device=dev).manual_seed(0)
        params = nmt.init(gen, staged_cfg)
        _, state, step = nmt_attention.optimizer(params, staged_cfg, 0.02, False, 0, None)
        losses = []

        def traced(*a):
            if len(losses) == NMT_REF_WARMUP:
                ev0.record()
            res = step(*a)
            losses.append(res[2]["loss"])
            return res

        order = itertools.islice(nmt_attention.batch_order(ds.src_train.shape[0], 64, 1, 0), n)
        nmt_attention.train(traced, params, state, gen,
                            torch.as_tensor(ds.src_train, dtype=torch.int64, device=dev),
                            torch.as_tensor(ds.tgt_train, dtype=torch.int64, device=dev), order)
        ev1.record()
        ev1.synchronize()
        return torch.stack(losses).cpu(), (n - NMT_REF_WARMUP) / (ev0.elapsed_time(ev1) / 1e3)

    hopper.reset_counts()
    k_losses, staged_rate = staged_trace(STAGED_NMT_TRACE)
    path_counts()
    with hopper.disabled():
        p_losses, staged_plain_rate = staged_trace(STAGED_NMT_TRACE)
    trace_rel = _rel(k_losses[:3], p_losses[:3])
    print(f"nmt staged: corpus {STAGED_NMT_LINES} lines, vocabularies {vocab[0]} (spa) and "
          f"{vocab[1]} (eng) words, model {tuple(staged_cfg)}, routes {routes}, {steps} steps, "
          f"launches {({k: c for k, c in counts.items() if c})}, loss {out['loss']:.4f}, val "
          f"loss {out['val_loss']:.4f}, val token accuracy {out['token_accuracy']:.4f}; "
          f"run() {seconds:.1f} s (load, init, {steps} steps and val); the first 3 steps' "
          f"losses differ from disabled()'s by {trace_rel:.3e} relative (tol "
          f"{TOL_TRAJ:.0e}), {STAGED_NMT_TRACE} steps by {_rel(k_losses, p_losses):.3e}; "
          f"{staged_rate:.2f} steps/s with kernels, {staged_plain_rate:.2f} under disabled()",
          flush=True)
    check(min(vocab) > 512, "NMT staged: both fitted vocabularies exceed 512 words")
    check(routes == ["kron_sparse_big:ds", "kron_sparse_big:ns", "kron_sparse_big:ds", "kron_dd",
                     "kron_sparse_big:ds", "kron_sparse_big:ns", "kron_sparse_big:ns"],
          f"NMT staged routes {routes}")
    check(steps == STAGED_NMT_LINES * 4 // 5 // 64, "NMT staged: one epoch of full batches")
    per_step = {"kron_sparse_big_ds": 3, "kron_sparse_big_ns": 3, "kron_dd": 1,
                "tri": 4 - row_mono, "kron_mono": row_mono,
                **_attn_launches(ds.tgt_train.shape[1] - 1, 2)}
    # the validation's forward passes launch the attention's forward too
    check({k: c for k, c in counts.items() if k != "attn_fwd"}
          == {k: per_step.get(k, 0) * steps for k in counts if k != "attn_fwd"}
          and counts["attn_fwd"] > per_step["attn_fwd"] * steps,
          f"NMT staged: launches per step {per_step} and no other")
    check(math.isfinite(out["loss"]) and math.isfinite(out["val_loss"])
          and 0.0 <= out["token_accuracy"] <= 1.0, "NMT staged: finite losses, accuracy in [0, 1]")
    check(trace_rel < TOL_TRAJ, "NMT staged: kernel and plain losses agree over 3 steps")
    check(vocab == (out["vocab_src"] - 1, out["vocab_tgt"] - 1), "NMT staged: run()'s vocabularies")
    del ds

    # 17d. path: LeNet5 on MNIST-sized IDX files: 60,000 + 10,000 images
    #      rendered from synthetic_hard to uint8 (the train files gzipped),
    #      decoded natively and in Python, then mnist_lenet5.run(data_dir=...)
    idx_dir = pathlib.Path(staged.name, "mnist")
    idx_dir.mkdir()
    gen = torch.Generator(device=dev).manual_seed(23)
    t0 = time.perf_counter()
    for split, n, gz in [("train", 60_000, True), ("t10k", 10_000, False)]:
        x, y = mnist.synthetic_hard(gen, n)
        write_idx(idx_dir, split, (x[..., 0] * 255.0).round().to(torch.uint8).cpu().numpy(),
                  y.to(torch.uint8).cpu().numpy(), gz)
    write_s = time.perf_counter() - t0
    built = native.available()
    check(built, "LeNet5 IDX: the native decoder builds (g++)")
    t0 = time.perf_counter()
    nat = mnist.load_idx(str(idx_dir))
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = mnist.load_idx_python(str(idx_dir))
    py_s = time.perf_counter() - t0
    # the native decode multiplies by the fp32 1/255, Python divides in fp64
    # and rounds: at most one fp32 spacing apart
    decode_err = max(float(np.abs(a - b).max()) for a, b in zip(nat, py))
    same_shape = [a.shape for a in nat] == [a.shape for a in py] == [
        (60_000, 28, 28, 1), (60_000,), (10_000, 28, 28, 1), (10_000,)]
    check(built and same_shape and decode_err <= 6e-8 and np.array_equal(nat[1], py[1])
          and np.array_equal(nat[3], py[3]), "LeNet5 IDX: native and Python decodes agree")
    del nat, py
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = mnist_lenet5.run(data_dir=str(idx_dir), epochs=1, steps_per_epoch=IDX_STEPS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(hopper.counts)
    path_counts()
    print(f"lenet5 idx: wrote 70,000 images in {write_s:.1f} s; decode native {nat_s:.3f} s, "
          f"Python {py_s:.3f} s, max diff {decode_err:.3e}, labels equal; run(data_dir) "
          f"{IDX_STEPS} steps, launches {({k: c for k, c in counts.items() if c})}, loss "
          f"{out['loss']:.4f}, best_test_error {out['best_test_error']:.4f} on the 10,000 t10k "
          f"images (the 0.007 bar is for real MNIST), {seconds:.2f} s (decode, init, steps, "
          f"eval)", flush=True)
    check(counts["kron_multi"] == IDX_STEPS
          and counts["tri"] == IDX_STEPS * (1 - lenet_mono)
          and counts["kron_mono"] == IDX_STEPS * lenet_mono,
          "LeNet5 IDX: K1 (with its K3, or its one launch) once per step")
    check(math.isfinite(out["loss"]) and out["steps"] == IDX_STEPS, "LeNet5 IDX: finite loss")

    # 17e. path: checkpoint resume on the card: 10 uninterrupted steps
    #      against 5, save, restore into a fresh init on the card, 5 more;
    #      LeNet5 under kron (K1, K3) and the K4 path's NMT (K4)
    ckpt_dir = os.path.join(staged.name, "ckpt")

    def lenet_case():
        gen = torch.Generator(device=dev).manual_seed(29)
        params = lenet5.init(gen)
        opt = PSGD(preconditioner="kron", kron_formats=dd, lr_params=0.1, lr_preconditioner=0.1,
                   grad_clip_max_norm=0.1 * math.sqrt(n_params))
        return opt, params, gen, lambda gen: mnist.synthetic_hard(gen, 64), lenet5.loss

    def k4_case():
        gen = torch.Generator(device=dev).manual_seed(31)
        params = nmt.init(gen, k4_cfg)
        opt = PSGD(preconditioner="kron", lr_params=0.05, lr_preconditioner=0.05,
                   grad_clip_max_norm=1.0)
        batch = lambda gen: translation.random_tokens(gen, k4_cfg.vocab_src, k4_cfg.vocab_tgt)
        return opt, params, gen, batch, nmt.loss

    def walk(opt, params, state, gen, batch, loss, n):
        for _ in range(n):
            params, state, _ = opt.step(loss, params, state, gen, *batch(gen))
        return params, state

    def flat(tree):
        return torch.cat([t.flatten().float() for t in _tree.tensors(tree)])

    def spread(case):
        """(the end of one uninterrupted 10-step run, the max abs difference
        between two such runs)."""
        ends = []
        for _ in range(2):
            opt, params, gen, batch, loss = case()
            ends.append(flat(walk(opt, params, opt.init(params), gen, batch, loss, 10)))
        return ends[0], (ends[0] - ends[1]).abs().max().item()

    # LeNet5's convolutions take cuDNN's default algorithms, whose gradients
    # need not repeat bit for bit: the resume is held with cuDNN's
    # deterministic ones, and the default's spread is printed beside it
    for name, case, counter, conv in [("lenet5 kron", lenet_case, "kron_multi", True),
                                      ("nmt k4", k4_case, "kron_dd_batched", False)]:
        hopper.reset_counts()
        note = ""
        if conv:
            note = f"; with cuDNN's default algorithms two runs differ by {spread(case)[1]:.3e}"
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = conv or was
        try:
            end10, bound = spread(case)
            opt, params, gen, batch, loss = case()
            params, state = walk(opt, params, opt.init(params), gen, batch, loss, 5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(ckpt_dir, 5, {"params": params, "opt": state, "gen": gen},
                            force=True)
            save_ms = (time.perf_counter() - t0) * 1e3
            nbytes = os.path.getsize(os.path.join(ckpt_dir, "5", "state.pt"))
            _, like_params, like_gen, _, _ = case()
            like = {"params": like_params, "opt": opt.init(like_params), "gen": like_gen}
            t0 = time.perf_counter()
            r = checkpoint.restore(ckpt_dir, like=like)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            on_card = all(t.device.type == "cuda" for t in _tree.tensors(r))
            on_card = on_card and r["gen"].device.type == "cuda"
            resumed = flat(walk(opt, r["params"], r["opt"], r["gen"], batch, loss, 5))
        finally:
            torch.cuda.synchronize()
            torch.backends.cudnn.deterministic = was
        err = (resumed - end10).abs().max().item()
        counts = dict(hopper.counts)
        path_counts()
        stacked = isinstance(r["opt"].precond, KronPrecond)
        print(f"checkpoint {name}: {resumed.numel()} values (params and state), resumed 5 + 5 "
              f"steps against 10: max diff {err:.3e}; two uninterrupted runs differ by "
              f"{bound:.3e}{' (cuDNN deterministic)' if conv else ''}{note}; save "
              f"{save_ms:.1f} ms ({nbytes} bytes), restore onto the card {restore_ms:.1f} ms; "
              f"stacked bucket {stacked}; launches {({k: c for k, c in counts.items() if c})}",
              flush=True)
        check(on_card and err <= bound and counts[counter] == (50 if conv else 30)
              and (stacked == (counter == "kron_dd_batched")),
              f"checkpoint {name}: the resumed run equals the uninterrupted one")

    # 17f. the CLI: `python -m psgd_tf_tpu_torch list`, then `run hello_psgd
    #      --set steps=120` on the card through the entry `python -m` takes
    #      (runpy), reporting its launch counts on stderr
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    listed = subprocess.run([sys.executable, "-m", "psgd_tf_tpu_torch", "list"], cwd=root,
                            env=env, capture_output=True, text=True, timeout=300)
    list_s = time.perf_counter() - t0
    names = [l.split(":")[0] for l in listed.stdout.strip().splitlines()]
    wrapper = ("import atexit, json, runpy, sys\n"
               "from psgd_tf_tpu_torch.ops import hopper\n"
               "atexit.register(lambda: print('launches ' + json.dumps(hopper.counts), "
               "file=sys.stderr))\n"
               "runpy.run_module('psgd_tf_tpu_torch', run_name='__main__', alter_sys=True)\n")
    t0 = time.perf_counter()
    ran = subprocess.run([sys.executable, "-c", wrapper, "run", "hello_psgd", "--set", "steps=120"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    run_s = time.perf_counter() - t0
    try:
        result = json.loads(ran.stdout.strip().splitlines()[-1])
        cli_counts = json.loads([l for l in ran.stderr.splitlines()
                                 if l.startswith("launches ")][-1].split(" ", 1)[1])
    except (IndexError, ValueError):
        result, cli_counts = {}, {}
    print(f"cli: list rc {listed.returncode} ({len(names)} workloads, {list_s:.1f} s); run "
          f"hello_psgd --set steps=120 rc {ran.returncode}, result {result}, launches "
          f"{({k: c for k, c in cli_counts.items() if c})} ({run_s:.1f} s, process start "
          f"included)", flush=True)
    check(listed.returncode == 0 and names == ["hello_psgd", "all_preconditioners",
                                               "mnist_lenet5", "lstm_xor", "rnn_xor_lra",
                                               "nmt_attention"], "cli: list")
    check(ran.returncode in (0, 1) and result.get("steps") == 120
          and ran.returncode == (0 if result.get("success") else 1)
          and cli_counts.get("dense_upd") == 120,
          f"cli: run hello_psgd on the card (K11 once a step); stderr {ran.stderr[-2000:]!r}")
    staged.cleanup()

    # 17g. the CLI's `bench` (`psgd_tf_tpu_torch.bench`): every row in-process
    #      at a short chain of BENCH_ITERS and one rep, each row's launches a
    #      chained iteration against the kernels its path runs, its figures
    #      finite and positive, the result through the last-line formatter
    t0 = time.perf_counter()
    hopper.reset_counts()
    bres = bench.measure(iters=BENCH_ITERS, reps=1)
    path_counts()
    bres["card"] = smi
    k1_step = lambda mono: {"kron_multi": 1, ("kron_mono" if mono else "tri"): 1}
    # bench's toy NMT step: `translation.batch(g, 64, 16)`, targets of 18
    toy_positions = translation.batch(torch.Generator(device=dev), 64, 16)[1].shape[1] - 1
    ref_step = {k: n for k, n in {"kron_sparse_big_ds": 3, "kron_sparse_big_ns": 3, "kron_dd": 1,
                                  "tri": 4 - row_mono, "kron_mono": row_mono}.items() if n}
    k12 = {"dense_big": 1, "tri": 1}
    want = {"diag": {}, "xmat": {}, "shift": {}, "lra": {"lra_upd": 1}, "lra_bf16": {},
            "splu": {"splu_one": 1}, "splu_big": {"splu_upd": 1}, "dense": k12, "dense_8k": k12,
            "dense_16k": k12, "kron_nd": {"kron_sparse_big_nd": 1, "tri": 1},
            "kron_ns": {"kron_sparse_big_ns": 1}, "kron_ns_wide": {"kron_sparse_big_ns_wide2": 1},
            "kron_ds": {"kron_sparse_big_ds": 1, "tri": 1},
            "nmt_fd": {**k1_step(toy_mono), **_attn_launches(toy_positions, 2)},
            "nmt_ref_grad": _attn_launches(12, 1), "nmt_ref_hvp": _attn_launches(12, 2),
            "nmt_ref_qupd": {**ref_step, **_attn_launches(12, 2)},
            "nmt_ref_full": {**ref_step, **_attn_launches(12, 2)}, "lenet5": k1_step(lenet_mono)}
    for row, w in want.items():
        got = bres[f"{row}_launches_per_iter"]
        check(got == w, f"bench {row}: launches a chained iteration {got}, want {w}")
    bad = [k for k, v in bres.items() if isinstance(v, float) and not math.isfinite(v)
           or isinstance(v, float) and v <= 0 and not k.endswith("_rel_spread")
           or k.endswith("_slopes_us") and not all(math.isfinite(x) and x > 0 for x in v)]
    line = bench.last_line(bres)
    head = json.loads(line)
    print(f"bench: {len(want)} rows at chains of {BENCH_ITERS}, one rep, "
          f"{time.perf_counter() - t0:.1f} s: stream {bres['hbm_stream_gb_per_sec']:.0f} GB/s, "
          f"fp32 {bres['fp32_peak_flops'] / 1e12:.1f} TFLOP/s, LeNet5 "
          f"{bres['lenet5_steps_per_sec']:.2f} steps/s, toy NMT {bres['nmt_fd_step_us']:.0f} us, "
          f"reference NMT {bres['nmt_ref_full_us']:.0f} us a step; routes "
          f"{bres['nmt_ref_routes']}; last line {len(line)} characters, {len(head['detail'])} "
          f"detail fields; figures not finite and positive: {bad}", flush=True)
    check(not bad and len(bres["nmt_ref_routes"]) == 7, "bench: every row's figures")
    check(len(line) <= bench.LAST_LINE_MAX and set(head) == {"metric", "value", "unit",
                                                             "vs_baseline", "detail"}
          and head["metric"] == "lenet5_kron_steps_per_sec" and head["unit"] == "steps/s"
          and head["vs_baseline"] == 1.0 and head["value"] > 0, "bench: the last line's form")

    # 18. S1: K14 on a one-rank NCCL group (the shard wrapper with no
    #     exchange) at n = 2^20, r = 10, update + apply, pipelined off and on,
    #     against its plain chain (the same call under disabled()) and K13
    #     on the same inputs and coins; the sharded K16 there against K16
    import torch.distributed as dist

    from psgd_tf_tpu_torch.parallel import make_mesh, policies

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh1 = make_mesh(data=1, shard=1, device=dev)
        print(f"s1: mesh {mesh1.shape}, backend {mesh1.backend}", flush=True)
        n = SHARD_LRA[0]
        st, (v, h, gr) = lra_case(n)
        s1_rel = s1_plain = s1_err = 0.0
        s1_ms = {}
        for coins in COINS:
            ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, coins)
            for pipelined in (False, True):
                args = (st.UV, st.d, v, h, gr, 0.05, coins, mesh1)
                before = hopper.counts["lra_upd_sharded"]
                got = lra_upd.fused_update_apply_sharded(*args, pipelined=pipelined)
                check(hopper.counts["lra_upd_sharded"] == before + 1, "s1: K14 launched")
                with hopper.disabled():
                    plain = lra_upd.fused_update_apply_sharded(*args, pipelined=pipelined)
                s1_rel = max([s1_rel] + [_rel(a, b) for a, b in zip(got, ref)])
                s1_plain = max([s1_plain] + [_rel(a, b) for a, b in zip(got, plain)])
                s1_err = max([s1_err] + [_abs(a, b) for a, b in zip(got, plain)])
        for name, fn in [
            ("k13", lambda: lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, (False, True))),
            ("k14 pipelined", lambda: lra_upd.fused_update_apply_sharded(
                st.UV, st.d, v, h, gr, 0.05, (False, True), mesh1, pipelined=True))]:
            s1_ms[name] = _time(torch, fn, 50)
        # K14's own time (kernel, plain chain), the kernel line's: one rank
        # exchanges nothing, so this is the stages' work
        s1_k14 = _time_ab(torch, hopper, lambda: lra_upd.fused_update_apply_sharded(
            st.UV, st.d, v, h, gr, 0.05, (False, True), mesh1), 50)
        k14_b10 = _bound(*family_work("lra", n))
        print(f"s1: K14 on one NCCL rank, n={n} r=10, four coin pairs, pipelined off and on "
              f"({lra_upd.CHUNKS} chunks): max rel err against the plain chain {s1_plain:.3e} "
              f"(max abs {s1_err:.3e}), against K13 {s1_rel:.3e} (tol {TOL_K1:.0e} each); "
              f"update+apply K14 {s1_k14[0]:.4f} ms (plain {s1_k14[1]:.4f}, bound "
              f"{k14_b10[0]:.4f} ms ({k14_b10[1]})), K13 {s1_ms['k13']:.4f} ms, K14 pipelined "
              f"{s1_ms['k14 pipelined']:.4f} ms", flush=True)
        check(max(s1_rel, s1_plain) <= TOL_K1, "s1: K14 on one rank vs plain and K13")
        del st, v, h, gr
        # the sharded K16 on the same rank at r = 10, update + apply, against
        # its plain chain and K16's fused apply, each timed: a world of one
        # exchanges nothing, so the two differ by the entries' own work
        n = SHARD_SPLU[0]
        st, (v, h, gr) = splu_case(n)
        fs = fields(st)
        got = splu_upd.fused_update_sharded(*fs, v, h, 0.05, mesh1, None, gr)
        with hopper.disabled():
            plain = splu_upd.fused_update_sharded(*fs, v, h, 0.05, mesh1, None, gr)
        ref = splu_upd.fused_update(*fs, v, h, 0.05, g=gr)
        rel = max(max(_rel(a, b), _rel(a, c)) for a, b, c in zip(got, plain, ref))
        s1_k16 = {"sharded": _time(torch, lambda: splu_upd.fused_update_sharded(
            *fs, v, h, 0.05, mesh1, None, gr), 50),
                  "k16": _time(torch, lambda: splu_upd.fused_update(*fs, v, h, 0.05, g=gr), 50)}
        print(f"s1: the sharded K16 on one NCCL rank, n={n} r=10: max rel err {rel:.3e} against "
              f"its plain chain and K16 (tol {TOL_K1:.0e}); update+apply sharded "
              f"{s1_k16['sharded']:.4f} ms, K16's fused apply {s1_k16['k16']:.4f} ms", flush=True)
        check(rel < TOL_K1, "s1: the sharded K16 at r=10 vs plain and K16")
        del st, fs, got, plain, ref
        # K14 and the sharded K16 past rank 32 (their rank-generic entries) at
        # RANK_BENCH, against their plain chains and the one-process kernels
        n, r = RANK_BENCH
        st, (v, h, gr) = lra_case(n, r)
        args = (st.UV, st.d, v, h, gr, 0.05, (True, False), mesh1)
        got = lra_upd.fused_update_apply_sharded(*args)
        with hopper.disabled():
            plain = lra_upd.fused_update_apply_sharded(*args)
        ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, (True, False))
        rel = max(max(_rel(a, b), _rel(a, c)) for a, b, c in zip(got, plain, ref))
        s1_rank = {"k14": _time_ab(torch, hopper, lambda: lra_upd.fused_update_apply_sharded(*args),
                                   10)}
        del st, got, plain, ref, args
        st, (v, h, gr) = splu_case(n, r)
        fs = fields(st)
        got = splu_upd.fused_update_sharded(*fs, v, h, 0.05, mesh1, None, gr)
        with hopper.disabled():
            plain = splu_upd.fused_update_sharded(*fs, v, h, 0.05, mesh1, None, gr)
        ref = splu_upd.launch("splu_upd", *fs, v, h, 0.05, gr)
        rel = max([rel] + [max(_rel(a, b), _rel(a, c)) for a, b, c in zip(got, plain, ref)])
        s1_rank["k16"] = _time_ab(torch, hopper, lambda: splu_upd.fused_update_sharded(
            *fs, v, h, 0.05, mesh1, None, gr), 10)
        del st, fs, got, plain, ref
        k14_b = _bound(*family_work("lra", n, r))  # as 8d's K13
        k16s_b = _bound(*splu_work(n, r, apply=True))
        print(f"s1: past rank 32, n={n} r={r} on one NCCL rank: K14 and the sharded K16 max rel "
              f"err {rel:.3e} against their plain chains and K13/K16 (tol {TOL_K1:.0e}); update"
              f"+apply K14 {s1_rank['k14'][0]:.4f} ms (plain {s1_rank['k14'][1]:.4f}, bound "
              f"{k14_b[0]:.4f} ms ({k14_b[1]}); K13 {rank_ms['k13'][0]:.4f} ms, 8d), sharded K16 "
              f"{s1_rank['k16'][0]:.4f} ms (plain "
              f"{s1_rank['k16'][1]:.4f}, bound {k16s_b[0]:.4f} ms ({k16s_b[1]}))", flush=True)
        check(rel < TOL_K1, f"s1: K14 and the sharded K16 at r={r} vs plain and one process")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 19. S2-S4 on two gloo ranks sharing the card: K14 and the sharded
    #     K16 against the single-process kernels; the sharded step at the
    #     reference widths (lra, then splu; then kron and lra with
    #     tensor-parallel parameters) against the single-process runs
    #     below; the toy NMT workload with its batch over `data`
    ref_toy = nmt_attention.run(steps=SHARD_NMT_STEPS, device=dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn(_sharded_job, 2)
    print(f"s2-s4: two gloo ranks sharing the card ({ranks[0]['backend']}: all_reduce takes "
          f"the CUDA tensors; the ring's send/recv hops stage their payload through host "
          f"memory), {time.perf_counter() - t0:.1f} s", flush=True)
    r0 = ranks[0]
    shard_err = {"lra_upd_sharded": s1_err, "splu_upd_sharded": 0.0}
    for n, res in r0["lra"].items():
        shard_err["lra_upd_sharded"] = max(shard_err["lra_upd_sharded"], res["err"])
        print(f"s2: K14 on 2 ranks, n={n} r=10, four coin pairs, pipelined off and on: gathered "
              f"(state', P' g) max rel err against the plain chain {res['rel_plain']:.3e} (max "
              f"abs {res['err']:.3e}), against K13 {res['rel']:.3e} (tol {TOL_K1:.0e} each); "
              f"update+apply {res['ms']:.4f} ms, pipelined {res['ms_pipe']:.4f} ms, plain "
              f"chain {res['plain_ms']:.4f} ms", flush=True)
        check(max(res["rel"], res["rel_plain"]) <= TOL_K1, f"s2: K14 vs plain and K13 at n={n}")
    for n, res in r0["splu"].items():
        shard_err["splu_upd_sharded"] = max(shard_err["splu_upd_sharded"], res["err"])
        print(f"s2: sharded K16 on 2 ranks, n={n} r=10: gathered (state', P' g) max rel err "
              f"against the plain chain {res['rel_plain']:.3e} (max abs {res['err']:.3e}), "
              f"against K16 {res['rel']:.3e} (tol {TOL_K1:.0e} each), corner triangles exact: "
              f"{res['tri_ok']}; update+apply {res['ms']:.4f} ms, plain chain "
              f"{res['plain_ms']:.4f} ms", flush=True)
        check(max(res["rel"], res["rel_plain"]) <= TOL_K1 and res["tri_ok"],
              f"s2: sharded K16 vs plain and K16 at n={n}")
    check(all(r["s2_counts"]["lra_upd_sharded"] > 0 and r["s2_counts"]["splu_upd_sharded"] > 0
              for r in ranks), "s2: every rank launched K14 and the sharded K16")
    for fam, steps, name in [("lra", SHARD_LRA_STEPS, "lra_upd_sharded"),
                             ("splu", SHARD_SPLU_STEPS, "splu_upd_sharded")]:
        res = r0[f"nmt_{fam}"]
        losses, rate, ref = res["losses"], res["rate"], res["ref"]
        counts = [r[f"nmt_{fam}"]["counts"] for r in ranks]
        launches[name] += sum(c[name] for c in counts)
        trace = _rel(torch.tensor(losses), torch.tensor(ref[0]))
        print(f"s3: NMT reference widths, {fam} rank 10, mesh (data=1, shard=2), {steps} steps: "
              f"launches per rank {[({k: v for k, v in c.items() if v}) for c in counts]}, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; against one process: loss trace max "
              f"rel diff {trace:.3e}, gathered last state max rel diff {res['state_rel']:.3e} "
              f"(tol {TOL_TRAJ:.0e} each), parameter change max abs diff "
              f"{res['delta_err']:.3e} (tol {res['delta_tol']:.3e}: one fp32 spacing at the "
              f"largest |p| a step; the largest change {res['delta_max']:.3e}); {rate:.2f} "
              f"steps/s sharded, {ref[2]:.2f} in one process (route "
              f"{list(k for k, v in ref[1].items() if v)})", flush=True)
        check(max(trace, res["state_rel"]) <= TOL_TRAJ and res["delta_err"] <= res["delta_tol"]
              and all(c[name] == steps for c in counts)
              and all(r[f"nmt_{fam}"]["losses"] == losses for r in ranks),
              f"s3: the sharded {fam} step: one {name} launch a step on each rank, the trace, "
              f"the parameters and the state as in one process")
    _s4_report(torch, ranks, check, launches, smi)
    toy = r0["toy_dp"]
    toy_err = max(abs(toy[k] - ref_toy[k]) for k in ("loss", "first_loss", "token_accuracy"))
    path_launch = {k: v for k, v in r0["toy_dp_counts"].items() if v}
    for name, c in r0["toy_dp_counts"].items():
        launches[name] += sum(r["toy_dp_counts"][name] for r in ranks)
    print(f"s3: nmt_attention.run(mesh=(data=2, shard=1)), {SHARD_NMT_STEPS} steps: loss "
          f"{toy['loss']:.5f}, token accuracy {toy['token_accuracy']:.4f}; run() without a "
          f"mesh {ref_toy['loss']:.5f}, {ref_toy['token_accuracy']:.4f}; max diff {toy_err:.3e} "
          f"(tol {TOL_SHARD_NMT:.0e}); launches per rank {path_launch}", flush=True)
    check(toy_err <= TOL_SHARD_NMT and path_launch.get("kron_multi") == SHARD_NMT_STEPS,
          "s3: the toy NMT workload over data")
    s4_rates = {fam: r0[f"tp_{fam}"]["rate"] for fam in TP_FIELDS}

    # 20. S5 on four gloo ranks sharing the card, mesh (data=2, shard=2):
    #     the reference NMT with parameters split over data, shard or both
    #     under kron and lra, against the same steps in one process
    t0 = time.perf_counter()
    s5 = _spawn(_s5_job, 4)
    _s5_report(torch, s5, check, launches, smi, s4_rates, time.perf_counter() - t0)
    shard_n = SHARD_LRA[0]
    shard_bound = {
        "lra_upd_sharded": _bound(*family_work("lra", shard_n)),
        "splu_upd_sharded": _bound(*splu_work(SHARD_SPLU[0], apply=True))}

    for name in ("kron_multi", "kron_dd", "kron_dd_batched", "tri", "kron_sparse_big_ns",
                 "kron_sparse_big_ds",
                 "kron_sparse_big_nd", "kron_sparse_big_ns_wide2", "kron_sparse_big_ns_wide_xla",
                 "lra_upd", "dense_upd", "dense_big", "splu_one", "splu_upd",
                 "lra_upd_sharded", "splu_upd_sharded", "kron_sparse_big_apply_ns",
                 "kron_sparse_big_apply_nd", "kron_sparse_big_apply_ns_wide", "tri_solve",
                 "kron_dd_multi", "splu_upd_apply", "splu_upd_mono", "kron_mono", "attn_fwd",
                 "attn_bwd", "attn_enc_grad"):
        check(launches[name] > 0, f"{name} launched on the paths")
    if failures:
        print(f"chip_smoke: {len(failures)} phase(s) failed: {failures}", file=sys.stderr)
        return 1
    src = "psgd_tf_tpu_torch/csrc/"
    pallas = "psgd_tf_tpu/ops/pallas/"

    def entry(name, source, replaces, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": pallas + replaces, "launches": launches[name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    big_n = DENSE_K12[-1]
    kernels = [
        entry("kron_multi", "kron_dd.cu", "kron_multi.py:222", max(k1_abs, mix_abs, dec_abs),
              k1_ms, k1_plain_ms, k1_bound),
        entry("kron_dd", "kron_dd.cu", "kron_dd.py:181", k2_abs, k2_ms, k2_plain_ms, k2_bound),
        entry("kron_dd_batched", "kron_batched.cu", "kron_dd.py:252", k4_err, k4_ms, k4_plain_ms,
              k4_bound),
        entry("tri", "tri.cu", "tri.py:94", k3_abs, k3_ms, k3_plain_ms, k3_bound, k3_lib_ms),
        entry("kron_sparse", "kron_dd.cu", "kron_sparse.py:293", k5_abs, k5_ms, k5_plain_ms,
              k5_bound),
        # the one-launch route of K1's chain, timed on the toy NMT list
        entry("kron_mono", "kron_dd.cu", "kron_multi.py:202", route_err,
              route_times["K1 toy NMT"][0], route_times["K1 toy NMT"][2], mono_bound),
    ]
    for name, line in [("kron_sparse_big_ns", 377), ("kron_sparse_big_ds", 711)]:
        acc = big[name]
        kernels.append(entry(name, "kron_sparse_big.cu", f"kron_sparse_big.py:{line}", acc["err"],
                             acc["ms"], acc["plain_ms"], _bound(acc["bytes"], acc["flops"])))
    for name, line, acc in [("kron_sparse_big_ns_wide2", 456, wide["kron_sparse_big_ns_wide2"]),
                            ("kron_sparse_big_ns_wide_xla", 524,
                             wide["kron_sparse_big_ns_wide_xla"]),
                            ("kron_sparse_big_nd", 598, k9)]:
        kernels.append(entry(name, "kron_sparse_big.cu", f"kron_sparse_big.py:{line}", acc["err"],
                             acc["ms"], acc["plain_ms"], acc["bound"]))
    kernels += [
        entry("lra_upd", "lra.cu", "lra_upd.py:217", lra_err, *lra_times[LRA_SIZES[-1]],
              lra_bounds[LRA_SIZES[-1]]),
        entry("dense_upd", "dense.cu", "dense_upd.py:90", dense_err["dense_upd"],
              *dense_times[DENSE_K11[-1]], dense_bound[DENSE_K11[-1]]),
        entry("dense_big", "dense.cu", "dense_big.py:230", dense_err["dense_big"],
              *dense_times[big_n], dense_bound[big_n]),
        entry("splu_one", "splu.cu", "splu_one.py:223", splu_err["splu_one"],
              *splu_times[SPLU_K15[-1]], splu_bounds[SPLU_K15[-1]]),
        entry("splu_upd", "splu.cu", "splu_upd.py:636", splu_err["splu_upd"],
              *splu_times[SPLU_K16[-1]], splu_bounds[SPLU_K16[-1]]),
        # K14's own time on one NCCL rank (S1); S2's two gloo ranks add
        # gloo's host-staged transport
        entry("lra_upd_sharded", "lra.cu", "lra_upd.py:487", shard_err["lra_upd_sharded"],
              *s1_k14, shard_bound["lra_upd_sharded"]),
        entry("splu_upd_sharded", "splu.cu", "splu_upd.py:914", shard_err["splu_upd_sharded"],
              r0["splu"][SHARD_SPLU[0]]["ms"], r0["splu"][SHARD_SPLU[0]]["plain_ms"],
              shard_bound["splu_upd_sharded"]),
    ]
    for name, line in [("kron_sparse_big_apply_ns", 848), ("kron_sparse_big_apply_nd", 928),
                       ("kron_sparse_big_apply_ns_wide", 893)]:
        acc = unrouted[name]
        kernels.append(entry(name, "kron_sparse_big.cu", f"kron_sparse_big.py:{line}", acc["err"],
                             acc["ms"], acc["plain_ms"], acc["bound"]))
    kernels += [
        entry("tri_solve", "tri.cu", "tri.py:161", solve_err, solve_ms, solve_plain_ms,
              solve_bound, solve_lib_ms),
        entry("kron_dd_multi", "kron_dd.cu", "kron_dd.py:424", multi_err, multi["ms"],
              multi["plain_ms"], multi["bound"]),
    ]
    n_apply = SPLU_K16[-1]  # bench.py's 2^20, as the splu_upd row
    kernels += [entry(name, "splu.cu", f"splu_upd.py:{line}", apply_err[name],
                      apply_times[n_apply][key], apply_times[n_apply]["plain"],
                      apply_bounds[n_apply])
                for name, line, key in [("splu_upd_apply", 814, "apply"),
                                        ("splu_upd_mono", 582, "mono")]]
    # the attention's kernels replace no TPU kernel: the JAX package leaves
    # the model's attention to XLA
    kernels += [{"name": name, "route": "cuda", "source": src + "attention.cu", "replaces": "none",
                 "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
                for name, (err, ms, plain_ms, bound) in attn_rows.items()]
    print(f"chip_smoke: every phase passed, {time.perf_counter() - t_main:.1f} s with the build",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
