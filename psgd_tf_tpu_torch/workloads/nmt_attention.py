"""Seq2seq + attention translation with mixed Kronecker formats.

Counterpart of `psgd_tf_tpu/workloads/nmt_attention.py`. Both modes use
the reference's per-layer mixed formats (`models.nmt.kron_formats`), the
same lr for parameters and preconditioner, grad-norm clip 1.0 and FD Hvp
by default (`exact_hvp=True` for the exact one). It runs on the card unless
`device` says otherwise.

Synthetic mode (no `data_path`): lr 0.05, batch 64, the procedural
reversal-translation pair (`data.translation`); the bar is a teacher-forced
token accuracy above 0.75 on a held-out 256-row batch after the default
1000 steps.

Corpus mode (`data_path`, a spa-eng corpus: file, directory or zip, see
`data.spa_eng`): the reference's real run. The model takes the reference's
real-run widths (embed 256, units 1024, attn 10, the vocabularies of the
fitted tokenizers), lr 0.02, batch 64 with drop-remainder over `epochs`
epochs of a seeded order; it reports the masked val loss and the val
token accuracy, whose bar is 0.5.

With `mesh` (a `parallel.Mesh`, as in JAX `:37, 85-91`) the step runs
sharded: the batch splits over `data` and the Kronecker state replicates;
every rank draws the same batches and probes from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from psgd_tf_tpu_torch.data import spa_eng, translation
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.optim.psgd import PSGD


def run(
    steps: int = 1000,
    batch_size: int = 64,
    max_len: int = 16,
    seed: int = 0,
    exact_hvp: bool = False,
    cfg: nmt.Config = nmt.Config(),
    lr: float | None = None,  # 0.05 synthetic, 0.02 with data_path
    data_path: str | None = None,
    epochs: int = 10,
    num_examples: int = 30000,
    embed: int = 256,
    units: int = 1024,
    device: torch.device | str = "cuda",
    mesh=None,
) -> dict:
    """`device` is ignored with a `mesh`, whose device it runs on.
    `epochs`, `num_examples`, `embed` and `units` apply to the corpus mode
    only; `steps`, `max_len` and `cfg` to the synthetic mode only."""
    if mesh is not None:
        device = mesh.device
    if data_path is not None:
        # the corpus run is epoch-based and sizes the model from the corpus:
        # refuse the synthetic knobs rather than ignore them
        if steps != 1000:
            raise ValueError(
                "steps applies to the synthetic task only; the real-corpus "
                "run is epoch-based — use epochs=/num_examples= instead"
            )
        if cfg != nmt.Config():
            raise ValueError(
                "cfg applies to the synthetic task only; the real-corpus "
                "run derives vocab from the tokenizers — use embed=/units="
            )
        return _run_real(data_path, batch_size=batch_size, seed=seed, exact_hvp=exact_hvp,
                         lr=0.02 if lr is None else lr, epochs=epochs,
                         num_examples=num_examples, embed=embed, units=units,
                         device=device, mesh=mesh)
    if cfg.vocab_src != cfg.vocab_tgt:
        # the synthetic pair draws target ids over the source vocabulary
        raise ValueError(
            f"synthetic translation draws target ids up to {cfg.vocab_src - 1} "
            f"(the source vocabulary), out of range for vocab_tgt="
            f"{cfg.vocab_tgt}; use vocab_src == vocab_tgt"
        )
    g = torch.Generator(device=device).manual_seed(seed)
    params = nmt.init(g, cfg)
    opt, state, step = optimizer(params, cfg, 0.05 if lr is None else lr, exact_hvp, seed,
                                  mesh)
    content = cfg.vocab_src - translation.SPECIALS

    first = loss = None
    for _ in range(steps):
        src, tgt = translation.batch(g, batch_size, max_len, content)
        params, state, aux = step(params, state, g, src, tgt)
        if first is None:
            first = float(aux["loss"])
        loss = aux["loss"]

    eval_src, eval_tgt = translation.batch(g, 256, max_len, content)
    acc = float(nmt.token_accuracy(params, eval_src, eval_tgt))
    return {
        "loss": float(loss),
        "first_loss": first,
        "token_accuracy": acc,
        "success": acc > 0.75,
        "steps": steps,
    }


def optimizer(params, cfg: nmt.Config, lr: float, exact_hvp: bool, seed: int, mesh):
    """(opt, state, step) of the workload's recipe; `step(params, state, g,
    src, tgt)` is sharded over `mesh` when one is given."""
    opt = PSGD(
        preconditioner="kron",
        kron_formats=nmt.kron_formats(cfg),
        lr_params=lr,
        lr_preconditioner=lr,
        grad_clip_max_norm=1.0,
        exact_hessian_vector_product=exact_hvp,
    )
    state = opt.init(params, seed=seed)
    if mesh is None:
        return opt, state, lambda *a: opt.step(nmt.loss, *a)
    from psgd_tf_tpu_torch.parallel import build_sharded_step, shard_state

    step = build_sharded_step(opt, nmt.loss, mesh, state, params)
    return opt, shard_state(mesh, state), step


def real_config(ds: spa_eng.SpaEng, embed: int = 256, units: int = 1024) -> nmt.Config:
    """The reference's real-run model for a loaded corpus: the fitted
    vocabularies, attn 10."""
    return nmt.Config(vocab_src=ds.src_tok.vocab_size, vocab_tgt=ds.tgt_tok.vocab_size,
                      embed=embed, units=units, attn=10)


def batch_order(n_train: int, batch_size: int, epochs: int, seed: int):
    """The corpus run's training batches as row indices: each epoch a
    `np.random.default_rng(seed + 1)` permutation cut into full batches
    (drop-remainder), as JAX `:176-189`. Raises ValueError when that gives
    no step."""
    steps_per_epoch = n_train // batch_size
    if epochs < 1 or steps_per_epoch < 1:
        raise ValueError(
            f"no training steps: epochs={epochs}, train split {n_train} "
            f"rows < batch_size={batch_size} — shrink batch_size or stage "
            "more examples"
        )

    def batches():
        rng = np.random.default_rng(seed + 1)
        for _ in range(epochs):
            order = rng.permutation(n_train)
            for b in range(steps_per_epoch):
                yield order[b * batch_size : (b + 1) * batch_size]

    return batches()


def train(step, params, state, generator: torch.Generator, src: torch.Tensor,
          tgt: torch.Tensor, order):
    """Run `step` over the batches `order` gives (index arrays into the
    token tensors `src`, `tgt`). Returns (params, state, the last loss, the
    number of steps)."""
    loss, n = None, 0
    for idx in order:
        idx = torch.as_tensor(idx, device=src.device)
        params, state, aux = step(params, state, generator, src[idx], tgt[idx])
        loss = aux["loss"]
        n += 1
    return params, state, loss, n


@torch.no_grad()
def val_metrics(params, src_val: np.ndarray, tgt_val: np.ndarray, batch_size: int,
                device) -> tuple[float, float]:
    """(val loss, val token accuracy), teacher-forced, in batches of
    `batch_size` rows with the tail batch included. The accuracy of a batch
    is weighted by its non-PAD target tokens, the loss (a mean over
    positions) by its positions, as JAX `:196-218`."""
    accs, losses, tok_w, pos_w = [], [], [], []
    for b in range(0, src_val.shape[0], batch_size):
        s, t = src_val[b : b + batch_size], tgt_val[b : b + batch_size]
        ts = torch.as_tensor(s, dtype=torch.int64, device=device)
        tt = torch.as_tensor(t, dtype=torch.int64, device=device)
        accs.append(float(nmt.token_accuracy(params, ts, tt)))
        losses.append(float(nmt.loss(params, ts, tt)))
        tok_w.append(int(np.sum(t[:, 1:] != 0)))
        pos_w.append(t[:, 1:].size)
    return float(np.average(losses, weights=pos_w)), float(np.average(accs, weights=tok_w))


def _run_real(
    data_path: str,
    batch_size: int = 64,
    seed: int = 0,
    exact_hvp: bool = False,
    lr: float = 0.02,
    epochs: int = 10,
    num_examples: int = 30000,
    embed: int = 256,
    units: int = 1024,
    device: torch.device | str = "cuda",
    mesh=None,
) -> dict:
    """The reference's spa-eng run. Success is a val token accuracy above
    0.5 (an untrained model sits near the unigram ceiling, ~0.35)."""
    ds = spa_eng.load(data_path, num_examples=num_examples, seed=seed)
    cfg = real_config(ds, embed, units)
    order = batch_order(ds.src_train.shape[0], batch_size, epochs, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    params = nmt.init(g, cfg)
    _, state, step = optimizer(params, cfg, lr, exact_hvp, seed, mesh)
    src = torch.as_tensor(ds.src_train, dtype=torch.int64, device=device)
    tgt = torch.as_tensor(ds.tgt_train, dtype=torch.int64, device=device)
    params, state, loss, steps = train(step, params, state, g, src, tgt, order)
    val_loss, acc = val_metrics(params, ds.src_val, ds.tgt_val, batch_size, device)
    return {
        "loss": float(loss),
        "val_loss": val_loss,
        "token_accuracy": acc,
        "success": acc > 0.5,
        "steps": steps,
        "vocab_src": cfg.vocab_src,
        "vocab_tgt": cfg.vocab_tgt,
    }


if __name__ == "__main__":
    print(run())
