"""Seq2seq + attention translation with mixed Kronecker formats.

Counterpart of `psgd_tf_tpu/workloads/nmt_attention.py`, synthetic mode:
the reference's per-layer mixed formats (`models.nmt.kron_formats`), lr
0.05 for parameters and preconditioner, grad-norm clip 1.0, FD Hvp by
default (`exact_hvp=True` for the exact one), batch 64, the procedural
reversal-translation pair (`data.translation`). The bar is a teacher-forced
token accuracy above 0.75 on a held-out 256-row batch after the default
1000 steps. It runs on the card unless `device` says otherwise.

With `mesh` (a `parallel.Mesh`, as in JAX `:37, 85-91`) the step runs
sharded: the batch splits over `data` and the Kronecker state replicates;
every rank draws the same batches and probes from the same seed.

Not ported: the real spa-eng corpus run (`data_path`), whose corpus is not
in the repository.
"""
from __future__ import annotations

import torch

from psgd_tf_tpu_torch.data import translation
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.optim.psgd import PSGD


def run(
    steps: int = 1000,
    batch_size: int = 64,
    max_len: int = 16,
    seed: int = 0,
    exact_hvp: bool = False,
    cfg: nmt.Config = nmt.Config(),
    lr: float = 0.05,
    data_path: str | None = None,
    device: torch.device | str = "cuda",
    mesh=None,
) -> dict:
    """`device` is ignored with a `mesh`, whose device it runs on."""
    if data_path is not None:
        raise NotImplementedError(
            "the real spa-eng corpus run is not ported: the corpus is not in "
            "the repository"
        )
    if cfg.vocab_src != cfg.vocab_tgt:
        # the synthetic pair draws target ids over the source vocabulary
        raise ValueError(
            f"synthetic translation draws target ids up to {cfg.vocab_src - 1} "
            f"(the source vocabulary), out of range for vocab_tgt="
            f"{cfg.vocab_tgt}; use vocab_src == vocab_tgt"
        )
    if mesh is not None:
        device = mesh.device
    g = torch.Generator(device=device).manual_seed(seed)
    params = nmt.init(g, cfg)
    opt = PSGD(
        preconditioner="kron",
        kron_formats=nmt.kron_formats(cfg),
        lr_params=lr,
        lr_preconditioner=lr,
        grad_clip_max_norm=1.0,
        exact_hessian_vector_product=exact_hvp,
    )
    state = opt.init(params, seed=seed)
    if mesh is not None:
        from psgd_tf_tpu_torch.parallel import build_sharded_step, shard_state

        step = build_sharded_step(opt, nmt.loss, mesh, state, params)
        state = shard_state(mesh, state)
    else:
        step = lambda *a: opt.step(nmt.loss, *a)
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


if __name__ == "__main__":
    print(run())
