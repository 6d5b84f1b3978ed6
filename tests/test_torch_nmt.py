"""Port parity for the NMT slice: the seq2seq + attention model, its
synthetic translation data and PSGD steps with the per-layer mixed
Kronecker formats, psgd_tf_tpu_torch against psgd_tf_tpu on the CPU, with
the same weights, tokens and probes fed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu.hvp as jhvp
from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.data import translation as jtranslation
from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu.optim.psgd import KronPrecond as JKronPrecond
from psgd_tf_tpu_torch import PSGD, hvp, interop, kron
from psgd_tf_tpu_torch.optim.psgd import KronPrecond
from psgd_tf_tpu_torch.data import translation
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.workloads import nmt_attention

torch.set_num_threads(1)

CFG = nmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=16, attn=4)
JCFG = jnmt.Config(*CFG)


def _inputs(seed, batch=8, max_len=6):
    """Weights and probes from numpy, tokens from the JAX package's data."""
    rng = np.random.default_rng(seed)
    shapes = jnmt.layer_shapes(JCFG)
    w = [0.3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    v = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    src, tgt = jtranslation.batch(jax.random.PRNGKey(seed), batch, max_len, CFG.vocab_src - 3)
    return w, v, np.asarray(src), np.asarray(tgt)


def _t(src, tgt):
    return torch.tensor(src, dtype=torch.int64), torch.tensor(tgt, dtype=torch.int64)


def test_config_shapes_and_formats_match_jax():
    for cfg, jcfg in [(nmt.Config(), jnmt.Config()), (nmt.ref_config(), jnmt.ref_config()), (CFG, JCFG)]:
        assert tuple(cfg) == tuple(jcfg)
        assert nmt.layer_shapes(cfg) == jnmt.layer_shapes(jcfg)
        assert nmt.kron_formats(cfg) == jnmt.kron_formats(jcfg)
    # the reference widths' parameter count
    assert sum(m * n for m, n in nmt.layer_shapes(nmt.ref_config())) == 12_424_273
    params = nmt.init(torch.Generator().manual_seed(0), CFG)
    assert [tuple(p.shape) for p in params] == nmt.layer_shapes(CFG)


def test_loss_accuracy_and_logits_match_jax():
    w, _, src, tgt = _inputs(0)
    assert (src == translation.PAD).any()  # the batch is padded: the masks matter
    tw, (ts, tt) = interop.tensors(w, device="cpu"), _t(src, tgt)
    jw = [jnp.asarray(a) for a in w]
    # 17 chained RNN steps whose fp32 sums run in another order: absolute
    # differences of ~1e-6 on logits of order 1
    for masked in (True, False):
        np.testing.assert_allclose(
            nmt._teacher_forced_logits(tw, ts, tt, mask_attention=masked).numpy(),
            np.asarray(jnmt._teacher_forced_logits(jw, jnp.asarray(src), jnp.asarray(tgt),
                                                   mask_attention=masked)),
            rtol=1e-5, atol=5e-6,
        )
    assert nmt.loss(tw, ts, tt).item() == pytest.approx(
        float(jnmt.loss(jw, jnp.asarray(src), jnp.asarray(tgt))), rel=1e-6)
    assert nmt.token_accuracy(tw, ts, tt).item() == pytest.approx(
        float(jnmt.token_accuracy(jw, jnp.asarray(src), jnp.asarray(tgt))))


def test_grads_and_exact_hvp_match_jax():
    w, v, src, tgt = _inputs(1)
    jl, jg, jh = jhvp.exact(jnmt.loss, [jnp.asarray(a) for a in w], [jnp.asarray(a) for a in v],
                            jnp.asarray(src), jnp.asarray(tgt))
    tl, tg, th = hvp.exact(nmt.loss, interop.tensors(w, device="cpu"),
                           interop.tensors(v, device="cpu"), *_t(src, tgt))
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    for a, b in zip(tg, jg, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    for a, b in zip(th, jh, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_finite_diff_hvp_matches_jax():
    w, v, src, tgt = _inputs(2)
    jl, jg, jh = jhvp.finite_diff(jnmt.loss, [jnp.asarray(a) for a in w],
                                  [jnp.asarray(a) for a in v], jnp.asarray(src), jnp.asarray(tgt))
    tl, tg, th = hvp.finite_diff(nmt.loss, interop.tensors(w, device="cpu"),
                                 interop.tensors(v, device="cpu"), *_t(src, tgt))
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    for a, b in zip(tg, jg, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    # (g(theta + delta v) - g(theta)) / delta multiplies the two gradients'
    # fp32 rounding by 1/delta = 1/sqrt(eps) ~ 2.9e3: an ulp of a gradient
    # entry near 1 becomes ~3.5e-4 in h
    for a, b in zip(th, jh, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-3)


def test_five_psgd_steps_match_jax(monkeypatch):
    """Five PSGD steps with the mixed formats (K1's kinds ds, ns, dd on the
    CPU path), exact Hvp, the same probes injected into both packages."""
    rng = np.random.default_rng(3)
    shapes = jnmt.layer_shapes(JCFG)
    w = [0.3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps = []
    for k in range(5):
        src, tgt = jtranslation.batch(jax.random.PRNGKey(10 + k), 8, 6, CFG.vocab_src - 3)
        steps.append((np.asarray(src), np.asarray(tgt),
                      [rng.standard_normal(s).astype(np.float32) for s in shapes]))
    hyper = dict(preconditioner="kron", kron_formats=jnmt.kron_formats(JCFG), lr_params=0.05,
                 lr_preconditioner=0.05, grad_clip_max_norm=1.0)

    jopt = JPSGD(**hyper)
    jparams = [jnp.asarray(a) for a in w]
    jstate = jopt.init(jparams, jax.random.PRNGKey(0))
    probe = []
    monkeypatch.setattr(jhvp, "random_like", lambda key, params: probe[0])

    def jstep(params, state, v, src, tgt):
        probe[:] = [v]
        return jopt.step(jnmt.loss, params, state, jax.random.PRNGKey(1), src, tgt)

    jstep = jax.jit(jstep)
    opt = PSGD(**hyper)
    params = interop.tensors(w, device="cpu")
    state = opt.init(params)
    for src, tgt, v in steps:
        jparams, jstate, jaux = jstep(jparams, jstate, [jnp.asarray(a) for a in v],
                                      jnp.asarray(src), jnp.asarray(tgt))
        params, state, aux = opt.step(nmt.loss, params, state, None, *_t(src, tgt),
                                      probes=interop.tensors(v, device="cpu"))
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)

    # ROADMAP's trajectory bound
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)
    for st, jst in zip(state.precond, jstate.precond, strict=True):
        assert st.fmt == tuple(jst.fmt)
        np.testing.assert_allclose(st.ql.numpy(), np.asarray(jst.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(st.qr.numpy(), np.asarray(jst.qr), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("batch_min", [4, 8])
def test_twenty_psgd_steps_default_formats_match_jax(monkeypatch, batch_min):
    """Twenty PSGD steps with PSGD's default Kronecker formats ('auto'):
    both embeddings take (norm, dense), K9's route past `kron_sparse.fits`,
    the fc (dense, scale), K10's. Exact Hvp, ids drawn per vocabulary,
    the same probes injected into both packages. The four (dense, dense)
    layers share one (128, 128) bucket: at the default `kron_batch_min=4`
    both packages stack them (the batched path, K4 on the card); at 8 they
    stay single layers (K2 on the card)."""
    cfg = nmt.Config(vocab_src=1100, vocab_tgt=1030, embed=16, units=32)
    jcfg = jnmt.Config(*cfg)
    shapes = jnmt.layer_shapes(jcfg)
    routes = [kron.route(kron.auto_format(s), s, "cuda") for s in shapes]
    assert routes == [jkron.route(kron.auto_format(s), s) for s in shapes]
    assert routes == ["kron_sparse_big:nd", "kron_dd", "kron_dd", "kron_dd",
                      "kron_sparse_big:nd", "kron_dd", "kron_sparse_big:ds"]
    rng = np.random.default_rng(4)
    w = [0.3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps = [(rng.integers(3, cfg.vocab_src, (8, 6)), rng.integers(3, cfg.vocab_tgt, (8, 5)),
              [rng.standard_normal(s).astype(np.float32) for s in shapes]) for _ in range(20)]
    hyper = dict(preconditioner="kron", kron_batch_min=batch_min, lr_params=0.05,
                 lr_preconditioner=0.05, grad_clip_max_norm=1.0)

    jopt = JPSGD(**hyper)
    jparams = [jnp.asarray(a) for a in w]
    jstate = jopt.init(jparams, jax.random.PRNGKey(0))
    probe = []
    monkeypatch.setattr(jhvp, "random_like", lambda key, params: probe[0])

    def jstep(params, state, v, src, tgt):
        probe[:] = [v]
        return jopt.step(jnmt.loss, params, state, jax.random.PRNGKey(1), src, tgt)

    jstep = jax.jit(jstep)
    opt = PSGD(**hyper)
    params = interop.tensors(w, device="cpu")
    state = opt.init(params)
    if batch_min == 4:
        pc, jpc = state.precond, jstate.precond
        assert isinstance(pc, KronPrecond) and isinstance(jpc, JKronPrecond)
        assert pc.batched_idx == jpc.batched_idx == ((1, 2, 3, 5),)
        assert pc.single_idx == jpc.single_idx == (0, 4, 6)
    else:
        assert [st.fmt for st in state.precond] == [tuple(st.fmt) for st in jstate.precond]
    for src, tgt, v in steps:
        jparams, jstate, jaux = jstep(jparams, jstate, [jnp.asarray(a) for a in v],
                                      jnp.asarray(src, jnp.int32), jnp.asarray(tgt, jnp.int32))
        params, state, aux = opt.step(nmt.loss, params, state, None, *_t(src, tgt),
                                      probes=interop.tensors(v, device="cpu"))
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)

    # ROADMAP's trajectory bound
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)
    if batch_min == 4:
        states = state.precond.batches + state.precond.singles
        jstates = jstate.precond.batches + jstate.precond.singles
    else:
        states, jstates = state.precond, jstate.precond
    for st, jst in zip(states, jstates, strict=True):
        np.testing.assert_allclose(st.ql.numpy(), np.asarray(jst.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(st.qr.numpy(), np.asarray(jst.qr), rtol=5e-4, atol=5e-5)


def test_translation_batch_structure():
    src, tgt = translation.batch(torch.Generator().manual_seed(0), 32, 10, content_vocab=13)
    assert src.shape == tgt.shape == (32, 12) and src.dtype == torch.int64
    assert (src[:, 0] == translation.BOS).all() and (tgt[:, 0] == translation.BOS).all()
    for s, t in zip(src.tolist(), tgt.tolist()):
        n = s.index(translation.EOS) - 1
        assert 10 // 4 <= n <= 10 and t.index(translation.EOS) == n + 1
        assert all(x == translation.PAD for x in s[n + 2:] + t[n + 2:])
        body_s, body_t = s[1:n + 1], t[1:n + 1]
        assert all(3 <= x < 16 for x in body_s)
        # the target is the reversed source through the cyclic bijection
        assert body_t == [3 + (x - 3 + 7) % 13 for x in reversed(body_s)]
    again = translation.batch(torch.Generator().manual_seed(0), 32, 10, content_vocab=13)
    assert torch.equal(src, again[0]) and torch.equal(tgt, again[1])
    full, _ = translation.batch(torch.Generator().manual_seed(1), 8, 6, 13, min_len=6)
    assert not (full == translation.PAD).any()
    assert translation.vocab_size() == jtranslation.vocab_size() == 32


def test_reference_width_tokens_stay_in_their_vocabularies():
    src, tgt = translation.random_tokens(torch.Generator().manual_seed(0), 9414, 4935)
    assert src.shape == (64, 18) and tgt.shape == (64, 13)
    assert int(src.min()) >= 3 and int(src.max()) < 9414
    assert int(tgt.min()) >= 3 and int(tgt.max()) < 4935


def test_workload_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(ValueError, match="vocab_tgt"):
        nmt_attention.run(steps=1, cfg=nmt.ref_config(), device="cpu")
    # the corpus mode refuses the synthetic knobs and a missing corpus, as JAX
    with pytest.raises(ValueError, match="synthetic task only"):
        nmt_attention.run(data_path="spa-eng.zip", steps=20, device="cpu")
    with pytest.raises(FileNotFoundError):
        nmt_attention.run(data_path=str(tmp_path / "spa-eng.zip"), device="cpu")


@pytest.mark.parametrize("exact_hvp", [False, True], ids=["fd", "exact"])
def test_workload_runs_on_cpu(exact_hvp):
    out = nmt_attention.run(steps=3, batch_size=8, max_len=6, cfg=CFG, exact_hvp=exact_hvp,
                            device="cpu")
    assert out["steps"] == 3 and np.isfinite(out["loss"]) and np.isfinite(out["first_loss"])
    assert 0.0 <= out["token_accuracy"] <= 1.0 and out["success"] == (out["token_accuracy"] > 0.75)
