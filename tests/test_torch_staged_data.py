"""Port parity for the staged-data paths: the spa-eng loader and tokenizers,
the native IDX decoder and batcher, `mnist.load_idx`, the NMT workload's
corpus mode (`data_path`) and LeNet5's IDX mode (`data_dir`),
psgd_tf_tpu_torch against psgd_tf_tpu on the CPU, on corpora and IDX files
written here from numpy seeds."""
import gzip
import pathlib
import re
import shutil
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu.hvp as jhvp
from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.data import mnist as jmnist
from psgd_tf_tpu.data import native as jnative
from psgd_tf_tpu.data import spa_eng as jspa_eng
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu.workloads import nmt_attention as jnmt_attention
from psgd_tf_tpu_torch import PSGD, interop
from psgd_tf_tpu_torch.data import mnist, native, spa_eng
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.workloads import mnist_lenet5, nmt_attention
from torch_staged_files import corpus_lines, write_mnist_dir

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

# tests/test_real_nmt_parity.py's fixture: english<TAB>spanish, one line with
# Tatoeba's attribution third column
FIXTURE_LINES = [
    "Go.\tVe.",
    "Run!\t¡Corre!",
    "Who?\t¿Quién?",
    "Fire!\t¡Fuego!",
    "Help!\t¡Ayuda!\tCC-BY (attribution column)",
    "I ran.\tCorrí.",
    "He ran.\tÉl corrió.",
    "Go home.\tVete a casa.",
    "She ran home.\tElla corrió a casa.",
    "We ran home.\tCorrimos a casa.",
    "I see him.\tLo veo.",
    "I see her.\tLa veo.",
    "You see me.\tMe ves.",
    "They see us.\tNos ven.",
    "Go see him.\tVe a verlo.",
    "Run home now.\tCorre a casa ahora.",
]
# JAX's preprocessing cases (tests/test_real_nmt_parity.py:53-64)
PREPROCESS_CASES = ["¿Quién corrió?", "He is a boy.", "Tom's 2nd car!", "Él"]

def _write(path, lines):
    path.write_text("\n".join(lines), encoding="utf-8")
    return str(path)


@pytest.fixture()
def fixture_corpus(tmp_path):
    return _write(tmp_path / "spa.txt", FIXTURE_LINES)


@pytest.fixture()
def generated_corpus(tmp_path):
    return _write(tmp_path / "spa.txt", corpus_lines(7, 130))


def _assert_same_dataset(got, want):
    for name in ("src_train", "tgt_train", "src_val", "tgt_val"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    assert got.src_tok.word_index == want.src_tok.word_index
    assert got.tgt_tok.word_index == want.tgt_tok.word_index
    assert list(got.src_tok.word_index) == list(want.src_tok.word_index)


# ------------------------------------------------------------------ spa-eng


def test_preprocess_sentence_matches_jax():
    lines = corpus_lines(0, 200)
    texts = PREPROCESS_CASES + [col for line in lines for col in line.split("\t")]
    assert len(texts) > 400
    for t in texts:
        assert spa_eng.preprocess_sentence(t) == jspa_eng.preprocess_sentence(t), t
    assert spa_eng.preprocess_sentence("¿Quién corrió?") == "<start> ¿ quien corrio ? <end>"


def test_tokenizers_match_jax():
    texts = ["<start> a b a <end>", "<start> b a c <end>"]
    for corpus in (texts, [spa_eng.preprocess_sentence(l.split("\t")[1])
                           for l in corpus_lines(1, 200)]):
        tok, jtok = spa_eng.fit_tokenizer(corpus), jspa_eng.fit_tokenizer(corpus)
        assert tok.word_index == jtok.word_index
        assert list(tok.word_index) == list(jtok.word_index)
        assert tok.vocab_size == jtok.vocab_size
        assert tok.encode(corpus + ["unseen words here"]) == jtok.encode(
            corpus + ["unseen words here"])
        assert tok.decode([2, 1, 4, 0]) == jtok.decode([2, 1, 4, 0])
    tok = spa_eng.fit_tokenizer(texts)
    assert tok.word_index == {"a": 1, "<start>": 2, "b": 3, "<end>": 4, "c": 5}


@pytest.mark.parametrize("seed,val_fraction,num_examples", [(0, 0.2, None), (3, 0.25, 100),
                                                            (5, 0.2, 30000)])
def test_load_matches_jax(generated_corpus, seed, val_fraction, num_examples):
    got = spa_eng.load(generated_corpus, num_examples=num_examples, seed=seed,
                       val_fraction=val_fraction)
    want = jspa_eng.load(generated_corpus, num_examples=num_examples, seed=seed,
                         val_fraction=val_fraction)
    _assert_same_dataset(got, want)
    # the attribution column never reaches the english side
    assert "attribution" not in got.tgt_tok.word_index
    assert got.src_train.shape[0] + got.src_val.shape[0] == min(130, num_examples or 130)


def test_load_from_file_directory_and_zip_match_jax(tmp_path, fixture_corpus):
    d = tmp_path / "dir" / "spa-eng"
    d.mkdir(parents=True)
    shutil.copy(fixture_corpus, d / "spa.txt")
    flat = tmp_path / "flat"
    flat.mkdir()
    shutil.copy(fixture_corpus, flat / "spa.txt")
    zp = tmp_path / "spa-eng.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.write(fixture_corpus, "spa-eng/spa.txt")
    zdir = tmp_path / "zipdir"
    zdir.mkdir()
    shutil.copy(zp, zdir / "spa-eng.zip")
    want = jspa_eng.load(fixture_corpus, num_examples=None)
    for path in (fixture_corpus, str(tmp_path / "dir"), str(flat), str(zp), str(zdir)):
        got = spa_eng.load(path, num_examples=None)
        _assert_same_dataset(got, want)
        _assert_same_dataset(got, jspa_eng.load(path, num_examples=None))
    empty = tmp_path / "empty"
    empty.mkdir()
    for load in (spa_eng.load, jspa_eng.load):
        with pytest.raises(FileNotFoundError, match="no spa.txt"):
            load(str(empty), num_examples=None)


def test_staged_path(monkeypatch, tmp_path, fixture_corpus):
    monkeypatch.delenv("PSGD_TF_TPU_SPA_ENG", raising=False)
    assert spa_eng.staged_path() is None
    empty = tmp_path / "empty"
    empty.mkdir()
    for value, want in [(fixture_corpus, fixture_corpus), (str(empty), None),
                        (str(tmp_path / "nope"), None), (str(tmp_path), fixture_corpus)]:
        monkeypatch.setenv("PSGD_TF_TPU_SPA_ENG", value)
        assert spa_eng.staged_path() == jspa_eng.staged_path()
        assert spa_eng.staged_path() == (None if want is None else value)


# ------------------------------------------------------------------ native

needs_native = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="no C++ toolchain / native build failed")


def _code_lines(path):
    """The source without its // comments."""
    return [re.sub(r"//.*", "", l).rstrip() for l in path.read_text().splitlines()]


def test_batcher_source_is_a_copy_of_jax():
    """The port builds its own copy. Every line of code is the JAX
    package's; one comment line names the reference file without a machine
    path."""
    ours = REPO / "psgd_tf_tpu_torch" / "data" / "_native" / "batcher.cpp"
    theirs = REPO / "psgd_tf_tpu" / "data" / "_native" / "batcher.cpp"
    assert _code_lines(ours) == _code_lines(theirs)
    a, b = ours.read_text().splitlines(), theirs.read_text().splitlines()
    assert len(a) == len(b) and sum(x != y for x, y in zip(a, b)) == 1
    assert native._SRC == ours


@needs_native
def test_native_builds_into_the_ports_build_dir():
    so = native._so_path()
    assert so.exists() and so.parent.parent == REPO / "psgd_tf_tpu_torch" / "_build"
    assert not (REPO / "psgd_tf_tpu_torch" / "data" / "_native" / "batcher.so").exists()


def _write_idx_pair(tmp_path, n, seed, gz=False, stem="x"):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(n,), dtype=np.uint8)
    op = gzip.open if gz else open
    ipath = tmp_path / (f"{stem}-images" + (".gz" if gz else ""))
    lpath = tmp_path / (f"{stem}-labels" + (".gz" if gz else ""))
    with op(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(lpath, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ipath), str(lpath), imgs, labels


@needs_native
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("max_n", [1 << 31, 17])
def test_native_decode_matches_jax(tmp_path, gz, max_n):
    ipath, lpath, imgs, labels = _write_idx_pair(tmp_path, 50, 0, gz)
    x, jx = native.decode_idx_images(ipath, max_n), jnative.decode_idx_images(ipath, max_n)
    y, jy = native.decode_idx_labels(lpath, max_n), jnative.decode_idx_labels(lpath, max_n)
    assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    n = min(50, max_n)
    assert x.shape == (n, 784)
    np.testing.assert_allclose(x, imgs[:n].reshape(n, -1) / 255.0, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(y, labels[:n])


@needs_native
@pytest.mark.parametrize("kind", ["bad_magic3", "bad_magic1", "short3", "short1", "tiny"])
def test_native_refusals_match_jax(tmp_path, kind):
    p = tmp_path / "bad"
    blob = {
        "bad_magic3": struct.pack(">IIII", 1234, 1, 2, 2) + b"\x00" * 4,
        "bad_magic1": struct.pack(">II", 1234, 3) + b"\x00" * 3,
        "short3": struct.pack(">IIII", 2051, 5, 28, 28) + b"\x00" * 100,
        "short1": struct.pack(">II", 2049, 5) + b"\x00" * 2,
        "tiny": b"\x00\x00",
    }[kind]
    p.write_bytes(blob)
    fns = ("decode_idx_labels",) if kind.endswith("1") else (
        ("decode_idx_images", "decode_idx_labels") if kind == "tiny" else ("decode_idx_images",))
    for fn in fns:
        with pytest.raises(ValueError) as ours:
            getattr(native, fn)(str(p))
        with pytest.raises(ValueError) as theirs:
            getattr(jnative, fn)(str(p))
        assert str(ours.value) == str(theirs.value)
        assert re.match(r"bad idx[13] file", str(ours.value))


@needs_native
@pytest.mark.parametrize("seed", [0, 42, 2**63 + 5])
def test_native_sample_batch_and_shuffle_match_jax(seed):
    rng = np.random.default_rng(1)
    images = rng.random((100, 17), dtype=np.float32)
    labels = rng.integers(0, 10, size=(100,)).astype(np.int32)
    x, y = native.sample_batch(images, labels, 32, seed=seed)
    jx, jy = jnative.sample_batch(images, labels, 32, seed=seed)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    for row, lab in zip(x, y):
        idx = np.where((images == row).all(axis=1))[0]
        assert len(idx) >= 1 and lab in labels[idx]
    order = native.shuffle_epoch(1000, seed=seed)
    np.testing.assert_array_equal(order, jnative.shuffle_epoch(1000, seed=seed))
    assert sorted(order.tolist()) == list(range(1000))


@needs_native
def test_native_sample_batch_refuses_bad_buffers():
    images = np.zeros((4, 3), np.float32)
    labels = np.zeros(4, np.int32)
    for bad_x, bad_y in [(images.astype(np.float64), labels), (images.T, labels),
                         (images, labels.astype(np.int64)), (images, labels[:3]),
                         (images[:0], labels[:0])]:
        with pytest.raises(ValueError):
            native.sample_batch(bad_x, bad_y, 2, seed=0)


def test_native_unavailable_raises(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="native batcher unavailable"):
        native.shuffle_epoch(3, 0)


# ------------------------------------------------------------------ load_idx

@pytest.mark.parametrize("gz", [(False, False), (True, False), (True, True)],
                         ids=["plain", "train_gz", "all_gz"])
def test_load_idx_matches_jax(tmp_path, monkeypatch, gz):
    raw = write_mnist_dir(tmp_path, 40, 12, 3, *gz)
    got_py = mnist.load_idx_python(str(tmp_path))
    monkeypatch.setattr(jnative, "available", lambda: False)
    want_py = jmnist.load_idx(str(tmp_path))
    monkeypatch.undo()
    for a, b, r in zip(got_py, want_py, raw):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got_py[0].shape == (40, 28, 28, 1) and got_py[2].shape == (12, 28, 28, 1)
    assert got_py[1].dtype == np.int32
    if native.available() and jnative.available():
        got_nat, want_nat = mnist.load_idx(str(tmp_path)), jmnist.load_idx(str(tmp_path))
        for a, b, p in zip(got_nat, want_nat, got_py):
            assert a.dtype == b.dtype == p.dtype and a.shape == b.shape == p.shape
            np.testing.assert_array_equal(a, b)
            # the native decode multiplies by the fp32 1/255, the Python one
            # divides in fp64 and rounds: one fp32 spacing at most
            np.testing.assert_allclose(a, p, atol=6e-8, rtol=0)
    # without the library the port takes the Python path
    monkeypatch.setattr(native, "available", lambda: False)
    for a, p in zip(mnist.load_idx(str(tmp_path)), got_py):
        np.testing.assert_array_equal(a, p)


def test_load_idx_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        mnist.load_idx(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jmnist.load_idx(str(tmp_path))


# ------------------------------------------------------------------ NMT data_path


def test_nmt_data_path_end_to_end(fixture_corpus):
    r = nmt_attention.run(data_path=fixture_corpus, batch_size=4, epochs=2, num_examples=None,
                          embed=8, units=16, lr=0.05, device="cpu")
    assert r["steps"] == 2 * (12 // 4) == 6
    assert set(r) == {"loss", "val_loss", "token_accuracy", "success", "steps", "vocab_src",
                      "vocab_tgt"}
    assert np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
    assert 0.0 <= r["token_accuracy"] <= 1.0 and r["success"] == (r["token_accuracy"] > 0.5)
    ds = jspa_eng.load(fixture_corpus, num_examples=None)
    assert (r["vocab_src"], r["vocab_tgt"]) == (ds.src_tok.vocab_size, ds.tgt_tok.vocab_size)
    # the vocabularies differ: the synthetic mode's vocab_src == vocab_tgt check is skipped
    assert r["vocab_src"] != r["vocab_tgt"]


class _RecordingPSGD:
    """Stands in for the JAX package's PSGD in `_run_real`: records the
    optimizer's settings, the initial weights and each step's batch, and
    leaves the weights as they are."""

    seen: dict = {}

    def __init__(self, **kwargs):
        self.seen.update(kwargs=kwargs, batches=[])

    def init(self, params, key):
        self.seen["params"] = [np.asarray(p) for p in params]
        return None

    def step(self, loss_fn, params, state, key, src, tgt):
        self.seen["batches"].append((np.asarray(src), np.asarray(tgt)))
        return params, state, {"loss": jnp.float32(0.0)}


def _jax_real_run(monkeypatch, corpus, **kwargs):
    """JAX's `_run_real` with the recording PSGD and no jit (the recorder
    sees host arrays)."""
    _RecordingPSGD.seen = {}
    monkeypatch.setattr(jnmt_attention, "PSGD", _RecordingPSGD)
    monkeypatch.setattr(jax, "jit", lambda f, **_: f)
    out = jnmt_attention.run(data_path=corpus, **kwargs)
    monkeypatch.undo()
    return out, _RecordingPSGD.seen


def test_nmt_batch_order_and_recipe_match_jax(monkeypatch, generated_corpus):
    kw = dict(batch_size=8, epochs=2, num_examples=None, embed=8, units=16, seed=3)
    _, seen = _jax_real_run(monkeypatch, generated_corpus, **kw)
    ds = spa_eng.load(generated_corpus, num_examples=None, seed=3)
    n_train = ds.src_train.shape[0]
    order = list(nmt_attention.batch_order(n_train, 8, 2, 3))
    assert len(order) == len(seen["batches"]) == 2 * (n_train // 8)
    for idx, (src, tgt) in zip(order, seen["batches"]):
        np.testing.assert_array_equal(ds.src_train[idx], src)
        np.testing.assert_array_equal(ds.tgt_train[idx], tgt)
    # the same optimizer recipe: hand formats, lr 0.02, clip 1.0, FD Hvp
    cfg = nmt_attention.real_config(ds, 8, 16)
    opt, _, _ = nmt_attention.optimizer(nmt.init(torch.Generator().manual_seed(0), cfg), cfg,
                                         0.02, False, 3, None)
    jkw = seen["kwargs"]
    assert opt.preconditioner == jkw["preconditioner"] == "kron"
    assert [tuple(f) for f in opt.kron_formats] == [tuple(f) for f in jkw["kron_formats"]]
    assert (opt.lr_params, opt.lr_preconditioner, opt.grad_clip_max_norm,
            opt.exact_hessian_vector_product) == (
        jkw["lr_params"], jkw["lr_preconditioner"], jkw["grad_clip_max_norm"],
        jkw["exact_hessian_vector_product"]) == (0.02, 0.02, 1.0, False)
    assert tuple(cfg) == tuple(jnmt.Config(vocab_src=ds.src_tok.vocab_size,
                                           vocab_tgt=ds.tgt_tok.vocab_size, embed=8, units=16,
                                           attn=10))


@pytest.mark.parametrize("batch_size", [10, 20])
def test_nmt_val_metrics_match_jax(monkeypatch, generated_corpus, batch_size):
    """JAX's val aggregation (a tail batch, token- and position-weighted)
    on the weights it starts from, against `val_metrics` on the same
    weights: within 1e-5."""
    out, seen = _jax_real_run(monkeypatch, generated_corpus, batch_size=batch_size, epochs=1,
                              num_examples=None, embed=8, units=16)
    ds = spa_eng.load(generated_corpus, num_examples=None)
    assert ds.src_val.shape[0] % batch_size != 0  # a tail batch
    val_loss, acc = nmt_attention.val_metrics(interop.tensors(seen["params"], device="cpu"),
                                              ds.src_val, ds.tgt_val, batch_size, "cpu")
    assert abs(val_loss - out["val_loss"]) <= 1e-5
    assert abs(acc - out["token_accuracy"]) <= 1e-5


def test_nmt_five_real_mode_steps_match_jax(monkeypatch, generated_corpus):
    """Five PSGD steps of the corpus mode's recipe (hand formats, lr 0.02,
    clip 1.0, FD Hvp) on its batches, the same weights and probes fed to
    both packages: the losses, weights and Q factors within 5e-4."""
    ds = spa_eng.load(generated_corpus, num_examples=None)
    cfg = nmt_attention.real_config(ds, 8, 16)
    jcfg = jnmt.Config(*cfg)
    shapes = jnmt.layer_shapes(jcfg)
    rng = np.random.default_rng(11)
    w = [0.3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    probes = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    order = list(nmt_attention.batch_order(ds.src_train.shape[0], 8, 1, 0))[:5]

    hyper = dict(preconditioner="kron", kron_formats=jnmt.kron_formats(jcfg), lr_params=0.02,
                 lr_preconditioner=0.02, grad_clip_max_norm=1.0,
                 exact_hessian_vector_product=False)
    jopt = JPSGD(**hyper)
    jparams = [jnp.asarray(a) for a in w]
    jstate = jopt.init(jparams, jax.random.PRNGKey(0))
    probe = []
    monkeypatch.setattr(jhvp, "random_like", lambda key, params: probe[0])

    def jstep(params, state, v, src, tgt):
        probe[:] = [v]
        return jopt.step(jnmt.loss, params, state, jax.random.PRNGKey(1), src, tgt)

    jstep = jax.jit(jstep)
    jlosses = []
    for idx, v in zip(order, probes):
        jparams, jstate, jaux = jstep(jparams, jstate, [jnp.asarray(a) for a in v],
                                      jnp.asarray(ds.src_train[idx]), jnp.asarray(ds.tgt_train[idx]))
        jlosses.append(float(jaux["loss"]))

    params = interop.tensors(w, device="cpu")
    opt, state, _ = nmt_attention.optimizer(params, cfg, 0.02, False, 0, None)
    assert opt == PSGD(**hyper)
    queue, losses = list(probes), []

    def step(params, state, g, src, tgt):
        out = opt.step(nmt.loss, params, state, g, src, tgt,
                       probes=interop.tensors(queue.pop(0), device="cpu"))
        losses.append(out[2]["loss"].item())
        return out

    src = torch.as_tensor(ds.src_train, dtype=torch.int64)
    tgt = torch.as_tensor(ds.tgt_train, dtype=torch.int64)
    params, state, loss, n = nmt_attention.train(step, params, state, None, src, tgt, order)
    assert n == 5 and loss.item() == losses[-1]
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)
    for st, jst in zip(state.precond, jstate.precond, strict=True):
        np.testing.assert_allclose(st.ql.numpy(), np.asarray(jst.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(st.qr.numpy(), np.asarray(jst.qr), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("case", ["steps", "cfg", "missing", "no_steps"])
def test_nmt_data_path_refusals_match_jax(tmp_path, fixture_corpus, case):
    kwargs = {
        "steps": dict(data_path=fixture_corpus, steps=20),
        "cfg": dict(data_path=fixture_corpus, cfg=None),
        "missing": dict(data_path=str(tmp_path / "nope" / "spa.txt")),
        "no_steps": dict(data_path=fixture_corpus, num_examples=None, batch_size=64,
                         embed=8, units=16),
    }[case]
    want = FileNotFoundError if case == "missing" else ValueError
    for pkg, extra in [(nmt_attention, {"device": "cpu"}), (jnmt_attention, {})]:
        kw = dict(kwargs)
        if case == "cfg":
            kw["cfg"] = (nmt if pkg is nmt_attention else jnmt).Config(embed=8)
        with pytest.raises(want) as err:
            pkg.run(**kw, **extra)
        if case != "missing":
            assert {"steps": "synthetic task only", "cfg": "synthetic task only",
                    "no_steps": "no training steps"}[case] in str(err.value)


# ------------------------------------------------------------------ LeNet5 data_dir


def test_lenet5_data_dir_runs_on_cpu(tmp_path):
    write_mnist_dir(tmp_path, 256, 256, 5, gz_train=True)
    out = mnist_lenet5.run(data_dir=str(tmp_path), epochs=1, steps_per_epoch=3, device="cpu")
    assert out["steps"] == 3 and np.isfinite(out["loss"])
    assert 0.0 <= out["best_test_error"] <= 1.0
    assert out["success"] == (out["best_test_error"] < 0.007)
    # the batches come from the files: the device copies hold the decoded arrays
    x_train, y_train, x_test, y_test = mnist_lenet5._device_idx(str(tmp_path), "cpu")
    want = mnist.load_idx(str(tmp_path))
    assert x_train.shape == (256, 28, 28, 1) and y_train.dtype == torch.int64
    np.testing.assert_array_equal(x_test.numpy(), want[2])
    np.testing.assert_array_equal(y_test.numpy(), want[3])
