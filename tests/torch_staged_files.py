"""Staged files written from numpy seeds for the port's tests: corpora in
the spa-eng format and MNIST's four IDX files. Imports neither JAX nor the
JAX package, so the card tests use it too."""
import gzip
import pathlib
import struct

import numpy as np

_SPA_LETTERS = list("abcdefghijlmnoprstuvyz") + list("áéíóúñü")
_ENG_LETTERS = list("abcdefghiklmnoprstuwy")
_ATTRIBUTION = "CC-BY 2.0 (France) Attribution: tatoeba.org #2877272 (CM) & #6085237 (Ente)"


def _forms(rng, letters, n):
    """`n` distinct lowercase word forms."""
    out, seen = [], set()
    while len(out) < n:
        lengths = rng.integers(2, 9, 2 * n)
        chars = np.array(letters)[rng.integers(0, len(letters), int(lengths.sum()))]
        for w in np.split(chars, np.cumsum(lengths)[:-1]):
            w = "".join(w)
            if w not in seen and len(out) < n:
                seen.add(w)
                out.append(w)
    return out


def corpus_lines(seed, n_lines, n_spa=300, n_eng=200):
    """spa-eng-format lines from a numpy seed: Zipf-drawn words, accents,
    '¿'/'¡' around questions and exclamations, digits and quotes that the
    preprocessing drops, an attribution column on a fifth of the lines."""
    rng = np.random.default_rng(seed)
    spa, eng = _forms(rng, _SPA_LETTERS, n_spa), _forms(rng, _ENG_LETTERS, n_eng)
    # Zipf (s = 1) ranks by inverting each vocabulary's CDF
    cdf_spa = np.cumsum(1.0 / np.arange(1, n_spa + 1))
    cdf_eng = np.cumsum(1.0 / np.arange(1, n_eng + 1))
    zipf = lambda cdf, k: np.minimum(np.searchsorted(cdf, rng.random(k) * cdf[-1]), len(cdf) - 1)
    lines = []
    for _ in range(n_lines):
        k = int(rng.integers(1, 9))
        e = [eng[i] for i in zipf(cdf_eng, k)]
        s = [spa[i] for i in zipf(cdf_spa, k + int(rng.integers(0, 3)))]
        if rng.random() < 0.1:
            e.insert(int(rng.integers(0, len(e) + 1)), f"{int(rng.integers(0, 100))}'s")
            s.insert(int(rng.integers(0, len(s) + 1)), '"' + s[0] + '"')
        e_txt, s_txt = " ".join(e).capitalize(), " ".join(s).capitalize()
        mood = rng.random()
        if mood < 0.2:
            e_txt, s_txt = e_txt + "?", "¿" + s_txt + "?"
        elif mood < 0.3:
            e_txt, s_txt = e_txt + "!", "¡" + s_txt + "!"
        else:
            e_txt, s_txt = e_txt + ".", s_txt + "."
        line = f"{e_txt}\t{s_txt}"
        if rng.random() < 0.2:
            line += "\t" + _ATTRIBUTION
        lines.append(line)
    return lines


def write_idx(d: pathlib.Path, split: str, imgs: np.ndarray, labels: np.ndarray, gz=False):
    """MNIST's two files of `split` ("train" or "t10k") in `d`: (n, 28, 28)
    uint8 images and (n,) uint8 labels, gzipped (level 1) with `gz`."""
    op, suffix = (lambda p, m: gzip.open(p, m, compresslevel=1), ".gz") if gz else (open, "")
    n = imgs.shape[0]
    with op(d / f"{split}-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.astype(np.uint8).tobytes())
    with op(d / f"{split}-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.astype(np.uint8).tobytes())


def write_mnist_dir(d: pathlib.Path, n_train, n_test, seed, gz_train=False, gz_test=False):
    """MNIST's four files in `d`, random bytes from `seed`; returns the
    uint8 images and labels."""
    rng = np.random.default_rng(seed)
    out = []
    for split, n, gz in (("train", n_train, gz_train), ("t10k", n_test, gz_test)):
        imgs = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, size=(n,), dtype=np.uint8)
        write_idx(d, split, imgs, labels, gz)
        out += [imgs, labels]
    return out
