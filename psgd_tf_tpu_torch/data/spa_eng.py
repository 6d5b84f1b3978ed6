"""Loader and tokenizer for the tab-separated spa-eng corpus.

Counterpart of `psgd_tf_tpu/data/spa_eng.py`, in numpy and the standard
library only: the same sentences, token ids, padded arrays and seeded split.
The TF reference's NMT demo (neural_machine_translation_with_attention.py:
19-86) reads `spa-eng.zip` (one `spa.txt`, lines of ``english<TAB>spanish``),
preprocesses each sentence (strip accents via NFD, lowercase, pad
punctuation with spaces, drop every char outside ``a-zA-Z?.!,¿``, wrap in
``<start> .. <end>``), word-tokenizes each language with a Keras
``Tokenizer(filters='')``, pads post to the per-language max length, and
takes an 80/20 train/val split.

Nothing is downloaded: point `load` at a staged copy, the ``spa.txt`` file
itself, a directory holding it (directly or under ``spa-eng/``), or the zip.
`staged_path()` reads the path from the environment variable
``PSGD_TF_TPU_SPA_ENG``. Tokenizer ids follow Keras: by frequency
(descending, first-appearance tie-break), 0 reserved for padding, 1 the most
frequent word. The split is a seeded permutation, so runs reproduce.
"""
from __future__ import annotations

import io
import os
import re
import unicodedata
import zipfile
from collections import Counter
from typing import NamedTuple

import numpy as np

_PUNCT = re.compile(r"([?.!,¿])")
_SPACES = re.compile(r'[" "]+')  # the reference's class: quote or space
_NONWORD = re.compile(r"[^a-zA-Z?.!,¿]+")


def preprocess_sentence(w: str) -> str:
    """The reference's sentence normalization."""
    w = "".join(
        c
        for c in unicodedata.normalize("NFD", w.lower().strip())
        if unicodedata.category(c) != "Mn"
    )
    w = _PUNCT.sub(r" \1 ", w)
    w = _SPACES.sub(" ", w)
    w = _NONWORD.sub(" ", w)
    return "<start> " + w.strip() + " <end>"


class Tokenizer(NamedTuple):
    """Keras ``Tokenizer(filters='')``: whitespace split, ids by descending
    frequency (stable tie-break on first appearance), 0 = PAD (never
    assigned)."""

    word_index: dict[str, int]

    @property
    def vocab_size(self) -> int:
        return len(self.word_index) + 1  # + 1 for token 0

    def encode(self, texts: list[str]) -> list[list[int]]:
        wi = self.word_index
        return [[wi[t] for t in s.split() if t in wi] for s in texts]

    def decode(self, ids) -> str:
        inv = {i: w for w, i in self.word_index.items()}
        return " ".join(inv[int(i)] for i in ids if int(i) in inv)


def fit_tokenizer(texts: list[str]) -> Tokenizer:
    counts = Counter()
    for s in texts:
        counts.update(s.split())
    # Counter keeps first-appearance order and sorted() is stable, so ties
    # keep that order, as Keras' fit_on_texts does
    ranked = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)
    return Tokenizer({w: i + 1 for i, (w, _) in enumerate(ranked)})


def _read_lines(path: str) -> list[str]:
    """spa.txt from a file, a directory, or the distribution zip."""
    if os.path.isdir(path):
        for cand in ("spa.txt", os.path.join("spa-eng", "spa.txt"), "spa-eng.zip"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                return _read_lines(p)
        raise FileNotFoundError(f"no spa.txt / spa-eng.zip under {path}")
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            name = next(n for n in zf.namelist() if n.endswith("spa.txt"))
            with zf.open(name) as f:
                return io.TextIOWrapper(f, encoding="utf-8").read().strip().split("\n")
    with open(path, encoding="utf-8") as f:
        return f.read().strip().split("\n")


def create_dataset(path: str, num_examples: int | None = None):
    """(english_sentences, spanish_sentences), both preprocessed. A third
    (Tatoeba attribution) column is ignored."""
    lines = _read_lines(path)[:num_examples]
    pairs = [[preprocess_sentence(w) for w in l.split("\t")[:2]] for l in lines]
    eng, spa = zip(*pairs)
    return list(eng), list(spa)


def _pad_post(seqs: list[list[int]]) -> np.ndarray:
    width = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


class SpaEng(NamedTuple):
    src_train: np.ndarray  # spanish, the reference's input language
    tgt_train: np.ndarray  # english
    src_val: np.ndarray
    tgt_val: np.ndarray
    src_tok: Tokenizer
    tgt_tok: Tokenizer


def load(path: str, num_examples: int | None = 30000, seed: int = 0,
         val_fraction: float = 0.2) -> SpaEng:
    """Read, preprocess, tokenize per language, pad post and split 80/20
    by `np.random.default_rng(seed).permutation`. Direction spa -> eng."""
    eng, spa = create_dataset(path, num_examples)
    src_tok, tgt_tok = fit_tokenizer(spa), fit_tokenizer(eng)
    src = _pad_post(src_tok.encode(spa))
    tgt = _pad_post(tgt_tok.encode(eng))
    perm = np.random.default_rng(seed).permutation(len(src))
    n_val = int(round(val_fraction * len(src)))
    tr, va = perm[n_val:], perm[:n_val]
    return SpaEng(src[tr], tgt[tr], src[va], tgt[va], src_tok, tgt_tok)


def staged_path() -> str | None:
    """The corpus named by ``PSGD_TF_TPU_SPA_ENG``, or None when it is unset
    or holds no spa.txt."""
    p = os.environ.get("PSGD_TF_TPU_SPA_ENG")
    if not p or not os.path.exists(p):
        return None
    try:
        _read_lines(p)
    except (FileNotFoundError, StopIteration):
        return None
    return p
