"""MNIST-style 28x28 digit data: procedural sets and the IDX file reader.

Counterpart of `psgd_tf_tpu/data/mnist.py`. `synthetic` and
`synthetic_hard` render digits from the same glyph bitmaps with the same
augmentations, drawn from a `torch.Generator` on an explicit device. The
random bits differ from JAX's, so the images differ; the distribution is
the same. Both return images (n, 28, 28, 1) float in [0, 1] (NHWC, as the
JAX package) and int64 labels.

`load_idx` reads MNIST's IDX files (plain or .gz) on the host into numpy,
with the JAX package's arrays: images (n, 28, 28, 1) float32, int32 labels.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

_GLYPHS_TXT = [
    # 8x8 glyphs, '#' = ink
    [
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        "##  ##  ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        "  ##    ",
        " ###    ",
        "  ##    ",
        "  ##    ",
        "  ##    ",
        "  ##    ",
        " ####   ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "    ##  ",
        "   ##   ",
        "  ##    ",
        " ##     ",
        "######  ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "    ##  ",
        "  ###   ",
        "    ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        "   ###  ",
        "  ####  ",
        " ## ##  ",
        "##  ##  ",
        "######  ",
        "    ##  ",
        "    ##  ",
        "        ",
    ],
    [
        "######  ",
        "##      ",
        "#####   ",
        "    ##  ",
        "    ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        " ####   ",
        "##      ",
        "##      ",
        "#####   ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        "######  ",
        "    ##  ",
        "   ##   ",
        "   ##   ",
        "  ##    ",
        "  ##    ",
        "  ##    ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        " ####   ",
        "        ",
    ],
    [
        " ####   ",
        "##  ##  ",
        "##  ##  ",
        " #####  ",
        "    ##  ",
        "    ##  ",
        " ####   ",
        "        ",
    ],
]



def _glyph_bank() -> np.ndarray:
    """(10, 24, 24) float glyphs: 8x8 bitmaps upsampled x3 with a soft edge."""
    g = np.array(
        [[[1.0 if c == "#" else 0.0 for c in row] for row in glyph] for glyph in _GLYPHS_TXT],
        dtype=np.float32,
    )
    g = np.repeat(np.repeat(g, 3, axis=1), 3, axis=2)  # (10, 24, 24)
    # soft edges: 3x3 box blur so augmentation shifts create sub-ink gradients
    k = np.ones((3, 3), np.float32) / 9.0
    out = np.zeros_like(g)
    padded = np.pad(g, ((0, 0), (1, 1), (1, 1)))
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * padded[:, dy : dy + 24, dx : dx + 24]
    return out


def _bank(device) -> torch.Tensor:
    """(10, 28, 28) glyphs centred in the 28x28 frame."""
    return torch.from_numpy(np.pad(_glyph_bank(), ((0, 0), (2, 2), (2, 2)))).to(device)


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def synthetic(generator: torch.Generator, n: int, dtype=torch.float32):
    """n augmented digit images: random shift (+-3 px), contrast, noise."""
    g, dev = generator, generator.device
    labels = torch.randint(0, 10, (n,), generator=g, device=dev)
    imgs = _bank(dev)[labels]  # (n, 28, 28)
    dy = torch.randint(-3, 4, (n,), generator=g, device=dev)
    dx = torch.randint(-3, 4, (n,), generator=g, device=dev)
    ar = torch.arange(28, device=dev)
    rows = (ar[None, :] - dy[:, None]) % 28
    cols = (ar[None, :] - dx[:, None]) % 28
    imgs = imgs[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    amp = _uniform(g, (n, 1, 1), 0.7, 1.0)
    noise = 0.08 * torch.randn(imgs.shape, generator=g, device=dev)
    imgs = torch.clamp(amp * imgs + noise, 0.0, 1.0).to(dtype)
    return imgs[..., None], labels


def synthetic_hard(generator: torch.Generator, n: int, dtype=torch.float32):
    """Hardened procedural digits: per-sample affine distortion (rotation
    +-28deg, shear, scale 0.75-1.3, sub-pixel shift), stroke thickness
    (gamma), contrast, a background ramp, heavy noise and occasional
    occlusion bars. LeNet5 plateaus at a non-zero error on this set."""
    g, dev = generator, generator.device
    labels = torch.randint(0, 10, (n,), generator=g, device=dev)
    imgs = _bank(dev)[labels]  # (n, 28, 28)

    ang = _uniform(g, (n,), -0.5, 0.5)
    shear = _uniform(g, (n,), -0.3, 0.3)
    scale = _uniform(g, (n,), 0.75, 1.3)
    dy = _uniform(g, (n,), -3.5, 3.5)
    dx = _uniform(g, (n,), -3.5, 3.5)
    c, s = torch.cos(ang), torch.sin(ang)
    # forward map F = scale * R(ang) @ Shear; sample at F^{-1} (output->src)
    f00, f01 = scale * c, scale * (c * shear - s)
    f10, f11 = scale * s, scale * (s * shear + c)
    det = f00 * f11 - f01 * f10
    i00, i01 = f11 / det, -f01 / det
    i10, i11 = -f10 / det, f00 / det

    yy, xx = torch.meshgrid(
        torch.arange(28, device=dev, dtype=torch.float32) - 13.5,
        torch.arange(28, device=dev, dtype=torch.float32) - 13.5,
        indexing="ij",
    )
    e = lambda t: t[:, None, None]
    sy = e(i00) * yy + e(i01) * xx + 13.5 - e(dy)
    sx = e(i10) * yy + e(i11) * xx + 13.5 - e(dx)

    # bilinear sample with zero outside
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    wy = sy - y0
    wx = sx - x0
    bidx = torch.arange(n, device=dev)[:, None, None]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < 28) & (xi >= 0) & (xi < 28)
        vals = imgs[bidx, yi.clamp(0, 27), xi.clamp(0, 27)]
        return torch.where(valid, vals, 0.0)

    imgs = (
        tap(y0, x0) * (1 - wy) * (1 - wx)
        + tap(y0, x0 + 1) * (1 - wy) * wx
        + tap(y0 + 1, x0) * wy * (1 - wx)
        + tap(y0 + 1, x0 + 1) * wy * wx
    )

    gamma = _uniform(g, (n, 1, 1), 0.55, 2.0)
    imgs = torch.clamp(imgs, 0.0, 1.0) ** gamma

    amp = _uniform(g, (n, 1, 1), 0.5, 1.0)
    gy = _uniform(g, (n, 1, 1), -0.15, 0.15)
    gx = _uniform(g, (n, 1, 1), -0.15, 0.15)
    ramp = gy * (yy / 14.0) + gx * (xx / 14.0)
    sigma = _uniform(g, (n, 1, 1), 0.08, 0.22)
    noise = sigma * torch.randn(imgs.shape, generator=g, device=dev)

    # occlusion bar: a 4-px strip dimmed to 20%, ~30% of samples
    pos = torch.randint(4, 24, (n, 1, 1), generator=g, device=dev)
    horiz = torch.rand((n, 1, 1), generator=g, device=dev) < 0.5
    occlude = torch.rand((n, 1, 1), generator=g, device=dev) < 0.3
    coord = torch.where(horiz, yy[None], xx[None]) + 13.5
    bar = (coord >= pos) & (coord < pos + 4) & occlude
    imgs = torch.where(bar, 0.2 * imgs, imgs)

    imgs = torch.clamp(amp * imgs + ramp + noise, 0.0, 1.0).to(dtype)
    return imgs[..., None], labels


def load_idx(data_dir: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read staged MNIST idx(.gz) files: (x_train, y_train, x_test, y_test),
    images (n, 28, 28, 1) float32 in [0, 1], int32 labels, numpy on the host.

    Decodes with the native C++ decoder (`data.native`) when it builds;
    otherwise, and on a file the native path refuses, with the Python path
    below, which is also its oracle: both give the same arrays."""
    from psgd_tf_tpu_torch.data import native

    if native.available():
        def pair(img_name, lab_name):
            x = native.decode_idx_images(os.path.join(data_dir, img_name))
            y = native.decode_idx_labels(os.path.join(data_dir, lab_name))
            return x.reshape(-1, 28, 28, 1), y

        try:
            xtr, ytr = pair("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
            xte, yte = pair("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
            return xtr, ytr, xte, yte
        except (FileNotFoundError, ValueError):
            pass  # the Python path names the missing file or the bad magic
    return load_idx_python(data_dir)


def load_idx_python(data_dir: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """`load_idx`'s pure-Python decode."""
    def _open(name):
        for fname in (name, name + ".gz"):
            path = os.path.join(data_dir, fname)
            if os.path.exists(path):
                return gzip.open(path, "rb") if fname.endswith(".gz") else open(path, "rb")
        raise FileNotFoundError(f"{name}[.gz] not in {data_dir}")

    def _images(name):
        with _open(name) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad idx magic {magic}")
            buf = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return (buf.reshape(n, rows, cols, 1) / 255.0).astype(np.float32)

    def _labels(name):
        with _open(name) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad idx magic {magic}")
            return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)

    return (
        _images("train-images-idx3-ubyte"),
        _labels("train-labels-idx1-ubyte"),
        _images("t10k-images-idx3-ubyte"),
        _labels("t10k-labels-idx1-ubyte"),
    )
