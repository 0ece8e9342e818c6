"""Sequential-MNIST data for the paper's Fig. 5 reproduction (a copy of
``repro.data.smnist``: numpy only, so the data are the reference's).

This container has no network access and no bundled MNIST copy, so by
default we use a *procedurally generated surrogate* with the identical
interface: 784-step 1-D sequences, 10 classes.  Each class is a smooth
random prototype curve (class-specific Fourier coefficients) plus noise and
random temporal warping — hard enough that the quantization LADDER of the
paper (fp32 → quantized → hardware-compatible) is meaningfully resolved,
which is what Fig. 5 measures (relative degradation, not absolute MNIST
accuracy).  DESIGN.md records this substitution.

If a real ``mnist.npz`` (keys x_train/y_train/x_test/y_test) is present at
``data/mnist.npz`` (repo root) or ``$MNIST_NPZ``, it is used instead.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

SEQ_LEN = 784
N_CLASSES = 10


def _mnist_path():
    for p in (os.environ.get("MNIST_NPZ", ""),
              os.path.join(os.path.dirname(__file__), "../../../data/mnist.npz")):
        if p and os.path.exists(p):
            return p
    return None


@dataclasses.dataclass
class SequentialMNISTLike:
    seed: int = 0
    n_train: int = 4096
    n_test: int = 1024
    n_fourier: int = 12
    noise: float = 0.15

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        t = np.linspace(0, 1, SEQ_LEN)
        # class prototypes: random low-frequency Fourier curves in [0, 1]
        self.protos = np.zeros((N_CLASSES, SEQ_LEN), np.float32)
        for c in range(N_CLASSES):
            coef = rng.normal(size=(self.n_fourier, 2)) / np.arange(
                1, self.n_fourier + 1)[:, None]
            curve = sum(coef[k, 0] * np.sin(2 * np.pi * (k + 1) * t)
                        + coef[k, 1] * np.cos(2 * np.pi * (k + 1) * t)
                        for k in range(self.n_fourier))
            curve = (curve - curve.min()) / (np.ptp(curve) + 1e-9)
            self.protos[c] = curve

    def _make(self, n, rng):
        y = rng.integers(0, N_CLASSES, size=(n,))
        # random temporal warp + amplitude jitter + additive noise
        shift = rng.integers(-40, 40, size=(n,))
        amp = rng.uniform(0.7, 1.3, size=(n, 1))
        x = np.stack([np.roll(self.protos[c], s)
                      for c, s in zip(y, shift)]).astype(np.float32)
        x = np.clip(x * amp + self.noise * rng.normal(size=x.shape), 0, 1)
        return x[..., None].astype(np.float32), y.astype(np.int32)

    def splits(self):
        rng = np.random.default_rng(self.seed + 1)
        xtr, ytr = self._make(self.n_train, rng)
        xte, yte = self._make(self.n_test, rng)
        return (xtr, ytr), (xte, yte)


def load_smnist(seed=0, n_train=4096, n_test=1024, binarize=False):
    """Returns ((x_train, y_train), (x_test, y_test)); x: (N, 784, 1)."""
    path = _mnist_path()
    if path:
        z = np.load(path)
        xtr = z["x_train"].reshape(-1, SEQ_LEN, 1).astype(np.float32) / 255.0
        xte = z["x_test"].reshape(-1, SEQ_LEN, 1).astype(np.float32) / 255.0
        tr = (xtr[:n_train], z["y_train"][:n_train].astype(np.int32))
        te = (xte[:n_test], z["y_test"][:n_test].astype(np.int32))
    else:
        tr, te = SequentialMNISTLike(seed=seed, n_train=n_train,
                                     n_test=n_test).splits()
    if binarize:
        tr = ((tr[0] > 0.5).astype(np.float32), tr[1])
        te = ((te[0] > 0.5).astype(np.float32), te[1])
    return tr, te
