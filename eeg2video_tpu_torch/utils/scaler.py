"""StandardScaler matching sklearn semantics (fit on train, transform both) —
the reference z-scores with per-split sklearn scalers everywhere
(EEG_VP_train_test.py:259-267, my_autoregressive_transformer.py:321-328,
eeg_text.py:141-145). A copy of the JAX package's ``utils/scaler.py``: numpy
only, serializable to the ``stats.npz`` (mean_z/std_z) contract documented by
the reference README (README.md:129,138)."""

from __future__ import annotations

import numpy as np


class StandardScaler:
    def __init__(self, mean=None, std=None):
        self.mean = mean
        self.std = std

    def fit(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        self.mean = x.mean(axis=0)
        # sklearn uses the biased (population) std
        self.std = x.std(axis=0)
        self.std = np.where(self.std == 0.0, 1.0, self.std)
        return self

    def transform(self, x):
        return ((np.asarray(x) - self.mean) / self.std).astype(np.float32)

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def save(self, path: str):
        np.savez(path, mean_z=self.mean, std_z=self.std)

    @classmethod
    def load(cls, path: str):
        z = np.load(path)
        return cls(mean=z["mean_z"], std=z["std_z"])
