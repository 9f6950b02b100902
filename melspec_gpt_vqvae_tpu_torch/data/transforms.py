"""Spectrogram transforms (numpy, host-side).

Parity with reference/datasets/transforms.py: ``Crop`` (center or
random, albumentations-equivalent semantics), ``StandardNormalizeAudio``
(per-mel-bin mean/std with a stats cache computed over the train split on
miss).  albumentations is not a dependency here — Center/RandomCrop on a 2D
array are a few lines of numpy.

The port's own copy of melspec_gpt_vqvae_tpu/data/transforms.py (numpy and the
standard library only): same classes, same batches for the same seed.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def center_crop(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """albumentations.CenterCrop semantics on (H, W)."""
    H, W = x.shape[:2]
    top = (H - h) // 2
    left = (W - w) // 2
    return x[top:top + h, left:left + w]


def random_crop(x: np.ndarray, h: int, w: int,
                rng: np.random.Generator) -> np.ndarray:
    H, W = x.shape[:2]
    top = int(rng.integers(0, H - h + 1))
    left = int(rng.integers(0, W - w + 1))
    return x[top:top + h, left:left + w]


class Crop:
    """(reference: datasets/transforms.py:75-91)

    Random crops draw positions under a lock: the loader's thread pool
    (``num_workers > 1``) calls transforms concurrently and numpy
    Generators are not thread-safe.  Draw ORDER is still
    scheduling-dependent under the pool — same semantics as the
    reference's multi-worker DataLoader, where each of the
    ``2*batch_size`` workers consumes its own stream."""

    def __init__(self, cropped_shape: Optional[Tuple[int, int]] = None,
                 random: bool = False, seed: int = 0):
        import threading
        self.cropped_shape = cropped_shape
        self.random = bool(random)
        self.rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.cropped_shape is None:
            return x
        h, w = self.cropped_shape
        if self.random:
            with self._lock:
                return random_crop(x, h, w, self.rng)
        return center_crop(x, h, w)


class StandardNormalizeAudio:
    """Frequency-wise normalisation with a cached-stats file
    (reference: datasets/transforms.py:13-65).  The cache file format is the
    reference's two-column text (means, stds per mel bin)."""

    def __init__(self, specs_dir: str,
                 train_ids_path: str = "./data/vggsound_train.txt",
                 cache_path: str = "./data/"):
        self.specs_dir = specs_dir
        self.train_ids_path = train_ids_path
        self.cache_path = os.path.join(
            cache_path, f"train_means_stds_{Path(specs_dir).stem}.txt")
        self.train_stats = self._calculate_or_load_stats()

    def _calculate_or_load_stats(self):
        try:
            stats = np.loadtxt(self.cache_path)
            means, stds = stats.T
        except OSError:
            with open(self.train_ids_path) as f:
                ids = [line.rstrip() for line in f]
            paths = [os.path.join(self.specs_dir, f"{i}_mel.npy") for i in ids]
            means_l, stds_l = [], []
            for p in paths:
                spec = np.load(p)
                means_l.append(spec.mean(axis=1))
                stds_l.append(spec.std(axis=1))
            means = np.array(means_l).mean(axis=0)
            stds = np.array(stds_l).mean(axis=0)
            np.savetxt(self.cache_path, np.vstack([means, stds]).T,
                       fmt="%0.8f")
        return {"means": means.reshape(-1, 1), "stds": stds.reshape(-1, 1)}

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x - self.train_stats["means"]) / self.train_stats["stds"]
