"""The deterministic stimulus battery of the code-parity check.

The port's own copy of ``make_battery`` in the repository's
``parity_check.py`` (numpy only): 48 clips of tones, chirps, harmonic
stacks, AM tones and seeded noise mixes, bit for bit the same waveforms.
"""

from __future__ import annotations

import numpy as np


def make_battery(n_samples: int, sr: int = 22050) -> np.ndarray:
    """Deterministic stimulus battery: tones, chirps, harmonics, AM, and
    seeded noise mixes.  Returns (48, n_samples) float32."""
    t = np.arange(n_samples, dtype=np.float64) / sr
    wavs = []
    # 16 pure tones, log-spaced across the mel range (fmin 125, fmax 7600)
    for f in np.geomspace(80.0, 7400.0, 16):
        wavs.append(0.3 * np.sin(2 * np.pi * f * t))
    # 8 linear chirps
    for f0, f1 in [(100, 2000), (2000, 100), (50, 7000), (7000, 50),
                   (300, 900), (900, 300), (1000, 4000), (4000, 1000)]:
        phase = 2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * t[-1]))
        wavs.append(0.3 * np.sin(phase))
    # 8 harmonic stacks (sawtooth-like partial sums)
    for f in np.geomspace(90.0, 1800.0, 8):
        w = sum(np.sin(2 * np.pi * f * k * t) / k for k in range(1, 6))
        wavs.append(0.25 * w / np.max(np.abs(w)))
    # 8 AM tones
    for f, fm in [(440, 2), (440, 8), (1000, 4), (1000, 16),
                  (3000, 3), (3000, 12), (200, 5), (5000, 7)]:
        wavs.append(0.3 * np.sin(2 * np.pi * f * t)
                    * (0.5 + 0.5 * np.sin(2 * np.pi * fm * t)))
    # 8 seeded noise mixes (broadband coverage; deterministic by seed)
    for seed in range(8):
        rng = np.random.default_rng(1000 + seed)
        wavs.append(0.15 * rng.standard_normal(n_samples)
                    + 0.15 * np.sin(2 * np.pi * (200 + 500 * seed) * t))
    return np.stack(wavs).astype(np.float32)
