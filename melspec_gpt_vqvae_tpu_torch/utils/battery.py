"""The deterministic stimulus batteries: the code-parity check's and the
learning proofs'.

The port's own copies of ``make_battery`` in the repository's
``parity_check.py`` (numpy only: 48 clips of tones, chirps, harmonic
stacks, AM tones and seeded noise mixes), of ``make_tone_battery`` and
``wavs_to_training_mels`` in ``scripts/quality_proof.py`` (64 clips of 4
frequency-band classes, and their mels as the codec trains on them) and
of ``make_hard_battery`` in ``scripts/spec_measured.py`` (64 clips of 4
classes of varied audio), bit for bit the same waveforms.
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


SR = 22050
N_CLASSES = 4
TONES_PER_CLASS = 4
JITTERS = 4


def make_tone_battery(mcfg):
    """64 clips: 4 frequency-band classes x 4 tones x 4 jittered variants.
    Returns (wavs (64, clip_samples) float32, labels (64,) int32, base
    frequencies (64,))."""
    rng = np.random.default_rng(7)
    t = np.arange(mcfg.clip_samples, dtype=np.float64) / SR
    freqs = np.geomspace(150.0, 4000.0, N_CLASSES * TONES_PER_CLASS)
    wavs, labels, base_freqs = [], [], []
    for i, f in enumerate(freqs):
        for j in range(JITTERS):
            amp = 0.3 * (1.0 + 0.1 * rng.standard_normal())
            w = amp * np.sin(2 * np.pi * f * (1 + 0.002 * j) * t)
            w += 0.01 * rng.standard_normal(len(t))
            wavs.append(w)
            labels.append(i // TONES_PER_CLASS)
            base_freqs.append(f)
    return (np.stack(wavs).astype(np.float32), np.asarray(labels, np.int32),
            np.asarray(base_freqs))


def make_hard_battery(mcfg, seed=11):
    """64 clips, 4 classes of structured but varied audio, each clip with
    its own random parameters (the token corpus has real conditional
    entropy; a draft cannot memorise it):

      0: band-limited noise bursts (random band and attack envelope)
      1: linear chirps (random start / end frequencies in a class band)
      2: AM tones (random carrier and modulation rate) over a noise floor
      3: two-tone chords with click transients

    Returns (wavs (64, clip_samples) float32, labels (64,) int32, None)."""
    sr = SR
    rng = np.random.default_rng(seed)
    t = np.arange(mcfg.clip_samples, dtype=np.float64) / sr
    wavs, labels = [], []
    per_class = 16
    for c in range(N_CLASSES):
        for _ in range(per_class):
            if c == 0:
                lo = rng.uniform(200, 1200)
                hi = lo * rng.uniform(1.3, 2.0)
                x = rng.standard_normal(len(t))
                spec = np.fft.rfft(x)
                f = np.fft.rfftfreq(len(t), 1.0 / sr)
                spec[(f < lo) | (f > hi)] = 0.0
                w = np.fft.irfft(spec, len(t))
                w *= 1.0 - np.exp(-t / rng.uniform(0.05, 0.5))
                w = 0.3 * w / (np.abs(w).max() + 1e-9)
            elif c == 1:
                f0 = rng.uniform(300, 800)
                f1 = f0 * rng.uniform(1.5, 4.0)
                ph = 2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * t[-1]))
                w = 0.3 * np.sin(ph + rng.uniform(0, 2 * np.pi))
            elif c == 2:
                fc = rng.uniform(800, 2500)
                fm = rng.uniform(2.0, 20.0)
                depth = rng.uniform(0.4, 1.0)
                w = (1 + depth * np.sin(2 * np.pi * fm * t)) / 2
                w = 0.25 * w * np.sin(2 * np.pi * fc * t)
                w += 0.02 * rng.standard_normal(len(t))
            else:
                fa = rng.uniform(400, 1000)
                fb = fa * rng.choice([1.25, 1.5, 2.0])
                w = 0.15 * (np.sin(2 * np.pi * fa * t)
                            + np.sin(2 * np.pi * fb * t))
                for _ in range(rng.integers(3, 9)):
                    i = rng.integers(0, len(t) - 200)
                    w[i:i + 200] += 0.3 * np.hanning(200) \
                        * rng.choice([-1.0, 1.0])
            w += 0.01 * rng.standard_normal(len(t))
            wavs.append(w)
            labels.append(c)
    return (np.stack(wavs).astype(np.float32),
            np.asarray(labels, np.int32), None)


def wavs_to_training_mels(wavs, mcfg, device):
    """Mels of ``wavs`` on ``device`` (kernel D on the card), 16 clips a
    call, cropped to 848 frames.  Returns numpy (mels01 (N, 80, 848) in [0,
    1], x_all (N, 80, 848, 1) in [-1, 1] float32), the input of every
    proof battery."""
    import torch

    from ..ops.mel_kernel import waveform_to_mel_fused
    with torch.inference_mode():
        mels = np.concatenate([
            waveform_to_mel_fused(torch.as_tensor(wavs[i:i + 16]).to(device),
                                  mcfg).cpu().numpy()
            for i in range(0, len(wavs), 16)])             # (N, 80, 860)
    mels = mels[:, :, 6:854]                               # crop 848
    return mels, (2.0 * mels - 1.0)[..., None].astype(np.float32)
