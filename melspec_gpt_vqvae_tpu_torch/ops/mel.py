"""Mel-spectrogram frontend, forward chain, in plain PyTorch.

Counterpart of the forward half of melspec_gpt_vqvae_tpu/ops/mel.py
(reference feature_extraction/extract_mel_spectrogram.py:141-190,
librosa 0.8.1 semantics): pad or trim to 10 s, reflect pad n_fft / 2,
periodic Hann, |rFFT|, Slaney filterbank (fmin 125, fmax 7600), then the
LowerThresh / Log10 / scale / Clip / Trim chain.  ``waveform_to_mel`` is
the plain version of kernel D (ops/mel_kernel.py).

The window and filterbank are built in numpy here: the JAX module cannot be
imported without JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import MelConfig

# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale + Slaney norm, librosa.filters.mel-compatible)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    log_mel = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) \
        / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_mel, f / _F_SP)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = 22050, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 125.0, fmax: float = 7600.0) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) triangular filterbank, Slaney-normalised
    (librosa.filters.mel with htk=False, norm='slaney')."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _hann(n_fft: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, librosa's default."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Forward chain (wav -> normalised log-mel in [0, 1])
# ---------------------------------------------------------------------------


def pad_or_trim(wav: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad or truncate the last axis to ``length`` samples
    (reference: extract_mel_spectrogram.py:169-173)."""
    n = wav.shape[-1]
    if n < length:
        return F.pad(wav, (0, length - n))
    return wav[..., :length]


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of a (..., samples) tensor by ``pad``."""
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, -1)


def stft_magnitude(y: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                   power: float = 1.0) -> torch.Tensor:
    """|STFT|^power with center=True reflect padding (librosa 0.8.1).
    y (..., samples) -> (..., 1 + n_fft // 2, n_frames)."""
    frames = _reflect_pad(y, n_fft // 2).unfold(-1, n_fft, hop)
    frames = frames * torch.as_tensor(_hann(n_fft), device=y.device)
    spec = torch.fft.rfft(frames, dim=-1).abs()
    if power != 1.0:
        spec = spec ** power
    return spec.transpose(-1, -2)


def mel_forward_chain(mel_linear: torch.Tensor,
                      cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """LowerThresh -> Log10 -> *20 -> -20 -> +100 -> /100 -> Clip -> Trim
    (reference: extract_mel_spectrogram.py:141-151)."""
    x = torch.log10(torch.clamp_min(mel_linear, cfg.lower_thresh))
    x = (x * cfg.multiply - cfg.subtract + cfg.add) / cfg.divide
    x = torch.clamp(x, cfg.clip_min, cfg.clip_max)
    return x[..., :cfg.trim_len]


def waveform_to_mel(wav: torch.Tensor,
                    cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """wav (..., samples) -> normalised mel (..., n_mels, trim_len), float32
    (reference ``get_spectrogram``: extract_mel_spectrogram.py:166-190)."""
    wav = pad_or_trim(wav.float(), cfg.clip_samples)
    spec = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.spec_power)
    basis = torch.as_tensor(mel_filterbank(cfg.sample_rate, cfg.n_fft,
                                           cfg.n_mels, cfg.fmin, cfg.fmax),
                            device=wav.device)
    return mel_forward_chain(torch.matmul(basis, spec), cfg)
