"""Mel-spectrogram frontend, forward and inverse chain, in plain PyTorch.

Counterpart of melspec_gpt_vqvae_tpu/ops/mel.py (reference
feature_extraction/extract_mel_spectrogram.py:29-34, 141-190, librosa 0.8.1
semantics).  Forward: pad or trim to 10 s, reflect pad n_fft / 2, periodic
Hann, |rFFT|, Slaney filterbank (fmin 125, fmax 7600), then the
LowerThresh / Log10 / scale / Clip / Trim chain; ``waveform_to_mel`` is the
plain version of kernel D (ops/mel_kernel.py).  Inverse: the scalar chain
undone, the filterbank inverted by projected-gradient NNLS, phases by
Griffin-Lim with momentum; no TPU kernel computes these (XLA runs them
there), so they are plain PyTorch on either device.

The window and filterbank are built in numpy here: the JAX module cannot be
imported without JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

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


def _windowed_frames(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """center=True frames: (..., samples) -> (..., n_frames, n_fft),
    reflect-padded by n_fft / 2 and Hann-windowed."""
    frames = _reflect_pad(y, n_fft // 2).unfold(-1, n_fft, hop)
    return frames * torch.as_tensor(_hann(n_fft), device=y.device)


def stft_magnitude(y: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                   power: float = 1.0) -> torch.Tensor:
    """|STFT|^power with center=True reflect padding (librosa 0.8.1).
    y (..., samples) -> (..., 1 + n_fft // 2, n_frames)."""
    spec = torch.fft.rfft(_windowed_frames(y, n_fft, hop), dim=-1).abs()
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


# ---------------------------------------------------------------------------
# Inverse: mel -> STFT magnitude (NNLS) -> Griffin-Lim -> waveform
# ---------------------------------------------------------------------------


def stft_complex(y: torch.Tensor, n_fft: int = 1024,
                 hop: int = 256) -> torch.Tensor:
    """Complex STFT (center=True, reflect pad): (..., samples) ->
    complex64 (..., 1 + n_fft // 2, n_frames)."""
    return torch.fft.rfft(_windowed_frames(y, n_fft, hop),
                          dim=-1).transpose(-1, -2)


@functools.lru_cache(maxsize=8)
def _window_sum_square(n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """Sum of the squared Hann windows over the overlap-add positions of
    ``n_frames`` frames, 1 where it is (numerically) 0; float32."""
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    wss = np.zeros(n_fft + hop * (n_frames - 1), np.float32)
    np.add.at(wss, idx.reshape(-1), np.tile(_hann(n_fft) ** 2, n_frames))
    return np.where(wss > 1e-10, wss, 1.0).astype(np.float32)


def istft(stft: torch.Tensor, n_fft: int = 1024, hop: int = 256,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT: Hann-windowed irFFT frames overlap-added (``fold``),
    divided by the window-sum-square, the n_fft / 2 centre padding trimmed.
    stft (..., 1 + n_fft // 2, n_frames) complex -> (..., samples)."""
    frames = torch.fft.irfft(stft.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * torch.as_tensor(_hann(n_fft), device=frames.device)
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    sig = F.fold(frames.reshape(-1, n_frames, n_fft).transpose(1, 2),
                 output_size=(1, out_len), kernel_size=(1, n_fft),
                 stride=(1, hop)).reshape(*lead, out_len)
    sig = sig / torch.as_tensor(_window_sum_square(n_fft, hop, n_frames),
                                device=sig.device)
    sig = sig[..., n_fft // 2: out_len - n_fft // 2]
    return sig if length is None else sig[..., :length]


def mel_inverse_chain(mel_norm: torch.Tensor,
                      cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Inverse of the scalar chain back to linear mel (reference:
    extract_mel_spectrogram.py:154-163; Clip, Trim and LowerThresh are the
    identity in inverse mode)."""
    x = mel_norm * cfg.divide
    x = x - cfg.add + cfg.subtract
    x = x / cfg.multiply
    return torch.pow(10.0, x)


@functools.lru_cache(maxsize=8)
def _nnls_step(cfg: MelConfig) -> float:
    """1 / the spectral norm of the filterbank's Gram matrix (numpy, as the
    JAX package computes it): the projected gradient's Lipschitz step."""
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                           cfg.fmax)
    return 1.0 / (float(np.linalg.norm(basis.T @ basis, 2)) + 1e-10)


def mel_to_stft(mel_linear: torch.Tensor, cfg: MelConfig = MelConfig(),
                n_iter: int = 200) -> torch.Tensor:
    """Invert the mel projection approximately by projected-gradient NNLS
    (librosa.feature.inverse.mel_to_stft solves nnls(mel_basis, M); the
    reference calls it at extract_mel_spectrogram.py:30-32): start from the
    Gram-diagonal-scaled transpose projection, then ``n_iter`` steps of
    s <- max(0, s - step B^T (B s - M)).  (..., n_mels, T) -> |STFT|
    (..., 1 + n_fft // 2, T) (power 1 / spec_power applied)."""
    basis = torch.as_tensor(mel_filterbank(cfg.sample_rate, cfg.n_fft,
                                           cfg.n_mels, cfg.fmin, cfg.fmax),
                            device=mel_linear.device)
    basis_t = basis.T.contiguous()
    gram_diag_inv = 1.0 / (torch.sum(basis * basis, dim=0) + 1e-10)
    s = torch.clamp_min((basis_t @ mel_linear) * gram_diag_inv[:, None], 0.0)
    step = _nnls_step(cfg)
    for _ in range(n_iter):
        grad = basis_t @ (basis @ s - mel_linear)
        s = torch.clamp_min(s - step * grad, 0.0)
    if cfg.spec_power != 1.0:
        s = s ** (1.0 / cfg.spec_power)
    return s


def griffin_lim(mag: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                n_iter: int = 32, n_fft: int = 1024, hop: int = 256,
                momentum: float = 0.99, length: Optional[int] = None,
                uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction with momentum (librosa.griffinlim
    defaults: 32 iterations, momentum 0.99, random initial phases).

    The initial phases are 2 pi ``uniform``, a U[0, 1) draw of ``mag``'s
    shape; without one it is drawn from ``generator`` (torch's default
    generator if None).  JAX's ``jax.random.uniform`` cannot be reproduced
    in torch: a caller that wants the JAX package's phases hands its draw
    in.  mag (..., 1 + n_fft // 2, T) -> (..., samples)."""
    if uniform is None:
        uniform = torch.rand(mag.shape, generator=generator,
                             device=mag.device)
    angles = torch.exp(2j * math.pi * uniform.to(mag.device, torch.float32))
    tprev = torch.zeros_like(angles)
    keep = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        rebuilt = stft_complex(istft(mag * angles, n_fft, hop), n_fft, hop)
        update = rebuilt - keep * tprev
        angles = update / (update.abs() + 1e-16)
        tprev = rebuilt
    return istft(mag * angles, n_fft, hop, length=length)


def mel_to_waveform(mel_norm: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    cfg: MelConfig = MelConfig(), gl_iters: int = 32,
                    uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole inverse: normalised mel (..., n_mels, T) -> waveform
    (..., (T - 1) hop) (reference ``inv_transforms``:
    extract_mel_spectrogram.py:154-163).  ``generator`` / ``uniform`` give
    Griffin-Lim's initial phases, as in ``griffin_lim``."""
    mag = mel_to_stft(mel_inverse_chain(mel_norm, cfg), cfg)
    return griffin_lim(mag, generator, n_iter=gl_iters, n_fft=cfg.n_fft,
                       hop=cfg.hop_length, uniform=uniform)
