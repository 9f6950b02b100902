"""Fused mel frontend: kernel D (csrc/mel.cu) and its wrapper.

Counterpart of melspec_gpt_vqvae_tpu/ops/mel_pallas.py.  The DFT is a
product with precomputed Hann-folded cos / -sin bases (more operations than
an FFT, but framing, window, DFT, magnitude, mel projection and the log
chain fuse into one kernel with one write of the (B, 80, 860) output).  The
plain version is ops/mel.py::waveform_to_mel (rFFT); the two agree to about
1e-3, the same bound the JAX package holds its Pallas kernel to
(tests/test_mel.py::test_pallas_mel_matches_xla_path).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import MelConfig

from .. import _build
from .mel import _hann, mel_filterbank, pad_or_trim, waveform_to_mel

_FREQ_TILE = 64   # frequencies per slab in the kernel


@functools.lru_cache(maxsize=4)
def _dft_mel_bases(cfg: MelConfig):
    """(cos_w, sin_w) (n_fft, F_pad) with the Hann window folded in, and the
    filterbank transposed to (F_pad, n_mels); F = 1 + n_fft // 2 padded with
    zero columns / rows to a multiple of the kernel's frequency tile."""
    n_fft = cfg.n_fft
    freqs = 1 + n_fft // 2
    f_pad = -(-freqs // _FREQ_TILE) * _FREQ_TILE
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(freqs)[None, :] \
        / n_fft
    win = _hann(n_fft)[:, None].astype(np.float64)
    cos_w = np.zeros((n_fft, f_pad), np.float32)
    sin_w = np.zeros((n_fft, f_pad), np.float32)
    cos_w[:, :freqs] = np.cos(ang) * win
    sin_w[:, :freqs] = -np.sin(ang) * win
    mel_t = np.zeros((f_pad, cfg.n_mels), np.float32)
    mel_t[:freqs] = mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels,
                                   cfg.fmin, cfg.fmax).T
    return cos_w, sin_w, mel_t


@functools.lru_cache(maxsize=4)
def _device_bases(cfg: MelConfig, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _dft_mel_bases(cfg))


def waveform_to_mel_fused(wav: torch.Tensor,
                          cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """wav (B, samples) -> normalised mel (B, n_mels, trim_len), float32:
    kernel D on CUDA tensors, ``waveform_to_mel`` on CPU tensors."""
    if _build.on_cpu(wav):
        return waveform_to_mel(wav, cfg)
    if wav.ndim != 2:
        raise ValueError(f"expected (B, samples), got {tuple(wav.shape)}")
    if cfg.n_fft % 32 or cfg.n_mels > 128 \
            or cfg.n_fft // 2 >= cfg.clip_samples \
            or cfg.trim_len > 1 + cfg.clip_samples // cfg.hop_length:
        raise ValueError(f"mel kernel does not take {cfg}")
    wav = pad_or_trim(wav.float(), cfg.clip_samples).contiguous()
    b = wav.shape[0]
    cos_w, sin_w, mel_t = _device_bases(cfg, wav.device)
    out = torch.empty(b, cfg.n_mels, cfg.trim_len, device=wav.device)
    _build.launch("msgv_mel", wav.device, wav.data_ptr(), cos_w.data_ptr(),
                  sin_w.data_ptr(), mel_t.data_ptr(), out.data_ptr(), b,
                  cfg.clip_samples, cfg.n_fft, cfg.hop_length, cfg.trim_len,
                  cos_w.shape[1], cfg.n_mels, cfg.spec_power,
                  cfg.lower_thresh, cfg.multiply, cfg.subtract, cfg.add,
                  cfg.divide, cfg.clip_min, cfg.clip_max)
    waveform_to_mel_fused.launches += 1
    return out


waveform_to_mel_fused.launches = 0
