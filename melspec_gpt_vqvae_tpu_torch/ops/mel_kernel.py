"""Fused mel frontend: kernel D (csrc/mel.cu) and its wrapper.

Counterpart of melspec_gpt_vqvae_tpu/ops/mel_pallas.py.  The TPU kernel
takes the windowed DFT as a dense product with precomputed bases; on the
card that is 80x the arithmetic the function needs, so kernel D does a real
FFT in shared memory instead: two windowed frames are the real and the
imaginary part of one complex FFT (Stockham radix-4 passes, a last radix-2
pass when log2 n_fft is odd), their spectra are separated afterwards, and
the Slaney filterbank is applied as one band of non-zero weights a mel row.
Framing, window, FFT, magnitude, mel projection and the log chain are one
kernel with one write of the (B, 80, 860) output.

  * ``waveform_to_mel_fused`` -- kernel D on CUDA tensors, the plain
    ``ops/mel.py::waveform_to_mel`` (rFFT) on CPU tensors; the two agree to
    about 1e-3 at worst, the bound the JAX package holds its Pallas kernel
    to (tests/test_mel.py::test_pallas_mel_matches_xla_path);
  * ``fft_tables`` / ``mel_bands`` -- the window, twiddle and filterbank
    band tables the wrapper hands the kernel, computed in float64 by numpy;
  * ``stockham_fft_ref`` / ``fft_pair_ref`` / ``mel_ref_fft`` -- the
    kernel's passes, pair packing, separation and banded filterbank in
    plain PyTorch from those same tables: for the CPU tests only, nothing
    on the card's path calls them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..configs import MelConfig

from .. import _build
from .mel import (_hann, _reflect_pad, mel_filterbank, mel_forward_chain,
                  pad_or_trim, waveform_to_mel)

# csrc/mel.cu: frames a CTA (kFrames) and complex FFT buffers a CTA
# (kGroups groups, two each)
_FRAMES, _BUFFERS = 8, 4
_SMEM_LIMIT = 227 * 1024


def _radix4_passes(n_fft: int) -> Tuple[int, bool]:
    """(radix-4 passes, whether a radix-2 pass follows) of an n_fft-point
    FFT, n_fft a power of two."""
    log2 = n_fft.bit_length() - 1
    return log2 // 2, bool(log2 % 2)


@functools.lru_cache(maxsize=4)
def fft_tables(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """(window (n_fft,) float32, twiddles (n_fft - 1,) complex64) of the
    kernel's FFT.  The radix-4 pass with stride ``ns`` (1, 4, 16, ...)
    reads ``exp(-2 pi i r k / (4 ns))``, r = 1..3, k < ns, at
    ``(ns - 1) + (r - 1) ns + k``; a last radix-2 pass (ns = n_fft / 2)
    reads ``exp(-2 pi i j / n_fft)`` at ``(ns - 1) + j``."""
    if n_fft < 64 or n_fft & (n_fft - 1):
        raise ValueError(f"mel kernel: n_fft must be a power of two >= 64, "
                         f"got {n_fft}")
    p4, last2 = _radix4_passes(n_fft)
    parts = []
    for p in range(p4):
        ns = 4 ** p
        r = np.arange(1, 4, dtype=np.float64)[:, None]
        k = np.arange(ns, dtype=np.float64)[None, :]
        parts.append(np.exp(-2j * np.pi * r * k / (4 * ns)).reshape(-1))
    if last2:
        parts.append(np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft))
    tw = np.concatenate(parts).astype(np.complex64)
    assert tw.shape == (n_fft - 1,)
    return _hann(n_fft), tw


@functools.lru_cache(maxsize=4)
def mel_bands(cfg: MelConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The Slaney filterbank as one band a mel row: (start (n_mels,) int32,
    offsets (n_mels + 1,) int32, weights (nnz,) float32); row m is
    ``weights[offsets[m]:offsets[m + 1]]`` from bin ``start[m]``, its first
    to its last non-zero (a row with none is an empty band)."""
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                        cfg.fmax)
    start = np.zeros(cfg.n_mels, np.int32)
    off = np.zeros(cfg.n_mels + 1, np.int32)
    weights = []
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if len(nz):
            start[m] = nz[0]
            weights.append(row[nz[0]:nz[-1] + 1])
        off[m + 1] = off[m] + (nz[-1] + 1 - nz[0] if len(nz) else 0)
    packed = (np.concatenate(weights) if weights
              else np.zeros(0)).astype(np.float32)
    return start, off, packed


def _smem_bytes(cfg: MelConfig, nnz: int) -> int:
    """Dynamic shared memory of one CTA, as csrc/mel.cu::msgv_mel sizes it."""
    return 8 * (_BUFFERS + 1) * cfg.n_fft \
        + 4 * ((_FRAMES - 1) * cfg.hop_length + cfg.n_fft + nnz) \
        + 4 * (2 * cfg.n_mels + 1)


@functools.lru_cache(maxsize=4)
def _device_tables(cfg: MelConfig, device: torch.device):
    window, tw = fft_tables(cfg.n_fft)
    tables = (window, tw.view(np.float32), *mel_bands(cfg))
    return tuple(torch.as_tensor(a, device=device) for a in tables)


# ---------------------------------------------------------------------------
# the kernel's arithmetic in plain PyTorch (CPU tests only)
# ---------------------------------------------------------------------------


def stockham_fft_ref(z: torch.Tensor) -> torch.Tensor:
    """Forward FFT over the last axis of a complex64 tensor as the kernel's
    threads do it: Stockham autosort passes of radix 4 (thread j of n / 4
    takes inputs j + r n / 4, multiplies them by the pass's twiddles and
    writes its 4-point DFT to (j - k) 4 + k + r ns, k = j mod ns), then a
    radix-2 pass when log2 n is odd; twiddles from ``fft_tables``."""
    n = z.shape[-1]
    tw = torch.from_numpy(fft_tables(n)[1]).to(z.device)
    p4, last2 = _radix4_passes(n)
    x = z.to(torch.complex64)
    minus_i = torch.tensor(-1j, dtype=torch.complex64, device=z.device)
    j = torch.arange(n // 4, device=z.device)
    for p in range(p4):
        ns = 4 ** p
        k = j % ns
        v = [x[..., j + r * (n // 4)] for r in range(4)]
        for r in (1, 2, 3):
            v[r] = v[r] * tw[(ns - 1) + (r - 1) * ns + k]
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], (v[1] - v[3]) * minus_i
        y = torch.empty_like(x)
        j0 = (j - k) * 4 + k
        for r, val in enumerate((t0 + t2, t1 + t3, t0 - t2, t1 - t3)):
            y[..., j0 + r * ns] = val
        x = y
    if last2:
        h = n // 2
        v1 = x[..., h:] * tw[h - 1:]
        x = torch.cat([x[..., :h] + v1, x[..., :h] - v1], dim=-1)
    return x


def fft_pair_ref(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|rFFT(a)|, |rFFT(b)|) over the last axis of two real (..., n)
    tensors through ONE complex FFT, as the kernel pairs frames:
    Z = FFT(a + i b), X_a[k] = (Z[k] + conj Z[n - k]) / 2,
    X_b[k] = (Z[k] - conj Z[n - k]) / 2i, k = 0..n / 2."""
    n = a.shape[-1]
    z = stockham_fft_ref(torch.complex(a.float(), b.float()))
    k = torch.arange(n // 2 + 1, device=a.device)
    zk, zn = z[..., k], z[..., (n - k) % n]
    ar, ai = zk.real + zn.real, zk.imag - zn.imag
    br, bi = zk.real - zn.real, zk.imag + zn.imag
    return (0.5 * torch.sqrt(ar * ar + ai * ai),
            0.5 * torch.sqrt(br * br + bi * bi))


def banded_filterbank_ref(mag: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """mag (..., bins) -> (..., n_mels): each mel row summed over its band
    of ``mel_bands`` (the dense ``mel_filterbank @ mag`` without the
    zeros)."""
    start, off, weights = mel_bands(cfg)
    w = torch.from_numpy(weights).to(mag.device)
    rows = []
    for m in range(cfg.n_mels):
        n = int(off[m + 1] - off[m])
        band = mag[..., int(start[m]):int(start[m]) + n]
        rows.append((band * w[int(off[m]):int(off[m + 1])]).sum(-1))
    return torch.stack(rows, dim=-1)


def mel_ref_fft(wav: torch.Tensor,
                cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """``waveform_to_mel`` as kernel D computes it: reflect-padded frames,
    frames 2p and 2p + 1 through one complex FFT (an odd last frame is
    paired with zeros), banded filterbank, log chain.  wav (B, samples) ->
    (B, n_mels, trim_len)."""
    wav = pad_or_trim(wav.float(), cfg.clip_samples)
    frames = _reflect_pad(wav, cfg.n_fft // 2).unfold(
        -1, cfg.n_fft, cfg.hop_length)[:, :cfg.trim_len]
    frames = frames * torch.from_numpy(fft_tables(cfg.n_fft)[0]).to(wav.device)
    n_frames = frames.shape[1]
    if n_frames % 2:
        frames = torch.cat([frames, torch.zeros_like(frames[:, :1])], dim=1)
    ma, mb = fft_pair_ref(frames[:, 0::2], frames[:, 1::2])
    mag = torch.stack([ma, mb], dim=2).flatten(1, 2)[:, :n_frames]
    if cfg.spec_power != 1.0:
        mag = mag ** cfg.spec_power
    mel = banded_filterbank_ref(mag, cfg).transpose(-1, -2)
    return mel_forward_chain(mel, cfg)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def waveform_to_mel_fused(wav: torch.Tensor, cfg: MelConfig = MelConfig()
                          ) -> torch.Tensor:
    """wav (B, samples) -> normalised mel (B, n_mels, trim_len), float32:
    kernel D on CUDA tensors, ``waveform_to_mel`` on CPU tensors or with
    the kernels off."""
    if not _build.use_kernel(wav):
        return waveform_to_mel(wav, cfg)
    if wav.ndim != 2:
        raise ValueError(f"expected (B, samples), got {tuple(wav.shape)}")
    if cfg.n_fft < 64 or cfg.n_fft & (cfg.n_fft - 1) \
            or cfg.n_fft // 2 >= cfg.clip_samples \
            or cfg.trim_len > 1 + cfg.clip_samples // cfg.hop_length:
        raise ValueError(f"mel kernel does not take {cfg}: n_fft must be a "
                         "power of two >= 64 with n_fft / 2 below the clip "
                         "length")
    wav = pad_or_trim(wav.float(), cfg.clip_samples).contiguous()
    b = wav.shape[0]
    window, tw, start, off, weights = _device_tables(cfg, wav.device)
    smem = _smem_bytes(cfg, weights.numel())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"mel kernel: n_fft={cfg.n_fft}, hop="
                         f"{cfg.hop_length} needs {smem} bytes of shared "
                         "memory (at most 227 KB)")
    out = torch.empty(b, cfg.n_mels, cfg.trim_len, device=wav.device)
    _build.launch("msgv_mel", wav.device, wav.data_ptr(), window.data_ptr(),
                  tw.data_ptr(), start.data_ptr(), off.data_ptr(),
                  weights.data_ptr(), out.data_ptr(), b, cfg.clip_samples,
                  cfg.n_fft, cfg.hop_length, cfg.trim_len, cfg.n_mels,
                  weights.numel(), cfg.spec_power, cfg.lower_thresh,
                  cfg.multiply, cfg.subtract, cfg.add, cfg.divide,
                  cfg.clip_min, cfg.clip_max)
    waveform_to_mel_fused.launches += 1
    return out


waveform_to_mel_fused.launches = 0
