"""Kernel D's design on the CPU: the shared-memory FFT, the pairing of
frames and the banded filterbank.

The Hopper kernel (csrc/mel.cu) runs only on the card, where chip_smoke.py
holds it to ``waveform_to_mel``.  Here the same passes in plain PyTorch
(``stockham_fft_ref``, ``fft_pair_ref``, ``banded_filterbank_ref``,
``mel_ref_fft``), from the same numpy tables the wrapper hands the kernel,
are held to ``torch.fft``, to the plain version and to the JAX package's
``waveform_to_mel`` and ``waveform_to_mel_pallas`` (interpret mode on the
CPU) on numpy-seeded inputs.  The mel bound is the JAX package's for its
own fused kernel, 2e-3 (tests/test_mel.py::test_pallas_mel_matches_xla_path).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import MelConfig as JMelConfig
from melspec_gpt_vqvae_tpu.ops import mel as JM
from melspec_gpt_vqvae_tpu.ops.mel_pallas import waveform_to_mel_pallas
from melspec_gpt_vqvae_tpu_torch.configs import MelConfig
from melspec_gpt_vqvae_tpu_torch.ops import mel as TM
from melspec_gpt_vqvae_tpu_torch.ops import mel_kernel as MK
from melspec_gpt_vqvae_tpu_torch.utils.battery import make_battery

torch.set_num_threads(1)

TOL_MEL = 2e-3
SHORT = dict(clip_samples=22050, trim_len=80)


# --------------------------- (a) the FFT ------------------------------------

@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048])
def test_stockham_fft_matches_torch_fft(n_fft):
    """Radix-4 passes (and the last radix-2 pass of 128, 512, 2048) against
    torch.fft.fft within 1e-4 of the spectrum's largest magnitude."""
    rng = np.random.default_rng(n_fft)
    z = torch.from_numpy((rng.standard_normal((3, n_fft))
                          + 1j * rng.standard_normal((3, n_fft)))
                         .astype(np.complex64))
    ref = torch.fft.fft(z.to(torch.complex128))
    out = MK.stockham_fft_ref(z)
    assert out.dtype == torch.complex64
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("n_fft", [64, 256, 1024])
def test_fft_pair_matches_rfft(n_fft):
    """Two real frames through one complex FFT, separated, against
    torch.fft.rfft of each within 1e-4 of the spectrum's max."""
    rng = np.random.default_rng(1 + n_fft)
    a, b = (torch.from_numpy(rng.standard_normal((4, n_fft))
                             .astype(np.float32)) for _ in range(2))
    ma, mb = MK.fft_pair_ref(a, b)
    for ours, x in ((ma, a), (mb, b)):
        ref = torch.fft.rfft(x.double()).abs()
        assert ours.shape == (4, n_fft // 2 + 1)
        assert (ours - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_fft_pair_with_zeros_is_the_single_frame():
    """An odd last frame is paired with zeros: its partner's spectrum is
    zero to rounding and its own is unchanged."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32))
    ma, mb = MK.fft_pair_ref(a, torch.zeros_like(a))
    ref = torch.fft.rfft(a.double()).abs()
    assert (ma - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert mb.abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("n_fft", [64, 128, 1024])
def test_twiddle_table_layout(n_fft):
    """fft_tables: n_fft - 1 entries, pass ns at (ns - 1) + (r - 1) ns + k,
    the radix-2 pass last; float32 roundings of the float64 roots."""
    window, tw = MK.fft_tables(n_fft)
    assert window.dtype == np.float32 and window.shape == (n_fft,)
    np.testing.assert_array_equal(window, TM._hann(n_fft))
    assert tw.dtype == np.complex64 and tw.shape == (n_fft - 1,)
    ns = 1
    while ns * 4 <= n_fft:
        for r in (1, 2, 3):
            k = np.arange(ns)
            want = np.exp(-2j * np.pi * r * k / (4 * ns)).astype(np.complex64)
            np.testing.assert_array_equal(
                tw[(ns - 1) + (r - 1) * ns + k], want)
        ns *= 4
    if ns < n_fft:
        want = np.exp(-2j * np.pi * np.arange(ns) / n_fft)
        np.testing.assert_array_equal(tw[ns - 1:], want.astype(np.complex64))


@pytest.mark.parametrize("bad", [0, 32, 96, 1000])
def test_fft_tables_refuse_other_sizes(bad):
    with pytest.raises(ValueError, match="power of two"):
        MK.fft_tables(bad)


# --------------------------- (b) the filterbank ------------------------------

@pytest.mark.parametrize("cfg", [MelConfig(), MelConfig(n_fft=256, n_mels=40),
                                 MelConfig(n_fft=64, n_mels=80)],
                         ids=["preset", "n_fft256", "n_fft64"])
def test_band_table_equals_dense_filterbank(cfg):
    """Every non-zero of a filterbank row lies in its band, and the banded
    sum equals the dense product within 1e-6."""
    fb = TM.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                           cfg.fmax)
    start, off, weights = MK.mel_bands(cfg)
    assert start.dtype == off.dtype == np.int32
    assert weights.dtype == np.float32 and off[-1] == len(weights)
    dense = np.zeros_like(fb)
    for m in range(cfg.n_mels):
        n = off[m + 1] - off[m]
        dense[m, start[m]:start[m] + n] = weights[off[m]:off[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    rng = np.random.default_rng(3)
    mag = torch.from_numpy(rng.uniform(0, 1, (5, fb.shape[1]))
                           .astype(np.float32))
    ref = mag.double() @ torch.from_numpy(fb).double().T
    out = MK.banded_filterbank_ref(mag, cfg)
    assert (out - ref).abs().max() <= 1e-6


def test_preset_fits_four_ctas_an_sm():
    """The VAS preset's CTA (8 frames, 4 FFT buffers, tables) leaves room
    for four CTAs in an SM's 228 KB (1 KB reserved a CTA)."""
    cfg = MelConfig()
    smem = MK._smem_bytes(cfg, len(MK.mel_bands(cfg)[2]))
    assert 4 * (smem + 1024) <= 228 * 1024
    big = dataclasses.replace(cfg, n_fft=8192)
    assert MK._smem_bytes(big, 0) > MK._SMEM_LIMIT


# --------------------------- (c) the whole chain -----------------------------

def _signals(n):
    """(name, waveform (n,)) of the edge cases: an impulse, a full-scale
    sine at the centre of bin 64, silence, and a loud burst that ends
    inside a frame pair."""
    t = np.arange(n)
    impulse = np.zeros(n, np.float32)
    impulse[5000] = 1.0
    burst = np.zeros(n, np.float32)
    burst[:6400] = np.sin(2 * np.pi * 64 * t[:6400] / 1024)
    return {"impulse": impulse,
            "sine": np.sin(2 * np.pi * 64 * t / 1024).astype(np.float32),
            "silence": np.zeros(n, np.float32),
            "burst": burst}


@pytest.mark.parametrize("name", ["impulse", "sine", "silence", "burst"])
def test_mel_ref_fft_edge_signals(name):
    cfg = MelConfig(**SHORT)
    wav = torch.from_numpy(_signals(cfg.clip_samples)[name])[None]
    ref = TM.waveform_to_mel(wav, cfg)
    out = MK.mel_ref_fft(wav, cfg)
    assert out.shape == ref.shape == (1, 80, 80)
    assert (out - ref).abs().max() <= TOL_MEL
    jref = np.asarray(JM.waveform_to_mel(jnp.asarray(wav.numpy()),
                                         JMelConfig(**SHORT)))[:, :, :80]
    np.testing.assert_allclose(out.numpy(), jref, atol=TOL_MEL)


def test_mel_ref_fft_on_battery_clips_matches_plain_and_jax():
    """Full-length battery clips (every fourth of the 48): against the
    plain version and the JAX ``waveform_to_mel``."""
    cfg = MelConfig()
    wav = make_battery(cfg.clip_samples)[::4]
    out = MK.mel_ref_fft(torch.from_numpy(wav), cfg)
    ref = TM.waveform_to_mel(torch.from_numpy(wav), cfg)
    assert out.shape == (12, 80, 860)
    assert (out - ref).abs().max() <= TOL_MEL
    jref = np.asarray(JM.waveform_to_mel(jnp.asarray(wav), JMelConfig()))
    np.testing.assert_allclose(out.numpy(), jref, atol=TOL_MEL)


def test_mel_ref_fft_matches_jax_pallas_kernel():
    """Against the TPU kernel itself in interpret mode, as
    tests/test_mel.py runs it, at its bound."""
    wav = (np.random.default_rng(7).standard_normal((2, 22050)) * 0.1) \
        .astype(np.float32)
    ref = np.asarray(waveform_to_mel_pallas(jnp.asarray(wav),
                                            JMelConfig(**SHORT),
                                            block_frames=64))
    out = MK.mel_ref_fft(torch.from_numpy(wav), MelConfig(**SHORT))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL_MEL)


@pytest.mark.parametrize("trim_len", [79, 80])
def test_odd_frame_count_pairs_the_last_frame_with_zeros(trim_len):
    cfg = MelConfig(clip_samples=22050, trim_len=trim_len)
    wav = torch.from_numpy((np.random.default_rng(8).standard_normal(
        (1, 22050)) * 0.1).astype(np.float32))
    out = MK.mel_ref_fft(wav, cfg)
    assert out.shape == (1, 80, trim_len)
    assert (out - TM.waveform_to_mel(wav, cfg)).abs().max() <= TOL_MEL


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (512, 128)])
def test_other_fft_sizes_through_the_chain(n_fft, hop):
    cfg = MelConfig(n_fft=n_fft, hop_length=hop, n_mels=40,
                    clip_samples=8000, trim_len=61)
    wav = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (2, 8000)) * 0.1).astype(np.float32))
    out = MK.mel_ref_fft(wav, cfg)
    assert (out - TM.waveform_to_mel(wav, cfg)).abs().max() <= TOL_MEL


def test_spec_power_is_applied_to_the_magnitudes():
    cfg = MelConfig(spec_power=2.0, **SHORT)
    wav = torch.from_numpy((np.random.default_rng(10).standard_normal(
        (1, 22050)) * 0.1).astype(np.float32))
    assert (MK.mel_ref_fft(wav, cfg)
            - TM.waveform_to_mel(wav, cfg)).abs().max() <= TOL_MEL


# --------------------------- (d) the wrapper ---------------------------------

def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    cfg = MelConfig(**SHORT)
    wav = torch.from_numpy((np.random.default_rng(11).standard_normal(
        (1, 22050)) * 0.1).astype(np.float32))
    before = MK.waveform_to_mel_fused.launches
    assert torch.equal(MK.waveform_to_mel_fused(wav, cfg),
                       TM.waveform_to_mel(wav, cfg))
    assert MK.waveform_to_mel_fused.launches == before
