"""PyTorch port, the offline tokenizer against the JAX package on the CPU.

The mel inverse chain (ops/mel.py: ``stft_complex``, ``istft``,
``mel_inverse_chain``, ``mel_to_stft``, ``griffin_lim`` with JAX's
uniform draw handed in, ``mel_to_waveform``), the two CLIs of
``melspec_gpt_vqvae_tpu_torch.feature_extraction`` against the
repository's feature_extraction/ CLIs on the same files (wavs of every
sample type, a VAS mel tree with a damaged file and one already done, the
same reference-format VQ-VAE file; the config each CLI builds narrowed to
tests/test_torch_port_convert.py's tiny one), the TF32 scope of the
parity-grade path, and ``parity_check`` on the CPU.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import melspec_gpt_vqvae_tpu.configs as jconfigs
from melspec_gpt_vqvae_tpu.configs import MelConfig as JMelConfig
from melspec_gpt_vqvae_tpu.models import quantized as JQ
from melspec_gpt_vqvae_tpu.ops import mel as JM
from melspec_gpt_vqvae_tpu.utils import convert as JC
from melspec_gpt_vqvae_tpu_torch import parity_check
from melspec_gpt_vqvae_tpu_torch.configs import MelConfig, VQVAEConfig
from melspec_gpt_vqvae_tpu_torch.feature_extraction import (
    extract_codes, extract_mel_spectrogram, tf32_flags)
from melspec_gpt_vqvae_tpu_torch.models import quantized as TQ
from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel
from melspec_gpt_vqvae_tpu_torch.ops import mel as TM
from melspec_gpt_vqvae_tpu_torch.utils import convert as TC

from chip_smoke import unexplained_flips
from test_torch_port_convert import VQ_CFG, _save, vqvae_state_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# a one-second clip: 87 frames
SHORT = dict(clip_samples=22050, trim_len=87)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_cli(monkeypatch):
    """Run a JAX CLI's ``main()`` with ``argv``; the JAX config it sets
    process-wide (matmul precision, the compile cache's threshold) is put
    back afterwards."""
    keys = ("jax_default_matmul_precision",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}

    def run(mod, argv):
        monkeypatch.setattr("sys.argv", [mod.__file__, *argv])
        mod.main()
    yield run
    for k, v in saved.items():
        jax.config.update(k, v)


def _tone(n, f=440.0, sr=22050):
    return (0.5 * np.sin(2 * np.pi * f * np.arange(n) / sr)).astype(
        np.float32)


# ---------------------------- the inverse chain ------------------------------

def test_stft_and_istft_match_jax():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 8192)).astype(np.float32)
    spec = TM.stft_complex(torch.from_numpy(y))
    ref = np.asarray(JM.stft_complex(jnp.asarray(y)))
    assert spec.shape == ref.shape == (2, 513, 33)
    np.testing.assert_allclose(spec.numpy(), ref, atol=1e-4)
    back = TM.istft(spec, length=8192).numpy()
    jback = np.asarray(JM.istft(jnp.asarray(ref), length=8192))
    np.testing.assert_allclose(back, jback, atol=1e-4)
    # the round trip, as tests/test_mel.py:102-107 holds JAX's
    np.testing.assert_allclose(back, y, atol=1e-4)
    untrimmed = TM.istft(spec).numpy()
    assert untrimmed.shape == (2, 32 * 256)


def test_mel_inverse_chain_matches_jax():
    cfg = MelConfig()
    x = np.random.default_rng(2).uniform(1e-4, 10.0, (80, 100)).astype(
        np.float32)
    y = TM.mel_forward_chain(torch.from_numpy(x), cfg)
    np.testing.assert_allclose(
        TM.mel_inverse_chain(y, cfg).numpy(),
        np.asarray(JM.mel_inverse_chain(jnp.asarray(y.numpy()),
                                        JMelConfig())), rtol=1e-5)
    # the forward / inverse round trip, tests/test_mel.py:92-99's bound
    np.testing.assert_allclose(TM.mel_inverse_chain(y, cfg).numpy(), x,
                               rtol=1e-3)


@pytest.fixture(scope="module")
def tone_mel():
    """A 1 s 440 Hz tone's mel (80, 87) in the short configuration."""
    return TM.waveform_to_mel(torch.from_numpy(_tone(22050))[None],
                              MelConfig(**SHORT))[0]


def test_mel_to_stft_matches_jax(tone_mel):
    lin = TM.mel_inverse_chain(tone_mel)
    got = TM.mel_to_stft(lin, MelConfig(**SHORT)).numpy()
    ref = np.asarray(JM.mel_to_stft(jnp.asarray(lin.numpy()),
                                    JMelConfig(**SHORT)))
    assert got.shape == ref.shape == (513, 87) and got.min() >= 0.0
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_griffin_lim_with_jax_angles_matches_jax(tone_mel):
    mag = TM.mel_to_stft(TM.mel_inverse_chain(tone_mel), MelConfig(**SHORT))
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, mag.shape))
    got = TM.griffin_lim(mag, n_iter=2, uniform=torch.from_numpy(u),
                         length=20000).numpy()
    ref = np.asarray(JM.griffin_lim(jnp.asarray(mag.numpy()), key,
                                    n_iter=2, length=20000))
    assert got.shape == ref.shape == (20000,)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # the generator form draws its own phases on the tensor's device
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    np.testing.assert_array_equal(TM.griffin_lim(mag, g1, n_iter=1).numpy(),
                                  TM.griffin_lim(mag, g2, n_iter=1).numpy())


def test_mel_to_waveform_32_iterations_round_trip(tone_mel):
    """32 Griffin-Lim iterations on both sides (JAX's draw handed to the
    port): the mel of each waveform within tests/test_mel.py:111-123's
    criterion, mean |mel - mel2| < 0.05 over the active frames."""
    jcfg, cfg = JMelConfig(**SHORT), MelConfig(**SHORT)
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (513, 87))
    got = TM.mel_to_waveform(tone_mel, cfg=cfg, gl_iters=32,
                             uniform=torch.from_numpy(np.asarray(u)))
    ref = np.asarray(JM.mel_to_waveform(jnp.asarray(tone_mel.numpy()), key,
                                        jcfg, gl_iters=32))
    assert got.shape == ref.shape == (86 * 256,)
    for wav in (got.numpy(), ref):
        mel2 = TM.waveform_to_mel(torch.from_numpy(wav)[None], cfg)[0]
        # the clip is one second of tone: its frames but the padded edge
        err = (mel2 - tone_mel)[:, 2:-2].abs().mean().item()
        assert err < 0.05, err


# ---------------------------- extract_mel_spectrogram ------------------------

def _write_wavs(folder):
    """A wav of each sample type the reader scales, a stereo one and one
    shorter than the clip."""
    folder.mkdir(parents=True)
    t = _tone(24000, 330.0)
    rng = np.random.default_rng(0)
    wavfile.write(folder / "a_int16.wav", 22050, (t * 32767).astype(np.int16))
    wavfile.write(folder / "b_float32.wav", 22050,
                  (t + 0.05 * rng.standard_normal(24000)).astype(np.float32))
    wavfile.write(folder / "c_stereo.wav", 22050,
                  np.stack([t, 0.3 * t], axis=1))
    wavfile.write(folder / "d_short.wav", 22050, t[:9000])
    wavfile.write(folder / "e_int32.wav", 22050,
                  (t * 2 ** 30).astype(np.int32))
    wavfile.write(folder / "f_uint8.wav", 22050,
                  (t * 100 + 128).astype(np.uint8))


def test_extract_mel_spectrogram_matches_jax_cli(tmp_path, jax_cli):
    wavs = tmp_path / "audio"
    _write_wavs(wavs)
    jmod = _load("feature_extraction/extract_mel_spectrogram.py", "jax_ems")
    out_j = tmp_path / "j" / "melspec_10s_22050hz"
    out_t = tmp_path / "t" / "melspec_10s_22050hz"
    jax_cli(jmod, ["-i", str(wavs), "-o", str(out_j), "-l", "22050",
                   "-b", "4"])
    n = extract_mel_spectrogram.main(["-i", str(wavs), "-o", str(out_t),
                                      "-l", "22050", "-b", "4",
                                      "--device", "cpu"])
    names = sorted(p.name for p in out_j.iterdir())
    assert n == 6 and names == sorted(p.name for p in out_t.iterdir())
    assert len(names) == 6
    for name in names:
        ref, got = np.load(out_j / name), np.load(out_t / name)
        assert got.shape == ref.shape == (80, 87) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-4)
    # the single-file API, and the reader itself
    y, mel = extract_mel_spectrogram.get_spectrogram(
        str(wavs / "d_short.wav"), None, 22050, save_results=False,
        device="cpu")
    jy, jmel = jmod.get_spectrogram(str(wavs / "d_short.wav"), None, 22050,
                                    save_results=False)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(mel, jmel, atol=1e-4)
    for p in wavs.iterdir():
        np.testing.assert_array_equal(extract_mel_spectrogram.read_wav(p),
                                      jmod.read_wav(p))


def test_read_wav_scales_stereo_pcm_before_the_mean(tmp_path):
    """Stereo int16: the port scales, then averages (librosa.load's
    result); the JAX CLI's reader averages first and leaves the float64
    mean unscaled.  Mono and float files read the same in both."""
    pcm = (np.stack([_tone(1000), 0.3 * _tone(1000)], axis=1)
           * 32767).astype(np.int16)
    wavfile.write(tmp_path / "s.wav", 22050, pcm)
    got = extract_mel_spectrogram.read_wav(tmp_path / "s.wav")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, (pcm / 32768.0).mean(axis=1), atol=1e-7)
    jmod = _load("feature_extraction/extract_mel_spectrogram.py", "jax_rw")
    np.testing.assert_allclose(jmod.read_wav(tmp_path / "s.wav"),
                               pcm.mean(axis=1), rtol=1e-6)


def test_extract_mel_spectrogram_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="melspec_5s"):
        extract_mel_spectrogram.main(["-i", str(tmp_path), "-o",
                                      str(tmp_path / "melspec_5s"),
                                      "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_mel_spectrogram.main(
                ["-i", str(tmp_path), "-o",
                 str(tmp_path / "melspec_10s_22050hz")])


def test_inv_transforms_matches_jax_shape(tone_mel):
    mel = tone_mel.numpy()
    got = extract_mel_spectrogram.inv_transforms(mel, gl_iters=2,
                                                 device="cpu")
    ref = _load("feature_extraction/extract_mel_spectrogram.py",
                "jax_ems_inv").inv_transforms(mel, gl_iters=2)
    assert got.shape == ref.shape == (86 * 256,)
    assert np.isfinite(got).all()


# ---------------------------- extract_codes ----------------------------------

TINY = {k: v for k, v in VQ_CFG.items()
        if k not in ("num_embeddings", "embedding_dim", "resolution")}
CODES_ARGV = ["-emb_dim", "4", "-n_e", "8", "-crop", "16", "-b", "2"]


def _mel_tree(root):
    """VAS layout: class a with four mels and a damaged file, class b with
    three mels, one of them already tokenized (a sentinel grid)."""
    rng = np.random.default_rng(11)
    for cls, n in (("a", 4), ("b", 3)):
        d = root / cls / "melspec_10s_22050hz"
        d.mkdir(parents=True)
        for i in range(n):
            np.save(d / f"v{i}_mel.npy",
                    rng.uniform(0, 1, (80, 40)).astype(np.float32))
    (root / "a" / "melspec_10s_22050hz" / "v9_mel.npy").write_bytes(
        b"not a numpy file")
    (root / "b" / "codes_10s").mkdir()
    np.save(root / "b" / "codes_10s" / "v1_mel_code.npy",
            np.full((40, 8), 7, np.int32))


def _codes(root):
    return {str(p.relative_to(root)): np.load(p)
            for p in sorted(root.glob("*/codes_10s/*.npy"))}


@pytest.fixture(scope="module")
def vq_file(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("vq"), "vqvae.ckpt",
                 vqvae_state_dict())


@pytest.fixture
def narrow(monkeypatch):
    """The config each CLI builds, narrowed to the tiny VQ-VAE."""
    monkeypatch.setattr(jconfigs, "VQVAEConfig",
                        functools.partial(jconfigs.VQVAEConfig, **TINY))
    monkeypatch.setattr(extract_codes, "VQVAEConfig",
                        functools.partial(VQVAEConfig, **TINY))


def test_extract_codes_matches_jax_cli(tmp_path, vq_file, narrow, jax_cli,
                                       capsys):
    jmod = _load("feature_extraction/extract_codes.py", "jax_codes")
    for side in ("j", "t"):
        _mel_tree(tmp_path / side)
    jax_cli(jmod, ["-i", str(tmp_path / "j"), "-m", vq_file, *CODES_ARGV])
    n = extract_codes.main(["-i", str(tmp_path / "t"), "-m", vq_file,
                            *CODES_ARGV, "--device", "cpu"])
    ref, got = _codes(tmp_path / "j"), _codes(tmp_path / "t")
    # 7 mels, one of them done before: 6 written; the damaged file skipped
    assert n == 6 and sorted(got) == sorted(ref) and len(got) == 7
    assert "a/codes_10s/v9_mel_code.npy" not in got
    for name in ref:
        assert got[name].shape == (40, 8) and got[name].dtype == np.int32
        np.testing.assert_array_equal(got[name], ref[name])
    np.testing.assert_array_equal(got["b/codes_10s/v1_mel_code.npy"], 7)
    assert len(np.unique(np.concatenate([g.ravel() for g in got.values()]))
               ) > 2
    out = capsys.readouterr().out
    assert out.count("is damaged") == 2 and "file exists" in out
    # idempotent: a second run writes nothing
    assert extract_codes.main(["-i", str(tmp_path / "t"), "-m", vq_file,
                               *CODES_ARGV, "--device", "cpu"]) == 0


def _int8_latents_jax(path, mels):
    """JAX's int8 encoder latents (rows in grid order) and codebook,
    calibrated on the first batch of 2 as its CLI does."""
    cfg = jconfigs.VQVAEConfig(num_embeddings=8, embedding_dim=4,
                               resolution=16)
    p = jax.tree_util.tree_map(jnp.asarray, JC.load_vqvae_params(path, cfg))
    x = jnp.asarray(2.0 * mels - 1.0)[..., None]
    qs = JQ.build_encode_qstate(p, cfg, x[:2], batch=2)

    @jax.jit
    def latents(p, qs, x):
        z = JQ.encoder_apply(p["encoder"], cfg, x, JQ.Int8Convs(qs))
        return JQ.conv_float(z, p["quant_conv"]["kernel"],
                             p["quant_conv"]["bias"])
    return np.asarray(latents(p, qs, x)).reshape(-1, 4)


def _int8_latents_port(path, mels):
    cfg = VQVAEConfig(num_embeddings=8, embedding_dim=4, resolution=16,
                      **TINY)
    vq = TC.load_vqvae_params(path, cfg)
    x = torch.from_numpy(2.0 * mels - 1.0)[..., None]
    with torch.no_grad():
        qs = TQ.build_encode_qstate(vq, cfg, x[:2], batch=2)
        z = TQ.encoder_apply(vq.encoder, cfg, x.permute(0, 3, 1, 2),
                             TQ.Int8Convs(qs))
        z = TQ.conv_float(z, vq.quant_conv.weight, vq.quant_conv.bias)
    return z.permute(0, 2, 3, 1).reshape(-1, 4), vq.quantize.embedding


def test_extract_codes_int8_matches_jax_cli(tmp_path, vq_file, narrow,
                                            jax_cli):
    """--int8 on one class folder (the calibration batch is its first two
    mels on both sides): codes equal, or a differing code a near-tie of
    the two latents by chip_smoke's rule."""
    jmod = _load("feature_extraction/extract_codes.py", "jax_codes_int8")
    for side in ("j", "t"):
        _mel_tree(tmp_path / side)
    jax_cli(jmod, ["-i", str(tmp_path / "j"), "-m", vq_file, *CODES_ARGV,
                   "--int8"])
    extract_codes.main(["-i", str(tmp_path / "t"), "-m", vq_file,
                        *CODES_ARGV, "--int8", "--device", "cpu"])
    ref, got = _codes(tmp_path / "j"), _codes(tmp_path / "t")
    assert sorted(got) == sorted(ref)
    names = [f"v{i}" for i in range(4)]       # class a, in file order
    d = tmp_path / "t" / "a" / "melspec_10s_22050hz"
    mels = np.stack([np.load(d / f"{n}_mel.npy")[:, 12:28] for n in names])
    zj = torch.from_numpy(_int8_latents_jax(vq_file, mels)).double()
    zt, codebook = _int8_latents_port(vq_file, mels)
    cj = torch.from_numpy(np.stack([ref[f"a/codes_10s/{n}_mel_code.npy"]
                                    for n in names]))
    ct = torch.from_numpy(np.stack([got[f"a/codes_10s/{n}_mel_code.npy"]
                                    for n in names]))
    assert cj.shape == (4, 40, 8)
    assert unexplained_flips(cj, ct, zj, zt.double(), codebook) == 0


def test_extract_codes_refuses_an_orbax_dir(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="torch_convert_orbax"):
        extract_codes.main(["-m", str(tmp_path / "orbax"), "--device",
                            "cpu"])


def test_tf32_scope_restores_the_callers_flags(tmp_path, vq_file, narrow,
                                               monkeypatch):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    seen, encode = [], VQModel.encode_to_indices

    def recording(self, x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return encode(self, x)
    monkeypatch.setattr(VQModel, "encode_to_indices", recording)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        _mel_tree(tmp_path)
        extract_codes.main(["-i", str(tmp_path), "-m", vq_file, *CODES_ARGV,
                            "--device", "cpu"])
        assert seen and set(seen) == {(False, False)}
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(KeyError):
            with tf32_flags(cudnn=True):
                assert torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
                raise KeyError("restored on the way out")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# ---------------------------- parity_check -----------------------------------

def test_parity_check_on_the_cpu_writes_jax_keys(tmp_path, monkeypatch):
    """One battery clip at the VAS width: the CPU worker's ``idx`` and the
    record's keys are the JAX script's (PARITY_CODES.json); on the CPU the
    one variant matches its reference exactly."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    worker = tmp_path / "w.npz"
    parity_check.main(["--worker", str(worker), "--clips", "1"])
    idx = np.load(worker)
    assert list(idx.keys()) == ["idx"]
    assert idx["idx"].shape == (1, 5, 53) and idx["idx"].dtype == np.int32
    out = tmp_path / "p.json"
    rec = parity_check.main(["--device", "cpu", "--clips", "1", "--out",
                             str(out)])
    assert json.loads(out.read_text()) == rec
    jrec = json.loads((ROOT / "PARITY_CODES.json").read_text())
    assert set(jrec) <= set(rec)
    jvar = next(iter(jrec["variants"].values()))
    assert list(rec["variants"]) == ["f32_plain_mel"]
    var = rec["variants"]["f32_plain_mel"]
    assert set(jvar) <= set(var)
    assert var["match_rate"] == 1.0 and var["mismatched_codes"] == 0
    assert rec["battery_clips"] == 1 and rec["codes_per_clip"] == 265
    assert rec["platform"] == "cpu"
    assert list(parity_check.VARIANTS) == [
        "f32_plain_mel", "f32_kernel_mel", "tf32_kernel_mel",
        "bf16_kernel_mel"]
