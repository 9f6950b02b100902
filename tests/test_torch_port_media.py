"""PyTorch port, media logging, against the JAX package on the CPU.

The same weights (through ``bridge``) and inputs (numpy, fixed seeds) go
through both packages at tests/test_callbacks.py's tiny geometry: a VQ-VAE
of two levels over a (4, 5) code grid, an 8-mel MelGAN, a 1- or 2-layer
GPT.  Bounds: the attention heatmap bit for bit; the attention maps
within 1e-5; the decoders within 1e-5 (tests/test_torch_port_convert.py's
bound for the same VQ-VAE and MelGAN forwards); raw audio within 1e-6
(tests/test_callbacks.py); greedy tokens exactly.  Sampled rows never
match JAX's PRNG, so they are held by shape and by the given half.  The
loggers write through ``events.jsonl`` (the card's machine has no
tensorboardX) and their tags are held to the JAX loggers' letter for
letter.
"""

import json
import os
import sys
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (DataConfig, ExperimentConfig,
                                           GPTConfig, TrainConfig, VAEConfig,
                                           VocoderConfig, VQVAEConfig)
from melspec_gpt_vqvae_tpu.data import DataModule as JDataModule
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.models.vocoder import MelGANGenerator as JMelGAN
from melspec_gpt_vqvae_tpu.models.vqvae import VQModel as JVQModel
from melspec_gpt_vqvae_tpu.parallel import make_mesh
from melspec_gpt_vqvae_tpu.training import callbacks as JCB
from melspec_gpt_vqvae_tpu.training import gpt_task as JT
from melspec_gpt_vqvae_tpu.training import logging as JL
from melspec_gpt_vqvae_tpu.training import runner as JR
from melspec_gpt_vqvae_tpu.training import vae_task as JVT
from melspec_gpt_vqvae_tpu.training.checkpoint import \
    CheckpointManager as JCheckpointManager
from melspec_gpt_vqvae_tpu_torch import bridge, train_gpt, train_gpt_vae
from melspec_gpt_vqvae_tpu_torch import configs as TC
from melspec_gpt_vqvae_tpu_torch.data import DataModule
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANGenerator
from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel
from melspec_gpt_vqvae_tpu_torch.training import callbacks as TCB
from melspec_gpt_vqvae_tpu_torch.training import gpt_task as TT
from melspec_gpt_vqvae_tpu_torch.training import runner
from melspec_gpt_vqvae_tpu_torch.training import vae_task as TVT
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.training.logging import (TBLogger,
                                                         attention_image)
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import VQVAETask
from melspec_gpt_vqvae_tpu_torch.utils import convert, demo
from melspec_gpt_vqvae_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(1)

VQ_TINY = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8,
                      ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                      resolution=16, z_channels=8, code_h=4, code_w=5)
VOC_TINY = VocoderConfig(n_mel_channels=8, ngf=4, n_residual_layers=1)
GPT_TINY = GPTConfig(vocab_size=16, block_size=21, n_layer=2, n_head=2,
                     n_embd=16, class_size=2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _jsonl_events(monkeypatch):
    """The port logger's JSON lines (as without tensorboardX)."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"codes": rng.integers(0, 16, (b, 4, 5)).astype(np.int32),
            "target": rng.integers(0, 2, (b,)).astype(np.int32),
            "label": ["dog"] * b,
            "image": rng.uniform(-1, 1, (b, 8, 10)).astype(np.float32)}


@pytest.fixture(scope="module")
def decoders():
    """One tiny VQ-VAE and MelGAN in flax, and the same weights in the
    port: (JAX FrozenDecoders, port FrozenDecoders, port modules)."""
    vq_params = JVQModel(VQ_TINY).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8, 10, 1)))["params"]
    voc_params = JMelGAN(VOC_TINY).init(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 10, 8)))["params"]
    jdec = JCB.FrozenDecoders(VQ_TINY, vq_params, VOC_TINY, voc_params,
                              code_h=4, code_w=5)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vq = bridge.load_vqvae(np_tree(vq_params), bridge.config_from_jax(VQ_TINY))
    voc = bridge.load_melgan(np_tree(voc_params),
                             bridge.config_from_jax(VOC_TINY))
    return jdec, TCB.FrozenDecoders(vq, voc, code_h=4, code_w=5,
                                    device=CPU), (vq, voc)


def _jsonl(log_dir):
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _record_jax_tags(monkeypatch):
    """The (tag, kind) pairs the JAX TBLogger is asked to write."""
    seen = []
    for kind in ("text", "image", "spectrogram", "audio"):
        def rec(self, tag, *a, _kind=kind, **kw):
            seen.append((tag, _kind))
        monkeypatch.setattr(JL.TBLogger, kind, rec)
    monkeypatch.setattr(JL.TBLogger, "flush", lambda self: None)
    return seen


def _port_tags(records):
    """(tag, kind) of the port logger's JSON lines; a spectrogram is an
    image whose tag the caller knows."""
    out = []
    for r in records:
        kind = next(k for k in ("text", "image", "audio", "value",
                                "histogram") if k in r)
        out.append((r["tag"], kind))
    return out


def _kinds(seen):
    return sorted((t, "image" if k == "spectrogram" else k) for t, k in seen)


def _wav(path):
    with wave.open(str(path), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth()) == (1, 2)
        return w.getframerate(), w.getnframes()


# ------------------------------ logging --------------------------------------

def test_attention_image_equals_jax_bit_for_bit():
    att = np.random.default_rng(2).uniform(0, 1, (2, 3, 7, 7))
    att = (att / att.sum(-1, keepdims=True)).astype(np.float32)
    for prior in (True, False):
        np.testing.assert_array_equal(attention_image(att, prior),
                                      JL.attention_image(att, prior))


def test_logger_audio_and_flush_in_the_jsonl_fallback(tmp_path):
    """``audio`` writes a mono PCM16 WAV beside events.jsonl (clipped to
    [-1, 1]) and its line; ``flush`` puts the lines on disk."""
    log = TBLogger(str(tmp_path))
    wav = np.array([0.0, 0.5, -0.5, 2.0, -2.0], np.float32)
    log.audio("val/x_audio", wav, 3, 16000)
    log.flush()
    (rec,) = _jsonl(log.log_dir)
    assert rec == {"tag": "val/x_audio", "step": 3,
                   "audio": "val_x_audio_3.wav", "sample_rate": 16000}
    path = os.path.join(log.log_dir, rec["audio"])
    assert _wav(path) == (16000, 5)
    with wave.open(path, "rb") as w:
        pcm = np.frombuffer(w.readframes(5), "<i2")
    np.testing.assert_array_equal(pcm, [0, 16383, -16383, 32767, -32767])
    log.close()


def test_logger_audio_under_tensorboardx(tmp_path, monkeypatch):
    """With tensorboardX the waveform is a Summary proto of a WAV, as the
    JAX package writes it (no soundfile needed)."""
    monkeypatch.delitem(sys.modules, "tensorboardX")
    pytest.importorskip("tensorboardX.proto.summary_pb2")
    log = TBLogger(str(tmp_path))
    assert log._writer is not None
    log.audio("train/a", np.zeros(64, np.float32), 1)
    log.flush()
    log.close()
    assert any("tfevents" in f for f in os.listdir(log.log_dir))


def test_step_timer_leaves_paused_seconds_out():
    timer = StepTimer(window=2)
    timer.tick(1)
    with timer.paused(CPU):
        time.sleep(0.3)
    out = timer.tick(1)
    assert out["perf/steps_per_sec"] > 20.0


@pytest.mark.parametrize("shape", [(2, 5, 53), (3, 4, 5)])
def test_codes_copy_equals_the_jax_packages(shape):
    """utils/codes.py is a copy: every function gives the JAX package's
    arrays."""
    from melspec_gpt_vqvae_tpu.utils import codes as JC
    from melspec_gpt_vqvae_tpu_torch.utils import codes as TCo
    grid = np.random.default_rng(0).integers(0, 128, shape)
    h, w = shape[1:]
    seq = TCo.grid_to_sequence(grid)
    np.testing.assert_array_equal(seq, JC.grid_to_sequence(grid))
    np.testing.assert_array_equal(TCo.sequence_to_grid(seq, h, w), grid)
    for rev in (False, True):
        np.testing.assert_array_equal(TCo.code_reader(seq, h, w, rev),
                                      JC.code_reader(seq, h, w, rev))
    twice = np.concatenate([seq, seq], axis=-1)
    np.testing.assert_array_equal(TCo.code_reader(twice, h, w),
                                  JC.code_reader(twice, h, w))
    for a, b in zip(TCo.make_idx(h, w), JC.make_idx(h, w)):
        np.testing.assert_array_equal(a, b)


# ---------------------------- attention maps --------------------------------

@pytest.mark.parametrize("flags", [{}, {"use_flash_train": True},
                                   {"mixed_precision": True}],
                         ids=["plain", "flash_config", "mixed"])
def test_gpt_attention_maps_match_jax(flags, monkeypatch):
    """The last layer's probabilities within 1e-5 of JAX's, through the
    plain attention whatever the config: neither kernel A nor F is
    reached."""
    cfg = GPT_TINY.replace(**flags)
    jp = JG.init_gpt_params(jax.random.PRNGKey(3), cfg)
    tp = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    idx = np.random.default_rng(4).integers(0, 16, (2, 20))
    c = np.array([0, 1])
    want = JG.gpt_attention_maps(jp, cfg, jnp.asarray(idx),
                                 JG.class_embed(jp, jnp.asarray(c)))

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was reached")
    monkeypatch.setattr(TG, "attend", refuse)
    monkeypatch.setattr(TG, "flash_attention", refuse)
    tcfg = bridge.config_from_jax(cfg)
    got = TG.gpt_attention_maps(tp, tcfg, torch.from_numpy(idx),
                                TG.class_embed(tp, torch.from_numpy(c)))
    assert got.shape == (2, 2, 21, 21) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    logits, att = TG.gpt_apply(tp, tcfg, torch.from_numpy(idx),
                               return_attn=True)
    assert att.shape == (2, 2, 20, 20) and logits.shape == (2, 20, 16)


def test_log_samples_matches_jax():
    """The greedy row exactly JAX's, the input rows equal, the sampled rows
    of the right shapes with the given half kept, the map over the class
    token and codes_nopix."""
    exp = ExperimentConfig(model=GPT_TINY, vae=VAEConfig(nz=16),
                           train=TrainConfig(batch_size=2))
    jtask = JT.GPTTask(exp, mesh=make_mesh({"data": 2}), use_pallas=False)
    jstate = jtask.init_state(0)
    want = jtask.log_samples(jstate["params"], jax.random.PRNGKey(0),
                             _batch(), top_k=4, n=1)
    task = TT.GPTTask(bridge.config_from_jax(exp), CPU)
    tp = bridge.gpt_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate["params"]))
    gen = torch.Generator().manual_seed(0)
    got = task.log_samples(tp, gen, _batch(), top_k=4, n=1)
    assert set(got) == set(want)
    for k in ("codes", "codes_det"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in ("codes_half", "codes_nopix"):
        assert got[k].shape == np.asarray(want[k]).shape == (1, 20)
    np.testing.assert_array_equal(got["codes_half"][:, :10],
                                  got["codes"][:, :10])
    assert got["att_nopix"].shape == np.asarray(want["att_nopix"]).shape \
        == (1, 2, 21, 21)
    again = task.log_samples(tp, gen, _batch(), top_k=4, n=1)
    assert not np.array_equal(again["codes_nopix"], got["codes_nopix"]) or \
        not np.array_equal(again["codes_half"], got["codes_half"])


# ------------------------------- decoders ------------------------------------

def test_frozen_decoders_match_jax(decoders):
    jdec, tdec, _ = decoders
    seq = np.random.default_rng(1).integers(0, 16, (2, 20))
    want = jdec.codes_to_spec(seq)
    got = tdec.codes_to_spec(torch.from_numpy(seq))
    assert got.shape == want.shape == (2, 8, 10)
    np.testing.assert_allclose(got, want, atol=1e-5)
    audio = tdec.spec_to_audio(got[0])
    assert audio.shape == (10 * 256,)
    np.testing.assert_allclose(audio, jdec.spec_to_audio(got[0]), atol=1e-5)
    # each piece alone: the vocoder needs no VQ-VAE, and without a model
    # its half gives None
    voc_only = TCB.FrozenDecoders(None, decoders[2][1], device=CPU)
    assert voc_only.codes_to_spec(seq) is None
    np.testing.assert_allclose(voc_only.spec_to_audio(got[0]), audio,
                               atol=1e-6)
    assert TCB.FrozenDecoders().spec_to_audio(got[0]) is None


def _write_wav(path, n=64, sr=22050, channels=1):
    pcm = (np.sin(np.linspace(0, 8 * np.pi, n * channels)) * 20000) \
        .astype("<i2")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("channels", [1, 2])
def test_find_raw_audio_matches_jax(tmp_path, monkeypatch, channels):
    """The wav branch gives JAX's samples (1e-6); a missing, other-rate or
    unreadable file, or an mp4 without ffmpeg, gives None."""
    cls = tmp_path / "features" / "dog"
    spec = cls / "melspec_10s_22050hz" / "video_00007_mel.npy"
    os.makedirs(spec.parent, exist_ok=True)
    spec.touch()
    assert TCB.find_raw_audio(str(spec)) is None
    wav = cls / "audio_10s_22050hz" / "video_00007.wav"
    _write_wav(wav, channels=channels)
    got = TCB.find_raw_audio(str(spec))
    assert got.shape == (64,)
    np.testing.assert_allclose(got, JCB.find_raw_audio(str(spec)), atol=1e-6)
    _write_wav(wav, sr=16000)
    assert TCB.find_raw_audio(str(spec)) is None
    wav.write_bytes(b"RIFF-not-a-wav")
    assert TCB.find_raw_audio(str(spec)) is None
    os.remove(wav)
    (cls / "videos").mkdir()
    (cls / "videos" / "video_00007.mp4").write_bytes(b"\x00")
    monkeypatch.setattr(TCB, "which_ffmpeg", lambda: "")
    assert TCB.find_raw_audio(str(spec)) is None


def test_ffmpeg_helpers_without_ffmpeg(monkeypatch):
    monkeypatch.setattr(demo.shutil, "which", lambda name: None)
    assert demo.which_ffmpeg() == ""
    with pytest.raises(RuntimeError, match="ffmpeg"):
        demo.extract_audio_from_video("a.mp4", "a.wav")


# -------------------------------- loggers ------------------------------------

def test_gpt_image_logger_writes_the_jax_tags(decoders, tmp_path,
                                              monkeypatch):
    jdec, tdec, _ = decoders
    exp = ExperimentConfig(model=GPT_TINY.replace(n_layer=1),
                           vae=VAEConfig(nz=16),
                           train=TrainConfig(batch_size=2))
    jtask = JT.GPTTask(exp, mesh=make_mesh({"data": 2}), use_pallas=False)
    jstate = jtask.init_state(0)
    seen = _record_jax_tags(monkeypatch)
    JCB.GPTImageLogger(jtask, JL.TBLogger(str(tmp_path / "j"),
                                          enabled=False), jdec)(
        jstate, _batch(), 1, "train")

    task = TT.GPTTask(bridge.config_from_jax(exp), CPU)
    state = task.init_state(0)
    log = TBLogger(str(tmp_path / "t"))
    TCB.GPTImageLogger(task, log, tdec)(state, _batch(), 1, "train")
    recs = _jsonl(log.log_dir)
    assert sorted(_port_tags(recs)) == _kinds(seen)
    assert len(seen) == 16
    by_tag = {r["tag"]: r for r in recs}
    att = np.load(os.path.join(log.log_dir, by_tag["train/att_nopix"]
                               ["image"]))
    assert att.shape == (21, 21, 1) and att.min() >= 0 and att.max() <= 1
    spec = np.load(os.path.join(log.log_dir,
                                by_tag["train/samples_det"]["image"]))
    assert spec.shape == (8, 10, 1)
    for r in recs:
        if "audio" in r:
            assert _wav(os.path.join(log.log_dir, r["audio"])) == \
                (22050, 10 * 256)
    # a batch without codes logs nothing
    TCB.GPTImageLogger(task, log, tdec)(state, {"target": [0]}, 2, "val")
    log.flush()
    assert len(_jsonl(log.log_dir)) == len(recs)


def test_vae_text_logger_writes_the_jax_tags(decoders, tmp_path,
                                             monkeypatch):
    """The JAX tag set with the decoders (original spec and audio, every
    row's _spec and _audio), the raw source audio preferred; without
    decoders the text alone, as before."""
    jdec, tdec, _ = decoders
    cfg = GPTConfig(vocab_size=16, block_size=20, n_layer=1, n_head=2,
                    n_embd=16)
    exp = ExperimentConfig(model=cfg, vae=VAEConfig(nz=16),
                           train=TrainConfig(batch_size=2))
    cls = tmp_path / "features" / "dog"
    spec_path = cls / "melspec_10s_22050hz" / "video_00001_mel.npy"
    _write_wav(cls / "audio_10s_22050hz" / "video_00001.wav")
    batch = dict(_batch(), file_path_=[str(spec_path)] * 2)

    jtask = JVT.VAETask(exp, steps_per_epoch=2, mesh=make_mesh({"data": 2}),
                        use_pallas=False)
    seen = _record_jax_tags(monkeypatch)
    JCB.VAETextLogger(jtask, JL.TBLogger(str(tmp_path / "j"), enabled=False),
                      jdec, interpolation_steps=3)(
        jtask.init_state(0), batch, 1, "val")

    task = TVT.VAETask(bridge.config_from_jax(exp), 2, CPU)
    state = task.init_state(0)
    log = TBLogger(str(tmp_path / "t"))
    TCB.VAETextLogger(task, log, tdec, interpolation_steps=3)(
        state, batch, 1, "val")
    recs = _jsonl(log.log_dir)
    assert sorted(_port_tags(recs)) == _kinds(seen)
    by_tag = {r["tag"]: r for r in recs}
    assert _wav(os.path.join(log.log_dir,
                             by_tag["val/original_audio"]["audio"])) == \
        (22050, 64)                      # the raw clip, not the vocoded one
    assert _wav(os.path.join(
        log.log_dir, by_tag["val/greedy_reconstruction_audio"]["audio"])) \
        == (22050, 10 * 256)

    bare = TBLogger(str(tmp_path / "bare"))
    TCB.VAETextLogger(task, bare)(state, _batch(), 1, "train")
    kinds = {k for _, k in _port_tags(_jsonl(bare.log_dir))}
    assert kinds == {"text", "image"}    # the input spectrogram, the text


# ------------------------------ fit_gpt --------------------------------------

@pytest.fixture(scope="module")
def vas_tree(tmp_path_factory):
    """Two classes of 8 clips: 12 train and 4 valid lines; (4, 5) code
    grids of vocab 16; (80, 860) mels."""
    root = tmp_path_factory.mktemp("media_vas")
    rng = np.random.default_rng(0)
    lines = []
    for cls in ["baby", "dog"]:
        mel_dir = root / "features" / cls / "melspec_10s_22050hz"
        codes_dir = root / "features" / cls / "codes_10s"
        mel_dir.mkdir(parents=True)
        codes_dir.mkdir(parents=True)
        for i in range(8):
            vid = f"video_{i:05d}"
            np.save(mel_dir / f"{vid}_mel.npy",
                    rng.uniform(0, 1, (80, 860)).astype(np.float32))
            np.save(codes_dir / f"{vid}_mel_code.npy",
                    rng.integers(0, 16, (4, 5)).astype(np.int64))
            lines.append(f"{cls}/{vid}")
    data = root / "data"
    data.mkdir()
    (data / "vas_train.txt").write_text("\n".join(lines[:12]) + "\n")
    (data / "vas_valid.txt").write_text("\n".join(lines[12:]) + "\n")
    return root


def _dm(cls, vas_tree):
    dm = cls(batch_size=2, spec_dir_path=str(
        vas_tree / "features" / "*" / "melspec_10s_22050hz"),
        data_root=str(vas_tree / "data"))
    dm.setup()
    return dm


def test_fit_gpt_calls_media_cb_where_jax_does(vas_tree, tmp_path):
    """Train batch gi and val batch i with index % logging_frequency == 0,
    with the state's step at that point and the same batch, in both
    packages; 0 turns it off."""
    cfg = GPT_TINY.replace(n_layer=1)
    exp = ExperimentConfig(model=cfg, vae=VAEConfig(nz=16),
                           train=TrainConfig(batch_size=2, epochs=2),
                           data=DataConfig(batch_size=2))
    kw = dict(epochs=2, seed=3, logging_frequency=2, ckpt_every=-1,
              limit_train_batches=5, limit_val_batches=3)

    def recorder(calls):
        def cb(state, batch, step, split):
            calls.append((split, int(step),
                          tuple(np.asarray(batch["codes"])[0].ravel())))
        return cb

    jcalls, tcalls = [], []
    jtask = JT.GPTTask(exp, mesh=make_mesh({"data": 1}), use_pallas=False)
    JR.fit_gpt(jtask, _dm(JDataModule, vas_tree),
               log=JL.TBLogger(str(tmp_path / "j"), enabled=False),
               ckpt=JCheckpointManager(str(tmp_path / "jc")),
               media_cb=recorder(jcalls), **kw)
    task = TT.GPTTask(bridge.config_from_jax(exp), CPU)
    runner.fit_gpt(task, _dm(DataModule, vas_tree),
                   log=TBLogger(str(tmp_path / "t")),
                   ckpt=CheckpointManager(str(tmp_path / "tc")),
                   media_cb=recorder(tcalls), **kw)
    assert tcalls == jcalls
    assert [(s, st) for s, st, _ in tcalls] == [
        ("train", 1), ("train", 3), ("train", 5), ("val", 5),
        ("train", 6), ("train", 8), ("train", 10), ("val", 10)]
    off = []
    runner.fit_gpt(task, _dm(DataModule, vas_tree),
                   log=TBLogger(str(tmp_path / "t")),
                   ckpt=CheckpointManager(str(tmp_path / "tc2")),
                   media_cb=recorder(off), **dict(kw, logging_frequency=0))
    assert off == []


# --------------------------- reference files ---------------------------------

def _reference_vq_file(path, model: VQModel):
    """The port VQModel's weights under the reference LitVQVAE names."""
    sd = {convert._vq_reference_name(k): v.detach()
          for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, str(path))
    return str(path)


def _reference_melgan_dir(path, model: MelGANGenerator, cfg):
    """The port MelGAN's weights in the reference Sequential layout, each
    conv weight-normed with g = |v| (so the fold gives v back), and its
    args.yml."""
    sd = {}
    for port, ref in convert._melgan_reference_names(cfg).items():
        w = dict(model.named_parameters())[f"{port}.weight"].detach()
        sd[f"{ref}.weight_v"] = w
        sd[f"{ref}.weight_g"] = w.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        sd[f"{ref}.bias"] = dict(model.named_parameters())[
            f"{port}.bias"].detach()
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "best_netG.pt"))
    with open(os.path.join(path, "args.yml"), "w") as f:
        f.write("!!python/object:argparse.Namespace\n"
                f"n_mel_channels: {cfg.n_mel_channels}\n"
                f"n_residual_layers: {cfg.n_residual_layers}\n"
                f"ngf: {cfg.ngf}\nseq_len: 8192\n")
    return str(path)


def _vqgan_run(root, cfg):
    """A port VQ-GAN run directory as train_vqvae.py lays it out, one
    checkpoint of a fresh state."""
    task = VQVAETask(cfg, CPU)
    state = task.init_state(5)
    run = root / "lightning_logs" / "vq-vas"
    ckpt = CheckpointManager(str(run / "checkpoints" / "version_0"))
    ckpt.save({"state": task.state_tree(state), "epoch": 0}, 1)
    ckpt.wait()
    return str(run), state["model"]


def test_load_vqvae_params_takes_a_port_vqgan_run(tmp_path):
    """The run directory, its checkpoint directory and its last.pt give the
    run's autoencoder bit for bit; a directory with neither stays refused
    with the orbax hint."""
    cfg = bridge.config_from_jax(VQ_TINY)
    run, model = _vqgan_run(tmp_path, cfg)
    ckpt_dir = os.path.join(run, "checkpoints", "version_0")
    for path in (run, ckpt_dir, os.path.join(ckpt_dir, "last.pt")):
        got = convert.load_vqvae_params(path, cfg)
        for k, v in model.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), (path, k)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="torch_convert_orbax.py"):
        convert.load_vqvae_params(str(tmp_path / "empty"), cfg)


# ---------------------------------- CLIs -------------------------------------

# the VAS geometry (80-mel, (5, 53) code grids, 848 frames) at narrow widths
VQ_CLI = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8,
                     ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
                     z_channels=8, disc_ndf=8)
VOC_CLI = VocoderConfig(n_mel_channels=80, ngf=4, n_residual_layers=1)
FRAMES = 848 * 256


@pytest.fixture(scope="module")
def vas_tree_53(tmp_path_factory):
    """Two classes of 4 clips: 6 train and 2 valid lines, (80, 860) mels and
    (5, 53) code grids of vocab 16."""
    root = tmp_path_factory.mktemp("media_vas53")
    rng = np.random.default_rng(1)
    lines = []
    for cls in ["baby", "dog"]:
        for sub in ("melspec_10s_22050hz", "codes_10s"):
            (root / "features" / cls / sub).mkdir(parents=True)
        for i in range(4):
            vid = f"video_{i:05d}"
            feat = root / "features" / cls
            np.save(feat / "melspec_10s_22050hz" / f"{vid}_mel.npy",
                    rng.uniform(0, 1, (80, 860)).astype(np.float32))
            np.save(feat / "codes_10s" / f"{vid}_mel_code.npy",
                    rng.integers(0, 16, (5, 53)).astype(np.int64))
            lines.append(f"{cls}/{vid}")
    data = root / "data"
    data.mkdir()
    (data / "vas_train.txt").write_text("\n".join(lines[:3] + lines[4:7])
                                        + "\n")
    (data / "vas_valid.txt").write_text(f"{lines[3]}\n{lines[7]}\n")
    return root


@pytest.fixture
def cli_preset(monkeypatch):
    """The GPT presets with VQ_CLI as the frozen VQ-VAE's geometry (the
    CLIs take it from the preset, which has no override for it)."""
    load = TC.load_preset
    vq = bridge.config_from_jax(VQ_CLI)

    def patched(*a, **kw):
        exp = load(*a, **kw)
        exp.vqvae = vq
        return exp
    monkeypatch.setattr(TC, "load_preset", patched)
    return vq


def _decoder_files(tmp_path, kind):
    g = torch.Generator().manual_seed(0)
    vq_cfg = bridge.config_from_jax(VQ_CLI)
    voc_cfg = bridge.config_from_jax(VOC_CLI)
    voc = bridge.init_conv_net_(MelGANGenerator(voc_cfg), g)
    voc_dir = _reference_melgan_dir(tmp_path / "melgan", voc, voc_cfg)
    if kind == "reference_file":
        vq = bridge.init_conv_net_(VQModel(vq_cfg), g)
        return _reference_vq_file(tmp_path / "vq.ckpt", vq), voc_dir
    return _vqgan_run(tmp_path, vq_cfg)[0], voc_dir


def _cli_argv(tree, experiment, block_size, vq_path, voc_dir):
    spec = tree / "features" / "*" / "melspec_10s_22050hz"
    override = (f"n_layer=1,n_embd=16,n_head=2,block_size={block_size},"
                "vocab_size=16,batch_size=2,use_flash_train=True,"
                f"spec_dir_path={spec}")
    return ["--dataset", "vas", "--experiment", experiment, "--train", "1",
            "--device", "cpu", "--epochs_override", "1",
            "--limit_train_batches", "1", "--limit_val_batches", "1",
            "--logging_frequency", "1", "--reconstruct_spec", vq_path,
            "--vocoder", voc_dir, "--data_root", str(tree / "data"),
            "--override", override]


def _media_records(run, tags):
    """The run's JSON lines, every tag in ``tags`` among them and every WAV
    a 22050 Hz clip of the VAS length."""
    logs = run / "TensorBoardLoggs" / "version_0"
    recs = _jsonl(str(logs))
    got = {r["tag"] for r in recs}
    assert set(tags) <= got, sorted(set(tags) - got)
    for r in recs:
        if "audio" in r:
            assert _wav(logs / r["audio"]) == (22050, FRAMES), r["tag"]
    return recs


@pytest.mark.parametrize("kind", ["reference_file", "vqgan_run"])
def test_train_gpt_cli_logs_media(vas_tree_53, tmp_path, monkeypatch,
                                  cli_preset, kind):
    """train_gpt.main with --reconstruct_spec (a reference-format VQ-VAE
    file, or a port VQ-GAN run directory) and --vocoder (a reference MelGAN
    folder): one train step and one val batch, each logging the gallery as
    text, the heatmap, (80, 848) spectrograms and their audio."""
    vq_path, voc_dir = _decoder_files(tmp_path, kind)
    monkeypatch.chdir(tmp_path)
    task, state, _ = train_gpt.main(train_gpt.init_config(
        _cli_argv(vas_tree_53, "m", 266, vq_path, voc_dir)))
    assert state["step"] == 1
    names = ["conditioning", "codes", "codes_half", "codes_nopix",
             "codes_det", "att_nopix", "inputs", "inputs_audio"]
    for n in ("reconstructions", "samples_half", "samples_nopix",
              "samples_det"):
        names += [n, f"{n}_audio"]
    run = tmp_path / "lightning_logs" / "m-vas"
    recs = _media_records(run, [f"{s}/{n}" for s in ("train", "val")
                                for n in names])
    logs = run / "TensorBoardLoggs" / "version_0"
    by_tag = {r["tag"]: r for r in recs}
    assert np.load(logs / by_tag["val/samples_det"]["image"]).shape == \
        (80, 848, 1)
    assert np.load(logs / by_tag["val/att_nopix"]["image"]).shape == \
        (266, 266, 1)


def test_train_gpt_cli_refuses_a_decoder_that_does_not_load(vas_tree,
                                                            tmp_path,
                                                            monkeypatch):
    """A decoder that does not load raises before the run directory is
    made."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "vas", "--experiment", "m", "--train", "1",
            "--device", "cpu", "--data_root", str(vas_tree / "data")]
    with pytest.raises(ValueError, match="best_netG.pt"):
        train_gpt.main(train_gpt.init_config(argv + ["--vocoder", "nope"]))
    with pytest.raises(FileNotFoundError):
        train_gpt.main(train_gpt.init_config(
            argv + ["--reconstruct_spec", "nope.ckpt"]))
    assert not (tmp_path / "lightning_logs").exists()


def test_train_gpt_vae_cli_logs_media(vas_tree_53, tmp_path, monkeypatch,
                                      cli_preset):
    """train_gpt_vae.main with both decoders: one step, VAETextLogger's
    rows as text, spectrograms and audio."""
    vq_path, voc_dir = _decoder_files(tmp_path, "vqgan_run")
    monkeypatch.chdir(tmp_path)
    argv = _cli_argv(vas_tree_53, "v", 265, vq_path, voc_dir)
    task, state, _, _ = train_gpt_vae.main(train_gpt_vae.init_config(
        argv + ["--warm_up", "1", "--kl_start", "0.5"]))
    assert state["step"] == 1
    tags = ["train/original_spec", "train/original_audio"]
    for row in ("original_codes", "greedy_reconstruction",
                "beam_reconstruction", "interpolation_4"):
        tags += [f"train/{row}{sfx}" for sfx in ("", "_spec", "_audio")]
    _media_records(tmp_path / "lightning_logs" / "v-vas", tags)
