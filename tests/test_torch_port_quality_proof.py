"""PyTorch port, the learning proof's pieces (scripts/torch_quality_proof.py)
on the CPU at a toy geometry.

The proof itself trains on the card only; these tests call its functions,
never ``main``, so no gate is loosened for a toy run: the tone battery
(bit for bit the JAX script's), its training mels, two codec steps and the
encode of a narrow codec, class-conditional sampling through a tiny GPT
decoded by that codec, the band and gate functions on made-up logs, and
the keys of the JSON the script writes (QUALITY.json's, the TPU's record,
plus the gates and the card).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu_torch.configs import (DataConfig, ExperimentConfig,
                                                 GPTConfig, MelConfig,
                                                 TrainConfig)
from melspec_gpt_vqvae_tpu_torch.ops.mel import waveform_to_mel
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import VQVAETask
from melspec_gpt_vqvae_tpu_torch.utils import battery

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def qp():
    return _load("scripts/torch_quality_proof.py", "torch_quality_proof")


@pytest.fixture(scope="module")
def mels():
    """Every eighth clip of the battery (two a class) and their training
    mels on the CPU."""
    wavs, labels, _ = battery.make_tone_battery(MelConfig())
    pick = np.arange(0, 64, 8)
    m, x = battery.wavs_to_training_mels(wavs[pick], MelConfig(), "cpu")
    return wavs[pick], labels[pick], m, x


def test_tone_battery_equals_the_jax_scripts(monkeypatch, tmp_path):
    # the JAX script sets a compile-cache directory in the environment
    # when imported; point it into the test's own directory
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jqp = _load("scripts/quality_proof.py", "jax_quality_proof")
    cfg = MelConfig()
    for got, want in zip(battery.make_tone_battery(cfg),
                         jqp.make_tone_battery(cfg)):
        np.testing.assert_array_equal(got, want)
    assert (battery.SR, battery.N_CLASSES, battery.TONES_PER_CLASS,
            battery.JITTERS) == (jqp.SR, jqp.N_CLASSES, jqp.TONES_PER_CLASS,
                                 jqp.JITTERS)


def test_training_mels_crop_and_range(mels):
    wavs, labels, m, x = mels
    assert m.shape == (8, 80, 848) and x.shape == (8, 80, 848, 1)
    ref = waveform_to_mel(torch.from_numpy(wavs[:2]), MelConfig()).numpy()
    np.testing.assert_array_equal(m[:2], ref[:, :, 6:854])
    np.testing.assert_array_equal(x[..., 0], (2.0 * m - 1.0).astype(
        np.float32))
    assert list(labels) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_class_bands_and_band_hits(qp, mels):
    _, labels, m, _ = mels
    bands = qp.class_bands(m, labels)
    assert set(bands) == {0, 1, 2, 3}
    # the classes are frequency bands: their dominant bins rise by class
    assert max(bands[0]) < min(bands[1]) and max(bands[2]) < min(bands[3])
    b = {0: [10], 1: [20], 2: [40], 3: [60]}
    assert qp.band_hit(12, 0, b) and qp.band_hit(13, 0, b)
    assert not qp.band_hit(14, 0, b)           # more than 3 bins away
    assert not qp.band_hit(16, 1, {0: [14], 1: [19], 2: [40], 3: [60]})


def _logs(disc, dw, margin, rec, factor=1.0):
    return [{"train/disc_loss": d, "train/d_weight": w,
             "train/logits_real": margin / 2, "train/logits_fake": -margin / 2,
             "train/rec_loss": rec, "train/disc_factor": factor}
            for d, w in zip(disc, dw)]


def test_gan_phase_gates(qp):
    cfg = qp.small_codec_cfg(disc_start=3)
    good = qp.gan_phase_summary(_logs([1.0, 0.9, 0.8, 0.7, 0.6, 0.5],
                                      [0.2] * 6, 0.4, 0.12), 0.1, cfg)
    assert all(good["gates"].values()) and good["steps"] == 6
    assert good["d_weight"] == {"min": 0.2, "max": 0.2, "final": 0.2}
    bad = qp.gan_phase_summary(
        _logs([0.5, 0.9, 0.8, 0.7, 0.6, 0.5], [0.0] + [0.2] * 5, -0.1, 0.3,
              factor=0.0), 0.1, cfg)
    assert not any(bad["gates"].values())


def test_codec_steps_encode_sample_and_result_keys(qp, mels):
    """Two steps of a narrow codec (the adversarial phase from the second),
    the encode, a tiny class GPT's samples decoded by the codec and scored,
    and the result's keys against QUALITY.json's."""
    _, labels, m, x = mels
    vcfg = dataclasses.replace(
        qp.small_codec_cfg(disc_start=1), ch=8, ch_mult=(1, 1, 1, 1, 1),
        z_channels=8, embedding_dim=8, num_embeddings=16, disc_ndf=8)
    task = VQVAETask(vcfg, "cpu")
    state = task.init_state(0)
    rng = np.random.default_rng(0)
    state, logs = qp.train_codec(task, state, x, 2, rng, bs=2)
    assert len(logs) == 2 and state["step"] == 2
    assert logs[0]["train/disc_factor"] == 0.0
    assert logs[1]["train/disc_factor"] == 1.0
    grids = qp.encode_grids(state["model"], x, "cpu")
    assert grids.shape == (8, 5, 53) and grids.dtype == np.int32
    assert grids.min() >= 0 and grids.max() < 16

    gcfg = GPTConfig(vocab_size=16, block_size=266, n_layer=1, n_head=1,
                     n_embd=16, class_size=4)
    gpt = GPTTask(ExperimentConfig(model=gcfg, train=TrainConfig(
        learning_rate=3e-4, epochs=1, batch_size=16),
        data=DataConfig(batch_size=16)), "cpu")
    gstate, l0, l1 = qp.train_class_gpt(gpt, grids, labels, 2, rng)
    assert np.isfinite(l0) and np.isfinite(l1)
    bands = qp.class_bands(m, labels)
    acc, per_class, detail = qp.sample_and_score(gpt, gstate, state["model"],
                                                 bands, 2)
    assert 0.0 <= acc <= 1.0 and set(per_class) == {0, 1, 2, 3}
    assert all(len(d["dom_bins"]) == 2 for d in detail)

    gan_out = qp.gan_phase_summary(logs, 0.5, vcfg)
    out = qp.result(acc, per_class, gan_out, 0.4, (l0, l1), 8, 0.1, detail,
                    {"platform": "cpu"})
    tpu = json.loads((ROOT / "QUALITY.json").read_text())
    assert set(tpu) <= set(out)
    assert set(out) - set(tpu) == {"gan_steps", "gates", "passed", "device"}
    assert set(out["gates"]) == {"accuracy", *gan_out["gates"]}
    assert out["passed"] == all(out["gates"].values())
    json.dumps(out)   # serialisable as written


def test_proof_refuses_to_run_without_a_card(qp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        qp.main()
