"""PyTorch port, scripts/torch_int8_quality.py on the CPU at a toy geometry.

The gate itself runs on the card at the JAX script's defaults; here its
``main`` runs end to end on 4 battery clips (one a class) with a narrow
codec and vocoder, a narrow reference-scale VQ-VAE of 5 x 4 codes, 2
codec steps, the decode stage calibrated on 4 grids: the record it
writes has the keys of the JAX script's INT8_DECODE.json (the TPU's
record) and the JAX gates unchanged, and it exits non-zero exactly when a
gate failed.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu_torch.configs import VocoderConfig, VQVAEConfig
from melspec_gpt_vqvae_tpu_torch.utils import battery

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(ch=8, num_res_blocks=1, z_channels=8, embedding_dim=8,
              num_embeddings=16, disc_ndf=8)


@pytest.fixture
def iq(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_int8_quality", ROOT / "scripts" / "torch_int8_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    codec = mod.small_codec_cfg

    def narrow_codec(disc_start):
        return dataclasses.replace(codec(disc_start), **NARROW)

    def four_clips(mcfg):
        wavs, labels, freqs = battery.make_tone_battery(mcfg)
        pick = np.arange(0, 64, 16)
        return wavs[pick], labels[pick], freqs[pick]

    monkeypatch.setattr(mod, "small_codec_cfg", narrow_codec)
    monkeypatch.setattr(mod, "make_tone_battery", four_clips)
    monkeypatch.setattr(mod, "VQVAEConfig", lambda: VQVAEConfig(
        ch_mult=(1, 1, 1, 1, 1), code_w=4, **NARROW))
    monkeypatch.setattr(mod, "VocoderConfig", lambda: VocoderConfig(
        ngf=4, n_residual_layers=1))
    # calibration on 4 random grids in place of 32
    monkeypatch.setattr(mod.qz, "build_qstate", functools.partial(
        mod.qz.build_qstate, n_calib=4))
    monkeypatch.setattr(mod, "VQ_STEPS", 2)
    monkeypatch.setattr(mod, "OUT", str(tmp_path / "int8.json"))
    return mod


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def test_record_has_the_jax_keys_and_gates(iq):
    try:
        out = iq.main("cpu")
        exited = False
    except SystemExit:
        exited = True
    rec = json.loads(Path(iq.OUT).read_text())
    jrec = json.loads((ROOT / "INT8_DECODE.json").read_text())
    for key, sub in _keys(jrec).items():
        assert key in rec
        if sub:
            assert set(sub) <= set(rec[key]), key
    assert rec["gates"] == jrec["gates"] == iq.GATES
    assert rec["pass"] == (not rec["failed_gates"]) == (not exited)
    if not exited:
        assert out == rec
    assert rec["trained"]["clips"] == 4 and rec["vq_steps"] == 2
    assert rec["reference_scale_random"]["batch"] == 32
    assert 0.0 <= rec["encoder"]["code_agreement_vs_bf16"] <= 1.0
    assert 0.0 <= rec["encoder"]["code_agreement_vs_f32"] <= 1.0
    assert 0.0 <= rec["trained"]["dominant_bin_match"] <= 1.0
    assert np.isfinite(rec["trained"]["spec_snr_db"])
    assert rec["device"] == {"platform": "cpu"}


def test_decode_pair_int8_stage_tracks_the_float_stage(iq):
    """The reference-scale pair at percentile 1 on the narrow shapes: the
    int8 stage is the float stage quantised, not another network (SNR
    well above 0 dB), and the two return the same shapes."""
    voc = iq.seeded(iq.MelGANGenerator(iq.VocoderConfig()), 3, "cpu")
    spec_f, wav_f, spec_q, wav_q = iq.reference_scale(voc, "cpu",
                                                      percentile=1.0)
    assert spec_f.shape == spec_q.shape == (32, 80, 64)
    assert wav_f.shape == wav_q.shape == (32, 64 * 256)
    assert iq.snr_db(spec_f, spec_q) > 10.0
