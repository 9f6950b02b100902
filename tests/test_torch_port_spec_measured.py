"""PyTorch port, speculative decoding timed on a trained pair
(scripts/torch_spec_measured.py) on the CPU at a toy geometry, and the
mixture corpus it trains on with ``SM_CORPUS=hard``
(utils/battery.py::make_hard_battery).

The wall clock is measured on the card; here ``main`` runs on the CPU for
both corpora with its module globals cut to a few steps (16 clips, a
narrow codec, a 2-layer target and a 1-layer draft 16 wide, one timed
call a mode), writing into a copy of the committed
SPEC_ACCEPTANCE_TORCH.json: ``measured_e2e`` and ``measured_e2e_hard``
carry SPEC_ACCEPTANCE.json's keys, and every other key of the file is
left as it was."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu_torch.configs import MelConfig
from melspec_gpt_vqvae_tpu_torch.utils import battery

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sm():
    return _load("scripts/torch_spec_measured.py", "torch_spec_measured")


@pytest.mark.parametrize("seed", [11, 3])
def test_hard_battery_equals_the_jax_scripts(monkeypatch, tmp_path, seed):
    # the JAX script sets a compile-cache directory in the environment
    # when imported; point it into the test's own directory
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    jsm = _load("scripts/spec_measured.py", "jax_spec_measured")
    cfg = MelConfig()
    got = battery.make_hard_battery(cfg, seed)
    want = jsm.make_hard_battery(cfg, seed)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] is None and want[2] is None
    assert got[0].shape == (64, cfg.clip_samples)
    np.testing.assert_array_equal(np.bincount(got[1]), [16] * 4)


def test_toy_runs_write_the_jax_records_keys(sm, monkeypatch, tmp_path):
    out_path = tmp_path / "SPEC_ACCEPTANCE_TORCH.json"
    committed = json.loads((ROOT / "SPEC_ACCEPTANCE_TORCH.json").read_text())
    out_path.write_text(json.dumps(committed))

    def every4th(fn):
        def sixteen(mcfg):
            w, l, f = fn(mcfg)
            return w[::4], l[::4], None if f is None else f[::4]
        return sixteen
    codec = sm.small_codec_cfg
    for name, value in (
            ("make_tone_battery", every4th(sm.make_tone_battery)),
            ("make_hard_battery", every4th(sm.make_hard_battery)),
            ("small_codec_cfg", lambda **kw: dataclasses.replace(
                codec(**kw), ch=8, ch_mult=(1, 1, 1, 1, 1), z_channels=8,
                embedding_dim=8, num_embeddings=16, disc_ndf=8)),
            ("VQ_STEPS", 2), ("GPT_STEPS", 2), ("ITERS", 1),
            ("TARGET_LAYERS", 2), ("DRAFT_LAYERS", 1), ("EMBD", 16),
            ("HEADS", 2), ("OUT", str(out_path))):
        monkeypatch.setattr(sm, name, value)
    rets = {}
    for corpus in ("tones", "hard"):
        monkeypatch.setattr(sm, "CORPUS", corpus)
        rets[corpus] = sm.main("cpu")

    out = json.loads(out_path.read_text())
    want = json.loads((ROOT / "SPEC_ACCEPTANCE.json").read_text())
    for k in set(committed) - {"measured_e2e", "measured_e2e_hard"}:
        assert out[k] == committed[k], k
    for key, corpus in (("measured_e2e", "tones"),
                        ("measured_e2e_hard", "hard")):
        got = out[key]
        assert got == json.loads(json.dumps(rets[corpus]))
        assert set(want[key]) <= set(got), set(want[key]) - set(got)
        assert set(got) - set(want[key]) <= {"dtypes", "device", "corpus"}
        assert got["corpus"] == corpus and got["batch"] == 1
        assert set(got["per_gamma"]) == {"2", "4", "8"}
        for row in got["per_gamma"].values():
            assert set(row) == set(want[key]["per_gamma"]["2"])
            assert 0.0 <= row["realized_acceptance"] <= 1.0
            assert row["rounds"] >= 265 // 9
        assert got["sampling"] == want[key]["sampling"]
        assert got["target"].startswith("2L/16d")
        assert got["draft"].startswith("1L/16d")
        assert got["device"] == {"platform": "cpu"}
        assert got["dtypes"] == {"params": "float32", "cache": "auto",
                                 "decode_weights": "auto"}


def test_spec_measured_refuses_to_run_without_a_card(sm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sm.main()
