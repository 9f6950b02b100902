"""PyTorch port, speculative decoding's acceptance with a trained pair
(scripts/torch_spec_acceptance.py) on the CPU at a toy geometry.

The measurement runs on the card; here ``main`` runs on the CPU with its
module globals cut to a few steps (16 clips of the battery, a 1-layer
and a 2-layer 16-wide GPT, gamma 2, 2 samples a class), writing over a
copy of the committed SPEC_ACCEPTANCE_TORCH.json, and the JSON it writes
is held to the keys of SPEC_ACCEPTANCE.json (the TPU's record), the
wall-clock runs' ``measured_e2e`` / ``measured_e2e_hard``
(scripts/torch_spec_measured.py's) kept as the file held them.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from melspec_gpt_vqvae_tpu_torch.configs import (DataConfig, ExperimentConfig,
                                                 GPTConfig, TrainConfig)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sa():
    spec = importlib.util.spec_from_file_location(
        "torch_spec_acceptance", ROOT / "scripts/torch_spec_acceptance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_toy_run_writes_the_jax_records_keys(sa, monkeypatch, tmp_path):
    full = sa.make_tone_battery

    def battery16(mcfg):
        w, l, f = full(mcfg)
        return w[::4], l[::4], f[::4]

    def tiny(layers):
        g = GPTConfig(vocab_size=128, block_size=266, n_layer=layers // 2
                      or 1, n_head=2, n_embd=16, class_size=4)
        return ExperimentConfig(model=g, train=TrainConfig(
            learning_rate=3e-4, epochs=1, batch_size=4),
            data=DataConfig(batch_size=4))
    out_path = tmp_path / "SPEC_ACCEPTANCE_TORCH.json"
    committed = json.loads((ROOT / "SPEC_ACCEPTANCE_TORCH.json").read_text())
    out_path.write_text(json.dumps(committed))
    for name, value in (("make_tone_battery", battery16), ("VQ_STEPS", 2),
                        ("GPT_STEPS", 2), ("SAMPLES", 2), ("GAMMAS", (2,)),
                        ("gpt_experiment", tiny), ("OUT", str(out_path))):
        monkeypatch.setattr(sa, name, value)
    ret = sa.main("cpu")
    out = json.loads(out_path.read_text())
    assert out == json.loads(json.dumps(ret))
    want = json.loads((ROOT / "SPEC_ACCEPTANCE.json").read_text())
    assert set(want) <= set(out), set(want) - set(out)
    for key in ("measured_e2e", "measured_e2e_hard"):
        assert out[key] == committed[key]
    assert set(out["gammas"]) == {"2"}
    assert set(out["gammas"]["2"]) == set(want["gammas"]["2"])
    for v in out["gammas"]["2"].values():
        assert 0.0 <= v <= 1.0
    assert out["sampling"] == {"temperature": 0.9, "top_k": 16}
    assert out["device"] == {"platform": "cpu"}


def test_acceptance_refuses_to_run_without_a_card(sa, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sa.main()
