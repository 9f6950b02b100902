"""PyTorch port, the GPT-VAE's learning proof (scripts/torch_quality_vae.py)
on the CPU at a toy geometry.

The proof trains on the card; here ``main`` runs on the CPU with its
module globals cut to a few steps (16 clips of the battery, a 1-layer,
16-wide GPT-VAE, 2 epochs) and the JSON it writes is held to the keys of
QUALITY_VAE.json (the TPU's record) plus gates (a)-(d), ``passed`` and the
device.  A toy run's gates may go either way: their logic is checked on
the TPU record's own numbers.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def qv():
    spec = importlib.util.spec_from_file_location(
        "torch_quality_vae", ROOT / "scripts/torch_quality_vae.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toy(mod, monkeypatch, tmp_path):
    """Cut the proof to a toy: every fourth clip (4 a class, 2 held out),
    2 codec steps, a 1-layer 16-wide VAE for 2 epochs of 2 steps."""
    full = mod.make_tone_battery

    def battery16(mcfg):
        w, l, f = full(mcfg)
        return w[::4], l[::4], f[::4]
    for name, value in (("make_tone_battery", battery16), ("VQ_STEPS", 2),
                        ("EPOCHS", 2), ("WARM_UP", 1), ("EMBD", 16),
                        ("LAYERS", 1), ("BS", 4),
                        ("OUT", str(tmp_path / "QUALITY_VAE_TORCH.json")),
                        ("SCRATCH", str(tmp_path / "scratch"))):
        monkeypatch.setattr(mod, name, value)


def test_toy_run_writes_the_jax_records_keys(qv, monkeypatch, tmp_path):
    _toy(qv, monkeypatch, tmp_path)
    try:
        out = qv.main("cpu")
    except SystemExit as e:   # a toy run's gates may fail: the record
        assert "gates failed" in str(e)   # is written first
    out = json.loads((tmp_path / "QUALITY_VAE_TORCH.json").read_text())
    want = json.loads((ROOT / "QUALITY_VAE.json").read_text())
    assert set(want) <= set(out), set(want) - set(out)
    assert set(out["gates"]) == {"a_elbo_and_rec_decrease",
                                 "b_heldout_band_accuracy",
                                 "c_mutual_info_and_active_units",
                                 "d_interpolation_endpoints"}
    assert out["passed"] == all(out["gates"].values())
    assert out["device"] == {"platform": "cpu"}
    assert out["clips"] == {"train": 8, "heldout": 8}
    assert out["steps"] == 2 * 2 and out["nz"] == 16
    assert 0.0 <= out["heldout_reconstruction_band_accuracy"] <= 1.0
    assert 0 <= out["active_units"] <= 16
    assert np.isfinite(out["val_loss"]["trained"])


def test_gates_on_the_tpu_records_numbers(qv):
    """Gates (a)-(d) on QUALITY_VAE.json's figures all pass, and each
    fails alone when its figure is moved past the JAX script's bound."""
    rec = json.loads((ROOT / "QUALITY_VAE.json").read_text())
    m0 = {"loss": rec["val_loss"]["random_init"],
          "rec": rec["val_rec"]["random_init"]}
    m1 = {"loss": rec["val_loss"]["trained"],
          "rec": rec["val_rec"]["trained"]}
    args = (m0, m1, rec["heldout_reconstruction_band_accuracy"],
            rec["mutual_info"], rec["active_units"],
            rec["interpolation_endpoint_accuracy"])
    assert all(qv.gates_of(*args).values())
    bad = {"a_elbo_and_rec_decrease": (m0, {**m1, "rec": 0.6 * m0["rec"]}),
           "b_heldout_band_accuracy": (0.625,),
           "c_mutual_info_and_active_units": (0.0,),
           "d_interpolation_endpoints": (0.5,)}
    where = {"a_elbo_and_rec_decrease": slice(0, 2),
             "b_heldout_band_accuracy": slice(2, 3),
             "c_mutual_info_and_active_units": slice(3, 4),
             "d_interpolation_endpoints": slice(5, 6)}
    for gate, values in bad.items():
        moved = list(args)
        moved[where[gate]] = values
        got = qv.gates_of(*moved)
        assert not got[gate] and sum(got.values()) == 3, (gate, got)


def test_proof_refuses_to_run_without_a_card(qv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        qv.main()
