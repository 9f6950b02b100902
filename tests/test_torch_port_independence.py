"""PyTorch port: its own copies of the framework-free modules.

The port imports nothing of the JAX package, so it keeps its own
``configs``, ``data`` and ``utils.battery``.  These tests hold each copy to
its original exactly -- presets, override parsing, batches, the battery --
and hold ``bridge.config_from_jax``, which turns a config of the JAX
package into the port's class, and ``build_pipeline``'s device rule: no
device means the card, and only ``device="cpu"`` builds on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import parity_check
from melspec_gpt_vqvae_tpu import configs as JC
from melspec_gpt_vqvae_tpu import data as JD
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import configs as TC
from melspec_gpt_vqvae_tpu_torch import data as TD
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.utils.battery import make_battery

torch.set_num_threads(1)

PRESETS = sorted(set(JC._PRESETS) & set(TC._PRESETS))
CONFIG_CLASSES = ["GPTConfig", "MelConfig", "VQVAEConfig", "VocoderConfig",
                  "DataConfig", "VAEConfig", "TrainConfig",
                  "ExperimentConfig"]


def _load(mod, key, **overrides):
    model, dataset = key.rsplit("_", 1)
    if model == "VAE":     # the legacy LSTM preset: (ExperimentConfig, LSTM)
        exp, lstm = mod.load_lstm_preset(dataset, **overrides)
        return {"exp": dataclasses.asdict(exp), "lstm": lstm._asdict()}
    return dataclasses.asdict(mod.load_preset(model, dataset, **overrides))


def test_both_packages_know_the_same_presets():
    assert sorted(JC._PRESETS) == sorted(TC._PRESETS) and len(PRESETS) >= 4
    assert JC._PRESETS == TC._PRESETS


@pytest.mark.parametrize("key", PRESETS)
def test_preset_equals_the_jax_packages(key):
    assert _load(TC, key) == _load(JC, key)
    ov = {"batch_size": 3, "learning_rate": 1e-3}
    assert _load(TC, key, **ov) == _load(JC, key, **ov)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_classes_are_distinct_with_equal_fields(name):
    j, t = getattr(JC, name), getattr(TC, name)
    assert j is not t
    assert [(f.name, f.type) for f in dataclasses.fields(j)] == \
        [(f.name, f.type) for f in dataclasses.fields(t)]
    assert [(f.name, f.default) for f in dataclasses.fields(j)
            if f.default is not dataclasses.MISSING] == \
        [(f.name, f.default) for f in dataclasses.fields(t)
         if f.default is not dataclasses.MISSING]


@pytest.mark.parametrize("spec", [
    "", "n_layer=2,n_embd=64,n_head=1,use_flash_train=True",
    "learning_rate=3e-4, cache_dtype=int8 ,last_linear=None",
    "mesh_shape={'data': 4, 'model': 2},ratios=(8, 8, 2, 2)",
    "spec_dir_path=./data/vas/features/*/melspec_10s_22050hz"])
def test_parse_overrides_equals_the_jax_packages(spec):
    assert TC.parse_overrides(spec) == JC.parse_overrides(spec)


@pytest.mark.parametrize("spec", ["n_layer", "n_layer=2,n_embd"])
def test_parse_overrides_refuses_like_the_jax_package(spec):
    for mod in (JC, TC):
        with pytest.raises(ValueError):
            mod.parse_overrides(spec)


def test_unknown_override_key_raises_in_both():
    for mod in (JC, TC):
        with pytest.raises((KeyError, ValueError, TypeError)):
            mod.load_preset("GPT", "vas", no_such_field=1)


@pytest.mark.parametrize("key", [k for k in PRESETS
                                 if not k.startswith("VAE_")])
def test_config_from_jax_round_trips(key):
    """A JAX-package config becomes the port's class of the same name with
    equal fields, nested configs included; from the ``asdict`` form too."""
    model, dataset = key.rsplit("_", 1)
    jexp = JC.load_preset(model, dataset, n_layer=2, cache_dtype="int8")
    texp = bridge.config_from_jax(jexp)
    assert type(texp) is TC.ExperimentConfig
    assert type(texp.model) is TC.GPTConfig
    assert type(texp.mel) is TC.MelConfig
    assert type(texp.train) is TC.TrainConfig
    assert dataclasses.asdict(texp) == dataclasses.asdict(jexp)
    assert texp == TC.load_preset(model, dataset, n_layer=2,
                                  cache_dtype="int8")
    again = bridge.config_from_jax(dataclasses.asdict(jexp),
                                   TC.ExperimentConfig)
    assert again == texp and type(again.vqvae) is TC.VQVAEConfig
    tm = bridge.config_from_jax(jexp.model)
    assert tm == texp.model and tm.head_dim == jexp.model.head_dim


def test_config_from_jax_refuses_what_the_port_does_not_know():
    d = dataclasses.asdict(JC.load_preset("GPT", "vas").model)
    with pytest.raises(ValueError, match="no_such_field"):
        bridge.config_from_jax({**d, "no_such_field": 1}, TC.GPTConfig)
    with pytest.raises(TypeError):
        bridge.config_from_jax(d)            # a dict needs its class
    with pytest.raises(TypeError):
        bridge.config_from_jax(JC.LSTMConfig()
                               if hasattr(JC, "LSTMConfig") else object())


# ------------------------------- data ---------------------------------------

@pytest.fixture(scope="module")
def vas_tree(tmp_path_factory):
    """The synthetic VAS tree of tests/test_torch_port_training.py."""
    root = tmp_path_factory.mktemp("port_vas")
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


def _batches(mod, vas_tree, split, **kw):
    dm = mod.DataModule(batch_size=4, spec_dir_path=str(
        vas_tree / "features" / "*" / "melspec_10s_22050hz"),
        data_root=str(vas_tree / "data"), num_workers=1, **kw)
    dm.setup()
    loader = dm.train_dataloader() if split == "train" \
        else dm.val_dataloader()
    return list(loader)


@pytest.mark.parametrize("split, kw", [
    ("train", {}), ("valid", {}), ("train", {"seed": 5}),
    ("train", {"random_crop": True}),
    ("train", {"process_index": 1, "process_count": 2})])
def test_datamodule_yields_the_jax_packages_batches(vas_tree, split, kw):
    """Same seed, same tree: the same batches in the same order -- file
    names, labels, targets and every array bit for bit."""
    np.random.seed(0)
    jb = _batches(JD, vas_tree, split, **kw)
    np.random.seed(0)
    tb = _batches(TD, vas_tree, split, **kw)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray) and a[k].dtype.kind in "fiu":
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert list(a[k]) == list(b[k]), k


def test_native_loader_resolves_to_the_repositorys_source():
    """The port's copy finds the same native/fastloader.cpp as the JAX
    package's, and agrees with it on whether the library is available."""
    from melspec_gpt_vqvae_tpu.data import native as JN
    from melspec_gpt_vqvae_tpu_torch.data import native as TN
    assert TN._source_path() == JN._source_path()
    assert TN._source_path().endswith("native/fastloader.cpp")
    assert TN.available() == JN.available()


def test_vocab_copy_equals_the_jax_packages():
    from melspec_gpt_vqvae_tpu.data import vocab as JV
    from melspec_gpt_vqvae_tpu_torch.data import vocab as TV
    names = [n for n in dir(JV) if not n.startswith("_")]
    assert names == [n for n in dir(TV) if not n.startswith("_")]
    for n in names:
        a, b = getattr(JV, n), getattr(TV, n)
        if isinstance(a, (int, str, tuple, list, dict)):
            assert a == b, n


@pytest.mark.parametrize("n_samples", [2205, 22050])
def test_make_battery_equals_parity_checks_bit_for_bit(n_samples):
    a = parity_check.make_battery(n_samples)
    b = make_battery(n_samples)
    assert a.dtype == b.dtype == np.float32 and b.shape == (48, n_samples)
    np.testing.assert_array_equal(a, b)


# ------------------------------ device rule ---------------------------------

def test_build_pipeline_without_a_device_means_the_card():
    """No card here: ``build_pipeline()`` raises and names the way to ask
    for the CPU; ``device="cpu"`` builds."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSV.build_pipeline("vas", init_random=True,
                           override="n_layer=1,n_head=2,n_embd=32")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSV.build_pipeline("vas", init_random=True, device="cuda",
                           override="n_layer=1,n_head=2,n_embd=32")
    exp, pipe = TSV.build_pipeline("vas", init_random=True, device="cpu",
                                   override="n_layer=1,n_head=2,n_embd=32")
    assert pipe.device.type == "cpu" and exp.model.dtype == "float32"
    assert type(exp) is TC.ExperimentConfig
