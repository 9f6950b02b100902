"""The GPT-VAE decoder's ``segments`` (models/gpt_vae.py::vae_decode, the
JAX function's argument) and the XL decode bench
(scripts/torch_xl_decode_bench.py) on the CPU.

Greedy ``vae_decode`` at a toy width with an odd head count (3 heads, as
the XL preset's 23 is odd) equals the JAX package's on the same weights
for 4 (the default) and 8 cache segments, over the model-dtype cache and
over the int8 cache with int8 block weights.  The bench's ``main`` runs
at a toy geometry (its preset loader patched) and prints the JAX
script's keys plus ``peak_gib``."""

import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig, VAEConfig
from melspec_gpt_vqvae_tpu.models import gpt_vae as JV
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt_vae as TV

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASE = GPTConfig(vocab_size=13, block_size=24, n_layer=2, n_head=3,
                 n_embd=24)


@pytest.mark.parametrize("segments", [4, 8])
@pytest.mark.parametrize("quant", ["auto", "int8"])
def test_vae_decode_segments_match_jax(segments, quant):
    base = BASE.replace(cache_dtype=quant, decode_weight_dtype=quant)
    vae = VAEConfig(nz=base.n_embd)
    jc = JV.make_vae_configs(base, vae)
    tc = TV.make_vae_configs(bridge.config_from_jax(base),
                             bridge.config_from_jax(vae))
    jp = JV.init_vae_params(jax.random.PRNGKey(0), jc)
    tp = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    z = np.random.default_rng(1).standard_normal((5, 24)).astype(np.float32)
    want = np.asarray(JV.vae_decode(jp, jc, jax.random.PRNGKey(2), z,
                                    "greedy", segments=segments,
                                    use_pallas=False))
    kw = {} if segments == TV.DECODE_SEGMENTS else {"segments": segments}
    got = TV.vae_decode(tp, tc, torch.from_numpy(z), "greedy", **kw)
    assert got.shape == (5, 24)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def xl():
    spec = importlib.util.spec_from_file_location(
        "torch_xl_decode_bench", ROOT / "scripts/torch_xl_decode_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_keys():
    """The keys of the JSON line scripts/xl_decode_bench.py's ``main``
    prints."""
    tree = ast.parse((ROOT / "scripts/xl_decode_bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = [{getattr(k, "value", None) for k in n.keys}
            for n in ast.walk(main) if isinstance(n, ast.Dict)]
    return next(k for k in keys if "tokens_per_sec" in k)


def test_xl_bench_toy_run_prints_the_jax_keys(xl, monkeypatch, capsys):
    full = xl.load_preset

    def tiny(name, dataset):
        assert (name, dataset) == ("GPT_VAE", "vggsound")
        exp = full(name, dataset)
        m = exp.model
        assert (m.n_layer, m.n_head, m.n_embd, m.vocab_size) == (
            40, 23, 1472, 1024), "the XL preset moved"
        return dataclasses.replace(exp, model=m.replace(
            n_layer=2, n_head=3, n_embd=24, vocab_size=32))
    monkeypatch.setattr(xl, "load_preset", tiny)
    monkeypatch.setattr(xl, "B", 3)
    monkeypatch.setattr(xl, "SEGMENTS", 8)
    out = xl.main("cpu")
    assert set(out) == _jax_keys() | {"peak_gib"}
    assert out["batch"] == 3 and out["segments"] == 8
    assert out["steps"] == 265 and out["peak_gib"] is None
    assert out["decode_seconds"] > 0 and out["clips_per_sec"] > 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert ast.literal_eval(last.replace("null", "None")) == out


def test_xl_bench_refuses_to_run_without_a_card(xl, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        xl.main()
