"""PyTorch port, ops: each op against its JAX counterpart on the CPU.

The same numpy inputs (fixed seeds) go through the JAX reference and the
port.  On CPU tensors every kernel wrapper takes its plain PyTorch
version, which these tests hold to the JAX package's own tolerances
(tests/test_ops.py, tests/test_mel.py); the kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import MelConfig
from melspec_gpt_vqvae_tpu.ops import attention as JA
from melspec_gpt_vqvae_tpu.ops import mel as JM
from melspec_gpt_vqvae_tpu.ops import sampling as JS
from melspec_gpt_vqvae_tpu.ops import vq as JV
from melspec_gpt_vqvae_tpu_torch.ops import attention as TA
from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as TDA
from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as TL
from melspec_gpt_vqvae_tpu_torch.ops import mel as TM
from melspec_gpt_vqvae_tpu_torch.ops import mel_kernel as TMK
from melspec_gpt_vqvae_tpu_torch.ops import sampling as TS
from melspec_gpt_vqvae_tpu_torch.ops import vocoder_stack as TVS
from melspec_gpt_vqvae_tpu_torch.ops import vq as TV

torch.set_num_threads(1)

PORT_MODULES = [
    "melspec_gpt_vqvae_tpu_torch",
    "melspec_gpt_vqvae_tpu_torch._build",
    "melspec_gpt_vqvae_tpu_torch.bridge",
    "melspec_gpt_vqvae_tpu_torch.export",
    "melspec_gpt_vqvae_tpu_torch.feature_extraction",
    "melspec_gpt_vqvae_tpu_torch.feature_extraction.extract_codes",
    "melspec_gpt_vqvae_tpu_torch.feature_extraction."
    "extract_mel_spectrogram",
    "melspec_gpt_vqvae_tpu_torch.ops.attention",
    "melspec_gpt_vqvae_tpu_torch.ops.decode_attention",
    "melspec_gpt_vqvae_tpu_torch.ops.flash_attention",
    "melspec_gpt_vqvae_tpu_torch.ops.int8_linear",
    "melspec_gpt_vqvae_tpu_torch.ops.mel",
    "melspec_gpt_vqvae_tpu_torch.ops.mel_kernel",
    "melspec_gpt_vqvae_tpu_torch.ops.quant",
    "melspec_gpt_vqvae_tpu_torch.ops.sampling",
    "melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack",
    "melspec_gpt_vqvae_tpu_torch.ops.vq",
    "melspec_gpt_vqvae_tpu_torch.parallel",
    "melspec_gpt_vqvae_tpu_torch.parallel.mesh",
    "melspec_gpt_vqvae_tpu_torch.parallel.pipeline",
    "melspec_gpt_vqvae_tpu_torch.parallel.reduce",
    "melspec_gpt_vqvae_tpu_torch.models.decode_graph",
    "melspec_gpt_vqvae_tpu_torch.models.gpt",
    "melspec_gpt_vqvae_tpu_torch.models.gpt_vae",
    "melspec_gpt_vqvae_tpu_torch.models.lstm_vae",
    "melspec_gpt_vqvae_tpu_torch.models.quantized",
    "melspec_gpt_vqvae_tpu_torch.models.speculative",
    "melspec_gpt_vqvae_tpu_torch.models.vocoder",
    "melspec_gpt_vqvae_tpu_torch.models.vqvae",
    "melspec_gpt_vqvae_tpu_torch.parity_check",
    "melspec_gpt_vqvae_tpu_torch.pipeline",
    "melspec_gpt_vqvae_tpu_torch.sample",
    "melspec_gpt_vqvae_tpu_torch.serve",
    "melspec_gpt_vqvae_tpu_torch.serving",
    "melspec_gpt_vqvae_tpu_torch.train_gpt",
    "melspec_gpt_vqvae_tpu_torch.train_gpt_vae",
    "melspec_gpt_vqvae_tpu_torch.train_vqvae",
    "melspec_gpt_vqvae_tpu_torch.training",
    "melspec_gpt_vqvae_tpu_torch.training.callbacks",
    "melspec_gpt_vqvae_tpu_torch.training.checkpoint",
    "melspec_gpt_vqvae_tpu_torch.training.gpt_task",
    "melspec_gpt_vqvae_tpu_torch.training.logging",
    "melspec_gpt_vqvae_tpu_torch.training.lstm_task",
    "melspec_gpt_vqvae_tpu_torch.training.optim",
    "melspec_gpt_vqvae_tpu_torch.training.runner",
    "melspec_gpt_vqvae_tpu_torch.training.vae_task",
    "melspec_gpt_vqvae_tpu_torch.training.vqvae_task",
    "melspec_gpt_vqvae_tpu_torch.utils",
    "melspec_gpt_vqvae_tpu_torch.utils.battery",
    "melspec_gpt_vqvae_tpu_torch.utils.codes",
    "melspec_gpt_vqvae_tpu_torch.utils.convert",
    "melspec_gpt_vqvae_tpu_torch.utils.demo",
    "melspec_gpt_vqvae_tpu_torch.utils.profiling",
    "melspec_gpt_vqvae_tpu_torch.utils.vae_tools",
    "melspec_gpt_vqvae_tpu_torch.configs",
    "melspec_gpt_vqvae_tpu_torch.data",
    "melspec_gpt_vqvae_tpu_torch.data.datasets",
    "melspec_gpt_vqvae_tpu_torch.data.loader",
    "melspec_gpt_vqvae_tpu_torch.data.native",
    "melspec_gpt_vqvae_tpu_torch.data.transforms",
    "melspec_gpt_vqvae_tpu_torch.data.vocab",
]


# the port's scripts whose imports the test also loads (by path: scripts/
# is no package)
PORT_SCRIPTS = ["scripts/torch_quality_proof.py",
                "scripts/torch_int8_quality.py",
                "scripts/torch_dryrun_multiprocess.py",
                "scripts/torch_quality_vae.py",
                "scripts/torch_spec_acceptance.py",
                "scripts/torch_dist_check.py"]


def test_port_never_imports_jax():
    """The card's machine has no JAX: importing every module of the port,
    ``chip_smoke`` (import only) and the port's scripts in ``PORT_SCRIPTS``
    (their module level) in a fresh interpreter must load none
    of jax, flax, optax, orbax or yaml (the card's machine has no PyYAML
    either), and nothing of the JAX package -- not even
    its framework-free modules -- nor the repository's ``parity_check``."""
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {PORT_MODULES + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            f"for i, p in enumerate({PORT_SCRIPTS!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f's{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
            "              'yaml', 'melspec_gpt_vqvae_tpu',\n"
            "              'parity_check'))\n"
            "assert not bad, bad\n")
    root = str(Path(__file__).resolve().parent.parent)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


# ---------------------------- attention -------------------------------------

@pytest.mark.parametrize("t", [1, 7, 24])
@pytest.mark.parametrize("n_unmasked", [0, 5])
def test_attention_matches_jax(t, n_unmasked):
    rng = np.random.default_rng(10 + t)
    q, k, v = (rng.standard_normal((2, 3, t, 16)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(JA.attend_xla(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), n_unmasked))
    out = TA.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), n_unmasked)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    np.testing.assert_array_equal(TA.window_mask(t, n_unmasked),
                                  JA.window_mask(t, n_unmasked))


# ---------------------------- VQ --------------------------------------------

@pytest.mark.parametrize("k", [16, 1024])
def test_vq_nearest_index_matches_jax_exactly(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((300, 256)).astype(np.float32)
    cb = rng.standard_normal((k, 256)).astype(np.float32)
    ref = np.asarray(JV.vq_nearest_index_xla(jnp.asarray(x), jnp.asarray(cb)))
    out = TV.vq_nearest_index(torch.from_numpy(x), torch.from_numpy(cb))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_vq_lookup_matches_jax():
    cb = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.asarray([[0, 3], [2, 1]], np.int32)
    ref = np.asarray(JV.vq_lookup(jnp.asarray(idx), jnp.asarray(cb)))
    out = TV.vq_lookup(torch.from_numpy(idx), torch.from_numpy(cb))
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------- mel -------------------------------------------

def test_mel_filterbank_and_window_match_jax():
    np.testing.assert_allclose(TM.mel_filterbank(), JM.mel_filterbank(),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(TM._hann(1024), JM._hann(1024))


def test_waveform_to_mel_matches_jax_on_a_full_clip():
    cfg = MelConfig()
    t = np.arange(cfg.clip_samples) / cfg.sample_rate
    wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
           + 0.05 * np.random.default_rng(5).standard_normal(t.size)
           ).astype(np.float32)[None]
    ref = np.asarray(JM.waveform_to_mel(jnp.asarray(wav), cfg))
    out = TM.waveform_to_mel(torch.from_numpy(wav), cfg)
    assert out.shape == (1, 80, 860)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_pad_or_trim_matches_jax():
    x = np.arange(10, dtype=np.float32)[None]
    for n in (6, 10, 14):
        np.testing.assert_array_equal(
            TM.pad_or_trim(torch.from_numpy(x), n).numpy(),
            np.asarray(JM.pad_or_trim(jnp.asarray(x), n)))


# ---------------------------- sampling --------------------------------------

def test_sampling_filters_match_jax():
    logits = np.random.default_rng(3).standard_normal((4, 17)).astype(
        np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    np.testing.assert_array_equal(TS.top_k_logits(tl, 5).numpy(),
                                  np.asarray(JS.top_k_logits(jl, 5)))
    np.testing.assert_array_equal(TS.top_p_logits(tl, 0.7).numpy(),
                                  np.asarray(JS.top_p_logits(jl, 0.7)))
    for kw in ({}, {"top_k": 5}, {"top_p": 0.8, "temperature": 0.7},
               {"top_k": 100, "top_p": 0.5}):
        ref = np.asarray(JS.filtered_log_probs(jl, **kw))
        out = TS.filtered_log_probs(tl, **kw).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(out[fin], ref[fin], atol=1e-6)


def test_greedy_matches_jax_and_samples_stay_in_the_filtered_support():
    logits = np.random.default_rng(4).standard_normal((64, 17)).astype(
        np.float32)
    greedy = TS.sample_logits(None, torch.from_numpy(logits), sample=False)
    ref = np.asarray(JS.sample_logits(None, jnp.asarray(logits),
                                      sample=False))
    np.testing.assert_array_equal(greedy.numpy(), ref)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([TS.sample_logits(g, torch.from_numpy(logits),
                                          top_k=3) for _ in range(20)])
    top3 = np.argsort(-logits, axis=1)[:, :3]
    for row in range(64):
        assert set(draws[:, row].tolist()) <= set(top3[row].tolist())


# ---------------------------- wrappers on CPU tensors -----------------------

def _wrapper_cases():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    wav = torch.from_numpy(rng.standard_normal((1, 4000)).astype(np.float32))
    cfg = MelConfig(clip_samples=4000, trim_len=12)
    from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANResnetBlock
    torch.manual_seed(0)
    blocks = [MelGANResnetBlock(4, 3 ** j) for j in range(3)]
    h = torch.from_numpy(rng.standard_normal((2, 4, 40)).astype(np.float32))
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 1, 2, 6, 8)).astype(
        np.int8))
    ks = torch.from_numpy(rng.random((2, 1, 2, 6)).astype(np.float32)).to(
        torch.bfloat16)
    x64 = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (8, 64)).astype(
        np.int8)).t()
    ws, bias = (torch.from_numpy(rng.random(8).astype(np.float32))
                for _ in range(2))
    return {
        "decode_attend_int8": (TDA.decode_attend_int8,
                               (q[:, :, 0], kq, kq, ks, ks, 1, 3),
                               TDA.decode_attend_int8_xla),
        "attend": (TA.attend, (q, q, q, 2), TA.attend_xla),
        "vq_nearest_index": (TV.vq_nearest_index, (x, cb),
                             TV.vq_nearest_index_xla),
        "waveform_to_mel_fused": (TMK.waveform_to_mel_fused, (wav, cfg),
                                  TM.waveform_to_mel),
        "fused_resblock_stack": (TVS.fused_resblock_stack, (h, blocks),
                                 TVS.resblock_stack),
        "int8_linear_splitk": (TL.int8_linear_splitk, (x64, wq, ws, bias),
                               TL.int8_linear_splitk_xla),
    }


@pytest.mark.parametrize("name", ["attend", "decode_attend_int8",
                                  "vq_nearest_index",
                                  "waveform_to_mel_fused",
                                  "fused_resblock_stack",
                                  "int8_linear_splitk"])
def test_wrapper_takes_plain_version_on_cpu(name):
    """On CPU tensors a kernel wrapper returns exactly its plain version's
    result and does not count a launch."""
    wrapper, args, plain = _wrapper_cases()[name]
    before = wrapper.launches
    with torch.no_grad():
        out = wrapper(*args)
        ref = plain(*args)
    assert wrapper.launches == before == 0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_wrapper_refuses_mixed_devices():
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError):
        TA.attend(q, q.to("meta"), q)
