"""PyTorch port, the generation round trip against the JAX package.

Greedy ``GenerationPipeline.generate`` (GPT decode -> VQ decode -> MelGAN)
and ``tokenize`` (mel -> crop -> VQ encode -> nearest index, as
bench.py:86-103 times it) on the same weights: tokens and codes exactly
equal, spectrograms and waveforms within 1e-5.  Plus the serving layer's
padding, seeding and refusals.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (ExperimentConfig, GPTConfig,
                                           MelConfig, VocoderConfig,
                                           VQVAEConfig)
from melspec_gpt_vqvae_tpu.models.gpt import init_gpt_params
from melspec_gpt_vqvae_tpu.models.vocoder import MelGANGenerator as JMelGAN
from melspec_gpt_vqvae_tpu.models.vqvae import VQModel as JVQModel
from melspec_gpt_vqvae_tpu.ops.mel import waveform_to_mel
from melspec_gpt_vqvae_tpu.pipeline import GenerationPipeline as JPipeline
from melspec_gpt_vqvae_tpu.pipeline import wav_bytes as j_wav_bytes
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import pipeline as TP
from melspec_gpt_vqvae_tpu_torch import serving as TSV

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from parity_check import make_battery  # noqa: E402

torch.set_num_threads(1)


def flax_params(module, x, seed):
    """Random numpy parameters of a flax module's tree (shapes from
    ``jax.eval_shape``, which compiles nothing): kernels scaled by fan-in,
    a unit-normal codebook, whose entries lie far apart against rounding."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = str(path[-1].key)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "embedding":
            return x
        return 1.0 + 0.1 * x if name == "scale" else 0.1 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _tiny_exp():
    vq = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8,
                     ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(), z_channels=8, resolution=8,
                     code_h=2, code_w=4)
    gpt = GPTConfig(vocab_size=16, block_size=9, n_layer=2, n_head=2,
                    n_embd=16, class_size=4)
    voc = VocoderConfig(n_mel_channels=4, ngf=4, n_residual_layers=1,
                        ratios=(2, 2))
    return dataclasses.replace(ExperimentConfig(model=gpt), vqvae=vq,
                               vocoder=voc)


@pytest.fixture(scope="module")
def pipes():
    exp = _tiny_exp()
    gp = jax.tree_util.tree_map(
        np.asarray, init_gpt_params(jax.random.PRNGKey(0), exp.model))
    vp = flax_params(JVQModel(exp.vqvae), jnp.zeros((1, 4, 8, 1)), 1)
    op = flax_params(JMelGAN(exp.vocoder), jnp.zeros((1, 8, 4)), 2)
    jpipe = JPipeline(exp, gp, vp, op, segments=2, chunk=3, bf16=False)
    tpipe = TP.GenerationPipeline(
        exp, bridge.gpt_params_from_jax(gp),
        bridge.load_vqvae(vp, exp.vqvae),
        bridge.load_melgan(op, exp.vocoder), segments=2, chunk=3, bf16=False)
    return exp, jpipe, tpipe


def test_greedy_generation_round_trip_matches_jax(pipes):
    _, jpipe, tpipe = pipes
    cls = np.asarray([0, 1, 2, 3, 1], np.int32)
    ref = jpipe.generate(cls, jax.random.PRNGKey(7), sample=False)
    out = tpipe.generate(cls, None, sample=False)
    assert out["tokens"].dtype == np.int32
    assert out["tokens"].shape == (5, 8) and out["specs"].shape == (5, 4, 8)
    assert out["wavs"].shape == (5, 32)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    np.testing.assert_allclose(out["specs"], ref["specs"], atol=1e-5)
    np.testing.assert_allclose(out["wavs"], ref["wavs"], atol=1e-5)


def test_tokenize_matches_jax_bench_path():
    """bench.py:86-103 on two 10 s noise clips of the parity battery,
    through a narrow VQ-VAE at the full 80 x 848 input and 5 x 53 code
    grid.  The two encoders differ by ~1e-5 in float32 (summation order,
    and flax's one-pass GroupNorm variance, which near-constant inputs such
    as the battery's clipped pure tones turn into large differences); the
    weights' seed leaves every latent's best and second-best codebook
    distances >= 2.5e-3 apart, so the codes must agree exactly."""
    vcfg = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8,
                       ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
                       attn_resolutions=(53,), z_channels=8)
    mcfg = MelConfig()
    jvq = JVQModel(vcfg)
    vp = flax_params(jvq, jnp.zeros((1, 80, 848, 1)), 7)
    wav = make_battery(mcfg.clip_samples)[[41, 44]]

    @jax.jit
    def bench_tokenize(vp, wav):          # bench.py:86-103, float32
        mel = waveform_to_mel(wav, mcfg)[:, :, 6:854]
        grid = jvq.apply({"params": vp}, (2.0 * mel - 1.0)[..., None],
                         method="encode_to_indices")
        return jnp.swapaxes(grid, 1, 2).reshape(grid.shape[0], -1)

    ref = np.asarray(bench_tokenize(vp, wav))
    codes = TP.tokenize(bridge.load_vqvae(vp, vcfg),
                        torch.from_numpy(wav), mcfg)
    assert codes.shape == (2, 265)
    np.testing.assert_array_equal(codes.numpy(), ref)


def test_service_pads_seeds_and_splits(pipes):
    exp, _, tpipe = pipes
    svc = TSV.GenerationService(exp, tpipe, batch=2, seed=1)
    a = svc.generate([0, 3, 1], seed=11, top_k=5)
    b = svc.generate([0, 3, 1], seed=11, top_k=5)
    assert a["tokens"].shape == (3, 8) and a["wavs"].shape == (3, 32)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    greedy = svc.generate([2, 1], sample=False)
    direct = tpipe.generate([2, 1], None, sample=False)
    np.testing.assert_array_equal(greedy["tokens"], direct["tokens"])
    assert svc.requests == 3
    with pytest.raises(ValueError):
        svc.generate([4])
    with pytest.raises(ValueError):
        svc.generate([0], temperature=0.0)


def test_service_sheds_load_past_the_queue_bound(pipes):
    exp, _, tpipe = pipes
    svc = TSV.GenerationService(exp, tpipe, batch=1, max_queue=1)
    svc._pending = 1          # one request already in flight
    with pytest.raises(TSV.ServiceOverloaded):
        svc.generate([0])
    assert svc.shed == 1


@pytest.mark.parametrize("kw", [{"kv_cache": "int8"}, {"int8_weights": 1},
                                {"mesh_spec": "data=2"},
                                {"draft_random": "n_layer=1"},
                                {"int8_decode": True}])
def test_build_pipeline_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        TSV.build_pipeline("vas", init_random=True, **kw)
    with pytest.raises(NotImplementedError):
        TSV.serve()


def test_wav_bytes_match_jax():
    wav = np.sin(np.linspace(0, 40, 500)).astype(np.float32) * 1.2
    assert TP.wav_bytes(wav) == j_wav_bytes(wav)
