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
                                           VQVAEConfig, load_preset,
                                           parse_overrides)
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


def tiny_pipelines():
    """(exp, JAX pipeline, port pipeline) of the tiny round trip on the
    same weights."""
    exp = _tiny_exp()
    gp = jax.tree_util.tree_map(
        np.asarray, init_gpt_params(jax.random.PRNGKey(0), exp.model))
    vp = flax_params(JVQModel(exp.vqvae), jnp.zeros((1, 4, 8, 1)), 1)
    op = flax_params(JMelGAN(exp.vocoder), jnp.zeros((1, 8, 4)), 2)
    jpipe = JPipeline(exp, gp, vp, op, segments=2, chunk=3, bf16=False)
    texp = bridge.config_from_jax(exp)   # each package gets its own classes
    tpipe = TP.GenerationPipeline(
        texp, bridge.gpt_params_from_jax(gp),
        bridge.load_vqvae(vp, texp.vqvae),
        bridge.load_melgan(op, texp.vocoder), segments=2, chunk=3,
        bf16=False)
    return exp, jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines()


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


# the int8 decode stage is ported (tests/test_torch_port_quantized.py) and
# so is mesh serving (tests/test_torch_port_serving_mesh.py); a mesh that
# is not the world's, here one process without a launcher, is refused
@pytest.mark.parametrize("kw", [{"mesh_spec": "data=2"},
                                {"mesh_spec": "model=2"}])
def test_build_pipeline_refuses_what_is_not_ported(kw):
    with pytest.raises(ValueError, match="world size is 1"):
        build_on_cpu("vas", init_random=True, **kw)


def build_on_cpu(*args, **kw):
    """``build_pipeline`` asked for the CPU: with no device it means the
    card and raises here."""
    return TSV.build_pipeline(*args, device="cpu", **kw)


# a one-layer, 32-wide GPT in front of the VAS VQ-VAE and MelGAN
SMALL = "n_layer=1,n_head=2,n_embd=32"


@pytest.mark.parametrize("kw, cache, weights", [
    ({}, "auto", "auto"),                       # the CPU's defaults
    ({"kv_cache": "int8"}, "int8", "auto"),
    ({"int8_weights": 1}, "auto", "int8"),
    ({"kv_cache": "int4", "int8_weights": 1}, "int4", "int8"),
])
def test_build_pipeline_serves_each_cache_and_weight_dtype(kw, cache,
                                                           weights):
    """build_pipeline on the CPU takes the JAX package's defaults there
    (float32, no quantisation) and builds every quantised variant; greedy
    decoding through it equals gpt_generate on its weights and config."""
    exp, pipe = build_on_cpu("vas", init_random=True, override=SMALL,
                             seed=3, **kw)
    m = exp.model
    assert (m.dtype, m.cache_dtype, m.decode_weight_dtype) == (
        "float32", cache, weights)
    assert pipe.device.type == "cpu" and pipe.draft_params is None
    toks, stats = pipe.generate_tokens([0, 5], None, sample=False)
    assert toks.shape == (2, 265) and stats == {}
    assert 0 <= int(toks.min()) and int(toks.max()) < m.vocab_size
    from melspec_gpt_vqvae_tpu_torch.models.gpt import (class_embed,
                                                        gpt_generate)
    ref = gpt_generate(pipe.gpt_params, m, None,
                       class_embed(pipe.gpt_params, torch.tensor([0, 5])),
                       steps=265, sample=False, segments=pipe.segments)
    torch.testing.assert_close(toks, ref, rtol=0, atol=0)


def test_build_pipeline_with_a_random_draft():
    """draft_random builds a draft from the target's overrides plus its
    own, seeded from seed + 1; greedy speculative tokens equal the plain
    pipeline's on the same target weights."""
    exp, spec = build_on_cpu("vas", init_random=True, override=SMALL,
                             seed=3, kv_cache="int8",
                             draft_random="n_layer=1,n_embd=16",
                             gamma=3)
    dcfg = spec.draft_cfg
    assert (dcfg.n_layer, dcfg.n_embd, dcfg.n_head) == (1, 16, 2)
    assert (dcfg.cache_dtype, dcfg.dtype) == ("int8", "float32")
    assert spec.gamma == 3 and spec.draft_params["tok_emb"].shape == (128, 16)
    _, plain = build_on_cpu("vas", init_random=True, override=SMALL,
                            seed=3, kv_cache="int8")
    toks, stats = spec.generate_tokens([1, 2], None, sample=False)
    ref, _ = plain.generate_tokens([1, 2], None, sample=False)
    torch.testing.assert_close(toks, ref, rtol=0, atol=0)
    assert stats["rounds"] >= 1 and stats["drafted"] == 3 * stats["rounds"]
    with pytest.raises(ValueError, match="vocab_size"):
        build_on_cpu("vas", init_random=True, override=SMALL,
                     draft_random="n_layer=1",
                     draft_override="vocab_size=64")
    with pytest.raises(ValueError, match="draft_override"):
        build_on_cpu("vas", init_random=True, override=SMALL,
                     draft_override="n_layer=1")


def test_build_pipeline_carries_jax_weights_and_draft():
    """params= carries the JAX package's trees across, the draft's
    included (``params["draft"]``, config from the overrides), and greedy
    speculative tokens equal greedy tokens without the draft."""
    exp = load_preset("GPT", "vas", **parse_overrides(SMALL))
    d_model = exp.model.replace(n_layer=1, n_embd=16)
    gpt, draft = (jax.tree_util.tree_map(np.asarray, init_gpt_params(
        jax.random.PRNGKey(s), m)) for s, m in ((0, exp.model), (1, d_model)))
    params = {"gpt": gpt,
              "vqvae": flax_params(JVQModel(exp.vqvae),
                                   jnp.zeros((1, 80, 848, 1)), 1),
              "vocoder": flax_params(JMelGAN(exp.vocoder),
                                     jnp.zeros((1, 848, 80)), 2)}
    _, plain = build_on_cpu("vas", params=params, override=SMALL)
    _, spec = build_on_cpu("vas", params={**params, "draft": draft},
                           override=SMALL,
                           draft_override="n_layer=1,n_embd=16")
    np.testing.assert_array_equal(spec.draft_params["head"]["w"].numpy(),
                                  draft["head"]["w"])
    np.testing.assert_array_equal(plain.gpt_params["tok_emb"].numpy(),
                                  gpt["tok_emb"])
    toks, stats = spec.generate_tokens([2, 7], None, sample=False)
    ref, _ = plain.generate_tokens([2, 7], None, sample=False)
    torch.testing.assert_close(toks, ref, rtol=0, atol=0)
    assert stats["rounds"] >= 1


def test_wav_bytes_match_jax():
    wav = np.sin(np.linspace(0, 40, 500)).astype(np.float32) * 1.2
    assert TP.wav_bytes(wav) == j_wav_bytes(wav)
