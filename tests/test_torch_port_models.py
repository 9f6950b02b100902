"""PyTorch port, models: GPT, VQ-VAE and MelGAN against the JAX package.

Random JAX parameter trees (numpy, fixed seeds) are carried across by the
port's bridge; the same numpy inputs go through both packages at tiny widths
(GPT as tests/test_gpt.py, VQ-VAE as tests/test_convert.py, MelGAN as
tests/test_callbacks.py plus a 3-block stage for dilations 1, 3, 9).
Logits, decodes and waveforms are held at 1e-5; code indices and greedy
tokens exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig, VocoderConfig, VQVAEConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.models.vocoder import MelGANGenerator as JMelGAN
from melspec_gpt_vqvae_tpu.models.vqvae import VQModel as JVQModel
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel

torch.set_num_threads(1)

GPT = GPTConfig(vocab_size=17, block_size=24, n_layer=2, n_head=2,
                n_embd=32, class_size=3)
VQ = VQVAEConfig(num_embeddings=8, embedding_dim=4, ch=32, ch_mult=(1, 2),
                 num_res_blocks=1, attn_resolutions=(8,), resolution=16,
                 z_channels=4)


def random_params(shapes, seed):
    """Random numpy leaves for a JAX parameter tree of shapes (from
    ``jax.eval_shape`` of the init, which costs no XLA compile): kernels
    scaled by fan-in, norm scales near 1, every bias and embedding non-zero
    so the bridge is exercised leaf for leaf."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale" or name.endswith("_s"):
            return 1.0 + 0.1 * x
        return x if name == "embedding" else 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_params(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return random_params(shapes["params"], seed)


@pytest.fixture(scope="module")
def gpt():
    jp = random_params(jax.eval_shape(
        lambda k: JG.init_gpt_params(k, GPT), jax.random.PRNGKey(0)), 0)
    return jp, bridge.gpt_params_from_jax(jp)


@pytest.fixture(scope="module")
def vq():
    jp = flax_params(JVQModel(VQ), jnp.zeros((1, 16, 16, 1)), 1)
    return jp, bridge.load_vqvae(jp, VQ)


def melgan_params(cfg, seed):
    return flax_params(JMelGAN(cfg), jnp.zeros((1, 10, 8)), seed)


def _cond(params_j, params_t, cls):
    cj = JG.class_embed(params_j, jnp.asarray(cls))
    ct = TG.class_embed(params_t, torch.as_tensor(cls))
    return cj, ct


# ---------------------------- bridge ----------------------------------------

def _jax_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_bridge_gpt_leaf_by_leaf(gpt):
    jp, tp = gpt
    for path, leaf in _jax_leaves(jp):
        t = tp
        for key in path:
            t = t[key.key]
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    n_port = len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: 0, tp,
                               is_leaf=lambda x: isinstance(x, torch.Tensor))))
    assert n_port == len(_jax_leaves(jp))


@pytest.mark.parametrize("which", ["vqvae", "melgan"])
def test_bridge_conv_nets_leaf_by_leaf(which, vq):
    """Every flax leaf maps to exactly one port tensor of the right shape,
    and the port module has no tensor left over."""
    if which == "vqvae":
        jp, model = vq[0], VQModel(VQ)
    else:
        cfg = VocoderConfig(n_mel_channels=8, ngf=4, n_residual_layers=3)
        jp = melgan_params(cfg, 2)
        from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANGenerator
        model = MelGANGenerator(cfg)
    sd = bridge.conv_state_dict(jp)
    assert len(sd) == len(_jax_leaves(jp))
    target = model.state_dict()
    assert set(sd) == set(target)
    for name, t in sd.items():
        assert t.shape == target[name].shape, name


# ---------------------------- GPT -------------------------------------------

def test_gpt_apply_logits_match_jax(gpt):
    jp, tp = gpt
    idx = np.random.default_rng(1).integers(0, 17, (3, 12)).astype(np.int32)
    cj, ct = _cond(jp, tp, np.asarray([0, 2, 1]))
    ref, _ = JG.gpt_apply(jp, GPT, jnp.asarray(idx), cj)
    out = TG.gpt_apply(tp, GPT, torch.from_numpy(idx), ct)
    assert out.shape == (3, 13, 17)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_prefill_and_teacher_forced_decode_match_jax(gpt):
    jp, tp = gpt
    toks = np.random.default_rng(2).integers(0, 17, (2, 6)).astype(np.int32)
    cj, ct = _cond(jp, tp, np.asarray([1, 2]))
    jl, jc = JG.gpt_prefill(jp, GPT, JG.init_kv_cache(GPT, 2), None, cj)
    tl, tc = TG.gpt_prefill(tp, GPT, TG.init_kv_cache(GPT, 2), None, ct)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for i in range(toks.shape[1]):
        jl, jc = JG.gpt_decode_step(jp, GPT, jc, jnp.asarray(toks[:, i]))
        tl, tc = TG.gpt_decode_step(tp, GPT, tc, torch.from_numpy(toks[:, i]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert tc["len"] == int(jc["len"]) == 7
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5)


@pytest.mark.parametrize("segments", [1, 3])
def test_greedy_generate_matches_jax_exactly(gpt, segments):
    jp, tp = gpt
    cls = np.asarray([0, 1, 2, 1])
    cj, ct = _cond(jp, tp, cls)
    steps = GPT.block_size - 1
    ref = JG.gpt_generate(jp, GPT, jax.random.PRNGKey(0), cj, None,
                          steps=steps, sample=False, segments=segments)
    out = TG.gpt_generate(tp, GPT, None, ct, steps=steps, sample=False,
                          segments=segments)
    assert out.shape == (4, steps)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_segmented_generate_equals_one_segment(gpt):
    _, tp = gpt
    ct = TG.class_embed(tp, torch.as_tensor([0, 2]))
    given = torch.as_tensor([[3, 4], [5, 6]])
    outs = [TG.gpt_generate(tp, GPT, torch.Generator().manual_seed(7), ct,
                            given, steps=10, top_k=5, segments=s)
            for s in (1, 4)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert outs[0].shape == (2, 12)


@pytest.mark.parametrize("cache_dtype", ["auto", "int8", "int4"])
def test_init_kv_cache_matches_jax(cache_dtype):
    cfg = GPT.replace(cache_dtype=cache_dtype)
    ref = JG.init_kv_cache(cfg, 3, max_len=10)
    out = TG.init_kv_cache(cfg, 3, max_len=10)
    assert set(out) == set(ref) and out["len"] == int(ref["len"]) == 0
    for name in set(ref) - {"len"}:
        assert out[name].shape == ref[name].shape, name
        assert str(out[name].dtype)[6:] == str(ref[name].dtype), name
        assert not out[name].any()


def test_unknown_cache_dtype_is_refused():
    with pytest.raises(ValueError, match="cache_dtype"):
        TG.init_kv_cache(GPT.replace(cache_dtype="fp8"), 1)


# ---------------------------- VQ-VAE ----------------------------------------

def test_vqvae_encode_to_indices_matches_jax_exactly(vq):
    jp, model = vq
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    ref = jax.jit(functools.partial(JVQModel(VQ).apply,
                                    method="encode_to_indices"))(
        {"params": jp}, x)
    with torch.no_grad():
        out = model.encode_to_indices(torch.from_numpy(x))
    assert out.shape == (2, 8, 8) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_vqvae_decode_code_matches_jax(vq):
    jp, model = vq
    grid = np.random.default_rng(4).integers(0, 8, (2, 8, 8)).astype(np.int32)
    decode = jax.jit(functools.partial(JVQModel(VQ).apply,
                                       method="decode_code"))
    ref = decode({"params": jp}, grid)
    with torch.no_grad():
        out = model.decode_code(torch.from_numpy(grid))
    assert out.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------- MelGAN ----------------------------------------

@pytest.mark.parametrize("n_res", [1, 3])
def test_melgan_matches_jax(n_res):
    cfg = VocoderConfig(n_mel_channels=8, ngf=4, n_residual_layers=n_res)
    jp = melgan_params(cfg, 5)
    mel = np.random.default_rng(6).uniform(0, 1, (2, 10, 8)).astype(
        np.float32)
    ref = jax.jit(JMelGAN(cfg).apply)({"params": jp}, mel)
    model = bridge.load_melgan(jp, cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(mel))
    assert out.shape == (2, 2560)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_random_init_is_seeded():
    a = bridge.init_conv_net_(VQModel(VQ), torch.Generator().manual_seed(3))
    b = bridge.init_conv_net_(VQModel(VQ), torch.Generator().manual_seed(3))
    for (na, ta), (_, tb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        torch.testing.assert_close(ta, tb, rtol=0, atol=0, msg=na)
    k = VQ.num_embeddings
    assert a.quantize.embedding.abs().max() <= 1.0 / k
