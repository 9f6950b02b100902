"""PyTorch port, the int8 serving path against the JAX package on the CPU.

The quantised KV cache (int8, and int4 packed two to a byte), the int8
streamed block weights and the decode step's attention over the quantised
cache (kernel E's plain version).  The same numpy inputs and JAX parameter
trees (carried across by the port's bridge) go through both packages at
the tiny geometry of test_torch_port_models.py.  Quantisers, packing,
weight quantisation and the int8 product are bitwise equal; cache values
and scales written by prefill and decode exactly equal; logits within
1e-5; greedy tokens exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.ops import decode_attention as JD
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as TD

torch.set_num_threads(1)

GPT = GPTConfig(vocab_size=17, block_size=24, n_layer=2, n_head=2,
                n_embd=32, class_size=3)
# (cache_dtype, decode_weight_dtype) of the quantised serving variants
VARIANTS = [("int8", "auto"), ("int4", "auto"), ("int8", "int8"),
            ("auto", "int8")]


def _ids(v):
    return f"cache_{v[0]}-weights_{v[1]}"


@pytest.fixture(scope="module")
def gpt():
    """A JAX parameter tree (numpy leaves, every bias non-zero) and the
    port's copy of it."""
    rng = np.random.default_rng(0)

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = str(path[-1].key)
        if name == "w" or name == "tok_emb" or name == "class_emb":
            return x / np.sqrt(s.shape[-2] if len(s.shape) > 1 else 1)
        return 1.0 + 0.1 * x if name.endswith("_s") else 0.05 * x
    shapes = jax.eval_shape(lambda k: JG.init_gpt_params(k, GPT),
                            jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jp, bridge.gpt_params_from_jax(jp)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------- quantisers ------------------------------------

def _quant_inputs():
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 16)).astype(
        np.float32) * 3.0
    # rows whose scale is exactly 1 (absmax 127 or 7) with values on .5
    # boundaries: both packages must round half to even
    x[0, 0, 0] = np.asarray([127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5,
                             4.5, 5.5, -6.5, 3.5, 0, -1.5, 2.49, 7.5])
    x[0, 0, 1] = np.asarray([7, 2.5, -3.5, 0.5, -0.5, 1.5, 6.5, -6.5, 4.5,
                             5.5, -2.5, 3.5, 0, -1.5, 2.51, -7])
    x[1, 2, 3] = 0.0                   # all-zero row: the 1e-8 scale floor
    return x


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_kv_quantisers_match_jax_bitwise(bits):
    x = _quant_inputs()
    jq = JG._quantize_kv if bits == "int8" else JG._quantize_kv4
    tq = TG._quantize_kv if bits == "int8" else TG._quantize_kv4
    qj, sj = jq(jnp.asarray(x))
    qt, st = tq(torch.from_numpy(x))
    assert str(qt.dtype)[6:] == str(qj.dtype)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the cached (bfloat16) scales too
    np.testing.assert_array_equal(
        st.to(torch.bfloat16).float().numpy(),
        np.asarray(sj.astype(jnp.bfloat16).astype(jnp.float32)))


def test_unpack4_matches_jax():
    p = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    out = TG._unpack4(torch.from_numpy(p))
    ref = np.asarray(JG._unpack4(jnp.asarray(p)))
    assert out.dtype == torch.int32 and out.shape == (4, 8, 16)
    np.testing.assert_array_equal(out.numpy(), ref)
    # and packing then unpacking gives the quantised values back
    q, _ = TG._quantize_kv4(torch.from_numpy(_quant_inputs()))
    vals = TG._unpack4(q)
    assert vals.min() >= -7 and vals.max() <= 7


def test_block_weight_quantisation_and_int8_mm_match_jax_bitwise(gpt):
    jp, tp = gpt
    wj = JG.quantize_block_weights(jp["blocks"])
    wt = TG.quantize_block_weights(tp["blocks"])
    x = np.random.default_rng(2).standard_normal((5, 4 * 32)).astype(
        np.float32)
    x[1] = 0.0                          # an all-zero row
    for name in ("attn_qkv", "attn_proj", "mlp_up", "mlp_down"):
        assert wt[name]["q"].dtype == torch.int8
        np.testing.assert_array_equal(wt[name]["q"].numpy(),
                                      np.asarray(wj[name]["q"]))
        np.testing.assert_array_equal(wt[name]["s"].numpy(),
                                      np.asarray(wj[name]["s"]))
        # the port keeps each layer column-major (the card's int8 layout)
        assert wt[name]["q"][1].stride()[0] == 1
        k = wt[name]["q"].shape[1]
        for layer in range(GPT.n_layer):
            ref = JG._int8_mm(jnp.asarray(x[:, :k]), wj[name]["q"][layer],
                              wj[name]["s"][layer])
            out = TG._int8_mm(torch.from_numpy(x[:, :k]),
                              wt[name]["q"][layer], wt[name]["s"][layer])
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------- decode attention ------------------------------

def _pack4(vals):
    """int values in [-7, 7] (..., hd) -> the cache's nibble pairs."""
    v = vals.astype(np.int32)
    return ((v[..., 0::2] & 0xF) | ((v[..., 1::2] & 0xF) << 4)).astype(
        np.uint8)


@pytest.mark.parametrize("bits", ["int8", "int4"])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_jax(bits, scale_dtype):
    """The port's plain decode attention on its (L, B, H, T, hd) cache ==
    the JAX Pallas kernel (interpret mode) and its XLA reference on the
    same cache transposed to their (L, H, B, hd, T) layout, at the JAX
    package's own bound (tests/test_gpt.py:339-364)."""
    rng = np.random.default_rng(5)
    L, B, H, hd, T = 3, 4, 2, 8, 13
    lim = 127 if bits == "int8" else 7
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.integers(-lim, lim + 1, (L, H, B, hd, T)).astype(np.int8)
    v = rng.integers(-lim, lim + 1, (L, H, B, hd, T)).astype(np.int8)
    ks = (0.01 + rng.random((L, H, B, T))).astype(np.float32)
    vs = (0.01 + rng.random((L, H, B, T))).astype(np.float32)
    if scale_dtype == "bfloat16":     # as the cache stores them
        ks, vs = (np.array(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for a in (ks, vs))
    kt, vt = (a.transpose(0, 2, 1, 4, 3) for a in (k, v))     # (L,B,H,T,hd)
    if bits == "int4":
        kt, vt = _pack4(kt), _pack4(vt)
    kst, vst = (torch.from_numpy(a.transpose(0, 2, 1, 3)).to(
        getattr(torch, scale_dtype)) for a in (ks, vs))
    args_j = [jnp.asarray(a) for a in (q, k, v, ks, vs)]
    for layer in (0, 2):
        for pos in (0, 5, T - 1):
            got = JD.decode_attend_int8(*args_j, jnp.asarray(layer),
                                        jnp.asarray(pos), interpret=True)
            ref = JD.decode_attend_int8_xla(*args_j, jnp.asarray(layer),
                                            jnp.asarray(pos))
            out = TD.decode_attend_int8(
                torch.from_numpy(q), torch.from_numpy(kt),
                torch.from_numpy(vt), kst, vst, layer, pos)
            assert out.dtype == torch.float32 and out.shape == (B, H, hd)
            for r in (got, ref):
                np.testing.assert_allclose(out.numpy(), np.asarray(r),
                                           atol=1e-4, rtol=1e-4)


# ---------------------------- decode path -----------------------------------

def _cond(jp, tp, cls):
    return (JG.class_embed(jp, jnp.asarray(cls)),
            TG.class_embed(tp, torch.as_tensor(cls)))


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_teacher_forced_quantised_decode_matches_jax(gpt, variant):
    """Prefill of the class prompt and two given tokens, then six decode
    steps on fixed tokens: logits within 1e-5 at every step, and every
    cache value and scale written exactly equal."""
    jp, tp = gpt
    cfg = GPT.replace(cache_dtype=variant[0], decode_weight_dtype=variant[1])
    wj = wt = None
    if variant[1] == "int8":
        wj = JG.quantize_block_weights(jp["blocks"])
        wt = TG.quantize_block_weights(tp["blocks"])
    rng = np.random.default_rng(3)
    given = rng.integers(0, 17, (2, 2)).astype(np.int32)
    toks = rng.integers(0, 17, (2, 6)).astype(np.int32)
    cj, ct = _cond(jp, tp, np.asarray([1, 2]))
    jl, jc = JG.gpt_prefill(jp, cfg, JG.init_kv_cache(cfg, 2, 12),
                            jnp.asarray(given), cj)
    tl, tc = TG.gpt_prefill(tp, cfg, TG.init_kv_cache(cfg, 2, 12),
                            torch.from_numpy(given), ct)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for i in range(toks.shape[1]):
        jl, jc = JG.gpt_decode_step(jp, cfg, jc, jnp.asarray(toks[:, i]), wj)
        tl, tc = TG.gpt_decode_step(tp, cfg, tc,
                                    torch.from_numpy(toks[:, i]), wt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   err_msg=f"step {i}")
    assert tc["len"] == int(jc["len"]) == 9
    for name in set(jc) - {"len"}:
        a, b = _np(tc[name].float() if name.endswith("scale")
                   else tc[name]), np.asarray(jc[name]).astype(
            np.float32 if name.endswith("scale") else jc[name].dtype)
        if variant[0] == "auto":
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_grow_cache_pads_values_and_scales_as_jax():
    cfg = GPT.replace(cache_dtype="int4")
    rng = np.random.default_rng(4)
    cache_t = TG.init_kv_cache(cfg, 2, 5)
    for name in ("k", "v", "k_scale", "v_scale"):
        cache_t[name] = torch.from_numpy(
            rng.integers(0, 200, cache_t[name].shape)).to(cache_t[name].dtype)
    cache_j = {name: (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      if name.endswith("scale") else jnp.asarray(t.numpy()))
               for name, t in cache_t.items() if name != "len"}
    gj, gt = JG._grow_cache(cache_j, 9), TG._grow_cache(cache_t, 9)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert gt[name].shape == gj[name].shape
        np.testing.assert_array_equal(
            gt[name].float().numpy(), np.asarray(gj[name]).astype(np.float32))


@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS[:3], ids=_ids)
def test_greedy_quantised_generate_matches_jax_exactly(gpt, variant,
                                                       segments):
    jp, tp = gpt
    cfg = GPT.replace(cache_dtype=variant[0], decode_weight_dtype=variant[1])
    cls = np.asarray([0, 1, 2, 1])
    cj, ct = _cond(jp, tp, cls)
    steps = GPT.block_size - 1
    ref = JG.gpt_generate(jp, cfg, jax.random.PRNGKey(0), cj, None,
                          steps=steps, sample=False, segments=segments)
    out = TG.gpt_generate(tp, cfg, None, ct, steps=steps, sample=False,
                          segments=segments)
    assert out.shape == (4, steps)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
