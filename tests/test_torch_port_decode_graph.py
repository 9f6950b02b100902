"""PyTorch port, the decode loop's captured program, on the CPU.

On the card a token's sampling and decode step are one CUDA graph, replayed
once a token (models/decode_graph.py).  What is recorded is the
device-position step: the position is a one-element tensor that the step
advances in place, the new cache slot is written by ``index_copy_`` (or,
over a quantised cache, by kernel E's launch, whose plain version runs
here), the int8 products go through ops/int8_linear.py.  On the CPU the
same step runs eagerly (``graph=True``), and these tests hold it against the
eager loop (``graph=False``) and against the JAX package: greedy and sampled
tokens exactly, on every cache kind, with and without int8 weights, one
segment and several, with given tokens, and under speculative decoding.
Beside it: the plain version of kernel E's fused write against
``_write_kv`` bit for bit, the kernel's split rule against
``choose_splits``, the int8 product's plain kernels against ``_int8_mm``
bitwise, the cached int8 weights, and the holder's launch accounting.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import decode_graph as DG
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.models import speculative as TS
from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as TD
from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as TL

torch.set_num_threads(1)

GPT = GPTConfig(vocab_size=24, block_size=40, n_layer=2, n_head=4,
                n_embd=64, class_size=3)
STEPS = 30
CACHES = ["auto", "int8", "int4"]
WEIGHTS = ["auto", "int8"]
CLS = np.asarray([0, 1, 2, 1])
GIVEN = np.asarray([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]])


@pytest.fixture(scope="module")
def gpt():
    """A JAX parameter tree (numpy leaves, every bias and the position
    embedding non-zero) and the port's copy of it."""
    rng = np.random.default_rng(0)

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = str(path[-1].key)
        if name in ("w", "tok_emb", "class_emb"):
            return x / np.sqrt(s.shape[-2] if len(s.shape) > 1 else 1)
        return 1.0 + 0.1 * x if name.endswith("_s") else 0.05 * x
    shapes = jax.eval_shape(lambda k: JG.init_gpt_params(k, GPT),
                            jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jp, bridge.gpt_params_from_jax(jp)


def _cfg(cache, weights, **kw):
    return GPT.replace(cache_dtype=cache, decode_weight_dtype=weights, **kw)


def _cond(jp, tp, cls=CLS):
    return (JG.class_embed(jp, jnp.asarray(cls)),
            TG.class_embed(tp, torch.as_tensor(cls)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------- (a) device position against the eager loop -------------

@pytest.mark.parametrize("given", [False, True], ids=["prompt", "given"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("cache", CACHES)
def test_device_position_greedy_equals_eager_loop(gpt, cache, weights,
                                                  segments, given):
    _, tp = gpt
    cfg = _cfg(cache, weights)
    ct = _cond(*gpt)[1]
    gv = torch.from_numpy(GIVEN) if given else None
    kw = dict(steps=STEPS, sample=False, segments=segments)
    eager = TG.gpt_generate(tp, cfg, None, ct, gv, graph=False, **kw)
    dev = TG.gpt_generate(tp, cfg, None, ct, gv, graph=True, **kw)
    assert dev.shape == (4, STEPS + (3 if given else 0))
    assert torch.equal(dev, eager)


@pytest.mark.parametrize("cache", CACHES)
def test_device_position_step_leaves_the_eager_steps_cache(gpt, cache):
    """Teacher-forced: the same tokens through eager steps (host position)
    and device-position steps give equal logits and equal cache bytes and
    scales at every step."""
    _, tp = gpt
    cfg = _cfg(cache, "int8")
    ct = _cond(*gpt)[1]
    wq = TG.quantize_block_weights(tp["blocks"])
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 24, (4, 9)))
    caches = []
    for on_device in (False, True):
        cache_ = TG.init_kv_cache(cfg, 4, max_len=12)
        _, cache_ = TG.gpt_prefill(tp, cfg, cache_, None, ct)
        if on_device:
            cache_["len"] = torch.tensor([cache_["len"]])
        caches.append(cache_)
    for i in range(toks.shape[1]):
        le, ce = TG.gpt_decode_step(tp, cfg, caches[0], toks[:, i], wq)
        ld, cd = TG.gpt_decode_step(tp, cfg, caches[1], toks[:, i], wq)
        assert torch.equal(le, ld), i
        assert int(cd["len"]) == ce["len"] == 2 + i
        for name in ce:
            if name != "len":
                assert torch.equal(ce[name], cd[name]), (i, name)


# ------------------- (b) against the JAX package ----------------------------

@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("cache,weights", [("auto", "auto"), ("int8", "auto"),
                                           ("int4", "auto"),
                                           ("int8", "int8")])
def test_device_position_greedy_matches_jax_exactly(gpt, cache, weights,
                                                    segments):
    jp, tp = gpt
    cfg = _cfg(cache, weights)
    cj, ct = _cond(jp, tp)
    ref = JG.gpt_generate(jp, cfg, jax.random.PRNGKey(0), cj, None,
                          steps=STEPS, sample=False, segments=segments)
    out = TG.gpt_generate(tp, cfg, None, ct, steps=STEPS, sample=False,
                          segments=segments, graph=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ------------------- (c) sampled tokens -------------------------------------

@pytest.mark.parametrize("skw", [dict(top_k=5), dict(top_p=0.8),
                                 dict(temperature=1.3)],
                         ids=["top_k", "top_p", "temperature"])
@pytest.mark.parametrize("cache,weights", [("auto", "auto"),
                                           ("int8", "int8"),
                                           ("int4", "auto")])
def test_device_position_sampled_tokens_equal_eager_loop(gpt, cache, weights,
                                                         skw):
    _, tp = gpt
    cfg = _cfg(cache, weights)
    ct = _cond(*gpt)[1]
    kw = dict(steps=STEPS, sample=True, segments=3, **skw)
    eager = TG.gpt_generate(tp, cfg, _gen(7), ct, graph=False, **kw)
    dev = TG.gpt_generate(tp, cfg, _gen(7), ct, graph=True, **kw)
    other = TG.gpt_generate(tp, cfg, _gen(8), ct, graph=True, **kw)
    assert torch.equal(dev, eager)
    assert not torch.equal(dev, other)


def test_a_holder_keeps_sessions_across_calls_and_evicts_the_oldest(gpt):
    """The same shape reuses its session (and gives the same tokens); a new
    shape builds one; beyond ``max_sessions`` the one used longest ago
    goes."""
    _, tp = gpt
    cfg = _cfg("int8", "int8")
    ct = _cond(*gpt)[1]
    holder = DG.DecodeGraphs(max_sessions=2)
    kw = dict(steps=STEPS, sample=False, graph=holder)
    wq = TG.quantize_block_weights(tp["blocks"])
    a = TG.gpt_generate(tp, cfg, None, ct, wq=wq, **kw)
    first = holder.last
    b = TG.gpt_generate(tp, cfg, None, ct, wq=wq, **kw)
    assert holder.captures == 1 and holder.last is first
    assert torch.equal(a, b)
    TG.gpt_generate(tp, cfg, None, ct, wq=wq, **{**kw, "steps": STEPS - 1})
    TG.gpt_generate(tp, cfg, None, ct[:2], wq=wq, **kw)
    assert holder.captures == 3 and len(holder) == 2
    TG.gpt_generate(tp, cfg, None, ct, wq=wq, **kw)    # evicted: built anew
    assert holder.captures == 4 and holder.last is not first
    # a second request through a kept session starts from a clean state
    assert torch.equal(TG.gpt_generate(tp, cfg, None, ct, wq=wq, **kw), a)
    assert holder.captures == 4


# ------------------- (d) speculative decoding --------------------------------

@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["small_draft", "target_as_draft"])
@pytest.mark.parametrize("cache,weights", [("auto", "auto"),
                                           ("int8", "int8"),
                                           ("int4", "auto")])
def test_speculative_on_device_positions(gpt, cache, weights, self_draft):
    """Through the device-position draft step and target chunk: greedy
    tokens equal ``gpt_generate``'s (and so the JAX package's), tokens and
    stats equal the eager rounds', greedy and sampled, with given tokens.
    A small random draft is mostly rejected; the target as its own draft
    is always accepted (the bonus token, the longest rewind)."""
    jp, tp = gpt
    cfg = _cfg(cache, weights)
    dcfg = cfg if self_draft else cfg.replace(n_layer=1)
    draft = tp if self_draft else TG.init_gpt_params(dcfg, _gen(1))
    cj, ct = _cond(jp, tp)
    dct = TG.class_embed(draft, torch.as_tensor(CLS))
    gv = torch.from_numpy(GIVEN[:, :2])
    ref_j = JG.gpt_generate(jp, cfg, jax.random.PRNGKey(0), cj,
                            jnp.asarray(GIVEN[:, :2]), steps=STEPS,
                            sample=False)
    for sample in (False, True):
        kw = dict(steps=STEPS, gamma=3, sample=sample,
                  top_k=6 if sample else None)
        eager, es = TS.gpt_speculative_generate(
            tp, cfg, draft, dcfg, _gen(5), ct, dct, gv, graph=False, **kw)
        dev, ds = TS.gpt_speculative_generate(
            tp, cfg, draft, dcfg, _gen(5), ct, dct, gv, graph=True, **kw)
        assert torch.equal(dev, eager) and ds == es
        if not sample:
            np.testing.assert_array_equal(dev.numpy(), np.asarray(ref_j))
            if self_draft:
                assert ds["accepted"] == ds["drafted"]
        assert ds["rounds"] >= 1 and ds["drafted"] == 3 * ds["rounds"]


def test_device_position_chunk_equals_host_position_chunk(gpt):
    """``gpt_decode_chunk`` at a device position: logits, cache bytes and
    scales of the host-position chunk, and the position advanced by c."""
    _, tp = gpt
    ct = _cond(*gpt)[1]
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 24, (4, 5)))
    for cache, weights in itertools.product(CACHES, WEIGHTS):
        cfg = _cfg(cache, weights)
        wq = (TG.quantize_block_weights(tp["blocks"]) if weights == "int8"
              else None)
        outs = []
        for on_device in (False, True):
            c = TG.init_kv_cache(cfg, 4, max_len=12)
            _, c = TG.gpt_prefill(tp, cfg, c, torch.from_numpy(GIVEN), ct)
            if on_device:
                c["len"] = torch.tensor([c["len"]])
            outs.append(TS.gpt_decode_chunk(tp, cfg, c, toks, wq))
        (le, ce), (ld, cd) = outs
        assert torch.equal(le, ld), (cache, weights)
        assert ce["len"] == int(cd["len"]) == 4 + 5
        for name in ce:
            if name != "len":
                assert torch.equal(ce[name], cd[name]), (cache, name)


# ------------------- (e) kernel E's fused write, plain version ---------------

@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_fused_write_twin_equals_write_kv_bit_for_bit(bits):
    """``decode_attend_int8(..., k_new=, v_new=)`` on CPU tensors writes the
    slot as ``_write_kv`` does (values and bfloat16 scales, nothing else
    touched) and attends over it: at a host and at a device position, with
    rows on .5 boundaries and an all-zero row."""
    rng = np.random.default_rng(5)
    cfg = GPT.replace(cache_dtype=bits)
    lim = 127.0 if bits == "int8" else 7.0
    for pos, layer in ((0, 0), (3, 1), (7, 0)):
        k_new, v_new, q = (torch.from_numpy(rng.standard_normal(
            (4, 4, 16)).astype(np.float32) * 2.0) for _ in range(3))
        k_new[0, 0] = torch.tensor([lim, 2.5, -3.5, 0.5, -0.5, 1.5, 6.5,
                                    -6.5, 4.5, 5.5, -2.5, 3.5, 0, -1.5,
                                    2.51, -lim])
        v_new[1, 2] = 0.0
        ref = TG.init_kv_cache(cfg, 4, max_len=8)
        for name in ("k", "v"):
            ref[name].random_(0, 100)
            ref[name + "_scale"].uniform_(0.01, 0.1)
        caches = [{n: t.clone() for n, t in ref.items() if n != "len"}
                  for _ in range(2)]
        TG._write_kv(ref, cfg, layer, pos, k_new[:, :, None],
                     v_new[:, :, None])
        want = TD.decode_attend_int8_xla(q, ref["k"], ref["v"],
                                         ref["k_scale"], ref["v_scale"],
                                         layer, pos)
        for cache, p in zip(caches, (pos, torch.tensor([pos]))):
            out = TD.decode_attend_int8(
                q, cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], layer, p, k_new=k_new, v_new=v_new)
            for name in cache:
                assert cache[name].dtype == ref[name].dtype
                assert torch.equal(cache[name], ref[name]), (pos, name)
            assert torch.equal(out, want)
        # pos_offset: the chunk's position j
        if pos:
            cache = {n: t.clone() for n, t in caches[0].items()}
            TD.decode_attend_int8(
                q, cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], layer, torch.tensor([pos - 1]),
                k_new=k_new, v_new=v_new, pos_offset=1)
            assert all(torch.equal(cache[n], ref[n]) for n in cache)


def test_kernel_split_rule_equals_choose_splits_on_a_grid():
    """The kernel's own arithmetic for a cluster launched at the cache's
    capacity: as many ranks take rows as ``choose_splits`` says for the
    position (never more than the cluster), consecutive shares that cover
    rows 0 .. n - 1 once, empty ranks behind them, and no share above what
    the launch sized shared memory for."""
    for bh in (1, 4, 16, 32, 33, 64, 66, 128, 256):
        for t_cap in (1, 34, 64, 100, 128, 266, 300):
            cluster = TD.choose_splits(bh, t_cap)
            cap = TD.max_share(bh, t_cap, cluster)
            for n in range(1, t_cap + 1):
                shares = TD.kernel_shares(bh, n, cluster)
                assert len(shares) == cluster
                active = [s for s in shares if s[1] > 0]
                want = TD.choose_splits(bh, n)
                assert want <= cluster
                assert len(active) <= want
                assert -(-n // want) == shares[0][1] <= cap
                assert shares[:len(active)] == active    # empty ones last
                covered = [t for t0, rows in active
                           for t in range(t0, t0 + rows)]
                assert covered == list(range(n)), (bh, t_cap, n)


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_split_with_empty_trailing_shares_equals_unsplit(bits):
    """``decode_attend_int8_split`` merged over a cluster larger than the
    ranks that hold rows (the captured launch early in a decode) equals the
    unsplit result within 1e-5."""
    rng = np.random.default_rng(6)
    quant = TD.quantize_kv if bits == "int8" else TD.quantize_kv4
    k, ks = quant(torch.from_numpy(
        rng.standard_normal((2, 1, 4, 266, 16)).astype(np.float32)))
    v, vs = quant(torch.from_numpy(
        rng.standard_normal((2, 1, 4, 266, 16)).astype(np.float32)))
    ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    for pos in (0, 5, 63, 64, 130, 200, 265):
        ref = TD.decode_attend_int8_xla(q, k, v, ks, vs, 1, pos)
        splits = TD.choose_splits(4, pos + 1)
        for cluster in (splits, 4):
            out = TD.decode_attend_int8_split(q, k, v, ks, vs, 1, pos,
                                              splits, cluster)
            assert float((out - ref).abs().max()) <= 1e-5, (pos, cluster)


# ------------------- (f) the cached int8 block weights -----------------------

def test_block_weight_cache_is_redone_when_the_weights_change():
    cfg = _cfg("int8", "int8")
    params = TG.init_gpt_params(cfg, _gen(2))
    cache = TG.BlockWeightCache()
    wq = cache.get(params["blocks"])
    ref = TG.quantize_block_weights(params["blocks"])
    for name in ref:
        assert torch.equal(wq[name]["q"], ref[name]["q"])
        assert torch.equal(wq[name]["s"], ref[name]["s"])
    assert cache.get(params["blocks"]) is wq and cache.passes == 1
    # a bias or a layer norm is not part of it
    params["blocks"]["mlp_up"]["b"].add_(1.0)
    assert cache.get(params["blocks"]) is wq and cache.passes == 1
    # an in-place change of a matrix
    params["blocks"]["mlp_up"]["w"].mul_(2.0)
    wq2 = cache.get(params["blocks"])
    assert wq2 is not wq and cache.passes == 2
    assert torch.equal(wq2["mlp_up"]["s"], 2.0 * ref["mlp_up"]["s"])
    # a replaced tensor of equal values
    params["blocks"]["attn_proj"]["w"] = \
        params["blocks"]["attn_proj"]["w"].clone()
    assert cache.get(params["blocks"]) is not wq2 and cache.passes == 3
    # a cast
    cast = TG.tree_to(params, dtype=torch.bfloat16)
    wq4 = cache.get(cast["blocks"])
    assert cache.passes == 4 and cache.get(cast["blocks"]) is wq4
    # a device move (the meta device stands in for another device)
    moved = TG.tree_to(params, device="meta")
    assert cache.get(moved["blocks"])["mlp_up"]["q"].device.type == "meta"
    assert cache.passes == 5
    cache.drop()
    cache.get(params["blocks"])
    assert cache.passes == 6


def test_pipeline_keeps_its_int8_weights_across_requests():
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline
    exp, pipe = build_pipeline(
        "vas", init_random=True, device="cpu", kv_cache="int8",
        int8_weights=1, override="n_layer=1,n_embd=32,n_head=2")
    a, _ = pipe.generate_tokens([0, 1], None, sample=False)
    b, _ = pipe.generate_tokens([0, 1], None, sample=False)
    assert torch.equal(a, b) and pipe.block_weights.passes == 1
    pipe.gpt_params["blocks"]["attn_qkv"]["w"].mul_(1.5)
    pipe.generate_tokens([0, 1], None, sample=False)
    assert pipe.block_weights.passes == 2
    # the switch: graph=False takes the eager loop, and gives the same
    _, eager = build_pipeline(
        "vas", init_random=True, device="cpu", kv_cache="int8",
        int8_weights=1, override="n_layer=1,n_embd=32,n_head=2",
        graph=False)
    assert eager.graph is False
    assert torch.equal(eager.generate_tokens([0, 1], None, sample=False)[0],
                       a)


# ------------------- (g) the int8 product's prologue and epilogue -----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_linear_plain_versions_equal_int8_mm_bitwise(gpt, dtype):
    jp, tp = gpt
    wj = JG.quantize_block_weights(jp["blocks"])
    wt = TG.quantize_block_weights(tp["blocks"])
    rng = np.random.default_rng(7)
    for name in wt:
        k = wt[name]["q"].shape[1]
        for m in (1, 4, 9):
            x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
            x[0, :4] = [127.0, 2.5, -3.5, 0.5]      # .5 boundaries at scale 1
            xt = torch.from_numpy(x).to(dtype)
            bias = torch.from_numpy(rng.standard_normal(
                wt[name]["q"].shape[2]).astype(np.float32)).to(dtype)
            q, s = wt[name]["q"][1], wt[name]["s"][1]
            want = TG._int8_mm(xt, q, s)
            xq, xs = TL.quantize_rows(xt)
            assert xq.dtype == torch.int8 and xq.shape == xt.shape
            acc = torch._int_mm(xq, q)
            got = TL.rescale_bias(acc, xs, s, bias)
            assert got.dtype == dtype
            assert torch.equal(got, want.to(dtype) + bias)
            assert torch.equal(TL.int8_linear(xt, q, s, bias), got)
            # zero pad rows, as the card's quantiser adds them, are exact
            pad = torch.cat([xq, torch.zeros(TL.pad_rows(m) - m, k,
                                             dtype=torch.int8)])
            assert torch.equal(TL.rescale_bias_xla(torch._int_mm(pad, q), xs,
                                                   s, bias), got)
            if dtype == torch.float32:
                ref = JG._int8_mm(jnp.asarray(x), wj[name]["q"][1],
                                  wj[name]["s"][1])
                np.testing.assert_array_equal(want.numpy(), np.asarray(ref))


# the VAS GPT's four block matrices (in, out), and stand-ins at the XL
# decoder's widths (1472 wide, 5888 in the MLP)
SPLITK_SHAPES = {"attn_qkv": (1024, 3072), "attn_proj": (1024, 1024),
                 "mlp_up": (1024, 4096), "mlp_down": (4096, 1024),
                 "xl_qkv": (1472, 4416), "xl_down": (5888, 1472)}


@functools.lru_cache(maxsize=None)
def _block_weight(k, n):
    """One layer's int8 weights (in, out) and scales, from a fixed draw."""
    g = torch.Generator().manual_seed(k * 7 + n)
    w = TG.quantize_block_weight(torch.randn(1, k, n, generator=g) / k ** 0.5)
    return w["q"][0], w["s"][0]


@pytest.mark.parametrize("name", list(SPLITK_SHAPES))
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_linear_splitk_plain_version_equals_int8_mm_bitwise(name, m,
                                                                 dtype):
    """The one-launch product's plain version (what the CPU runs, and what
    the card's kernel is held to) is the three-kernel chain and ``_mm``'s
    own lines, bit for bit, at the widths the kernel serves."""
    k, n = SPLITK_SHAPES[name]
    q, s = _block_weight(k, n)
    g = torch.Generator().manual_seed(m * 31 + k)
    x = torch.randn(m, k, generator=g) * 3.0
    x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])   # .5 at scale 1
    x = x.to(dtype)
    bias = torch.randn(n, generator=g).to(dtype)
    want = TG._int8_mm(x, q, s).to(dtype) + bias
    got = TL.int8_linear_splitk_xla(x, q, s, bias)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(TL.int8_linear_splitk(x, q, s, bias), want)
    assert torch.equal(TL.int8_linear_chain(x, q, s, bias), want)
    assert torch.equal(TL.int8_linear(x, q, s, bias), want)
    assert TL.splitk_plan(m, k, n) == -(-n // 8 // 132)


class _StandInModelGroup:
    """A model group of one rank: the row-cut form without a process
    group (its all-reduces change nothing)."""

    def all_reduce_(self, t, axis, async_op=False, op="sum"):
        return None


@pytest.mark.parametrize("rows,name,tp,taken", [
    (8, "attn_qkv", False, "splitk"), (8, "mlp_down", False, "splitk"),
    (1, "mlp_up", False, "splitk"),
    (TL.SPLITK_MAX_ROWS, "attn_proj", False, "splitk"),
    (TL.SPLITK_MAX_ROWS + 1, "attn_proj", False, "chain"),
    (512, "mlp_up", False, "chain"), (512, "mlp_down", False, "chain"),
    (8, "attn_proj", True, "chain"), (8, "mlp_down", True, "chain"),
    (8, "attn_qkv", True, "splitk"), (8, "mlp_up", True, "splitk")])
def test_fused_mm_takes_the_one_launch_product_at_small_m(
        gpt, monkeypatch, rows, name, tp, taken):
    """``_mm`` with ``fused`` takes the one-launch product at small M and
    the three-kernel chain at large M and for a row-cut product under a
    model axis (a column-cut one under the axis takes the one launch); the
    result is ``_mm``'s unfused one either way."""
    _, tparams = gpt
    p = TG._layer(tparams["blocks"], 0)
    pw = TG._layer(TG.quantize_block_weights(tparams["blocks"]), 0)
    calls = []
    for kind, attr in (("splitk", "int8_linear_splitk"),
                       ("chain", "int8_linear_chain")):
        def wrapped(*a, _fn=getattr(TL, attr), _kind=kind, **kw):
            calls.append(_kind)
            return _fn(*a, **kw)
        monkeypatch.setattr(TL, attr, wrapped)
    k = pw[name]["q"].shape[0]
    a = torch.randn(rows, k, generator=torch.Generator().manual_seed(rows))
    group = _StandInModelGroup() if tp else None
    got = TG._mm(a, p, pw, name, fused=True, tp=group)
    assert calls == [taken]
    assert torch.equal(got, TG._mm(a, p, pw, name, tp=group))


def test_splitk_plan_refuses_what_the_kernel_does_not_take():
    assert TL.splitk_plan(TL.SPLITK_MAX_ROWS + 1, 1024, 1024) is None
    assert TL.splitk_plan(8, 1024 + 32, 1024) is None
    assert TL.splitk_plan(8, 32, 64) is None
    assert TL.splitk_plan(0, 1024, 1024) is None
    # the quantised rows and the weight tiles outgrow shared memory
    assert TL.splitk_plan(16, 32768, 1024) is None
    # the fewest 8-column groups a CTA that spread the groups over the SMs
    assert TL.splitk_plan(8, 1024, 3072) == 3
    assert TL.splitk_plan(8, 4096, 1024) == 1
    assert TL.splitk_plan(8, 1024, 40, sms=4) == 2


def test_pad_rows_is_a_multiple_of_eight_and_at_least_32():
    assert [TL.pad_rows(m) for m in (1, 8, 32, 33, 40, 41)] == \
        [32, 32, 32, 40, 40, 48]


# ------------------- (h) launch accounting ------------------------------------

@pytest.mark.parametrize("batch", ["small", "large"])
def test_holder_launch_accounting(gpt, monkeypatch, batch):
    """With counting stand-ins for the wrappers (the plain versions, as on
    the CPU, plus a count), n replays of the decode program read what n
    eager steps read: E once a layer, and four int8 products a layer --
    each one launch of the one-launch product at a small batch, each a
    ``quantize_rows`` and a ``rescale_bias`` past ``SPLITK_MAX_ROWS``
    rows; and a captured program's bookkeeping adds what one run of the
    body held on every replay."""
    _, tp = gpt
    cfg = _cfg("int8", "int8")
    cls = CLS if batch == "small" else \
        np.arange(TL.SPLITK_MAX_ROWS + 1) % GPT.class_size
    ct = _cond(*gpt, cls=cls)[1]

    def counting(fn):
        def wrapped(*a, **kw):
            wrapped.launches += 1
            return fn(*a, **kw)
        wrapped.launches = wrapped.streamed = 0
        return wrapped
    monkeypatch.setattr(TD, "decode_attend_int8",
                        counting(TD.decode_attend_int8))
    for name in ("quantize_rows", "rescale_bias", "row_scales",
                 "int8_linear_splitk"):
        monkeypatch.setattr(TL, name, counting(getattr(TL, name)))
    zero = {"decode_attention": 0, "decode_attention_streamed": 0,
            "quantize_rows": 0, "row_scales": 0, "rescale_bias": 0,
            "int8_linear_splitk": 0}
    assert DG.launch_counts() == zero
    TG.gpt_generate(tp, cfg, None, ct, steps=STEPS, sample=False, graph=True)
    n = STEPS * cfg.n_layer
    chain, one = (0, 4 * n) if batch == "small" else (4 * n, 0)
    # the plain versions launch nothing, so no launch took the streamed
    # body; a replay adds what the capture noted of it (below)
    want = {"decode_attention": n, "decode_attention_streamed": 0,
            "quantize_rows": chain, "row_scales": 0,
            "rescale_bias": chain, "int8_linear_splitk": one}
    assert DG.launch_counts() == want
    # the eager loop's steps launch E as often (its int8 products run the
    # plain chain)
    TG.gpt_generate(tp, cfg, None, ct, steps=STEPS, sample=False, graph=False)
    want["decode_attention"] += n
    assert DG.launch_counts() == want
    # what a replay of a captured program adds
    prog = DG.Program(lambda: None, torch.device("cpu"))
    prog.launches = {"decode_attention": 2, "decode_attention_streamed": 2,
                     "rescale_bias": 8, "int8_linear_splitk": 4}
    prog.graph = type("G", (), {"replay": lambda self: None})()
    for _ in range(3):
        prog.replay()
    want["decode_attention"] += 6
    want["decode_attention_streamed"] += 6
    want["rescale_bias"] += 24
    want["int8_linear_splitk"] += 12
    assert DG.launch_counts() == want


def test_tensors_token_names_every_address():
    a, b = torch.zeros(3), torch.zeros(3)
    t1 = DG.tensors_token({"x": a, "y": {"z": b}}, None)
    assert t1 == DG.tensors_token({"y": {"z": b}, "x": a}, None)
    assert t1 != DG.tensors_token({"x": b, "y": {"z": a}}, None)
    assert t1 != DG.tensors_token({"x": a, "y": {"z": b.clone()}}, None)


def test_pipeline_serialises_concurrent_generate_tokens(monkeypatch):
    """A pipeline's captured programs share static buffers, so
    ``generate_tokens`` must never run twice at once: six threads call it
    together, a stand-in for ``gpt_generate`` counts how many are inside
    and yields the interpreter while it holds the place."""
    import sys
    import threading
    import time

    from melspec_gpt_vqvae_tpu_torch import pipeline as TP
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline
    _, pipe = build_pipeline(
        "vas", init_random=True, device="cpu",
        override="n_layer=1,n_embd=32,n_head=2")
    inside, worst, calls = [0], [0], [0]

    def generate(params, cfg, generator, cond, **kw):
        inside[0] += 1
        worst[0] = max(worst[0], inside[0])
        time.sleep(0.005)
        calls[0] += 1
        inside[0] -= 1
        return torch.zeros((cond.shape[0], kw["steps"]), dtype=torch.long)
    monkeypatch.setattr(TP, "gpt_generate", generate)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda: [pipe.generate_tokens([0, 1], None)
                            for _ in range(5)]) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls[0] == 30 and worst[0] == 1
