"""PyTorch port, speculative decoding: the pins of tests/test_speculative.py.

Chunk verification equals single steps (and the JAX chunk); draft ==
target reproduces the port's ``gpt_generate`` exactly for the same
generator; greedy speculative decoding equals greedy ``gpt_generate`` (the
port's and the JAX package's) for any draft, with a prefix and with the
int8 cache and weights; the accept/reject and residual draw preserve the
target distribution; and the pipeline and service wiring.  Weights come
from the JAX package's own initialiser, carried across by the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.models import speculative as JS
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.models import speculative as TS
from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline

torch.set_num_threads(1)

CFG = GPTConfig(vocab_size=16, block_size=24, n_layer=2, n_head=2,
                n_embd=16, class_size=4)
DRAFT = CFG.replace(n_layer=1)
CLS = np.asarray([0, 1, 2])


def _setup(cfg=CFG, seed=0, cls=CLS):
    """(JAX params, port params, JAX cond, port cond) from the JAX
    package's initialiser."""
    jp = jax.tree_util.tree_map(
        np.asarray, JG.init_gpt_params(jax.random.PRNGKey(seed), cfg))
    tp = bridge.gpt_params_from_jax(jp)
    return (jp, tp, JG.class_embed(jp, jnp.asarray(cls, jnp.int32)),
            TG.class_embed(tp, torch.as_tensor(cls)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("cache_dtype", ["auto", "int8", "int4"])
def test_decode_chunk_matches_single_steps(cache_dtype):
    cfg = CFG.replace(cache_dtype=cache_dtype)
    _, tp, _, ct = _setup(cfg)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, 16, (3, 5)))
    caches, logits = [], []
    for _ in range(2):
        cache = TG.init_kv_cache(cfg, 3, max_len=12)
        _, cache = TG.gpt_prefill(tp, cfg, cache, None, ct)
        caches.append(cache)
    logits_c, cache_c = TS.gpt_decode_chunk(tp, cfg, caches[0], toks)
    cache_s = caches[1]
    for i in range(5):
        step, cache_s = TG.gpt_decode_step(tp, cfg, cache_s, toks[:, i])
        logits.append(step)
    np.testing.assert_allclose(logits_c.numpy(),
                               torch.stack(logits, 1).numpy(), atol=2e-4)
    assert cache_c["len"] == cache_s["len"] == 6
    for name in set(cache_c) - {"len"}:
        np.testing.assert_allclose(cache_c[name][:, :, :, :6].float(),
                                   cache_s[name][:, :, :, :6].float(),
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("variant", [("auto", "auto"), ("int8", "int8"),
                                     ("int4", "auto")],
                         ids=lambda v: f"cache_{v[0]}-weights_{v[1]}")
def test_decode_chunk_matches_jax(variant):
    cfg = CFG.replace(cache_dtype=variant[0], decode_weight_dtype=variant[1])
    jp, tp, cj, ct = _setup(cfg)
    wj = wt = None
    if variant[1] == "int8":
        wj = JG.quantize_block_weights(jp["blocks"])
        wt = TG.quantize_block_weights(tp["blocks"])
    toks = np.random.default_rng(1).integers(0, 16, (3, 4)).astype(np.int32)
    _, jc = JG.gpt_prefill(jp, cfg, JG.init_kv_cache(cfg, 3, 9), None, cj)
    _, tc = TG.gpt_prefill(tp, cfg, TG.init_kv_cache(cfg, 3, 9), None, ct)
    jl, jc = JS.gpt_decode_chunk(jp, cfg, jc, jnp.asarray(toks), wj)
    tl, tc = TS.gpt_decode_chunk(tp, cfg, tc, torch.from_numpy(toks), wt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert tc["len"] == int(jc["len"]) == 5
    if variant[0] != "auto":
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                tc[name].float().numpy(),
                np.asarray(jc[name]).astype(np.float32), err_msg=name)


def test_draft_equals_target_is_bit_identical_to_gpt_generate():
    _, tp, _, ct = _setup()
    for steps, gamma, kw in ((10, 4, dict(top_k=5)),
                             (10, 3, dict(temperature=0.8, top_p=0.9)),
                             (7, 7, {})):
        ref = TG.gpt_generate(tp, CFG, _gen(3), ct, steps=steps,
                              sample=True, **kw)
        out, stats = TS.gpt_speculative_generate(
            tp, CFG, tp, CFG, _gen(3), ct, ct, steps=steps, gamma=gamma,
            sample=True, **kw)
        np.testing.assert_array_equal(ref.numpy(), out.numpy(),
                                      err_msg=f"steps={steps} g={gamma}")
        # p == q: every proposal is accepted
        assert stats["accepted"] == stats["drafted"] \
            or stats["rounds"] * (gamma + 1) >= steps - 1


def test_greedy_speculative_exact_for_any_draft():
    jp, tp, cj, ct = _setup()
    _, dp, _, dct = _setup(DRAFT, seed=9)
    ref_j = JG.gpt_generate(jp, CFG, jax.random.PRNGKey(5), cj, steps=12,
                            sample=False)
    ref = TG.gpt_generate(tp, CFG, None, ct, steps=12, sample=False)
    out, stats = TS.gpt_speculative_generate(
        tp, CFG, dp, DRAFT, None, ct, dct, steps=12, gamma=4, sample=False)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_j))
    assert 0 <= stats["accepted"] <= stats["drafted"]
    assert stats["drafted"] == 4 * stats["rounds"]


def test_speculative_with_given_prefix_and_int8():
    cfg = CFG.replace(cache_dtype="int8", decode_weight_dtype="int8")
    jp, tp, cj, ct = _setup(cfg)
    _, dp, _, dct = _setup(DRAFT.replace(cache_dtype="int8",
                                         decode_weight_dtype="int8"), seed=4)
    given = np.asarray([[1, 2], [3, 4], [5, 6]], np.int32)
    ref_j = JG.gpt_generate(jp, cfg, jax.random.PRNGKey(7), cj,
                            jnp.asarray(given), steps=8, sample=False)
    ref = TG.gpt_generate(tp, cfg, None, ct, torch.from_numpy(given),
                          steps=8, sample=False)
    for draft, d_cond in ((tp, ct), (dp, dct)):
        d_cfg = cfg if draft is tp else cfg.replace(n_layer=1)
        out, _ = TS.gpt_speculative_generate(
            tp, cfg, draft, d_cfg, None, ct, d_cond,
            torch.from_numpy(given), steps=8, gamma=3, sample=False)
        assert out.shape == (3, 10)
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_j))


def test_speculative_preserves_target_distribution():
    """draft != target, sampled: the histogram of each output position
    over 4096 lanes matches direct target sampling within 5 sigma of
    binomial noise; rejections must occur for this to test the residual
    draw."""
    vocab, lanes = 8, 4096
    cfg = GPTConfig(vocab_size=vocab, block_size=8, n_layer=1, n_head=1,
                    n_embd=8, class_size=1)
    zeros = np.zeros((lanes,), np.int32)
    _, tp, _, ct = _setup(cfg, seed=1, cls=zeros)
    _, dp, _, dct = _setup(cfg, seed=2, cls=zeros)   # p != q
    out, stats = TS.gpt_speculative_generate(
        tp, cfg, dp, cfg, _gen(11), ct, dct, steps=3, gamma=2,
        temperature=1.2, top_k=6)
    ref = TG.gpt_generate(tp, cfg, _gen(12), ct, steps=3, temperature=1.2,
                          top_k=6)
    assert stats["accepted"] < stats["drafted"]
    o, r = out.numpy(), ref.numpy()
    for pos in (0, 1, 2):
        ho = np.bincount(o[:, pos], minlength=vocab) / lanes
        hr = np.bincount(r[:, pos], minlength=vocab) / lanes
        sigma = np.sqrt(np.maximum(hr * (1 - hr), 1e-4) / lanes)
        assert (np.abs(ho - hr) < 5 * sigma + 0.01).all(), \
            f"pos {pos}: {ho} vs {hr}"


# ---------------------------- pipeline and service --------------------------

@pytest.fixture(scope="module")
def pipes():
    """The tiny round trip of test_torch_port_pipeline.py, plain and with a
    one-layer draft."""
    from tests.test_torch_port_pipeline import tiny_pipelines
    exp, _, plain = tiny_pipelines()
    dcfg = exp.model.replace(n_layer=1)
    _, dp, _, _ = _setup(dcfg, seed=42)
    spec = GenerationPipeline(exp, plain.gpt_params, plain.vq, plain.melgan,
                              segments=2, chunk=3, bf16=False,
                              draft_params=dp, draft_cfg=dcfg, gamma=3)
    return exp, plain, spec


def test_pipeline_speculative_greedy_matches_plain(pipes):
    _, plain, spec = pipes
    cls = np.asarray([0, 1, 2, 3], np.int32)
    ref = plain.generate(cls, None, sample=False)
    out = spec.generate(cls, None, sample=False)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    np.testing.assert_allclose(out["wavs"], ref["wavs"], atol=1e-5)
    st = out["spec_stats"]
    assert st["rounds"] >= 1 and 0 <= st["accepted"] <= st["drafted"]
    assert st["accept_rate"] == round(st["accepted"] / st["drafted"], 4)
    assert "spec_stats" not in ref


def test_service_sums_spec_stats_over_a_request(pipes):
    exp, _, spec = pipes
    svc = TSV.GenerationService(exp, spec, batch=2, seed=1)
    whole = svc.generate([0, 3, 1], seed=5, top_k=5)
    parts = [spec.generate(np.asarray(c, np.int32),
                           torch.Generator().manual_seed(s), top_k=5)
             for c, s in (([0, 3], 5), ([1, 1], 7))]
    np.testing.assert_array_equal(
        whole["tokens"], np.concatenate([parts[0]["tokens"],
                                         parts[1]["tokens"][:1]]))
    for f in ("rounds", "drafted", "accepted"):
        assert whole["spec_stats"][f] == sum(p["spec_stats"][f]
                                             for p in parts)
    assert "spec_stats" not in TSV.GenerationService(
        exp, pipes[1], batch=2).generate([0], seed=5)
