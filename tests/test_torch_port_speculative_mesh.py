"""The port's speculative decoding over a mesh against the JAX package: the
pins of tests/test_speculative.py:140-206 at their geometry (a 2-layer
target and a 1-layer draft, 4 heads, 32 wide).

One gloo world of four ranks runs once for the module
(tests/torch_dist_worlds.py): target and draft cut over ``model``, the
batch over ``data`` (``data=2,model=2``, and ``model=4``), over a
model-dtype cache and over the int8 cache with int8 weights.  Greedy
tokens and the ``rounds`` / ``accepted`` counts must equal the JAX
package's one-device run, which needs the round advance all-reduced (MIN)
over the data group; sampled tokens and counts equal the port's
one-process run for the same seed, also with a draft close to the target
(a noisy copy), whose lanes accept different counts a round; and the mesh
pipeline with a draft matches the meshless one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.models import speculative as JS
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.models import speculative as TS
from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline

import torch_dist_worlds as W
from test_torch_port_pipeline import tiny_pipelines

torch.set_num_threads(1)

CFG = GPTConfig(vocab_size=16, block_size=24, n_layer=2, n_head=4,
                n_embd=32, class_size=4)
DRAFT = CFG.replace(n_layer=1)
CACHES = {"auto": "auto", "int8": "int8"}
MESHES = ({"data": 2, "model": 2}, {"model": 4})
STEPS, GAMMA, SEED, TOP_K = 8, 3, 13, 5
CLS = np.asarray([0, 1, 2, 3, 0, 1, 2, 3], np.int32)


def _key(shape):
    return ",".join(f"{k}={v}" for k, v in shape.items())


def _cfgs(cache):
    w = "int8" if cache == "int8" else "auto"
    return (CFG.replace(cache_dtype=cache, decode_weight_dtype=w),
            DRAFT.replace(cache_dtype=cache, decode_weight_dtype=w))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_spec_mesh")
    jp = JG.init_gpt_params(jax.random.PRNGKey(0), CFG)
    jd = JG.init_gpt_params(jax.random.PRNGKey(7), DRAFT)
    params = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
    draft = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jd))
    cls = torch.from_numpy(CLS.astype(np.int64))
    cond = TG.class_embed(params, cls)
    cfgs = {name: tuple(bridge.config_from_jax(c) for c in _cfgs(cache))
            for name, cache in CACHES.items()}
    # a noisy copy of the target as the draft: lanes accept 0 .. gamma
    cfgs["near"] = (cfgs["auto"][0], cfgs["auto"][0])
    g = torch.Generator().manual_seed(3)
    near = _noisy(params, g)
    drafts = {"auto": draft, "int8": draft, "near": near}

    # the pipeline with a draft (tests/test_speculative.py:180-206)
    exp, _, plain = tiny_pipelines()
    pdcfg = plain.exp.model.replace(n_layer=1)
    pdraft = TG.init_gpt_params(pdcfg, torch.Generator().manual_seed(42))
    pipe_kw = {"draft_params": pdraft, "draft_cfg": pdcfg, "gamma": GAMMA}
    serve = {"meshes": (), "cfgs": {}, "params": params, "cond": cond,
             "x": None, "steps": STEPS, "seed": SEED, "top_k": TOP_K,
             "pipe_meshes": ({"data": 2, "model": 2},),
             "pipe_exp": plain.exp, "pipe_gpt": plain.gpt_params,
             "pipe_vq": plain.vq, "pipe_melgan": plain.melgan,
             "pipe_cls": CLS[:4], "pipe_draft": pipe_kw}
    W.write_inputs(tmp, {"params": params, "drafts": drafts, "cond": cond,
                         "cls": cls, "cfgs": cfgs, "meshes": MESHES,
                         "steps": STEPS, "gamma": GAMMA, "seed": SEED,
                         "top_k": TOP_K, "serve": serve})
    procs = W.spawn("spec", 4, tmp)

    ref = {}
    jc = JG.class_embed(jp, jnp.asarray(CLS))
    jdc = JG.class_embed(jd, jnp.asarray(CLS))
    for name, cache in CACHES.items():
        c, dc = _cfgs(cache)
        toks, stats = JS.gpt_speculative_generate(
            jp, c, jd, dc, jax.random.PRNGKey(3), jc, jdc, steps=STEPS,
            gamma=GAMMA, sample=False)
        ref[f"jax/{name}"] = (np.asarray(toks), int(stats["rounds"]),
                              int(stats["accepted"]))
    for name, (tc, tdc) in cfgs.items():
        d = drafts[name]
        for sample in (False, True):
            ref[f"port/{name}/{sample}"] = TS.gpt_speculative_generate(
                params, tc, d, tdc, torch.Generator().manual_seed(SEED),
                cond, TG.class_embed(d, cls), steps=STEPS, gamma=GAMMA,
                top_k=TOP_K, sample=sample, graph=True)
    spec = GenerationPipeline(plain.exp, plain.gpt_params, plain.vq,
                              plain.melgan, segments=2, chunk=0, bf16=False,
                              **pipe_kw)
    ref["pipe"] = spec.generate(CLS[:4], None, sample=False)
    return W.join(procs, tmp), ref


def _noisy(params, g):
    if isinstance(params, dict):
        return {k: _noisy(v, g) for k, v in params.items()}
    return params + 0.004 * torch.randn(params.shape, generator=g)


def _gathered(outs, key, shape):
    m = shape.get("model", 1)
    parts = [outs[r][key] for r in range(0, len(outs), m)]
    return (np.concatenate([p[0].numpy() for p in parts]),
            [p[1] for p in parts])


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("shape", MESHES, ids=_key)
def test_speculative_tp_sharded_matches_single_device(world, shape, cache,
                                                      graph):
    """Greedy speculative decoding with target and draft cut over
    ``model`` and the batch over ``data``: tokens, rounds and accepted
    exactly the JAX package's one-device run, on every rank."""
    outs, ref = world
    toks, stats = _gathered(outs, f"{_key(shape)}/{cache}/False/{graph}",
                            shape)
    want, rounds, accepted = ref[f"jax/{cache}"]
    np.testing.assert_array_equal(toks, want)
    for o in outs:
        st = o[f"{_key(shape)}/{cache}/False/{graph}"][1]
        assert (st["rounds"], st["accepted"]) == (rounds, accepted), st
        assert st["drafted"] == rounds * GAMMA


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("cache", list(CACHES) + ["near"])
@pytest.mark.parametrize("shape", MESHES, ids=_key)
def test_speculative_sampled_over_mesh_equals_one_process(world, shape,
                                                          cache, sample):
    """Speculative decoding over the mesh against the port's one-process
    run for the seed, sampled and greedy, in both loops: every uniform
    (positions, acceptance, residual) drawn for the global batch and cut
    to this rank's rows, the advance the global minimum (with the near
    draft the data ranks' own minima differ), so tokens and stats are
    equal."""
    outs, ref = world
    want, want_stats = ref[f"port/{cache}/{sample}"]
    for graph in (False, True):
        toks, stats = _gathered(
            outs, f"{_key(shape)}/{cache}/{sample}/{graph}", shape)
        np.testing.assert_array_equal(toks, want.numpy())
        assert all(s == want_stats for s in stats), (stats, want_stats)
    if cache == "near" and not sample:   # lanes accept more than none
        assert want_stats["accepted"] > 0


def test_pipeline_speculative_mesh_wiring(world):
    """GenerationPipeline with a draft over ``data=2,model=2``: greedy
    clips equal the meshless speculative pipeline's, stats too
    (tests/test_speculative.py:180-206)."""
    outs, ref = world
    got = outs[0]["pipe/data=2,model=2"]
    np.testing.assert_array_equal(got["tokens"], ref["pipe"]["tokens"])
    np.testing.assert_allclose(got["wavs"], ref["pipe"]["wavs"], atol=1e-5)
    assert got["spec_stats"] == ref["pipe"]["spec_stats"]
    assert got["spec_stats"]["rounds"] >= 1
    assert all(o["pipe/data=2,model=2"] is None for o in outs[1:])


def test_quantising_a_model_sharded_gpt_is_refused():
    """int8 block weights must come cut from the full weights' (a row-cut
    product's scales span all its input rows): the decode refuses to
    quantise a shard itself."""
    from melspec_gpt_vqvae_tpu_torch.parallel import mesh as TM
    mesh = TM.Mesh({"model": 2}, "cpu")   # the rules alone, no group
    c = bridge.config_from_jax(_cfgs("int8")[0])
    params = TG.init_gpt_params(c, torch.Generator().manual_seed(0))
    local = TM.shard_gpt_for_serving(mesh, params)
    cond = TG.class_embed(local, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="shard_block_weights"):
        TG.gpt_generate(local, c, None, cond, steps=2, sample=False,
                        mesh=mesh)
