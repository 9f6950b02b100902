"""The port's speculative decoding over a mesh against the JAX package: the
pins of tests/test_speculative.py:140-206 at their geometry (a 2-layer
target and a 1-layer draft, 4 heads, 32 wide).

Two gloo worlds of four ranks run once for the module
(tests/torch_dist_worlds.py): target and draft cut over ``model``, the
batch over ``data`` (``data=2,model=2``, and ``model=4``), over a
model-dtype cache and over the int8 cache with int8 weights; and both
models at 5 heads (40 wide) under ``model=4``, which cuts them 2, 1, 1,
1.  Greedy
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
# 5 heads over model=4, cut 2, 1, 1, 1 (parallel/mesh.py::head_range); the
# case's "heads" names the GPT, not a mesh axis
ODD = dict(n_head=5, n_embd=40)
ODD_MESHES = ({"model": 4, "heads": 5},)
STEPS, GAMMA, SEED, TOP_K = 8, 3, 13, 5
CLS = np.asarray([0, 1, 2, 3, 0, 1, 2, 3], np.int32)


def _key(shape):
    return ",".join(f"{k}={v}" for k, v in shape.items())


def _cfgs(cache, cfg=CFG, draft_cfg=DRAFT):
    w = "int8" if cache == "int8" else "auto"
    return (cfg.replace(cache_dtype=cache, decode_weight_dtype=w),
            draft_cfg.replace(cache_dtype=cache, decode_weight_dtype=w))


def _spec_case(cfg, draft_cfg, noise=0.004):
    """(the world's inputs, the JAX one-device and port one-process
    references) of a target ``cfg`` and draft ``draft_cfg``; the near
    draft is the target with ``noise`` x a normal draw added."""
    jp = JG.init_gpt_params(jax.random.PRNGKey(0), cfg)
    jd = JG.init_gpt_params(jax.random.PRNGKey(7), draft_cfg)
    params = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
    draft = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jd))
    cls = torch.from_numpy(CLS.astype(np.int64))
    cond = TG.class_embed(params, cls)
    cfgs = {name: tuple(bridge.config_from_jax(c)
                        for c in _cfgs(cache, cfg, draft_cfg))
            for name, cache in CACHES.items()}
    # a noisy copy of the target as the draft: lanes accept 0 .. gamma
    cfgs["near"] = (cfgs["auto"][0], cfgs["auto"][0])
    g = torch.Generator().manual_seed(3)
    near = _noisy(params, g, noise)
    drafts = {"auto": draft, "int8": draft, "near": near}
    inputs = {"params": params, "drafts": drafts, "cond": cond, "cls": cls,
              "cfgs": cfgs, "steps": STEPS, "gamma": GAMMA, "seed": SEED,
              "top_k": TOP_K}

    ref = {}
    jc = JG.class_embed(jp, jnp.asarray(CLS))
    jdc = JG.class_embed(jd, jnp.asarray(CLS))
    for name, cache in CACHES.items():
        c, dc = _cfgs(cache, cfg, draft_cfg)
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
    return inputs, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four-rank world at the module's geometry, and one at 5 heads
    (``ODD``) under ``model=4``: (each world's rank outputs, their
    references)."""
    tmp = tmp_path_factory.mktemp("torch_spec_mesh")
    inputs, ref = _spec_case(CFG, DRAFT)

    # the pipeline with a draft (tests/test_speculative.py:180-206)
    exp, _, plain = tiny_pipelines()
    pdcfg = plain.exp.model.replace(n_layer=1)
    pdraft = TG.init_gpt_params(pdcfg, torch.Generator().manual_seed(42))
    pipe_kw = {"draft_params": pdraft, "draft_cfg": pdcfg, "gamma": GAMMA}
    serve = {"meshes": (), "cfgs": {}, "params": inputs["params"],
             "cond": inputs["cond"], "x": None, "steps": STEPS, "seed": SEED,
             "top_k": TOP_K, "pipe_meshes": ({"data": 2, "model": 2},),
             "pipe_exp": plain.exp, "pipe_gpt": plain.gpt_params,
             "pipe_vq": plain.vq, "pipe_melgan": plain.melgan,
             "pipe_cls": CLS[:4], "pipe_draft": pipe_kw}
    W.write_inputs(tmp / "even", {**inputs, "meshes": MESHES,
                                  "serve": serve})
    procs = {"even": W.spawn("spec", 4, tmp / "even")}
    # at 40 wide the 32-wide case's noise leaves a greedy draft no token
    odd_inputs, odd_ref = _spec_case(CFG.replace(**ODD),
                                     DRAFT.replace(**ODD), noise=0.001)
    W.write_inputs(tmp / "odd", {
        **odd_inputs, "meshes": ({"model": 4},),
        "serve": {"meshes": (), "cfgs": {}, "params": None, "cond": None,
                  "x": None}})
    procs["odd"] = W.spawn("spec", 4, tmp / "odd")
    spec = GenerationPipeline(plain.exp, plain.gpt_params, plain.vq,
                              plain.melgan, segments=2, chunk=0, bf16=False,
                              **pipe_kw)
    ref["pipe"] = spec.generate(CLS[:4], None, sample=False)
    outs = {w: W.join(p, tmp / w) for w, p in procs.items()}
    return outs, {"even": ref, "odd": odd_ref}


def _case(world, shape):
    """(rank outputs, references, output key of the mesh) of a case: the
    5-head world for a shape that names ``heads``."""
    outs, refs = world
    w = "odd" if "heads" in shape else "even"
    mesh = {k: v for k, v in shape.items() if k != "heads"}
    return outs[w], refs[w], _key(mesh)


def _noisy(params, g, noise):
    if isinstance(params, dict):
        return {k: _noisy(v, g, noise) for k, v in params.items()}
    return params + noise * torch.randn(params.shape, generator=g)


def _gathered(outs, key, shape):
    m = shape.get("model", 1)
    parts = [outs[r][key] for r in range(0, len(outs), m)]
    return (np.concatenate([p[0].numpy() for p in parts]),
            [p[1] for p in parts])


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("shape", MESHES + ODD_MESHES, ids=_key)
def test_speculative_tp_sharded_matches_single_device(world, shape, cache,
                                                      graph):
    """Greedy speculative decoding with target and draft cut over
    ``model`` (also 5 heads over 4 ranks) and the batch over ``data``:
    tokens, rounds and accepted exactly the JAX package's one-device run,
    on every rank."""
    outs, ref, key = _case(world, shape)
    toks, stats = _gathered(outs, f"{key}/{cache}/False/{graph}", shape)
    want, rounds, accepted = ref[f"jax/{cache}"]
    np.testing.assert_array_equal(toks, want)
    for o in outs:
        st = o[f"{key}/{cache}/False/{graph}"][1]
        assert (st["rounds"], st["accepted"]) == (rounds, accepted), st
        assert st["drafted"] == rounds * GAMMA


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("cache", list(CACHES) + ["near"])
@pytest.mark.parametrize("shape", MESHES + ODD_MESHES, ids=_key)
def test_speculative_sampled_over_mesh_equals_one_process(world, shape,
                                                          cache, sample):
    """Speculative decoding over the mesh against the port's one-process
    run for the seed, sampled and greedy, in both loops: every uniform
    (positions, acceptance, residual) drawn for the global batch and cut
    to this rank's rows, the advance the global minimum (with the near
    draft the data ranks' own minima differ), so tokens and stats are
    equal."""
    outs, ref, key = _case(world, shape)
    want, want_stats = ref[f"port/{cache}/{sample}"]
    for graph in (False, True):
        toks, stats = _gathered(outs, f"{key}/{cache}/{sample}/{graph}",
                                shape)
        np.testing.assert_array_equal(toks, want.numpy())
        assert all(s == want_stats for s in stats), (stats, want_stats)
    if cache == "near" and not sample:   # lanes accept more than none
        assert want_stats["accepted"] > 0


def test_pipeline_speculative_mesh_wiring(world):
    """GenerationPipeline with a draft over ``data=2,model=2``: greedy
    clips equal the meshless speculative pipeline's, stats too
    (tests/test_speculative.py:180-206)."""
    outs, ref, _ = _case(world, {})
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
    local = TM.shard_gpt_for_serving(mesh, params, c.n_head)
    cond = TG.class_embed(local, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="shard_block_weights"):
        TG.gpt_generate(local, c, None, cond, steps=2, sample=False,
                        mesh=mesh)
