"""The port's GPipe schedule (melspec_gpt_vqvae_tpu_torch/parallel/
pipeline.py) against the JAX package: forwards at pipe=4 (4
microbatches), pipe=2 (2) and data=2,pipe=2 (2) against JAX's sequential
``gpt_apply``; the loss and gradients against JAX's ``gpt_pp_loss_fn``;
the GPT and GPT-VAE tasks on a pipe mesh against JAX's data-parallel
tasks; dropout across data shards; the refusals.  A 4-layer variant of
tests/test_parallel.py's geometry (4 heads, 32 wide), so that four stages
hold a layer each.

Two gloo worlds run once for the module (tests/torch_dist_worlds.py,
``world_pp``): four ranks and two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (DataConfig, ExperimentConfig,
                                           GPTConfig, TrainConfig,
                                           VAEConfig)
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.parallel import pipeline as JPP
from melspec_gpt_vqvae_tpu.parallel.mesh import batch_sharding
from melspec_gpt_vqvae_tpu.parallel.mesh import make_mesh as jax_mesh
from melspec_gpt_vqvae_tpu.training.gpt_task import GPTTask as JGPTTask
from melspec_gpt_vqvae_tpu.training.vae_task import VAETask as JVAETask
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.parallel import pipeline as TPP
from melspec_gpt_vqvae_tpu_torch.parallel.mesh import Mesh, shard_tree

import torch_dist_worlds as W

CFG = GPTConfig(vocab_size=16, block_size=24, n_layer=4, n_head=4,
                n_embd=32, class_size=4)
TASK_CFG = CFG.replace(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                       block_size=21)
FORWARDS = {"pp": [({"pipe": 4}, 4), ({"data": 2, "pipe": 2}, 2)],
            "pp2": [({"pipe": 2}, 2)]}


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _exp(model, **vae):
    return ExperimentConfig(model=model, vae=VAEConfig(**vae),
                            train=TrainConfig(learning_rate=1e-3, epochs=1,
                                              batch_size=8),
                            data=DataConfig(batch_size=8))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pp")
    jparams = JG.init_gpt_params(jax.random.PRNGKey(0), CFG)
    params = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jparams))
    rng = np.random.default_rng(7)
    x = rng.integers(0, 16, (8, 12)).astype(np.int32)
    c = rng.integers(0, 4, (8,)).astype(np.int32)

    brng = np.random.default_rng(3)
    gbatch = {"codes": brng.integers(0, 16, (8, 5, 4)).astype(np.int32),
              "target": brng.integers(0, 4, (8, 1)).astype(np.int32)}
    jtask = JGPTTask(_exp(TASK_CFG), jax_mesh({"data": 2}))
    jstate = jtask.init_state(0)
    jstate, _ = jtask.train_step(jstate, gbatch, jax.random.PRNGKey(0))
    gtree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]),
        jstate["opt_state"], jstate["step"])

    vbatch = {"codes": brng.integers(0, 16, (8, 5, 4)).astype(np.int32)}
    vtask = JVAETask(_exp(TASK_CFG.replace(class_size=None), nz=32,
                          warm_up=2), 4, mesh=jax_mesh({"data": 2}))
    vstate = vtask.init_state(0)
    vtree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, vstate["params"]),
        vstate["opt_state"], vstate["step"], kl_weight=vstate["kl_weight"])
    vkey = jax.random.PRNGKey(5)
    veps = torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(vkey)[0], (8, 1, 32))))

    common = {"cfg": bridge.config_from_jax(CFG), "params": params,
              "x": torch.from_numpy(x).long(),
              "tokens": torch.from_numpy(
                  rng.integers(0, 16, (8, 13))).long(),
              "classes": torch.from_numpy(c).long(),
              "exp": bridge.config_from_jax(jtask.exp), "gpt_tree": gtree,
              "gpt_batch": gbatch,
              "vae_exp": bridge.config_from_jax(vtask.exp),
              "vae_tree": vtree, "vae_batch": vbatch, "vae_eps": veps}
    procs = {}
    for name, size in (("pp", 4), ("pp2", 2)):
        W.write_inputs(tmp / name, dict(common, forwards=FORWARDS[name],
                                        full=name == "pp"))
        procs[name] = W.spawn("pp", size, tmp / name)

    ref = {}
    cond = JG.class_embed(jparams, jnp.asarray(c))
    ref["forward"] = np.asarray(JG.gpt_apply(jparams, CFG, jnp.asarray(x),
                                             cond, use_pallas=False)[0])
    mesh = jax_mesh({"data": 2, "pipe": 2})
    sharded = JPP.shard_gpt_params_pp(mesh, jparams)
    toks = jnp.asarray(np.asarray(common["tokens"]), jnp.int32)
    xs = jax.device_put(toks, batch_sharding(mesh, 2))
    cs = jax.device_put(jnp.asarray(c), batch_sharding(mesh, 1))
    ref["loss"], ref["grads"] = jax.jit(jax.value_and_grad(
        lambda p: JPP.gpt_pp_loss_fn(p, CFG, xs, cs, mesh, n_micro=2,
                                     use_pallas=False)))(sharded)
    jstate, jloss = jtask.train_step(jstate, gbatch, jax.random.PRNGKey(7))
    ref["gpt_loss"] = float(jloss)
    ref["gpt_eval"] = float(jtask.eval_step(jstate, gbatch))
    vstate, vloss, _ = vtask.train_step(vstate, vbatch, vkey)
    ref["vae_loss"], ref["vae_state"] = float(vloss), vstate
    out = {name: W.join(p, tmp / name) for name, p in procs.items()}
    return out, ref


@pytest.mark.parametrize("world,key", [
    ("pp", "pipe=4"), ("pp", "data=2,pipe=2"), ("pp2", "pipe=2")])
def test_pp_forward_matches_sequential_jax(worlds, world, key):
    """Every stage returns the logits of its data rank's rows, within 2e-5
    of JAX's sequential gpt_apply."""
    out, ref = worlds
    data = 2 if key.startswith("data") else 1
    pipe = len(out[world]) // data
    for r, o in enumerate(out[world]):
        d = r // pipe
        rows = slice(d * 8 // data, (d + 1) * 8 // data)
        np.testing.assert_allclose(_np(o[f"forward/{key}"]),
                                   ref["forward"][rows], atol=2e-5)


@pytest.mark.parametrize("variant", ["plain", "remat"])
def test_pp_loss_and_grads_match_jax(worlds, variant):
    """data=2, pipe=2, two microbatches: the loss (the mean of the data
    ranks' losses, each the same on both stages) within 1e-5 and every
    gathered gradient (the blocks' stage slabs, the pipe-summed
    embeddings, ln_f and head, averaged over data) within 5e-5 of JAX's
    gpt_pp_loss_fn; remat (policy attn) the same."""
    out, ref = worlds
    want = {jax.tree_util.keystr(p).replace("']['", "/").strip("[]'"): v
            for p, v in jax.tree_util.tree_leaves_with_path(ref["grads"])}
    losses = [o[f"loss/{variant}"] for o in out["pp"]]
    assert losses[0] == losses[1] and losses[2] == losses[3]
    assert abs((losses[0] + losses[2]) / 2 - float(ref["loss"])) < 1e-5
    for n, g in _flat(out["pp"][0][f"grads/{variant}"]):
        np.testing.assert_allclose(_np(g), np.asarray(want[n]),
                                   atol=5e-5, err_msg=n)
    assert all(o[f"grads/{variant}"] is None for o in out["pp"][1:])
    # the stages of data rank 1 hold data rank 0's averaged gradients
    for r in (0, 1):
        for (n, a), (_, b) in zip(
                _flat(out["pp"][r][f"local_grads/{variant}"]),
                _flat(out["pp"][r + 2][f"local_grads/{variant}"])):
            assert torch.equal(a, b), (r, n)


def test_pp_tasks_match_data_parallel_jax(worlds):
    """GPTTask and VAETask at data=2,pipe=2 (pp_micro 2) from a JAX state:
    the first loss within 1e-5 (GPT) and 1e-4 (VAE, JAX's noise) of JAX's
    data-parallel tasks; the GPT's evaluation after the step within 1e-5;
    the VAE's parameters after it."""
    out, ref = worlds
    for o in out["pp"]:
        assert abs(o["gpt_loss"] - ref["gpt_loss"]) < 1e-5
        assert abs(o["vae_loss"] - ref["vae_loss"]) < 1e-4
    ev = np.mean([out["pp"][r]["gpt_eval"] for r in (0, 2)])
    assert abs(ev - ref["gpt_eval"]) < 1e-5
    adam = ref["vae_state"]["opt_state"].inner_state[0]
    noise = {n: np.asarray(v) < 1e-14 for n, v in _flat(adam.nu)}
    want = dict(_flat(ref["vae_state"]["params"]))
    for n, t in _flat(out["pp"][0]["vae_after"]["params"]):
        ok = np.abs(_np(t) - np.asarray(want[n])) <= 1e-5
        assert (ok | noise[n]).all(), n


def test_pp_dropout_independent_across_data_shards(worlds):
    """The same rows on both data ranks draw other masks; the stages of a
    data rank return the same logits."""
    out, _ = worlds
    d = [o["dropout"] for o in out["pp"]]
    assert torch.equal(d[0], d[1]) and torch.equal(d[2], d[3])
    assert not torch.allclose(d[0], d[2])


@pytest.mark.parametrize("name", ["layers", "micro"])
def test_pp_rejects_bad_shapes(worlds, name):
    """n_layer 6 over 4 stages and a local batch of 8 over 3 microbatches
    raise on every rank, before any collective."""
    out, _ = worlds
    for o in out["pp"]:
        assert o[f"refused/{name}"] is not None
        assert "divisible" in o[f"refused/{name}"]


def test_pp_param_axes_and_single_process_pipe():
    """The stage cut of each leaf (JAX's gpt_param_pp_pspecs: the layer
    axis of a stacked blocks leaf, the others whole; the rule alone, on a
    Mesh of two stages without a process group), and a pipe axis of one
    stage: the schedule over 4 microbatches equals gpt_apply; a batch the
    microbatches do not divide is refused."""
    cfg = bridge.config_from_jax(CFG)
    params = TG.init_gpt_params(cfg, torch.Generator().manual_seed(0))
    stage = shard_tree(Mesh({"pipe": 2}, "cpu"), params, cfg.n_head)
    half = cfg.n_layer // 2
    assert torch.equal(stage["blocks"]["attn_qkv"]["w"],
                       params["blocks"]["attn_qkv"]["w"][:half])
    assert torch.equal(stage["blocks"]["ln1_s"],
                       params["blocks"]["ln1_s"][:half])
    assert stage["tok_emb"] is params["tok_emb"]
    assert stage["head"]["w"] is params["head"]["w"]
    x = torch.randint(0, 16, (8, 12), generator=torch.Generator())
    mesh = Mesh({"pipe": 1}, "cpu", n_micro=4)
    with torch.no_grad():
        torch.testing.assert_close(
            TPP.gpt_apply_pp(params, cfg, x, mesh=mesh),
            TG.gpt_apply(params, cfg, x), atol=1e-6, rtol=1e-6)
    mesh.n_micro = 3
    with pytest.raises(ValueError, match="divisible"):
        TPP.gpt_apply_pp(params, cfg, x, mesh=mesh)
