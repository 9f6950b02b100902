"""The port's mesh, Megatron tensor parallelism and data parallelism
(melspec_gpt_vqvae_tpu_torch/parallel/mesh.py, models/gpt.py's TP path,
the tasks' ``mesh``) against the JAX package, at tests/test_parallel.py's
geometry (2 layers, 4 heads, 32 wide).

Three gloo worlds run once for the module (tests/torch_dist_worlds.py):
four ranks (``model=4`` and ``data=2,model=2``) at that geometry, four at
an odd head count (``ODD``: 5 heads, 40 wide, cut 2, 1, 1, 1 over
``model=4`` and 3, 2 over ``model=2``), and two (``data=2``).  The JAX
references are computed here while they run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (DataConfig, ExperimentConfig,
                                           GPTConfig, TrainConfig,
                                           VAEConfig)
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.parallel.mesh import make_mesh as jax_mesh
from melspec_gpt_vqvae_tpu.training.gpt_task import GPTTask as JGPTTask
from melspec_gpt_vqvae_tpu.training.vae_task import VAETask as JVAETask
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import configs as TC
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.parallel import mesh as TM
from melspec_gpt_vqvae_tpu_torch.training import optim as TO
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask, _map
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import gpt_loss_fn
from melspec_gpt_vqvae_tpu_torch.training.lstm_task import LSTMVAETask

import torch_dist_worlds as W

CFG = GPTConfig(vocab_size=16, block_size=24, n_layer=2, n_head=4,
                n_embd=32, class_size=4)
TASK_CFG = CFG.replace(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                       block_size=21)
# heads the model axis does not divide (parallel/mesh.py::head_range)
ODD = dict(n_head=5, n_embd=40)
MAX_NORM = 0.05


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


def _jax_gpt_task(task_cfg=TASK_CFG):
    """JAX's GPTTask on a data=2 mesh after two steps: (task, state, the
    port's tree of that state, the batch)."""
    rng = np.random.default_rng(3)
    batch = {"codes": rng.integers(0, 16, (8, 5, 4)).astype(np.int32),
             "target": rng.integers(0, 4, (8, 1)).astype(np.int32)}
    task = JGPTTask(_exp(task_cfg), jax_mesh({"data": 2}))
    state = task.init_state(0)
    for s in range(2):
        state, _ = task.train_step(state, batch, jax.random.PRNGKey(s))
    tree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state["params"]),
        state["opt_state"], state["step"])
    return task, state, tree, batch


def _jax_vae_task(task_cfg=TASK_CFG):
    rng = np.random.default_rng(4)
    batch = {"codes": rng.integers(0, 16, (8, 5, 4)).astype(np.int32)}
    task = JVAETask(_exp(task_cfg.replace(class_size=None),
                         nz=task_cfg.n_embd, warm_up=2), 4,
                    mesh=jax_mesh({"data": 2}))
    state = task.init_state(0)
    state, _, _ = task.train_step(state, batch, jax.random.PRNGKey(1))
    tree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state["params"]),
        state["opt_state"], state["step"], kl_weight=state["kl_weight"])
    return task, state, tree, batch


def _elbo_eps(key, b, nz):
    """The eps JAX's elbo_loss draws from ``key`` (k_enc of its split)."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key)[0], (b, 1, nz))))


def _lstm_inputs():
    """A tiny LSTM-VAE (SGD with momentum, the global-norm clip live) and
    one step of it on one process, the port alone."""
    cfg = TC.LSTMConfig(vocab_size=18, nz=8, ni=16, enc_nh=16, dec_nh=16,
                        dec_dropout_in=0.0, dec_dropout_out=0.0, bos_id=16,
                        eos_id=17, max_len=22)
    exp = TC.ExperimentConfig(
        model=TC.GPTConfig(vocab_size=18, block_size=22, n_layer=1,
                           n_head=1, n_embd=16),
        vae=TC.VAEConfig(nz=8),
        train=TC.TrainConfig(learning_rate=0.5, optimizer="sgd",
                             momentum=0.5, epochs=1, batch_size=4,
                             grad_clip=0.5))
    batch = {"codes": np.random.default_rng(5).integers(
        0, 16, (4, 4, 5)).astype(np.int32)}
    eps = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 1, 8)).astype(np.float32))
    task = LSTMVAETask(exp, cfg, 4, "cpu")
    state = task.init_state(0)
    state, _, _ = task.train_step(state, batch, torch.Generator(),
                                  eps=torch.zeros_like(eps))
    tree = task.state_tree(state)
    tree = {k: (_map(v, lambda t: t.clone()) if isinstance(v, dict) else v)
            for k, v in tree.items()}
    state, loss, _ = task.train_step(state, batch, torch.Generator(),
                                     eps=eps)
    return ({"lstm_exp": exp, "lstm_cfg": cfg, "lstm_tree": tree,
             "lstm_batch": batch, "lstm_eps": eps},
            float(loss), task.state_tree(state))


def _start_tp(tmp, cfg, task_cfg, world, lstm_inp):
    """Write a ``tp`` world's inputs at ``cfg`` (the tasks at
    ``task_cfg``), start it, and compute its JAX and one-process
    references meanwhile: (the started world, the references)."""
    jparams = JG.init_gpt_params(jax.random.PRNGKey(0), cfg)
    params = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jparams))
    rng = np.random.default_rng(1)
    x = rng.integers(0, 16, (4, 10)).astype(np.int64)
    tokens = rng.integers(0, 16, (8, 23)).astype(np.int64)
    classes = rng.integers(0, 4, (8,)).astype(np.int64)
    jtask, jstate, gtree, gbatch = _jax_gpt_task(task_cfg)
    vtask, vstate, vtree, vbatch = _jax_vae_task(task_cfg)
    vkey = jax.random.PRNGKey(5)
    vexp = bridge.config_from_jax(vtask.exp)

    # a checkpoint of one process for the mesh to restore
    exp = bridge.config_from_jax(jtask.exp)
    single = GPTTask(exp, "cpu")
    sstate = single.init_state(1)
    sstate, _ = single.train_step(sstate, gbatch, torch.Generator())
    ckpt_in = tmp / f"ckpt_in_{world}"
    CheckpointManager(str(ckpt_in)).save(
        {"state": single.state_tree(sstate), "epoch": 0}, 1)
    single_tree = single.state_tree(sstate)
    single_eval = float(single.eval_step(sstate, gbatch))

    common = {"cfg": bridge.config_from_jax(cfg), "params": params,
              "x": torch.from_numpy(x), "tokens": torch.from_numpy(tokens),
              "classes": torch.from_numpy(classes), "max_norm": MAX_NORM,
              "exp": exp, "gpt_tree": gtree, "gpt_batch": gbatch,
              "vae_exp": vexp, "vae_tree": vtree, "vae_batch": vbatch,
              "vae_eps": _elbo_eps(vkey, 8, task_cfg.n_embd),
              "ckpt_in": str(ckpt_in),
              "ckpt_out": str(tmp / f"ckpt_out_{world}"), **lstm_inp}
    W.write_inputs(tmp / world, common)
    procs = W.spawn("tp", 4, tmp / world)

    ref = {"params": jparams, "params_t": params, "common": common,
           "cfg": cfg}
    ref["forward"] = np.asarray(JG.gpt_apply(jparams, cfg, jnp.asarray(x),
                                             use_pallas=False)[0])
    ref["gpt_eval"] = float(jtask.eval_step(jstate, gbatch))
    jstate, jloss = jtask.train_step(jstate, gbatch, jax.random.PRNGKey(7))
    ref["gpt_loss"], ref["gpt_state"] = float(jloss), jstate
    vstate, vloss, _ = vtask.train_step(vstate, vbatch, vkey)
    ref["vae_loss"], ref["vae_state"] = float(vloss), vstate
    ref["single_tree"], ref["single_eval"] = single_tree, single_eval
    # the full-gradient clip on one process
    full = _map(TG.tree_to(params), lambda t: t.clone().requires_grad_(True))
    gpt_loss_fn(full, common["cfg"], common["tokens"],
                common["classes"]).backward()
    named = list(TO.named_leaves(full))
    ref["norm"] = float(torch.sqrt(sum((t.grad ** 2).sum()
                                       for _, t in named)))
    TO.clip_by_global_norm_(named, MAX_NORM)
    ref["clipped"] = _map(full, lambda t: t.grad)
    return procs, ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the worlds, compute the JAX side meanwhile, join them.
    ``ref`` holds the even geometry's references, ``ref["tp_odd"]`` the
    odd head count's."""
    tmp = tmp_path_factory.mktemp("torch_tp")
    lstm_inp, lstm_loss, lstm_after = _lstm_inputs()
    tp, ref = _start_tp(tmp, CFG, TASK_CFG, "tp", lstm_inp)
    W.write_inputs(tmp / "dp", ref["common"])
    dp = W.spawn("dp", 2, tmp / "dp")
    tp_odd, ref["tp_odd"] = _start_tp(tmp, CFG.replace(**ODD),
                                      TASK_CFG.replace(**ODD), "tp_odd", {})
    ref["lstm_loss"], ref["lstm_after"] = lstm_loss, lstm_after
    out = {"tp": W.join(tp, tmp / "tp"), "dp": W.join(dp, tmp / "dp"),
           "tp_odd": W.join(tp_odd, tmp / "tp_odd")}
    return out, ref, tmp


def _case(worlds, key):
    """(the world's rank outputs, its references, the mesh key) of a case
    key: ``odd/...`` for the odd head count's world."""
    out, ref, _ = worlds
    if key.startswith("odd/"):
        return out["tp_odd"], ref["tp_odd"], key[4:]
    return out["tp"], ref, key


# ------------------------------ mesh parsing ---------------------------------

@pytest.mark.parametrize("spec,shape", [
    ("", None), ("data=2,model=4", {"data": 2, "model": 4}),
    ("pipe=4", {"pipe": 4}), ("data=-1,model=2", {"data": -1, "model": 2})])
def test_parse_mesh(spec, shape):
    assert TM.parse_mesh(spec) == shape


@pytest.mark.parametrize("rank,coords", [
    (0, (0, 0)), (3, (0, 3)), (4, (1, 0)), (6, (1, 2))])
def test_rank_coordinates_are_row_major(rank, coords):
    """Under {"data": 2, "model": 4}, rank r has data coordinate r // 4
    and model coordinate r % 4 (the JAX mesh's reshape of the devices)."""
    assert TM._unravel(rank, (2, 4)) == coords
    assert TM._ravel(coords, (2, 4)) == rank


@pytest.mark.parametrize("shape,match", [
    ({"data": 2}, "world size is 1"), ({"model": 2, "pipe": 1},
                                       "world size is 1"),
    ({"data": -1, "model": -1}, "at most one")])
def test_make_mesh_refuses_a_mesh_off_the_world(shape, match):
    with pytest.raises(ValueError, match=match):
        TM.make_mesh(shape)


def test_unknown_axis_and_single_process_mesh():
    with pytest.raises(ValueError, match="unknown axis"):
        TM.parse_mesh("data=1,tensor=2")
    mesh = TM.make_mesh({"data": -1, "model": 1})
    assert mesh.shape == {"data": 1, "model": 1}
    assert not mesh.active("data") and not mesh.sharded
    assert TM.local_batch_slice(8, mesh) == slice(0, 8)


# ------------------------------ shards ---------------------------------------

@pytest.mark.parametrize("key,m", [("model=4", 4), ("data=2,model=2", 2),
                                   ("odd/model=4", 4),
                                   ("odd/data=2,model=2", 2)])
def test_shard_gather_round_trip(worlds, key, m):
    """Gathering every rank's shard gives the full tree bit for bit on
    rank 0 (the other ranks get None), and rank r's fused qkv holds its
    heads of each of q, k and v (``head_range``: an even cut of 4 heads,
    2, 1, 1, 1 and 3, 2 of 5), ``attn_proj`` those heads' rows."""
    outs, ref, key = _case(worlds, key)
    c = ref["cfg"].n_embd
    hd = c // ref["cfg"].n_head
    full = dict(_flat(ref["params_t"]))
    for n, t in _flat(outs[0][f"round_trip/{key}"]):
        assert torch.equal(t, full[n]), n
    counts = []
    for r, o in enumerate(outs):
        assert r == 0 or o[f"round_trip/{key}"] is None
        shard = dict(_flat(o[f"shard/{key}"]))
        mr = r % m
        lo, n = TM.head_range(ref["cfg"].n_head, m, mr)
        counts.append(n)
        rows = slice(lo * hd, (lo + n) * hd)
        qkv = full["blocks/attn_qkv/w"]
        want = torch.cat([qkv[..., i * c:(i + 1) * c][..., rows]
                          for i in range(3)], -1)
        assert torch.equal(shard["blocks/attn_qkv/w"], want)
        assert torch.equal(shard["blocks/attn_proj/w"],
                           full["blocks/attn_proj/w"][:, rows])
        w = 4 * c // m
        assert torch.equal(shard["blocks/mlp_down/w"],
                           full["blocks/mlp_down/w"][:, mr * w:(mr + 1) * w])
        assert torch.equal(shard["blocks/attn_proj/b"],
                           full["blocks/attn_proj/b"])
    assert counts[:m] == TM.head_counts(ref["cfg"].n_head, m)


@pytest.mark.parametrize("n_head,m,counts", [
    (4, 2, [2, 2]), (5, 4, [2, 1, 1, 1]), (5, 2, [3, 2]),
    (23, 4, [6, 6, 6, 5]), (23, 2, [12, 11]), (3, 3, [1, 1, 1])])
def test_head_range_partition(n_head, m, counts):
    """The first ``n_head % m`` ranks take ``ceil(n_head / m)`` heads, the
    rest ``floor``, in order and without a gap."""
    ranges = [TM.head_range(n_head, m, r) for r in range(m)]
    assert [n for _, n in ranges] == counts == TM.head_counts(n_head, m)
    assert [lo for lo, _ in ranges] == [sum(counts[:r]) for r in range(m)]


@pytest.mark.parametrize("cfg,m,match", [
    (dict(n_head=3, n_embd=24), 4, "exceeds n_head 3"),
    (dict(n_head=4, n_embd=8), 3, r"MLP width 4 \* n_embd = 32"),
    (dict(n_head=5, n_embd=40), 4, None),
    (dict(n_head=23, n_embd=1472), 4, None)],
    ids=["wider_than_heads", "mlp_width", "5_heads", "23_heads"])
def test_check_divisible_refuses_what_no_rank_can_hold(cfg, m, match):
    """A model axis may cut the heads unevenly; it is refused only wider
    than the heads, or where it does not divide the MLP's width (that cut
    stays even); each refusal names its limit."""
    mesh = TM.Mesh({"model": m}, "cpu")   # the rule alone, no group
    c = TC.GPTConfig(vocab_size=16, block_size=8, n_layer=1, **cfg)
    if match is None:
        TM.check_divisible(mesh, c)
        return
    with pytest.raises(ValueError, match=match):
        TM.check_divisible(mesh, c)
    with pytest.raises(ValueError, match=match):
        GPTTask(TC.ExperimentConfig(model=c), "cpu", mesh)


# ------------------------------ forwards and steps ---------------------------

@pytest.mark.parametrize("key", ["model=4", "data=2,model=2",
                                 "odd/model=4", "odd/data=2,model=2"])
def test_tp_forward_matches_jax(worlds, key):
    outs, ref, key = _case(worlds, key)
    for o in outs:
        np.testing.assert_allclose(_np(o[f"forward/{key}"]), ref["forward"],
                                   atol=2e-5)


def _assert_after_step(tree, jstate, tol=1e-6):
    """Params after the step within ``tol`` of JAX's, except where Adam's
    second moment is zero up to rounding (a gradient of rounding noise
    turns into a step of +-lr whose sign is the rounding's)."""
    adam = jstate["opt_state"].inner_state[0]
    noise = {n: np.asarray(v) < 1e-14 for n, v in _flat(adam.nu)}
    want = dict(_flat(jstate["params"]))
    for n, t in _flat(tree["params"]):
        ok = np.abs(_np(t) - np.asarray(want[n])) <= tol
        assert (ok | noise[n]).all(), n
    # those are few: the key half of the qkv bias (softmax ignores it),
    # unused embedding rows
    assert sum(int(v.sum()) for v in noise.values()) < 0.01 * sum(
        v.size for v in noise.values())


@pytest.mark.parametrize("world", ["tp", "dp", "tp_odd"])
def test_gpt_task_step_matches_jax(worlds, world):
    """GPTTask at data=2,model=2 (tensor parallel; 4 heads, and 5 cut 3,
    2) and data=2 (DDP) from a JAX state: the loss of the global batch
    within 1e-5 of JAX's GPTTask on make_mesh({"data": 2}), every rank's,
    and the parameters after one AdamW step."""
    out, ref, _ = worlds
    if world == "tp_odd":
        ref = ref["tp_odd"]
    for o in out[world]:
        assert abs(o["gpt_loss"] - ref["gpt_loss"]) < 1e-5
    _assert_after_step(out[world][0]["gpt_after"], ref["gpt_state"])
    if world != "dp":
        # the gathered tree is rank 0's alone
        assert all(o["gpt_after"] is None for o in out[world][1:])
    # each rank's parameters after the step equal its data replica's
    stride = len(out[world]) // 2
    for r in range(stride):
        for (n, a), (_, b) in zip(_flat(out[world][r]["gpt_local"]),
                                  _flat(out[world][r + stride]["gpt_local"])):
            assert torch.equal(a, b), (r, n)


def test_tp_eval_and_vae_step_match_jax(worlds):
    """The TP task's evaluation (the mean of the data ranks') and the
    GPT-VAE task's first loss at data=2,model=2 with JAX's noise: 1e-5 and
    1e-4 of JAX's; at 4 heads and at 5 (cut 3, 2)."""
    for key in ("", "odd/"):
        outs, ref, _ = _case(worlds, key)
        ev = np.mean([outs[r]["gpt_eval"] for r in (0, 2)])
        assert abs(ev - ref["gpt_eval"]) < 1e-5
        for o in outs:
            assert abs(o["vae_loss"] - ref["vae_loss"]) < 1e-4
        _assert_after_step(outs[0]["vae_after"], ref["vae_state"], 1e-5)


def test_lstm_data_parallel_matches_one_process(worlds):
    """The LSTM-VAE at data=2 (SGD with momentum, the clip live after the
    all-reduce) against the same step on one process."""
    out, ref, _ = worlds
    for o in out["dp"]:
        assert abs(o["lstm_loss"] - ref["lstm_loss"]) < 1e-5
        want = dict(_flat(ref["lstm_after"]["params"]))
        for n, t in _flat(o["lstm_after"]["params"]):
            torch.testing.assert_close(t, want[n], atol=1e-5, rtol=1e-5)


def test_clip_by_global_norm_over_model_shards(worlds):
    """The global norm over model=4 shards, even (4 heads) and unequal (5
    heads cut 2, 1, 1, 1), clips as on one process."""
    for key in ("", "odd/"):
        outs, ref, _ = _case(worlds, key)
        assert ref["norm"] > MAX_NORM
        want = dict(_flat(ref["clipped"]))
        for n, g in _flat(outs[0]["clipped_grads"]):
            torch.testing.assert_close(g, want[n], atol=1e-7, rtol=1e-5)


def test_dropout_independent_across_data_replicated_across_model(worlds):
    """The same rows on every rank: the two data ranks draw other masks,
    the two model ranks of a data group the same (their activations are
    replicas)."""
    out, _, _ = worlds
    for world in ("tp", "tp_odd"):
        d = [o["dropout"] for o in out[world]]
        assert torch.equal(d[0], d[1]) and torch.equal(d[2], d[3])
        assert not torch.allclose(d[0], d[2])


# ------------------------------ checkpoints ----------------------------------

def test_checkpoint_written_on_a_mesh_restores_on_one_process(worlds):
    """The data=2,model=2 checkpoint restores at world size 1 bit for bit
    (and on the mesh again), and a world-size-1 checkpoint restores on the
    mesh bit for bit, its evaluation the same; at 4 heads and at 5 (cut 3,
    2: the gathered leaves join parts of unequal size)."""
    _, _, tmp = worlds
    for key, world in (("", "tp"), ("odd/", "tp_odd")):
        outs, ref, _ = _case(worlds, key)
        task = GPTTask(ref["common"]["exp"], "cpu")
        tree = CheckpointManager(str(tmp / f"ckpt_out_{world}")).restore(
            "last")["state"]
        again = task.state_tree(task.load_state(tree))
        for part in ("params", "mu", "nu"):
            written = dict(_flat(outs[0]["gpt_after"][part]))
            reloaded = dict(_flat(outs[0]["gpt_reloaded"][part]))
            for n, t in _flat(again[part]):
                assert torch.equal(t, written[n]) and torch.equal(
                    t, reloaded[n]), (part, n)
            single = dict(_flat(ref["single_tree"][part]))
            for n, t in _flat(outs[0]["restored_single"][part]):
                assert torch.equal(t, single[n]), (part, n)
        assert all(o["restored_single"] is None for o in outs[1:])
        assert again["count"] == outs[0]["gpt_after"]["count"] == 3
        ev = np.mean([outs[r]["restored_single_eval"] for r in (0, 2)])
        assert abs(ev - ref["single_eval"]) < 1e-5


def test_adafactor_refuses_split_parameters():
    """optax's adafactor factors and clips over whole leaves: a mesh that
    splits them is refused (the rule alone: a Mesh object of two model
    ranks, no process group)."""
    mesh = TM.Mesh({"model": 2}, "cpu")
    assert mesh.sharded
    params = {"blocks": {"attn_qkv": {"w": torch.zeros(2, 4, 12)}}}
    with pytest.raises(ValueError, match="adafactor"):
        TO.make_optimizer("adafactor", params, 1e-3, mesh=mesh)
