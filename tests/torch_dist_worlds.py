"""Worlds of gloo processes for the port's distributed tests.

A test writes its inputs (torch tensors, the port's configs, numpy arrays)
into a directory with ``write_inputs``, starts a world with ``spawn`` --
``size`` processes of this file, each joining a gloo process group through
a ``file://`` store in that directory (no fixed port, so parallel test
workers never clash) -- and ``join``s it under a time limit: a world that
does not finish in time is killed and the test fails.  Each rank runs the
world's function (``WORLDS``) and saves what it computed as
``out_{rank}.pt``; the test compares that with the JAX package, which only
the test process imports.

Run by ``spawn`` as ``python tests/torch_dist_worlds.py WORLD RANK SIZE
DIR``.  Every rank pins torch to one thread.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
COLLECTIVE_TIMEOUT = timedelta(seconds=120)


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------


def write_inputs(folder, inputs) -> None:
    import torch
    os.makedirs(folder, exist_ok=True)
    torch.save(inputs, os.path.join(folder, "inputs.pt"))


def spawn(world: str, size: int, folder):
    """Start ``size`` ranks of ``world`` on the inputs in ``folder``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = []
    for rank in range(size):
        log = open(os.path.join(folder, f"log_{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, world, str(rank), str(size),
             str(folder)], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=str(REPO)), log))
    return procs


def join(procs, folder, timeout: float = 300.0):
    """Wait for every rank; kill them all and raise past ``timeout`` or
    when one failed.  Returns each rank's saved outputs."""
    import torch
    deadline = time.monotonic() + timeout
    failed = None
    try:
        for p, _ in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                failed = f"the world ran past its {timeout:.0f} s limit"
                break
            if p.returncode != 0 and failed is None:
                failed = f"a rank exited with {p.returncode}"
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(
            f"--- rank {r} ---\n" + Path(folder, f"log_{r}.txt").read_text()
            [-3000:] for r in range(len(procs)))
        raise AssertionError(f"{failed}\n{logs}")
    return [torch.load(os.path.join(folder, f"out_{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------


def _rows(x, mesh):
    from melspec_gpt_vqvae_tpu_torch.parallel import local_batch_slice
    return x[local_batch_slice(x.shape[0], mesh)]


def _batch_rows(batch, mesh):
    return {k: _rows(v, mesh) for k, v in batch.items()}


def _mesh(shape, n_micro=0):
    from melspec_gpt_vqvae_tpu_torch.parallel import make_mesh
    return make_mesh(shape, "cpu", n_micro)


def _local(params, mesh, n_head):
    from melspec_gpt_vqvae_tpu_torch.parallel import shard_tree
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import _map
    return _map(shard_tree(mesh, params, n_head), lambda t: t.clone())


def world_tp(inp, out):
    """Tensor parallelism: forwards, shards, tasks, dropout, clipping and
    checkpoints over 4 ranks (at ``inp["cfg"]``'s head count, even or
    not over the model axis)."""
    import torch

    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.parallel import gather_tree
    from melspec_gpt_vqvae_tpu_torch.training import optim as O
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import (GPTTask, _map,
                                                               gpt_loss_fn)
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask

    cfg, params, x = inp["cfg"], inp["params"], inp["x"]
    for shape in ({"model": 4}, {"data": 2, "model": 2}):
        mesh = _mesh(shape)
        key = ",".join(f"{k}={v}" for k, v in shape.items())
        local = _local(params, mesh, cfg.n_head)
        out[f"shard/{key}"] = local
        out[f"round_trip/{key}"] = gather_tree(mesh, local, cfg.n_head)
        with torch.no_grad():
            out[f"forward/{key}"] = G.gpt_apply(local, cfg, x, mesh=mesh)

    # dropout: the same rows on every rank, a train forward
    mesh = _mesh({"data": 2, "model": 2})
    dcfg = cfg.replace(embd_pdrop=0.5, attn_pdrop=0.5, resid_pdrop=0.5)
    gen = step_generator(5, 0, 0, torch.device("cpu"),
                         mesh.coord("data"))
    with torch.no_grad():
        out["dropout"] = G.gpt_apply(_local(params, mesh, cfg.n_head), dcfg,
                                     x, train=True, generator=gen, mesh=mesh)

    # the global gradient norm over model shards
    mesh = _mesh({"model": 4})
    local = _map(_local(params, mesh, cfg.n_head),
                 lambda t: t.requires_grad_(True))
    gpt_loss_fn(local, cfg, inp["tokens"], inp["classes"],
                mesh=mesh).backward()
    O.clip_by_global_norm_(list(O.named_leaves(local)), inp["max_norm"],
                           mesh)
    out["clipped_grads"] = gather_tree(mesh, _map(local, lambda t: t.grad),
                                        cfg.n_head)

    # the tasks at data=2, model=2 from a JAX state, one step
    for name, make in (
            ("gpt", lambda: GPTTask(inp["exp"], "cpu",
                                    "data=2,model=2")),
            ("vae", lambda: VAETask(inp["vae_exp"], 4, "cpu",
                                    "data=2,model=2"))):
        task = make()
        state = task.load_state(inp[f"{name}_tree"])
        batch = _batch_rows(inp[f"{name}_batch"], task.mesh)
        g = torch.Generator()
        if name == "gpt":
            out["gpt_eval"] = float(task.eval_step(state, batch))
            state, loss = task.train_step(state, batch, g)[:2]
        else:
            state, loss, _ = task.train_step(
                state, batch, g, eps=_rows(inp["vae_eps"], task.mesh))
        out[f"{name}_loss"] = float(loss)
        out[f"{name}_after"] = task.state_tree(state)   # None off rank 0
        out[f"{name}_local"] = _map(state["params"],
                                    lambda t: t.detach().clone())
        if name == "gpt":
            # the checkpoint this mesh writes, and the one of a single
            # process it restores
            ckpt = CheckpointManager(inp["ckpt_out"])
            ckpt.save({"state": task.state_tree(state), "epoch": 0}, 3)
            ckpt.wait()
            back = task.load_state(ckpt.restore("last")["state"])
            out["gpt_reloaded"] = task.state_tree(back)
            single = task.load_state(
                CheckpointManager(inp["ckpt_in"]).restore("last")["state"])
            out["restored_single"] = task.state_tree(single)
            out["restored_single_eval"] = float(task.eval_step(
                single, _batch_rows(inp["gpt_batch"], task.mesh)))


def world_dp(inp, out):
    """Data parallelism over 2 ranks: the class GPT's step from a JAX
    state, and the LSTM-VAE's against one process."""
    import torch

    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask, _map
    from melspec_gpt_vqvae_tpu_torch.training.lstm_task import LSTMVAETask

    task = GPTTask(inp["exp"], "cpu", "data=2")
    state = task.load_state(inp["gpt_tree"])
    state, loss = task.train_step(
        state, _batch_rows(inp["gpt_batch"], task.mesh), torch.Generator())
    out["gpt_loss"] = float(loss)
    out["gpt_after"] = task.state_tree(state)
    out["gpt_local"] = _map(state["params"], lambda t: t.detach().clone())

    lt = LSTMVAETask(inp["lstm_exp"], inp["lstm_cfg"], 4, "cpu", "data=2")
    state = lt.load_state(inp["lstm_tree"])
    x = lt.batch_tokens(inp["lstm_batch"])
    rows = _rows(torch.arange(x.shape[0]), lt.mesh)
    state, loss, _ = lt.train_step(
        state, x[rows], torch.Generator(), eps=inp["lstm_eps"][rows])
    out["lstm_loss"] = float(loss)
    out["lstm_after"] = lt.state_tree(state)


def world_pp(inp, out):
    """Pipeline parallelism over 4 ranks (``size`` 4) or 2."""
    import torch

    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.parallel.mesh import (gather_tree,
                                                           reduce_gradients)
    from melspec_gpt_vqvae_tpu_torch.parallel.pipeline import (
        gpt_apply_pp, gpt_pp_loss_fn, loss_backward)
    from melspec_gpt_vqvae_tpu_torch.training import optim as O
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask, _map
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask

    cfg, params, x = inp["cfg"], inp["params"], inp["x"]
    cond_c = inp["classes"]
    for shape, micro in inp["forwards"]:
        mesh = _mesh(shape, micro)
        key = ",".join(f"{k}={v}" for k, v in shape.items())
        local = _local(params, mesh, cfg.n_head)
        with torch.no_grad():
            out[f"forward/{key}"] = gpt_apply_pp(
                local, cfg, _rows(x, mesh),
                G.class_embed(local, _rows(cond_c, mesh)), mesh=mesh)
    if not inp["full"]:
        return

    # loss and gradients at data=2, pipe=2, two microbatches
    mesh = _mesh({"data": 2, "pipe": 2}, 2)
    for name, c in (("plain", cfg),
                    ("remat", cfg.replace(remat=True, remat_policy="attn"))):
        local = _map(_local(params, mesh, cfg.n_head), lambda t: t.requires_grad_(True))
        loss = gpt_pp_loss_fn(local, c, _rows(inp["tokens"], mesh),
                              _rows(cond_c, mesh), mesh)
        loss_backward(loss, mesh)
        reduce_gradients(mesh, O.named_leaves(local))
        out[f"loss/{name}"] = float(loss)
        grads = _map(local, lambda t: t.grad)
        out[f"grads/{name}"] = gather_tree(mesh, grads, cfg.n_head)  # None off rank 0
        out[f"local_grads/{name}"] = grads

    # dropout: the same rows on both data ranks
    dcfg = cfg.replace(embd_pdrop=0.0, attn_pdrop=0.5, resid_pdrop=0.5)
    local = _local(params, mesh, cfg.n_head)
    gen = step_generator(9, 0, 0, torch.device("cpu"), mesh.coord("data"))
    with torch.no_grad():
        out["dropout"] = gpt_apply_pp(local, dcfg, x[:4],
                                      G.class_embed(local, cond_c[:4]),
                                      mesh=mesh, train=True, generator=gen)

    # the refusals: every rank raises before any collective
    for name, run in (
            ("layers", lambda: GPTTask(dataclasses.replace(
                inp["exp"], model=inp["exp"].model.replace(n_layer=6)),
                "cpu", _mesh({"pipe": 4}))),
            ("micro", lambda: gpt_apply_pp(
                _local(params, _mesh({"pipe": 4}, 3), cfg.n_head), cfg, x[:8],
                mesh=_mesh({"pipe": 4}, 3)))):
        try:
            run()
            out[f"refused/{name}"] = None
        except ValueError as e:
            out[f"refused/{name}"] = str(e)

    # the tasks on a pipe mesh from a JAX state: one step
    task = GPTTask(inp["exp"], "cpu", "data=2,pipe=2", pp_micro=2)
    state = task.load_state(inp["gpt_tree"])
    state, loss = task.train_step(
        state, _batch_rows(inp["gpt_batch"], task.mesh), torch.Generator())
    out["gpt_loss"] = float(loss)
    out["gpt_eval"] = float(task.eval_step(
        state, _batch_rows(inp["gpt_batch"], task.mesh)))
    vt = VAETask(inp["vae_exp"], 4, "cpu", "data=2,pipe=2", pp_micro=2)
    state = vt.load_state(inp["vae_tree"])
    state, loss, _ = vt.train_step(
        state, _batch_rows(inp["vae_batch"], vt.mesh), torch.Generator(),
        eps=_rows(inp["vae_eps"], vt.mesh))
    out["vae_loss"] = float(loss)
    out["vae_after"] = vt.state_tree(state)


def world_reduce(inp, out):
    """``cross_process_concat`` with unequal rows and an empty shard, and
    ``cross_process_sum``, over 2 ranks."""
    import numpy as np

    from melspec_gpt_vqvae_tpu_torch.parallel import reduce as R

    mesh = _mesh(None)
    rank = mesh.coord("data")
    for name, arrays in inp["concat"].items():
        out[f"concat/{name}"] = R.cross_process_concat(arrays[rank], mesh)
    out["sum"] = R.cross_process_sum(inp["sums"][rank], mesh)
    out["sum_world"] = R.cross_process_sum(inp["sums"][rank])
    out["gather_fn"] = R.concat_gather_fn(mesh) is not None
    out["dtype"] = str(R.cross_process_concat(
        np.zeros((1, 2), np.float64), mesh).dtype)


def _key(shape):
    return ",".join(f"{k}={v}" for k, v in shape.items())


def _serving(params, cfg, mesh):
    """This rank's served GPT shard and int8 block weights (cut from the
    full weights' quantisation), as GenerationPipeline(mesh=) keeps
    them."""
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.parallel import (shard_block_weights,
                                                      shard_gpt_for_serving)
    wq = (shard_block_weights(mesh, G.quantize_block_weights(
        params["blocks"]), cfg.n_head) if cfg.decode_weight_dtype == "int8"
        else None)
    return shard_gpt_for_serving(mesh, params, cfg.n_head), wq


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def _forced_logits(params, cfg, wq, cond, forced, mesh=None):
    """The logits of a prefill and then of a decode step on each row of
    ``forced`` (steps, B), at host positions (the eager loop's step) and
    at a device position (the captured program's, run eagerly here)."""
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    out = []
    for device_pos in (False, True):
        cache = G.init_kv_cache(cfg, cond.shape[0],
                                max_len=1 + forced.shape[0],
                                heads=G.local_heads(params, cfg, mesh))
        logits, cache = G.gpt_prefill(params, cfg, cache, None, cond,
                                      mesh=mesh)
        out.append(logits)
        if device_pos:
            cache["len"] = G.torch.tensor([cache["len"]])
        for tok in forced:
            logits, cache = G.gpt_decode_step(params, cfg, cache, tok, wq,
                                              mesh=mesh)
            out.append(logits)
    return G.torch.stack(out)


def world_serve(inp, out):
    """Serving over a mesh: greedy decode (float32; int8 cache and int8
    weights), both loops, the prefill forward, per-rank bytes, and the
    pipeline; over 4 ranks (``inp["meshes"]``) or, for sampled tokens, 2."""
    import torch

    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline

    params, cond, x = inp["params"], inp["cond"], inp["x"]
    for shape in inp["meshes"]:
        mesh = _mesh(shape)
        key = _key(shape)
        for name, cfg in inp["cfgs"].items():
            local, wq = _serving(params, cfg, mesh)
            kw = dict(steps=inp["steps"], wq=wq, mesh=mesh)
            for graph in (False, True):
                out[f"greedy/{key}/{name}/{graph}"] = G.gpt_generate(
                    local, cfg, None, _rows(cond, mesh), sample=False,
                    graph=graph, **kw)
            out[f"sampled/{key}/{name}"] = G.gpt_generate(
                local, cfg, torch.Generator().manual_seed(inp["seed"]),
                _rows(cond, mesh), top_k=inp["top_k"], graph=True, **kw)
            if "forced" in inp:
                out[f"logits/{key}/{name}"] = _forced_logits(
                    local, cfg, wq, _rows(cond, mesh),
                    _rows(inp["forced"].T, mesh).T, mesh)
            if name == "f32":
                rows = _rows(x, mesh)
                cache = G.init_kv_cache(
                    cfg, rows.shape[0], max_len=rows.shape[1],
                    heads=G.local_heads(local, cfg, mesh))
                out[f"prefill/{key}"] = G.gpt_prefill(local, cfg, cache,
                                                      rows, mesh=mesh)[0]
                cache = G.init_kv_cache(
                    cfg, cond.shape[0] // mesh.size("data"),
                    max_len=1 + inp["steps"],
                    heads=G.local_heads(local, cfg, mesh))
                out[f"bytes/{key}"] = _tree_bytes(local) + _tree_bytes(
                    {k: v for k, v in cache.items() if k != "len"})
    for shape in inp.get("pipe_meshes", ()):
        mesh = _mesh(shape)
        pipe = GenerationPipeline(inp["pipe_exp"], inp["pipe_gpt"],
                                  inp["pipe_vq"], inp["pipe_melgan"],
                                  segments=2, chunk=0, bf16=False, mesh=mesh,
                                  **inp.get("pipe_draft", {}))
        out[f"pipe/{_key(shape)}"] = pipe.generate(inp["pipe_cls"], None,
                                                   sample=False)


def world_spec(inp, out):
    """Speculative decoding over a mesh: target and draft over ``model``,
    the batch over ``data``; greedy (model-dtype and int8 caches) and
    sampled, both loops."""
    import torch

    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.models.speculative import \
        gpt_speculative_generate

    for shape in inp["meshes"]:
        mesh = _mesh(shape)
        key = _key(shape)
        for name, (cfg, dcfg) in inp["cfgs"].items():
            local, wq = _serving(inp["params"], cfg, mesh)
            dlocal, dwq = _serving(inp["drafts"][name], dcfg, mesh)
            for sample in (False, True):
                gen = torch.Generator().manual_seed(inp["seed"])
                for graph in (False, True):
                    toks, stats = gpt_speculative_generate(
                        local, cfg, dlocal, dcfg, gen if sample else None,
                        _rows(inp["cond"], mesh),
                        G.class_embed(dlocal, _rows(inp["cls"], mesh)),
                        steps=inp["steps"], gamma=inp["gamma"],
                        sample=sample, top_k=inp["top_k"], wq=wq,
                        draft_wq=dwq, graph=graph, mesh=mesh)
                    gen = torch.Generator().manual_seed(inp["seed"])
                    out[f"{key}/{name}/{sample}/{graph}"] = (toks, stats)
    world_serve(inp["serve"], out)


def placement_recorder():
    """(a ``TorchFunctionMode``, the list it fills): inside the mode every
    move of a tensor to a named device -- ``Tensor.to`` with a device
    (``Module.to`` included) or ``Tensor.cuda`` -- is recorded as the
    (shape, dtype) it lands with, whichever module makes the call, and on
    the CPU too, where such a move is a no-op.  Tensors made where they
    are needed (a host generator's draws) are no moves."""
    import torch
    from torch.overrides import TorchFunctionMode

    placed = []

    def targets_device(func, args, kwargs):
        if func is torch.Tensor.cuda:
            return True
        return func is torch.Tensor.to and (
            kwargs.get("device") is not None
            or any(isinstance(a, (str, torch.device, torch.Tensor))
                   for a in args[1:]))

    class Placements(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            res = func(*args, **kwargs)
            if isinstance(res, torch.Tensor) and targets_device(
                    func, args, kwargs):
                placed.append((tuple(res.shape), str(res.dtype)))
            return res

    return Placements(), placed


def world_served_placement(inp, out):
    """``build_pipeline(mesh_spec=)`` from host trees under
    ``placement_recorder``: what the construction moved, then the greedy
    tokens of the rank's rows, float32 and int8 (cache and weights)."""
    import torch

    from melspec_gpt_vqvae_tpu_torch import serving as S

    for name, kw in inp["variants"].items():
        mode, placed = placement_recorder()
        with mode:
            _, pipe = S.build_pipeline(
                "vas", init_random=True, override=inp["override"],
                seed=inp["seed"], device="cpu", mesh_spec=inp["mesh_spec"],
                **kw)
        out[f"placed/{name}"] = placed
        with torch.no_grad():
            out[f"tokens/{name}"] = pipe.generate_tokens(
                inp["cls"], None, sample=False)[0]
        out[f"device/{name}"] = str(pipe.device)


WORLDS = {"tp": world_tp, "dp": world_dp, "pp": world_pp,
          "reduce": world_reduce, "serve": world_serve, "spec": world_spec,
          "served_placement": world_served_placement}


def main(world: str, rank: int, size: int, folder: str) -> None:
    import torch
    torch.set_num_threads(1)
    from melspec_gpt_vqvae_tpu_torch.parallel import (maybe_init_distributed,
                                                      shutdown_distributed)
    maybe_init_distributed("cpu", COLLECTIVE_TIMEOUT, init_method="file://"
                           + os.path.join(folder, "store"), rank=rank,
                           world_size=size)
    try:
        inp = torch.load(os.path.join(folder, "inputs.pt"),
                         weights_only=False)
        out = {}
        WORLDS[world](inp, out)
        torch.save(out, os.path.join(folder, f"out_{rank}.pt"))
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
