#!/usr/bin/env python
"""The port's distributed training and serving on several cards against
one card.

Run under ``torchrun`` with one process a card, e.g. on four:

    torchrun --standalone --nproc_per_node 4 scripts/torch_dist_check.py

(``--device cpu --override n_layer=4,n_embd=32,n_head=4`` rehearses it
with gloo on the CPU at a narrow width.)  ``--part training`` or ``--part
serving`` runs one half; ``--serve_meshes`` names the serving meshes
(default: ``data=N``, ``model=N`` and ``data=2,model=N/2``) and
``--serve_variants`` the configurations (default: all three below).

The class GPT at the VAS preset's full width (24 layers, 16 heads, 1024
wide, kernel F, mixed precision unless ``--override
mixed_precision=False``, dropout 0, seed 7) takes one train step on a
seeded global batch of 8 under each mesh of the world's ranks --
``data=N`` (DDP), ``model=N`` and ``data=2,model=N/2`` (Megatron),
``pipe=N`` and ``data=2,pipe=N/2`` (GPipe, 2 microbatches a data rank)
-- each data rank on its rows. Rank 0 takes the same step on one card
(no mesh) and compares the loss, every gradient gathered to full leaves
on rank 0 (its error over the leaf's largest) and the parameter update
(``_update_err``: over the elements whose one-card gradient lies farther
from zero than the leaf's largest gradient difference, |update - one
card's update| / |one card's update|, the worst leaf; a step that left
the parameters as they were reads 1). The bounds of loss, gradients and
update: float32 1e-5, 1e-3 and 5e-2; mixed precision 2e-4, 1e-2 and
5e-2, because a product's operands are rounded to bfloat16 after sums
taken in another order (the model axis splits the row-parallel
products' K, the data and pipe axes the batch), so an operand one
float32 ulp apart can land a bfloat16 ulp (2^-8) apart, and such flips
add up over 24 layers. Then each mesh's ms a step (5 steps, the last 3
timed) and NCCL's device ms a step (``torch.profiler``). Rank 0 prints
one JSON line a mesh and, last, ``{"ok": ..., "world": N, "card":
...}``; the exit code is 1 when a bound fails.

Serving: the VAS GPT preset at its full width (random weights, seed
783435) behind the VQ-VAE and MelGAN serves a seeded greedy batch of 8
classes through ``GenerationPipeline(mesh=)`` under each serving mesh --
the card's default (bfloat16, int8 KV cache, int8 block weights, the
captured decode program, whose tensor-parallel step records NCCL
all-reduces), then bfloat16 and float32 with the model-dtype cache --
against the same weights on one card (rank 0, no mesh).  The int8
tokens must equal one card's exactly (the row-cut int8 products reduce
the activation scale with MAX and the int32 sums with SUM: the
arithmetic is the single card's); for bfloat16 and float32, whose
row-parallel sums take another order, the share of equal tokens is
reported.  Beside them: each rank's peak memory, reset before the
pipeline is built, so that it includes the construction (a mesh's
pipeline is built from the host tree, each rank moving its own parts
alone to its card), what each rank held when the peak was reset
(nothing of an earlier pipeline may remain), and the request's seconds
(the second request of the shape, after its capture).

XL (``--part xl``): the ``GPT_VAE_vggsound`` preset, whose 23 heads no
model axis above 1 divides (the ranks hold 12, 11 or 6, 6, 6, 5 heads,
``parallel/mesh.py::head_range``).  Its decoder
(scripts/torch_xl_decode_bench.py: bfloat16, int8 KV cache and weights,
top-k 100 from the prior, 8 segments) decodes batches of 64 and 256 on
one card (rank 0) and over ``model=N``: the sampled tokens must equal one
card's exactly (the int8 arithmetic is the single card's); beside them
each rank's peak GiB and the seconds a decode.  Then its train step
(``VAETask``, 2.09B parameters, AdamW, mixed precision, remat ``attn``,
kernel F, the preset's batch of 1; scripts/torch_train_probe.py) on one
card and over ``model=N``, held to the bounds above of its precision
(``--override mixed_precision=False`` for float32; the loss, which sums
the 265 tokens' cross entropy where the class GPT's averages it, a token
at a time: the difference over 265), with ms a step and each rank's peak
GiB.  ``--part xl_train`` runs the train step alone.  Launch
``--nproc_per_node 2`` for ``model=2``, 4 for ``model=4``.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NCCL_KERNELS = ("nccl", "onerankreduce")


def _grads(params):
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import _map
    return _map(params, lambda t: t.grad.detach())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _update_err(before, ref_after, ref_grads, after, grads):
    """(the worst leaf's update error, the share of elements it covers):
    see the module's docstring.  Every argument maps leaf names to host
    tensors."""
    worst, kept, total = 0.0, 0, 0
    for k, g_r in ref_grads.items():
        g_r, g_m = g_r.float(), grads[k].float().cpu()
        sure = g_r.abs() > (g_m - g_r).abs().max()
        d_r = (ref_after[k].float() - before[k].float())[sure]
        d_m = (after[k].float() - before[k].float())[sure]
        kept += int(sure.sum())
        total += sure.numel()
        den = d_r.norm()
        if den > 0:
            worst = max(worst, ((d_m - d_r).norm() / den).item())
    return worst, kept / total


def _nccl_ms(task, state, batch, gen, steps=2):
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            task.train_step(state, batch, gen(i))
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and any(
                n in ev.key.lower() for n in NCCL_KERNELS):
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
    return us / 1e3 / steps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(task, state, batch, gen, dev):
    """ms a step over steps 3-5 of 5."""
    times = []
    for i in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        task.train_step(state, batch, gen(i))
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(times[2:]))


SERVE_VARIANTS = {"int8": ("bfloat16", "int8", "int8"),
                  "bf16": ("bfloat16", "auto", "auto"),
                  "float32": ("float32", "auto", "auto")}


def _request(pipe, dev, gen_fn):
    """(tokens of the whole batch on rank 0 (None elsewhere), seconds):
    the full request (tokens, spectrograms, waveforms) on the card, the
    tokens alone on the CPU (its conv stages at the preset's width would
    take minutes)."""
    from melspec_gpt_vqvae_tpu_torch.parallel import gather_rows, is_primary
    cls = list(range(8))
    _sync(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        out = pipe.generate(cls, gen_fn(), sample=False)
        toks = None if out is None else out["tokens"]
    else:
        toks, _ = pipe.generate_tokens(cls, gen_fn(), sample=False)
        if pipe.mesh is not None:
            toks = (gather_rows(pipe.mesh, toks)
                    if pipe.mesh.coord("model") == 0 else None)
        toks = toks.numpy() if toks is not None and is_primary() else None
    _sync(dev)
    return toks, time.perf_counter() - t0


def serving_check(dev, override, meshes, variants):
    """The serving half (see the module's docstring); returns ok."""
    import dataclasses

    import torch.distributed as dist

    from melspec_gpt_vqvae_tpu_torch.configs import (load_preset,
                                                     parse_overrides)
    from melspec_gpt_vqvae_tpu_torch.models.gpt import DTYPES, tree_to
    from melspec_gpt_vqvae_tpu_torch.parallel import (is_primary, make_mesh,
                                                      parse_mesh)
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    from melspec_gpt_vqvae_tpu_torch.serving import random_weights

    base = load_preset("GPT", "vas", **parse_overrides(override))
    gpt, vq, voc = random_weights(base, 783435)   # float32, on the host

    def pipeline(variant, mesh):
        """One card: the tree moved whole.  A mesh: the host tree, which
        each rank cuts leaf by leaf, moving its parts alone to its card
        (as ``build_pipeline(mesh_spec=)`` does)."""
        dtype, cache, weights = SERVE_VARIANTS[variant]
        exp = dataclasses.replace(base, model=base.model.replace(
            dtype=dtype, cache_dtype=cache, decode_weight_dtype=weights))
        if mesh is None:
            return GenerationPipeline(
                exp, tree_to(gpt, device=dev, dtype=DTYPES[dtype]), vq, voc)
        return GenerationPipeline(exp, tree_to(gpt, dtype=DTYPES[dtype]), vq,
                                  voc, mesh=mesh, device=dev)

    def gen_fn():
        return torch.Generator(device=dev).manual_seed(5)

    def peak_reset():
        if dev.type == "cuda":
            gc.collect()   # the last pipeline's graphs hold it in a cycle
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)

    def held():
        """What the rank holds when the peak is reset, before the
        pipeline is built: nothing of an earlier pipeline may remain."""
        return (torch.cuda.memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)

    ok = True
    ref = {}
    if is_primary():
        for variant in variants:
            peak_reset()
            before = held()
            pipe = pipeline(variant, None)
            toks, first = _request(pipe, dev, gen_fn)
            _, secs = _request(pipe, dev, gen_fn)
            ref[variant] = toks
            print(json.dumps({"serving": "one card", "variant": variant,
                              "first_request_s": first, "request_s": secs,
                              "peak_gib": peak(), "held_gib": before}),
                  flush=True)
            del pipe
    for spec in meshes:
        mesh = make_mesh(parse_mesh(spec), dev)
        for variant in variants:
            peak_reset()
            before = held()
            pipe = pipeline(variant, mesh)
            toks, first = _request(pipe, dev, gen_fn)
            _, secs = _request(pipe, dev, gen_fn)
            peaks = [None] * mesh.size("data") * mesh.size("model")
            dist.all_gather_object(peaks, peak())
            helds = [None] * len(peaks)
            dist.all_gather_object(helds, before)
            del pipe
            if not is_primary():
                continue
            match = float((toks == ref[variant]).mean())
            row = {"serving": spec, "variant": variant,
                   "token_match": match, "first_request_s": first,
                   "request_s": secs, "peak_gib_by_rank": peaks,
                   "held_gib_by_rank": helds}
            if variant == "int8":
                row["ok"] = match == 1.0
                ok = ok and row["ok"]
            print(json.dumps(row), flush=True)
    return ok


def _reset_peak(dev):
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    """The peak GiB since the last reset (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)


def _rank_peaks(mesh, dev):
    """Every rank's peak GiB since the last reset, on every rank."""
    import torch.distributed as dist
    peaks = [None] * mesh.size("model")
    dist.all_gather_object(peaks, _peak(dev), group=mesh.group("model"))
    return peaks


def xl_check(dev, n, override="", decode=True):
    """The XL part (see the module's docstring; ``override``: preset
    overrides, a narrow rehearsal on the CPU or float32; ``decode``
    False: the train step alone); returns ok."""
    from melspec_gpt_vqvae_tpu_torch.parallel import make_mesh

    ok = True
    mesh = make_mesh({"model": n}, dev)
    if decode:
        ok = _xl_decode(dev, n, mesh, override)
    return _xl_train(dev, n, mesh, override) and ok


def _xl_decode(dev, n, mesh, override):
    """The XL decoder over ``mesh`` against one card; returns ok."""
    from torch_xl_decode_bench import decode_bench, xl_decoder

    from melspec_gpt_vqvae_tpu_torch.parallel import is_primary
    from melspec_gpt_vqvae_tpu_torch.parallel.mesh import barrier
    ok = True
    cfgs, host = xl_decoder(dev, override)
    with torch.no_grad():
        for batch in (64, 256):
            one = None
            if is_primary():
                row, one = decode_bench(cfgs, host, dev, batch=batch)
                print(json.dumps({"xl_decode": "one card", **row}),
                      flush=True)
            barrier()
            row, toks = decode_bench(cfgs, host, dev, mesh, batch=batch)
            if is_primary():
                row["tokens_equal"] = bool(torch.equal(toks, one))
                ok = ok and row["tokens_equal"]
                print(json.dumps({"xl_decode": f"model={n}", **row}),
                      flush=True)
            del toks, one
    return ok


def _xl_train(dev, n, mesh, override):
    """The XL train step over ``mesh`` against one card; returns ok."""
    from torch_train_probe import xl_vae_task

    from melspec_gpt_vqvae_tpu_torch.parallel import is_primary
    from melspec_gpt_vqvae_tpu_torch.parallel.mesh import (barrier,
                                                           gather_tree)
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator

    def gen(i):
        return step_generator(1, 0, i, dev)

    ref = None
    if is_primary():
        _reset_peak(dev)
        task, batch = xl_vae_task(dev, override=override)
        st = task.init_state(7)
        before = {k: v.detach().to("cpu", copy=True) for k, v in
                  _flat(st["params"])}
        st, loss = task.train_step(st, batch, gen(0))[:2]
        ref = {"loss": loss.item(), "before": before,
               "params": {k: v.detach().to("cpu", copy=True) for k, v in
                          _flat(st["params"])},
               "grads": {k: v.to("cpu", copy=True)
                         for k, v in _flat(_grads(st["params"]))}}
        ref["ms"] = _ms(task, st, batch, gen, dev)
        print(json.dumps({"xl_train": "one card", "loss": ref["loss"],
                          "ms": ref["ms"], "peak_gib": _peak(dev)}),
              flush=True)
        del task, st
        _reset_peak(dev)
    barrier()
    _reset_peak(dev)
    task, batch = xl_vae_task(dev, mesh, override)
    state = task.init_state(7)
    state, loss = task.train_step(state, batch, gen(0))[:2]
    grads = gather_tree(task.mesh, _grads(state["params"]),
                        task.cfgs.encoder.n_head)
    tree = task.state_tree(state)
    params = (None if not is_primary() else
              {k: v.to("cpu", copy=True) for k, v in _flat(tree["params"])})
    del tree
    ms = _ms(task, state, batch, gen, dev)
    peaks = _rank_peaks(mesh, dev)
    if is_primary():
        errs = {k: (g.float().cpu() - ref["grads"][k].float()).abs().max()
                .item() / ref["grads"][k].abs().max().clamp_min(1e-30).item()
                for k, g in _flat(grads)}
        worst = max(errs, key=errs.get)
        g_err = errs[worst]
        u_err, share = _update_err(ref["before"], ref["params"],
                                   ref["grads"], params, dict(_flat(grads)))
        tokens = task.cfgs.encoder.block_size
        mixed = task.cfgs.encoder.mixed_precision
        loss_bound, grad_bound = (2e-4, 1e-2) if mixed else (1e-5, 1e-3)
        row = {"xl_train": f"model={n}", "mixed_precision": mixed,
               "loss": loss.item(),
               "loss_diff": abs(loss.item() - ref["loss"]),
               "grad_rel_err": g_err, "grad_worst_leaf": worst,
               "update_err": u_err, "update_share": share, "ms": ms,
               "one_card_ms": ref["ms"], "peak_gib_by_rank": peaks}
        row["ok"] = (row["loss_diff"] / tokens <= loss_bound
                     and g_err <= grad_bound and u_err <= 5e-2)
        print(json.dumps(row), flush=True)
        return row["ok"]
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default="",
                    help="more preset overrides, e.g. a narrow width")
    ap.add_argument("--part", default="all",
                    choices=["all", "training", "serving", "xl",
                             "xl_train"])
    ap.add_argument("--serve_meshes", default="",
                    help="';'-separated serving meshes (default: data=N; "
                         "model=N; data=2,model=N/2)")
    ap.add_argument("--serve_variants", default=",".join(SERVE_VARIANTS),
                    help="comma-separated, of " + ", ".join(SERVE_VARIANTS))
    args = ap.parse_args()
    from melspec_gpt_vqvae_tpu_torch.configs import (load_preset,
                                                     parse_overrides)
    from melspec_gpt_vqvae_tpu_torch.parallel import (is_primary,
                                                      local_batch_slice,
                                                      maybe_init_distributed,
                                                      process_count,
                                                      shutdown_distributed)
    from melspec_gpt_vqvae_tpu_torch.parallel.mesh import gather_tree
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = maybe_init_distributed(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    n = process_count()
    ok = True
    if args.part in ("xl", "xl_train"):
        return _finish(xl_check(dev, n, args.override, args.part == "xl"),
                       n, dev)
    if args.part in ("all", "serving"):
        meshes = ([m for m in args.serve_meshes.split(";") if m]
                  or [f"data={n}", f"model={n}", f"data=2,model={n // 2}"])
        with torch.no_grad():
            ok = serving_check(dev, args.override, meshes,
                               args.serve_variants.split(","))
    if args.part == "serving":
        return _finish(ok, n, dev)
    exp = load_preset("GPT", "vas", **{
        "use_flash_train": True, "mixed_precision": True,
        "embd_pdrop": 0.0, "attn_pdrop": 0.0, "resid_pdrop": 0.0,
        **parse_overrides(args.override)})
    mixed = exp.model.mixed_precision
    loss_bound, grad_bound = (2e-4, 1e-2) if mixed else (1e-5, 1e-3)
    rng = np.random.default_rng(0)
    batch = {"codes": rng.integers(0, 128, (8, 5, 53)).astype(np.int64),
             "target": rng.integers(0, 8, (8,)).astype(np.int64)}

    def gen(i):
        return step_generator(1, 0, i, dev)

    ref = None
    if is_primary():
        plain = GPTTask(exp, dev)
        st = plain.init_state(7)
        before = {k: v.detach().to("cpu", copy=True) for k, v in
                  _flat(st["params"])}
        st, loss = plain.train_step(st, batch, gen(0))
        # copies: the timed steps below move the live tensors
        ref = {"loss": loss.item(), "before": before,
               "params": {k: v.detach().to("cpu", copy=True) for k, v in
                          _flat(st["params"])},
               "grads": {k: v.to("cpu", copy=True)
                         for k, v in _flat(_grads(st["params"]))}}
        ref["ms"] = _ms(plain, st, batch, gen, dev)
        print(json.dumps({"mesh": "one card", "mixed_precision": mixed,
                          "loss": ref["loss"], "ms": ref["ms"]}),
              flush=True)
        del plain, st

    meshes = [(f"data={n}", 0), (f"model={n}", 0),
              (f"data=2,model={n // 2}", 0), (f"pipe={n}", 2),
              (f"data=2,pipe={n // 2}", 2)]
    for spec, micro in meshes:
        task = GPTTask(exp, dev, spec, pp_micro=micro)
        state = task.init_state(7)
        rows = local_batch_slice(8, task.mesh)
        local = {k: v[rows] for k, v in batch.items()}
        state, loss = task.train_step(state, local, gen(0))
        # the full leaves on rank 0, None on the other ranks
        grads = gather_tree(task.mesh, _grads(state["params"]),
                            task.cfg.n_head)
        tree = task.state_tree(state)
        params = (None if not is_primary() else
                  {k: v.to("cpu", copy=True) for k, v in
                   _flat(tree["params"])})
        del tree
        ms = _ms(task, state, local, gen, dev)
        nccl = (_nccl_ms(task, state, local, gen) if dev.type == "cuda"
                else None)
        if is_primary():
            g_err = max(
                (g.float().cpu() - ref["grads"][k].float()).abs().max().item()
                / ref["grads"][k].abs().max().clamp_min(1e-30).item()
                for k, g in _flat(grads))
            u_err, share = _update_err(ref["before"], ref["params"],
                                       ref["grads"], params,
                                       dict(_flat(grads)))
            row = {"mesh": spec, "n_micro": micro, "loss": loss.item(),
                   "loss_diff": abs(loss.item() - ref["loss"]),
                   "grad_rel_err": g_err, "update_err": u_err,
                   "update_share": share, "ms": ms, "nccl_device_ms": nccl}
            row["ok"] = (row["loss_diff"] <= loss_bound
                         and g_err <= grad_bound and u_err <= 5e-2)
            ok = ok and row["ok"]
            print(json.dumps(row), flush=True)
        del task, state, grads, params
    _finish(ok, n, dev)


def _finish(ok, n, dev):
    from melspec_gpt_vqvae_tpu_torch.parallel import (is_primary,
                                                      shutdown_distributed)
    if is_primary():
        card = "cpu"
        if dev.type == "cuda":
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip().splitlines()[0]
        print(json.dumps({"ok": ok, "world": n, "card": card}),
              flush=True)
    shutdown_distributed()
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
