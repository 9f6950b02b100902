"""Training: ``VAETask.train_step`` on batches of code tokens staged on
the device before the window, one step after another.

The mix's file gives the batch, how many distinct batches are staged
(tokens uniform over the vocabulary, from the run's seed) and how many
first steps the reference follows.  Set-up builds the one train state the
window goes on stepping, with the benchmark's seeded weights, and drives
it through those first steps by the window's own call, on batches whose
rows all differ; it keeps what the check compares: each step's loss, the
first gradient's norm by leaf as AdamW holds it after one step (its first
moment over 1 - beta1), and each leaf's norm of change after the last of
those steps.  Each step's latent noise and dropout generator come from
the seed, so that the reference draws the same.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from harness import compare, program, weights


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


class Generator:
    def __init__(self, cell, seed: int, device, overrides=None):
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        self.cfg, self.tr = cell.config, cell.traffic
        self.overrides = overrides
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.hooks = []   # (stage, fn): "batch" and "step" faults of a test
        self.step_no = 0

    # -- traffic ------------------------------------------------------------
    def stage_batches(self):
        tr, m = self.tr, self.cfg["model"]
        g = weights.generator(self.seed, "batches", self.dev)
        self.batches = torch.randint(
            0, m["vocab_size"], (tr["distinct_batches"], tr["batch"],
                                 m["block_size"]), generator=g,
            device=self.dev)
        self.eps = torch.randn((tr["distinct_batches"], tr["batch"], 1,
                                m["n_embd"]), generator=g, device=self.dev)

    def step_inputs(self, i: int):
        """Step ``i``'s tokens, latent noise and dropout generator."""
        j = i % self.tr["distinct_batches"]
        gen = weights.generator(self.seed, f"dropout:{i}", self.dev)
        return self.batches[j], self.eps[j], gen

    def step(self):
        x, eps, gen = self.step_inputs(self.step_no)
        for stage, fn in self.hooks:
            if stage == "batch":
                x, eps = fn(x, eps)
        self.state, loss, _ = self.task.train_step(self.state, x, gen,
                                                   eps=eps)
        for stage, fn in self.hooks:
            if stage == "step":
                fn(self)
        self.step_no += 1
        return loss

    # -- phases -------------------------------------------------------------
    def setup(self):
        from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
        self.exp = program.experiment(self.cfg, self.overrides)
        self.task = VAETask(self.exp, self.tr["steps_per_epoch"], self.dev)
        flat = program.vae_weights(self.cfg["model"], self.seed, self.dev)
        params = {}
        for name, t in flat.items():
            node = params
            *path, leaf = name.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t.requires_grad_(True)
        del flat
        self.state = {"params": params,
                      "optimizer": self.task._optimizer(params), "step": 0,
                      "kl_weight": torch.tensor(float(self.exp.vae.kl_start),
                                                device=self.dev)}
        self.stage_batches()
        leaves = dict(_leaves(params))
        start = {n: t.detach().clone() for n, t in leaves.items()}
        opt = self.state["optimizer"]
        b1 = self.exp.train.betas[0]
        losses = []
        for i in range(self.tr["check_steps"]):
            losses.append(self.step())
            if i == 0:
                first_grad = {n: self._first_moment_norm(opt, t, b1)
                              for n, t in leaves.items()}
        change = {n: float((t.detach() - start[n]).double().norm())
                  for n, t in leaves.items()}
        del start
        self.first = {"losses": [float(v) for v in losses],
                      "first_grad": first_grad, "change": change}
        # the heap of set-up (the imports, the model's build) out of the
        # collector's way: a step leaves objects that survive into its
        # oldest generation, whose full passes then traverse every object
        # of the process, some 0.25 s every few steps on an H100 machine's
        # host; the steps' own garbage is still collected
        gc.collect()
        gc.freeze()
        for _ in range(self.tr["warm_steps"]):
            self.step()
        _sync(self.dev)

    @staticmethod
    def _first_moment_norm(opt, t, b1) -> float:
        """The norm of the gradient AdamW took in its first step: its first
        moment over 1 - beta1 (0 where the step left no state)."""
        m = opt.state.get(t, {}).get("exp_avg")
        return 0.0 if m is None else float((m.double() / (1.0 - b1)).norm())

    def window(self, seconds: float, spans: bool) -> Dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        tokens = n * self.tr["batch"] * self.cfg["model"]["block_size"]
        self.counters.update(steps=n, units=n, window_s=elapsed)
        return {"metrics": {"train_tokens_per_s": tokens / elapsed},
                "attempted": n, "failed": 0}

    def traced_unit(self):
        from melspec_gpt_vqvae_tpu_torch.ops import flash_attention as fa
        shapes = []
        fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

        def rec_fwd(q, k, v, keep, n_unmasked=0, *a, **kw):
            shapes.append(("fwd", tuple(q.shape), int(n_unmasked),
                           keep is not None))
            return fwd(q, k, v, keep, n_unmasked, *a, **kw)

        def rec_bwd(q, k, v, keep, o, lse, do, n_unmasked=0, *a, **kw):
            shapes.append(("bwd", tuple(q.shape), int(n_unmasked),
                           keep is not None))
            return bwd(q, k, v, keep, o, lse, do, n_unmasked, *a, **kw)
        # the wrappers count their launches under their module name
        rec_fwd.launches, rec_bwd.launches = fwd.launches, bwd.launches
        fa.flash_attention_fwd, fa.flash_attention_bwd = rec_fwd, rec_bwd
        try:
            for _ in range(self.tr["traced_steps"]):
                with torch.profiler.record_function("bench.train_step"):
                    self.step()
            _sync(self.dev)
        finally:
            fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
            fwd.launches, bwd.launches = rec_fwd.launches, rec_bwd.launches
        self.counters["traced_steps"] = self.tr["traced_steps"]
        self.counters["traced_units"] = self.tr["traced_steps"]
        self.counters["flash_launches"] = shapes

    def release(self):
        del self.state, self.task, self.batches, self.eps
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self):
        """The first steps' inputs again, drawn from the seed."""
        self.stage_batches()
        out = []
        for i in range(self.tr["check_steps"]):
            # the task's anneal: min(1, weight + rate) a step
            kl = min(1.0, float(self.exp.vae.kl_start)
                     + (i + 1) * self.task_anneal())
            x, eps, gen = self.step_inputs(i)
            out.append((x, eps, gen, kl))
        return out

    def task_anneal(self) -> float:
        vae = self.exp.vae
        if vae.warm_up > 0 and self.tr["steps_per_epoch"] > 0:
            return (1.0 - vae.kl_start) / (vae.warm_up
                                           * self.tr["steps_per_epoch"])
        return 0.0

    def check(self) -> Dict[str, float]:
        steps = self.reference_steps()
        ref = compare.reference_train(self.cfg, self.seed, self.dev, steps)
        del self.batches, self.eps
        return compare.train_readings(self.first, ref)
