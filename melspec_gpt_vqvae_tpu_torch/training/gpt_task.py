"""Class-conditional GPT training system (the reference's ``Lit_minGPT``).

Counterpart of melspec_gpt_vqvae_tpu/training/gpt_task.py:34-205 on one
device: next-token cross entropy over the 265 code positions behind the
class token, the minGPT two-group AdamW, a train step that updates the
parameters and the optimizer in place, sampling through the KV-cached
``gpt_generate`` (the captured decode program on the card, its captures
kept in ``GPTTask.graphs``) and the media callback's gallery
(``log_samples``).

A train state is ``{"params": nested dict of leaf tensors with
requires_grad, "optimizer": torch.optim.AdamW, "step": int}``.
``state_tree`` and ``load_state`` turn it into and out of a plain nested
dict of tensors and numbers -- the form checkpoints and bridge.py carry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import ExperimentConfig, GPTConfig

from ..models import decode_graph
from ..models.gpt import (DTYPES, class_embed, count_params,
                          cross_entropy_loss, gpt_apply, gpt_attention_maps,
                          gpt_generate, gpt_param_template, init_gpt_params)
from ..utils.profiling import StepTimer, gpt_fwd_flops, peak_flops
from .optim import (get_lr, gpt_adamw, load_optimizer_state,
                    optimizer_state_tree, with_lr)

TrainState = Dict[str, object]


def tokens_from_batch(codes) -> torch.Tensor:
    """(B, 5, 53) code grid -> (B, 265) column-major int64 tokens
    (reference get_x: minGPT.py:387-394)."""
    codes = torch.as_tensor(np.asarray(codes))
    return codes.transpose(1, 2).reshape(codes.shape[0], -1).long()


def gpt_loss_fn(params, cfg: GPTConfig, x: torch.Tensor, c: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """Conditioned next-token cross entropy (minGPT.py:260-285, 413-417).
    x: (B, 265) tokens; c: (B,) or (B, 1) class index.  The logits from
    the class token on predict x: the first ``cond.shape[1] - 1`` are
    dropped."""
    cond = class_embed(params, c)
    logits = gpt_apply(params, cfg, x[:, :-1], cond, train=train,
                       generator=generator)
    return cross_entropy_loss(logits[:, cond.shape[1] - 1:], x)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


class GPTTask:
    """Config, device and steps of the GPT-class model."""

    def __init__(self, exp: ExperimentConfig, device: torch.device):
        self.exp = exp
        self.cfg = exp.model
        self.device = torch.device(device)
        # the decode programs of ``sample``, kept across calls: the train
        # state's parameters are updated in place, so their addresses hold
        self.graphs = decode_graph.DecodeGraphs()

    def _optimizer(self, params) -> torch.optim.AdamW:
        tr = self.exp.train
        return gpt_adamw(params, tr.learning_rate, tr.weight_decay, tr.betas)

    def init_state(self, seed: int = 783435) -> TrainState:
        """Random parameters from ``seed`` (drawn on the CPU, so a seed gives
        the same weights on every device), a fresh AdamW, step 0."""
        params = init_gpt_params(self.cfg, torch.Generator().manual_seed(seed),
                                 device=self.device)
        params = _map(params, lambda t: t.detach().requires_grad_(True))
        return {"params": params, "optimizer": self._optimizer(params),
                "step": 0}

    def state_template(self) -> Dict:
        """``state_tree``'s layout as shapes and dtypes only (``meta``
        tensors, no memory on any device): what a checkpoint of this
        task's geometry must look like."""
        params = gpt_param_template(self.cfg)
        return {"params": params, "mu": params, "nu": params, "count": 0,
                "lr": 0.0, "step": 0}

    # ------------------------------------------------------------------
    def state_tree(self, state: TrainState) -> Dict:
        """The state as a nested dict: params, the AdamW moments ``mu`` and
        ``nu`` (zeros before the first step), their step ``count``, the
        live ``lr`` and the train ``step``.  Tensors are the live ones,
        detached, not copies."""
        opt = state["optimizer"]
        return {"params": _map(state["params"], lambda t: t.detach()),
                **optimizer_state_tree(opt, state["params"]),
                "lr": get_lr(opt), "step": int(state["step"])}

    def load_state(self, tree: Dict) -> TrainState:
        """A train state on this task's device from a ``state_tree``-shaped
        dict (a checkpoint's, or bridge.train_state_from_jax's): parameters
        and moments are copied exactly, in the model dtype."""
        dtype = DTYPES[self.cfg.dtype]
        params = _map(tree["params"], lambda t: torch.as_tensor(t).to(
            self.device, dtype, copy=True).requires_grad_(True))
        opt = with_lr(self._optimizer(params), tree["lr"])
        load_optimizer_state(opt, params, tree)
        return {"params": params, "optimizer": opt, "step": int(tree["step"])}

    # ------------------------------------------------------------------
    def batch_tensors(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        x = tokens_from_batch(batch["codes"]).to(self.device)
        c = torch.as_tensor(np.asarray(batch["target"])).reshape(-1)
        return x, c.long().to(self.device)

    def train_step(self, state: TrainState, batch: Dict,
                   generator: torch.Generator
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One AdamW step on ``batch`` with dropout masks from
        ``generator`` (on this task's device).  Updates the state in place
        and returns it with the loss, a 0-d tensor on the device (reading
        it waits for the step)."""
        x, c = self.batch_tensors(batch)
        opt = state["optimizer"]
        opt.zero_grad(set_to_none=True)
        loss = gpt_loss_fn(state["params"], self.cfg, x, c,
                           generator=generator, train=True)
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict) -> torch.Tensor:
        x, c = self.batch_tensors(batch)
        return gpt_loss_fn(state["params"], self.cfg, x, c)

    @torch.no_grad()
    def sample(self, params, generator: Optional[torch.Generator], c,
               steps: int, given: Optional[torch.Tensor] = None,
               temperature: float = 1.0, top_k: Optional[int] = None,
               sample: bool = True) -> torch.Tensor:
        """KV-cached sampling (minGPT.py:293-360) -> (B, T0 + steps)."""
        cond = class_embed(params, torch.as_tensor(c).reshape(-1).to(
            self.device))
        return gpt_generate(params, self.cfg, generator, cond, given,
                            steps=steps, temperature=temperature,
                            top_k=top_k, sample=sample,
                            graph=self.graphs if cond.is_cuda else None)

    @torch.no_grad()
    def log_samples(self, params, generator: torch.Generator, batch: Dict,
                    temperature: float = 1.0, top_k: Optional[int] = 100,
                    n: int = 1) -> Dict[str, np.ndarray]:
        """The reference's gallery of the batch's first ``n`` items
        (gpt_task.py:183-205, minGPT.py:530-612): their ``codes``,
        ``codes_half`` (the first half given, the rest sampled),
        ``codes_nopix`` (sampled from the class alone), ``codes_det``
        (greedy) and ``att_nopix``, the last layer's attention over the
        class token and ``codes_nopix``.  The three generations draw from
        three generators seeded from ``generator``."""
        x, c = self.batch_tensors(batch)
        x, c = x[:n], c[:n]
        seeds = torch.randint(2 ** 62, (3,), generator=generator,
                              device=generator.device).tolist()
        gens = [torch.Generator(device=self.device).manual_seed(s)
                for s in seeds]
        t = x.shape[1]
        half = self.sample(params, gens[0], c, steps=t - t // 2,
                           given=x[:, :t // 2], temperature=temperature,
                           top_k=top_k, sample=True)
        nopix = self.sample(params, gens[1], c, steps=t,
                            temperature=temperature, top_k=top_k,
                            sample=True)
        det = self.sample(params, gens[2], c, steps=t, sample=False)
        att = gpt_attention_maps(params, self.cfg, nopix,
                                 class_embed(params, c))
        return {k: v.cpu().numpy() for k, v in (
            ("codes", x), ("codes_half", half), ("codes_nopix", nopix),
            ("codes_det", det), ("att_nopix", att))}

    def perf_timer(self, params, window: int = 50) -> StepTimer:
        """StepTimer with tokens/s and, on a card with a known peak, MFU
        of this task's train step on ``params``."""
        cfg = self.cfg
        n = count_params(params)
        b, t = self.exp.train.batch_size, cfg.block_size - 1
        fwd = gpt_fwd_flops(n, b, t, cfg.n_layer, cfg.n_embd)
        return StepTimer(window, tokens_per_example=t,
                         flops_per_step=3.0 * fwd,
                         peak=peak_flops(self.device, DTYPES[cfg.dtype]))

