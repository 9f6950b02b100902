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

With a ``mesh`` (parallel/mesh.py; a ``--mesh`` spec or a ``Mesh``) the
task trains over the world's ranks (gpt_task.py:58-130 of the JAX
package): the parameters are this rank's shard (Megatron heads and MLP
columns on a ``model`` axis, a stage's layers on a ``pipe`` axis, where
the loss is ``parallel.pipeline.gpt_pp_loss_fn``), the gradients are
averaged over the ``data`` axis after the backward (DDP), and the returned
loss is the global batch's.  ``state_tree`` gathers full leaves to rank 0 and
``load_state`` slices this rank's, so checkpoints hold no mesh.
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
from ..parallel.mesh import (MODEL_AXIS, PIPE_AXIS, as_mesh,
                             check_divisible, data_size, gather_leaf,
                             gather_tree, is_primary, mean_over_data,
                             reduce_gradients, shard_leaf, shard_tree)
from ..parallel.pipeline import gpt_pp_loss_fn, loss_backward
from ..parallel.reduce import cross_process_sharded
from ..utils import profiling
from ..utils.profiling import StepTimer, gpt_fwd_flops, peak_flops
from .optim import (get_lr, gpt_adamw, load_optimizer_state, named_leaves,
                    optimizer_state_tree, with_lr)

TrainState = Dict[str, object]


def tokens_from_batch(codes) -> torch.Tensor:
    """(B, 5, 53) code grid -> (B, 265) column-major int64 tokens
    (reference get_x: minGPT.py:387-394)."""
    codes = torch.as_tensor(np.asarray(codes))
    return codes.transpose(1, 2).reshape(codes.shape[0], -1).long()


def gpt_loss_fn(params, cfg: GPTConfig, x: torch.Tensor, c: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False, mesh=None) -> torch.Tensor:
    """Conditioned next-token cross entropy (minGPT.py:260-285, 413-417).
    x: (B, 265) tokens; c: (B,) or (B, 1) class index.  The logits from
    the class token on predict x: the first ``cond.shape[1] - 1`` are
    dropped.  ``mesh``: ``gpt_apply``'s."""
    cond = class_embed(params, c)
    logits = gpt_apply(params, cfg, x[:, :-1], cond, train=train,
                       generator=generator, mesh=mesh)
    return cross_entropy_loss(logits[:, cond.shape[1] - 1:], x)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _opt_leaves(mesh, opt_tree, fn, *args):
    """A non-Adam optimizer's per-leaf state (``{leaf: {key: value}}``)
    with ``fn(mesh, leaf, tensor, *args)`` applied to its tensors of a
    leaf's shape (momentum); 0-d entries (steps) pass."""
    return {name: {k: (fn(mesh, name, v, *args) if torch.is_tensor(v)
                       and v.ndim else v) for k, v in st.items()}
            for name, st in opt_tree.items()}


def gather_state_tree(mesh, tree: Dict, n_head: int) -> Optional[Dict]:
    """A ``state_tree`` dict of this rank's parts of a GPT of ``n_head``
    heads -> full leaves on global rank 0's host, one leaf at a time, and
    None on every other rank (a collective of rank 0's model or pipe
    group); ``tree`` itself unless the mesh splits parameters."""
    if mesh is None or not mesh.sharded:
        return tree
    out = dict(tree)
    for part in ("params", "mu", "nu"):
        if part in tree:
            out[part] = gather_tree(mesh, tree[part], n_head)
    if "opt" in tree:
        out["opt"] = _opt_leaves(mesh, tree["opt"], gather_leaf, n_head)
    return out if is_primary() else None


def shard_state_tree(mesh, tree: Dict, n_head: int) -> Dict:
    """``gather_state_tree``'s inverse: full leaves -> this rank's parts
    (views; the task copies them onto its device) of a GPT of ``n_head``
    heads."""
    if mesh is None:
        return tree
    out = dict(tree)
    for part in ("params", "mu", "nu"):
        if part in tree:
            out[part] = shard_tree(mesh, tree[part], n_head)
    if "opt" in tree:
        out["opt"] = _opt_leaves(mesh, tree["opt"], shard_leaf, n_head)
    return out


def _split(mesh) -> int:
    """How many ranks share one data rank's step (its model and pipe
    ranks): a rank's useful FLOPs are that share of the step's."""
    return 1 if mesh is None else (mesh.size(MODEL_AXIS)
                                   * mesh.size(PIPE_AXIS))


class GPTTask:
    """Config, device, mesh and steps of the GPT-class model.  ``mesh``:
    None (one device), a ``parallel.mesh.Mesh`` or a ``--mesh`` spec, made
    with ``pp_micro`` microbatches for a ``pipe`` axis (0 = twice the
    stages)."""

    def __init__(self, exp: ExperimentConfig, device: torch.device,
                 mesh=None, pp_micro: int = 0):
        self.exp = exp
        self.cfg = exp.model
        self.device = torch.device(device)
        self.mesh = as_mesh(mesh, self.device, pp_micro)
        check_divisible(self.mesh, self.cfg)
        self.pp = self.mesh is not None and self.mesh.has(PIPE_AXIS)
        # the decode programs of ``sample``, kept across calls: the train
        # state's parameters are updated in place, so their addresses hold
        self.graphs = decode_graph.DecodeGraphs()

    def _optimizer(self, params) -> torch.optim.AdamW:
        tr = self.exp.train
        return gpt_adamw(params, tr.learning_rate, tr.weight_decay, tr.betas)

    def init_state(self, seed: int = 783435) -> TrainState:
        """Random parameters from ``seed`` (drawn on the CPU, so a seed gives
        the same weights on every device; under a mesh the full tree, of
        which this rank keeps its shard), a fresh AdamW, step 0."""
        full = init_gpt_params(self.cfg, torch.Generator().manual_seed(seed))
        params = _map(shard_tree(self.mesh, full, self.cfg.n_head),
                      lambda t: t.to(self.device, copy=True)
                      .requires_grad_(True))
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
    def state_tree(self, state: TrainState) -> Optional[Dict]:
        """The state as a nested dict: params, the AdamW moments ``mu`` and
        ``nu`` (zeros before the first step), their step ``count``, the
        live ``lr`` and the train ``step``.  Tensors are the live ones,
        detached, not copies; under a mesh that splits parameters the full
        leaves, gathered to rank 0's host, and None on the other ranks (a
        collective: ``gather_state_tree``)."""
        opt = state["optimizer"]
        return gather_state_tree(self.mesh, {
            "params": _map(state["params"], lambda t: t.detach()),
            **optimizer_state_tree(opt, state["params"]),
            "lr": get_lr(opt), "step": int(state["step"])}, self.cfg.n_head)

    def load_state(self, tree: Dict) -> TrainState:
        """A train state on this task's device from a ``state_tree``-shaped
        dict (a checkpoint's, or bridge.train_state_from_jax's): parameters
        and moments are copied exactly, in the model dtype; under a mesh
        this rank's shard of them."""
        tree = shard_state_tree(self.mesh, tree, self.cfg.n_head)
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
        it waits for the step).  Under a mesh ``batch`` is this rank's
        rows, ``generator`` this data rank's, and the loss the global
        batch's mean."""
        x, c = self.batch_tensors(batch)
        opt = state["optimizer"]
        opt.zero_grad(set_to_none=True)
        with profiling.span("train.forward"):
            loss = self.loss(state["params"], x, c, generator, train=True)
        with profiling.span("train.backward"):
            loss_backward(loss, self.mesh)
            reduce_gradients(self.mesh, named_leaves(state["params"]))
        with profiling.span("train.optimizer"):
            opt.step()
        state["step"] += 1
        return state, mean_over_data(self.mesh, [loss.detach()])[0]

    def loss(self, params, x: torch.Tensor, c: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             train: bool = False) -> torch.Tensor:
        """``gpt_loss_fn`` over this task's mesh: the pipeline's on a
        ``pipe`` axis (gpt_task.py:58-90 of the JAX package)."""
        if self.pp:
            return gpt_pp_loss_fn(params, self.cfg, x, c, self.mesh,
                                  generator=generator, train=train)
        return gpt_loss_fn(params, self.cfg, x, c, generator=generator,
                           train=train, mesh=self.mesh)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict) -> torch.Tensor:
        x, c = self.batch_tensors(batch)
        return self.loss(state["params"], x, c)

    def media_state(self, state: TrainState) -> Optional[TrainState]:
        """The state a media callback samples from: the train state itself,
        or under a mesh that splits parameters one with the full
        parameters on this task's device on global rank 0 and None on the
        other ranks (a collective: rank 0 then logs on one device, as the
        JAX loggers do)."""
        if not cross_process_sharded(self.mesh):
            return state
        params = gather_tree(self.mesh, state["params"], self.cfg.n_head,
                             device=self.device)
        return dict(state, params=params) if is_primary() else None

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
        fwd = gpt_fwd_flops(count_params(gpt_param_template(cfg)),
                            self.exp.train.batch_size, cfg.block_size - 1,
                            cfg.n_layer, cfg.n_embd)
        return StepTimer(window, tokens_per_example=cfg.block_size - 1,
                         flops_per_step=3.0 * fwd / _split(self.mesh),
                         peak=peak_flops(self.device, DTYPES[cfg.dtype]),
                         batch_scale=data_size(self.mesh))

