"""GPT-VAE training system (the reference's ``GPT_VAE`` LightningModule).

Counterpart of melspec_gpt_vqvae_tpu/training/vae_task.py on one device:
the KL anneal ``kl_weight = min(1, kl_weight + anneal_rate)`` with
``anneal_rate = (1 - kl_start) / (warm_up * steps_per_epoch)``, its weight
kept in the train state so that it resumes exactly (Lit_GPT_VAE.py:69-75,
253-256, 959-964); the free-bits and beta = 0 branches
(``gpt_vae.training_loss``); validation at KL weight 1 unless beta = 0;
NLL = (kl + rec) / sentences and PPL = exp(nll * sentences / words)
(:363-383); corpus MI and AU (:395-525); IW-NLL; reconstruction, decoding
and latent interpolation.

A train state is ``{"params": {"encoder", "decoder"} of leaf tensors with
requires_grad, "optimizer", "step": int, "kl_weight": 0-d float32 tensor
on the device}``; ``state_tree`` / ``load_state`` turn it into and out of
the nested dict that checkpoints and bridge.py carry, as ``GPTTask``'s do.

A ``mesh`` runs both GPT stacks over the world's ranks as ``GPTTask``'s
does (vae_task.py:42-149 of the JAX package): Megatron shards of both
stacks' blocks on a ``model`` axis, the pipeline schedule for both on a
``pipe`` axis, the gradients averaged over ``data``; the loss and report
of a train step are the global batch's, and the evaluation's sums, MI /
AU and IW-NLL are reduced over the data group.  Reconstruction, decoding
and interpolation (the media and the CLI's tools) run on one device on
full parameters (``media_state``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..configs import ExperimentConfig
from ..models import gpt_vae as V
from ..models.gpt import DTYPES, count_params
from ..parallel.mesh import (as_mesh, check_divisible, data_coordinate,
                             data_size, mean_over_data, reduce_gradients,
                             shard_tree)
from ..parallel.pipeline import loss_backward
from ..parallel.reduce import cross_process_sum
from ..utils import profiling
from ..utils.profiling import StepTimer, gpt_fwd_flops, peak_flops
from .gpt_task import (GPTTask, _map, _split, gather_state_tree,
                       shard_state_tree, tokens_from_batch)
from .optim import (get_lr, load_optimizer_state, make_optimizer,
                    named_leaves, optimizer_state_tree, with_lr)

TrainState = Dict[str, object]


class VAETask:
    """Config, device, mesh and steps of the GPT-VAE (``mesh`` and
    ``pp_micro`` as ``GPTTask``'s)."""

    def __init__(self, exp: ExperimentConfig, steps_per_epoch: int,
                 device: torch.device, mesh=None, pp_micro: int = 0):
        self.exp = exp
        self.cfgs = V.make_vae_configs(exp.model, exp.vae)
        self.device = torch.device(device)
        self.mesh = as_mesh(mesh, self.device, pp_micro)
        check_divisible(self.mesh, self.cfgs.encoder)
        vae = exp.vae
        if vae.warm_up > 0 and steps_per_epoch > 0:
            self.anneal_rate = (1.0 - vae.kl_start) / (
                vae.warm_up * steps_per_epoch)
        else:
            self.anneal_rate = 0.0

    def _optimizer(self, params) -> torch.optim.Optimizer:
        # the JAX task builds its optimizer without train.grad_clip
        tr = self.exp.train
        return make_optimizer(tr.optimizer, params, tr.learning_rate,
                              tr.weight_decay, tr.betas,
                              momentum=tr.momentum, mesh=self.mesh)

    def init_state(self, seed: int = 783435) -> TrainState:
        """Random parameters from ``seed`` (drawn on the CPU), a fresh
        optimizer, step 0, ``kl_weight = kl_start``; under a mesh this
        rank's shard of the full tree."""
        full = V.init_vae_params(self.cfgs,
                                 torch.Generator().manual_seed(seed))
        params = _map(shard_tree(self.mesh, full, self.cfgs.encoder.n_head),
                      lambda t: t.to(self.device, copy=True)
                      .requires_grad_(True))
        return {"params": params, "optimizer": self._optimizer(params),
                "step": 0, "kl_weight": torch.tensor(
                    float(self.exp.vae.kl_start), device=self.device)}

    # ------------------------------------------------------------------
    def _adam(self) -> bool:
        return self.exp.train.optimizer in ("adam", "adamw")

    def state_template(self) -> Dict:
        """``state_tree``'s layout as ``meta`` tensors (shapes and dtypes,
        no memory): params and, for Adam / AdamW, the moments."""
        params = V.vae_param_template(self.cfgs)
        out = {"params": params, "lr": 0.0, "step": 0,
               "kl_weight": torch.empty((), device="meta")}
        if self._adam():
            out.update(mu=params, nu=params, count=0)
        return out

    def state_tree(self, state: TrainState) -> Optional[Dict]:
        """params, the optimizer's state (``optim.optimizer_state_tree``),
        the live ``lr``, the train ``step`` and ``kl_weight``; the live
        tensors, detached (under a mesh that splits parameters, the full
        leaves on rank 0's host and None on the other ranks: a
        collective)."""
        return gather_state_tree(self.mesh, self._local_tree(state),
                                 self.cfgs.encoder.n_head)

    def _local_tree(self, state: TrainState) -> Dict:
        """``state_tree``'s dict of this rank's live tensors, detached."""
        opt = state["optimizer"]
        return {"params": _map(state["params"], lambda t: t.detach()),
                **optimizer_state_tree(opt, state["params"]),
                "lr": get_lr(opt), "step": int(state["step"]),
                "kl_weight": state["kl_weight"].detach()}

    def load_state(self, tree: Dict) -> TrainState:
        """A train state on this task's device from a ``state_tree``-shaped
        dict; every tensor copied exactly (under a mesh, this rank's
        shard)."""
        tree = shard_state_tree(self.mesh, tree,
                                self.cfgs.encoder.n_head)
        dtype = DTYPES[self.cfgs.encoder.dtype]
        params = _map(tree["params"], lambda t: torch.as_tensor(t).to(
            self.device, dtype, copy=True).requires_grad_(True))
        opt = with_lr(self._optimizer(params), tree["lr"])
        load_optimizer_state(opt, params, tree)
        kl = torch.as_tensor(tree["kl_weight"]).to(self.device,
                                                   torch.float32, copy=True)
        return {"params": params, "optimizer": opt,
                "step": int(tree["step"]), "kl_weight": kl.reshape(())}

    # ------------------------------------------------------------------
    def batch_tokens(self, batch) -> torch.Tensor:
        """A loader batch's (B, 5, 53) codes -> (B, 265) tokens on the
        device; a (B, T) token array passes through."""
        if isinstance(batch, dict):
            return tokens_from_batch(batch["codes"]).to(self.device)
        return torch.as_tensor(batch).long().to(self.device)

    def train_step(self, state: TrainState, batch, generator: torch.Generator,
                   epoch: int = 0, eps: Optional[torch.Tensor] = None):
        """One optimizer step with the latent noise (unless given as
        ``eps``, ``gpt_vae.training_loss``'s) and dropout masks from
        ``generator``.  From ``freeze_epoch`` on the encoder's updates are
        zeroed (its parameters put back after the step), not its
        gradients: the optimizer's moments go on moving as in the JAX
        task.  Updates the state in place; returns (state, the loss, the
        report), 0-d tensors on the device: under a mesh the global
        batch's, ``eps`` this rank's rows' noise."""
        vae = self.exp.vae
        x = self.batch_tokens(batch)
        if vae.beta == 0:
            kl_weight = torch.zeros((), device=self.device)
        else:
            kl_weight = torch.clamp_max(state["kl_weight"] + self.anneal_rate,
                                        1.0)
        opt = state["optimizer"]
        opt.zero_grad(set_to_none=True)
        with profiling.span("train.forward"):
            loss, aux = V.training_loss(state["params"], self.cfgs, x,
                                        kl_weight, nsamples=vae.nsamples,
                                        train=True, generator=generator,
                                        eps=eps, mesh=self.mesh)
        with profiling.span("train.backward"):
            loss_backward(loss, self.mesh)
            reduce_gradients(self.mesh, named_leaves(state["params"]))
        frozen = vae.freeze_epoch >= 0 and epoch >= vae.freeze_epoch
        with profiling.span("train.optimizer"):
            if frozen:
                enc = [t for _, t in named_leaves(state["params"]["encoder"])]
                before = [t.detach().clone() for t in enc]
            opt.step()
            if frozen:
                with torch.no_grad():
                    for t, b in zip(enc, before):
                        t.copy_(b)
        state["step"] += 1
        state["kl_weight"] = kl_weight.detach()
        b = x.shape[0]
        report = {
            "train/loss": ((aux["loss_rc"] + aux["loss_kl"]) / b
                           if vae.beta != 0 else loss).detach(),
            "train/loss_rc": aux["loss_rc"].detach() / b,
            "train/loss_kl": aux["loss_kl"].detach() / b,
            "train/kl_weight": state["kl_weight"]}
        if "fake_loss_kl" in aux:
            report["train/fake_loss_kl"] = aux["fake_loss_kl"].detach()
        keys = [k for k in report if k != "train/kl_weight"]
        loss, *vals = mean_over_data(self.mesh, [loss.detach()]
                                     + [report[k] for k in keys])
        report.update(zip(keys, vals))
        return state, loss, report

    # the full parameters on rank 0 for its media and tools on one device
    media_state = GPTTask.media_state

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """Sums over the batch of the ELBO at KL weight 1 (the annealed
        weight when beta = 0) and its parts, and the batch's word and
        sentence counts (Lit_GPT_VAE.py:331-337)."""
        x = self.batch_tokens(batch)
        kl_w = (state["kl_weight"] if self.exp.vae.beta == 0 else 1.0)
        loss, rec, kl = V.elbo_loss(state["params"], self.cfgs, x, kl_w,
                                    self.exp.vae.nsamples,
                                    generator=generator, eps=eps,
                                    mesh=self.mesh)
        b, t = x.shape
        return {"loss": float(loss.sum()), "loss_rc": float(rec.sum()),
                "loss_kl": float(kl.sum()), "num_words": (t - 1) * b,
                "num_sents": b}

    @staticmethod
    def sum_outputs(outputs) -> Dict[str, float]:
        return {k: float(sum(o[k] for o in outputs))
                for k in ("loss", "loss_rc", "loss_kl", "num_words",
                          "num_sents")}

    @staticmethod
    def metrics_from_sums(sums: Dict[str, float]) -> Dict[str, float]:
        """NLL and PPL from the epoch's sums (Lit_GPT_VAE.py:363-383)."""
        rec, kl = sums["loss_rc"], sums["loss_kl"]
        words, sents = sums["num_words"], sums["num_sents"]
        nll = (kl + rec) / sents
        return {"loss": sums["loss"] / sents, "nll": nll, "kl": kl / sents,
                "rec": rec / sents,
                "ppl": float(np.exp(nll * sents / words))}

    @classmethod
    def aggregate_epoch(cls, outputs) -> Dict[str, float]:
        return cls.metrics_from_sums(cls.sum_outputs(outputs))

    # ------------------------------------------------------------------
    def _generator(self, generator):
        return (generator if generator is not None
                else torch.Generator(device=self.device).manual_seed(0))

    def calc_mi_au(self, state: TrainState, batches: Iterable,
                   generator: Optional[torch.Generator] = None):
        """Corpus MI and AU over loader batches or (B, T) token arrays; a
        collective under a mesh (the posteriors pooled over the data
        group, the statistics then the same on every rank)."""
        return V.corpus_mi_and_au(state["params"], self.cfgs,
                                  (self.batch_tokens(b) for b in batches),
                                  self._generator(generator),
                                  mesh=self.mesh)

    @torch.no_grad()
    def calc_iwnll(self, state: TrainState, batches: Iterable,
                   nsamples: int = 500, ns: int = 10,
                   generator: Optional[torch.Generator] = None):
        """(IW NLL, IW PPL) over loader batches or token arrays
        (utils.py:50-77); the sums reduced over the mesh's data group, each
        data rank drawing its own noise."""
        g = self._generator(generator)
        if generator is None and data_coordinate(self.mesh):
            g.manual_seed(data_coordinate(self.mesh))
        nll_sum, words, sents = 0.0, 0, 0
        for b in batches:
            x = self.batch_tokens(b)
            nll_sum += float(V.nll_iw(state["params"], self.cfgs, x,
                                      nsamples, ns, g, mesh=self.mesh).sum())
            words += (x.shape[1] - 1) * x.shape[0]
            sents += x.shape[0]
        tot = cross_process_sum({"nll": nll_sum, "words": float(words),
                                 "sents": float(sents)}, self.mesh)
        nll_sum, words, sents = tot["nll"], tot["words"], tot["sents"]
        nll = nll_sum / sents
        return nll, float(np.exp(nll * sents / words))

    @torch.no_grad()
    def reconstruct(self, state: TrainState, batch, strategy="greedy",
                    generator: Optional[torch.Generator] = None):
        return V.reconstruct(state["params"], self.cfgs,
                             self.batch_tokens(batch), strategy,
                             self._generator(generator))

    @torch.no_grad()
    def decode(self, state: TrainState, z, strategy="greedy",
               generator: Optional[torch.Generator] = None, top_k=None,
               temperature=None):
        return V.vae_decode(state["params"], self.cfgs, z, strategy,
                            top_k=top_k, temperature=temperature,
                            generator=self._generator(generator))

    @torch.no_grad()
    def interpolate(self, state: TrainState, x_from, x_to, steps: int = 5,
                    generator: Optional[torch.Generator] = None):
        """Greedy decodes at ``steps`` evenly spaced points between a
        latent drawn from each item's posterior
        (GPT_VAE_callbacks.py:324-386)."""
        g = self._generator(generator)
        p = state["params"]
        mu_f, lv_f = V.encoder_forward(p, self.cfgs, self.batch_tokens(x_from))
        mu_t, lv_t = V.encoder_forward(p, self.cfgs, self.batch_tokens(x_to))
        z_from = V.reparameterize(mu_f, lv_f, 1, g)
        z_to = V.reparameterize(mu_t, lv_t, 1, g)
        return [self.decode(state, float(v) * z_to + (1.0 - float(v)) * z_from,
                            "greedy", g)
                for v in np.linspace(0.0, 1.0, steps)]

    def perf_timer(self, params, window: int = 50) -> StepTimer:
        """StepTimer with tokens/s and, on a card with a known peak, MFU of
        the encoder and decoder passes."""
        enc, dec = self.cfgs.encoder, self.cfgs.decoder
        b = self.exp.train.batch_size
        full = V.vae_param_template(self.cfgs)
        fwd = (gpt_fwd_flops(count_params(full["encoder"]), b,
                             enc.block_size, enc.n_layer, enc.n_embd)
               + gpt_fwd_flops(count_params(full["decoder"]), b,
                               dec.block_size, dec.n_layer, dec.n_embd))
        return StepTimer(window, tokens_per_example=enc.block_size,
                         flops_per_step=3.0 * fwd / _split(self.mesh),
                         peak=peak_flops(self.device, torch.bfloat16
                                         if enc.mixed_precision
                                         else DTYPES[enc.dtype]),
                         batch_scale=data_size(self.mesh))
