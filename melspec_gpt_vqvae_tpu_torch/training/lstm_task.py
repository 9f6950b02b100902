"""LSTM-VAE training system (the reference's legacy ``VAE`` Lightning
module, modules/Lit_vae.py:19-910).

Counterpart of melspec_gpt_vqvae_tpu/training/lstm_task.py on one device,
with ``VAETask``'s surface, so that ``runner.fit_vae`` / ``evaluate_vae``
and ``callbacks.metrics_epoch_end`` drive it unchanged:

  * each (5, 53) code grid becomes five <s>/</s>-wrapped sentences of its
    first 50 time columns, time-major (``lstm_tokens_from_batch``,
    Lit_vae.py:172-201): a batch of B grids trains on 5B sentences of 52
    tokens;
  * the KL weight anneals a step by ``(1 - kl_start) / (warm_up *
    steps_per_epoch)`` and rides in the state; the free-bits, beta = 0 and
    IW-train branches are ``lstm_vae.lstm_training_loss``'s;
  * the optimiser is ``optim.make_optimizer`` (the preset's SGD at lr 1.0
    with global-norm clipping at 5, Lit_vae.py:85-92);
  * validation at KL weight 1 (the annealed weight when beta = 0), NLL and
    PPL as ``VAETask``'s, corpus MI and AU, the IW-NLL, and greedy /
    beam / sampled reconstructions and samples from the prior.

A train state is ``VAETask``'s: ``{"params": {"encoder", "decoder"},
"optimizer", "step": int, "kl_weight": 0-d float32 tensor}``; a non-Adam
optimiser's state is saved per leaf (``optim.optimizer_state_tree``).

A ``mesh`` may have a ``data`` axis only, as in the JAX package
(lstm_task.py:32-33, 117-135, 189 there): the gradients are averaged over
it before the clip, the step's loss and report are the global batch's,
and the evaluation's sums, MI / AU and IW-NLL are reduced over it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..configs import ExperimentConfig, LSTMConfig
from ..models import gpt_vae as G
from ..models import lstm_vae as L
from ..parallel.mesh import (DATA_AXIS, as_mesh, data_coordinate,
                             data_size, mean_over_data, reduce_gradients)
from ..parallel.reduce import cross_process_sum, pool_posteriors
from ..utils.profiling import StepTimer
from .gpt_task import _map
from .optim import (load_optimizer_state, make_optimizer, named_leaves,
                    with_lr)
from .vae_task import VAETask

TrainState = Dict[str, object]


def lstm_tokens_from_batch(codes, bos_id: int, eos_id: int,
                           part_len: int = 50) -> torch.Tensor:
    """(B, H, W) code grids -> (B * H * min(W, part_len) / part_len,
    part_len + 2) int64 sentences: the first ``part_len`` time columns,
    time-major, cut into ``part_len``-token parts, each wrapped in <s> and
    </s> (Lit_vae.py:172-201).  A grid with fewer tokens than a whole
    number of parts becomes one sentence a grid."""
    codes = torch.as_tensor(np.asarray(codes)).long()
    b, h, w = codes.shape
    keep = min(part_len, w)
    flat = codes[:, :, :keep].transpose(1, 2).reshape(b, -1)
    parts = (flat.reshape(-1, part_len) if (h * keep) % part_len == 0
             else flat)
    n = parts.shape[0]
    return torch.cat([torch.full((n, 1), bos_id), parts,
                      torch.full((n, 1), eos_id)], dim=1)


class LSTMVAETask:
    """Config, device and steps of the LSTM-VAE; the methods ``VAETask``
    has, on the LSTM model."""

    def __init__(self, exp: ExperimentConfig, cfg: LSTMConfig,
                 steps_per_epoch: int, device: torch.device, mesh=None):
        self.exp = exp
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = as_mesh(mesh, self.device)
        if self.mesh is not None and set(self.mesh.names) - {DATA_AXIS}:
            raise ValueError(f"--mesh {self.mesh.shape}: the LSTM-VAE is "
                             "data-parallel only (a 'data' axis)")
        vae = exp.vae
        if vae.warm_up > 0 and steps_per_epoch > 0:
            self.anneal_rate = (1.0 - vae.kl_start) / (
                vae.warm_up * steps_per_epoch)
        else:
            self.anneal_rate = 0.0

    def _optimizer(self, params) -> torch.optim.Optimizer:
        tr = self.exp.train
        return make_optimizer(tr.optimizer, params, tr.learning_rate,
                              tr.weight_decay, tr.betas,
                              momentum=tr.momentum, grad_clip=tr.grad_clip,
                              mesh=self.mesh)

    def init_state(self, seed: int = 783435) -> TrainState:
        """Random parameters from ``seed`` (drawn on the CPU), a fresh
        optimiser, step 0, ``kl_weight = kl_start``."""
        params = L.init_lstm_vae(self.cfg, torch.Generator().manual_seed(seed),
                                 device=self.device)
        params = _map(params, lambda t: t.detach().requires_grad_(True))
        return {"params": params, "optimizer": self._optimizer(params),
                "step": 0, "kl_weight": torch.tensor(
                    float(self.exp.vae.kl_start), device=self.device)}

    # ------------------------------------------------------------------
    def state_template(self) -> Dict:
        """``state_tree``'s layout as ``meta`` tensors: params and, for Adam
        / AdamW, the moments."""
        params = L.lstm_vae_param_template(self.cfg)
        out = {"params": params, "lr": 0.0, "step": 0,
               "kl_weight": torch.empty((), device="meta")}
        if self.exp.train.optimizer in ("adam", "adamw"):
            out.update(mu=params, nu=params, count=0)
        return out

    # a data axis holds every parameter whole: the local tree is the state
    state_tree = VAETask._local_tree

    def load_state(self, tree: Dict) -> TrainState:
        params = _map(tree["params"], lambda t: torch.as_tensor(t).to(
            self.device, torch.float32, copy=True).requires_grad_(True))
        opt = with_lr(self._optimizer(params), tree["lr"])
        load_optimizer_state(opt, params, tree)
        kl = torch.as_tensor(tree["kl_weight"]).to(self.device,
                                                   torch.float32, copy=True)
        return {"params": params, "optimizer": opt,
                "step": int(tree["step"]), "kl_weight": kl.reshape(())}

    # ------------------------------------------------------------------
    def batch_tokens(self, batch) -> torch.Tensor:
        """A loader batch's code grids -> its sentences on the device; a
        (N, T) token array passes through."""
        if isinstance(batch, dict):
            return lstm_tokens_from_batch(batch["codes"], self.cfg.bos_id,
                                          self.cfg.eos_id).to(self.device)
        return torch.as_tensor(batch).long().to(self.device)

    def train_step(self, state: TrainState, batch, generator: torch.Generator,
                   epoch: int = 0, eps: Optional[torch.Tensor] = None):
        """One optimiser step, the latent noise (unless given as ``eps``)
        and the decoder's dropout masks from ``generator``.  Updates the
        state in place; returns (state, the loss, the report), 0-d tensors
        on the device."""
        vae = self.exp.vae
        x = self.batch_tokens(batch)
        if vae.beta == 0:
            kl_weight = torch.zeros((), device=self.device)
        else:
            kl_weight = torch.clamp_max(state["kl_weight"] + self.anneal_rate,
                                        1.0)
        opt = state["optimizer"]
        opt.zero_grad(set_to_none=True)
        loss, aux = L.lstm_training_loss(
            state["params"], self.cfg, vae, x, kl_weight,
            nsamples=vae.nsamples, train=True, generator=generator, eps=eps)
        loss.backward()
        reduce_gradients(self.mesh, named_leaves(state["params"]))
        opt.step()
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

    media_state = VAETask.media_state

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """Sums over the batch's sentences of the ELBO at KL weight 1 (the
        annealed weight when beta = 0) and its parts, and the word and
        sentence counts."""
        x = self.batch_tokens(batch)
        kl_w = state["kl_weight"] if self.exp.vae.beta == 0 else 1.0
        loss, rec, kl = L.lstm_vae_loss(state["params"], self.cfg, x, kl_w,
                                        self.exp.vae.nsamples,
                                        generator=generator, eps=eps)
        b, t = x.shape
        return {"loss": float(loss.sum()), "loss_rc": float(rec.sum()),
                "loss_kl": float(kl.sum()), "num_words": (t - 1) * b,
                "num_sents": b}

    sum_outputs = staticmethod(VAETask.sum_outputs)
    metrics_from_sums = staticmethod(VAETask.metrics_from_sums)

    @classmethod
    def aggregate_epoch(cls, outputs) -> Dict[str, float]:
        return cls.metrics_from_sums(cls.sum_outputs(outputs))

    # ------------------------------------------------------------------
    _generator = VAETask._generator

    @torch.no_grad()
    def calc_mi_au(self, state: TrainState, batches: Iterable,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None):
        """Corpus MI and AU (Lit_vae.py:341-453) over loader batches or
        (N, T) token arrays; (nan, 0, zeros) below two sentences.  ``eps``
        (N, nz) is the MI's noise, else drawn from ``generator``.  A
        collective under a mesh: the posteriors pooled over its data
        group."""
        mus, logvars = [], []
        for b in batches:
            mu, lv = L.lstm_encoder_forward(state["params"]["encoder"],
                                            self.cfg, self.batch_tokens(b))
            mus.append(mu)
            logvars.append(lv)
        pooled = pool_posteriors(mus, logvars, self.cfg.nz, self.mesh)
        if pooled is None:
            return float("nan"), 0, torch.zeros(self.cfg.nz)
        mu, lv = pooled
        mi = G.mi_from_posteriors(mu, lv, self._generator(generator), eps)
        au, au_var = G.active_units_from_means(mu)
        return float(mi), int(au), au_var

    @torch.no_grad()
    def calc_iwnll(self, state: TrainState, batches: Iterable,
                   nsamples: int = 500, ns: int = 10,
                   generator: Optional[torch.Generator] = None):
        """(IW NLL, IW PPL) over loader batches or token arrays
        (Lit_vae.py:610-643); the sums reduced over the mesh's data
        group."""
        g = self._generator(generator)
        if generator is None and data_coordinate(self.mesh):
            g.manual_seed(data_coordinate(self.mesh))
        nll_sum, words, sents = 0.0, 0, 0
        for b in batches:
            x = self.batch_tokens(b)
            nll_sum += float(L.lstm_nll_iw(state["params"], self.cfg, x,
                                           nsamples, ns, g).sum())
            words += (x.shape[1] - 1) * x.shape[0]
            sents += x.shape[0]
        tot = cross_process_sum({"nll": nll_sum, "words": float(words),
                                 "sents": float(sents)}, self.mesh)
        nll_sum, words, sents = tot["nll"], tot["words"], tot["sents"]
        nll = nll_sum / sents
        return nll, float(np.exp(nll * sents / words))

    @torch.no_grad()
    def reconstruct(self, state: TrainState, batch, strategy="greedy",
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode, draw one z, decode greedily, by the true beam search or
        by sampling (Lit_vae.py:133-147)."""
        g = self._generator(generator)
        z, _ = L.lstm_encode(state["params"]["encoder"], self.cfg,
                             self.batch_tokens(batch), 1, g, eps)
        return self.decode(state, z[:, 0], strategy, g)

    @torch.no_grad()
    def decode(self, state: TrainState, z: torch.Tensor, strategy="greedy",
               generator: Optional[torch.Generator] = None,
               beam: int = 5) -> torch.Tensor:
        """z (B, nz) -> tokens (B, max_len) (Lit_vae.py:111-131)."""
        p = state["params"]["decoder"]
        if strategy == "beam":
            return L.lstm_beam_search(p, self.cfg, z, beam=beam)[0]
        return L.lstm_sample_decode(p, self.cfg, z,
                                    greedy=strategy == "greedy",
                                    generator=self._generator(generator))[0]

    @torch.no_grad()
    def sample_from_prior(self, state: TrainState, n: int,
                          strategy: str = "sample",
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        g = self._generator(generator)
        z = torch.randn((n, self.cfg.nz), generator=g,
                        device=g.device).to(self.device)
        return self.decode(state, z, strategy, g)

    def perf_timer(self, params, window: int = 50) -> StepTimer:
        """StepTimer of grids (``examples``) a second, the global batch's."""
        return StepTimer(window, batch_scale=data_size(self.mesh))
