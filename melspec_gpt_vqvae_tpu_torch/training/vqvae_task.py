"""VQ-VAE(+GAN) training system (the reference's ``LitVQVAE``).

Counterpart of melspec_gpt_vqvae_tpu/training/vqvae_task.py on one device.
The first stage trains with two Adams (betas (0.5, 0.9)): the autoencoder
(encoder, decoder, quantiser, quant convs) and the PatchGAN discriminator,
with the hinge loss, a ``disc_start`` delay and the adaptive generator
weight, the ratio of the gradient norms of the reconstruction and the
generator losses at the decoder's last conv kernel
(reference: big_model_attn_gan.py:643-660, 742-766, 834-844).

An iteration is the generator phase, then the discriminator phase:

  * generator: one forward of the autoencoder (kernel C picks the codes)
    and of the discriminator in train mode (batch statistics; its running
    statistics are not moved); the two gradient norms come from
    ``torch.autograd.grad`` on that one forward, where the JAX package
    replays the model twice; ``d_weight`` is computed at every step, also
    while ``disc_factor`` is 0;
  * discriminator: the autoencoder runs again with the parameters the
    generator phase just updated (kernel C's second launch), then the
    discriminator on the real batch and on that reconstruction, its
    BatchNorm statistics moved by both passes in that order.

``step`` counts iterations (the reference's Lightning ``global_step``
counts two a batch, hence its ``disc_start * 2``) and advances in the
discriminator phase, so both phases of iteration i see step i.

A train state is ``{"model": VQModel, "disc": NLayerDiscriminator,
"opt_ae", "opt_disc": torch.optim.Adam, "step": int}``; ``state_tree`` /
``load_state`` turn it into and out of the nested dict that checkpoints and
bridge.py carry: ``{ae_params, disc_params, disc_stats, opt_ae, opt_disc,
step}`` as the JAX task's state, torch-named.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..bridge import init_conv_net_
from ..configs import VQVAEConfig
from ..models.vqvae import (NLayerDiscriminator, VQModel,
                            adaptive_gan_weight, hinge_d_loss)
from .optim import load_optimizer_state, optimizer_state_tree, vqvae_adam

TrainState = Dict[str, object]

TRAIN_KEYS = ("train/aeloss", "train/quant_loss", "train/rec_loss",
              "train/d_weight", "train/g_loss", "train/perplexity",
              "train/disc_factor", "train/disc_loss", "train/logits_real",
              "train/logits_fake")


def _floats(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors of one device -> floats in one device-to-host copy."""
    vals = torch.stack([v.detach().float() for v in values.values()])
    return dict(zip(values, vals.tolist()))


class VQVAETask:
    """Config, device and steps of the VQ-GAN first stage."""

    def __init__(self, cfg: VQVAEConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)

    def _nets(self) -> Tuple[VQModel, NLayerDiscriminator]:
        cfg = self.cfg
        return VQModel(cfg), NLayerDiscriminator(
            cfg.disc_ndf, cfg.disc_num_layers, cfg.disc_in_channels)

    def _state(self, model, disc, step: int = 0) -> TrainState:
        # the discriminator stays in train mode (batch statistics) in both
        # phases, as the JAX task applies it with train=True
        model.to(self.device).train()
        disc.to(self.device).train()
        lr = self.cfg.learning_rate
        return {"model": model, "disc": disc,
                "opt_ae": vqvae_adam(dict(model.named_parameters()), lr),
                "opt_disc": vqvae_adam(dict(disc.named_parameters()), lr),
                "step": int(step)}

    def init_state(self, seed: int = 783435) -> TrainState:
        """Random weights from ``seed`` (drawn on the CPU, so a seed gives the
        same weights on every device), fresh Adams, step 0."""
        g = torch.Generator().manual_seed(seed)
        model, disc = self._nets()
        init_conv_net_(model, g)
        init_conv_net_(disc, g)
        return self._state(model, disc)

    # ------------------------------------------------------------------
    def state_template(self) -> Dict:
        """``state_tree``'s layout as ``meta`` tensors (shapes, no memory)."""
        with torch.device("meta"):
            model, disc = self._nets()
        ae = dict(model.named_parameters())
        dp = dict(disc.named_parameters())
        return {"ae_params": ae, "disc_params": dp,
                "disc_stats": dict(disc.named_buffers()),
                "opt_ae": {"mu": ae, "nu": ae, "count": 0},
                "opt_disc": {"mu": dp, "nu": dp, "count": 0}, "step": 0}

    def state_tree(self, state: TrainState) -> Dict:
        """Both nets' parameters, the discriminator's BatchNorm statistics,
        each Adam's moments and count (``optim.optimizer_state_tree``) and
        the step; the live tensors, detached, torch-named."""
        model, disc = state["model"], state["disc"]
        ae = {n: p.detach() for n, p in model.named_parameters()}
        dp = {n: p.detach() for n, p in disc.named_parameters()}
        return {"ae_params": ae, "disc_params": dp,
                "disc_stats": {n: b.detach()
                               for n, b in disc.named_buffers()},
                "opt_ae": optimizer_state_tree(
                    state["opt_ae"], dict(model.named_parameters())),
                "opt_disc": optimizer_state_tree(
                    state["opt_disc"], dict(disc.named_parameters())),
                "step": int(state["step"])}

    def load_state(self, tree: Dict) -> TrainState:
        """A train state on this task's device from a ``state_tree``-shaped
        dict (a checkpoint's, or bridge.vqgan_train_state_from_jax's); every
        tensor copied exactly."""
        model, disc = self._nets()
        model.load_state_dict(tree["ae_params"], strict=True)
        disc.load_state_dict({**tree["disc_params"], **tree["disc_stats"]},
                             strict=True)
        state = self._state(model, disc, tree["step"])
        load_optimizer_state(state["opt_ae"], dict(model.named_parameters()),
                             tree["opt_ae"])
        load_optimizer_state(state["opt_disc"], dict(disc.named_parameters()),
                             tree["opt_disc"])
        return state

    # ------------------------------------------------------------------
    def batch_images(self, batch) -> torch.Tensor:
        """A loader batch's ``image`` (B, H, W) -> (B, H, W, 1) float32 on
        the device; an (B, H, W, 1) array or tensor passes through."""
        if isinstance(batch, dict):
            return torch.as_tensor(np.asarray(batch["image"]))[..., None].to(
                self.device, torch.float32)
        return torch.as_tensor(batch).to(self.device, torch.float32)

    def _ae_losses(self, model: VQModel, x: torch.Tensor):
        qloss, recon, (perp, idx) = model(x)
        rec_loss = torch.mean(torch.abs(x - recon))   # nll_loss, L1 (:665)
        return qloss, recon, rec_loss, perp, idx

    def _disc_factor(self, step: int) -> float:
        return 0.0 if step < self.cfg.disc_start else float(
            self.cfg.disc_factor)

    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, Dict[str, float]]:
        """One iteration: the generator phase, then the discriminator phase
        (Lightning alternates optimizer_idx 0 / 1; reference
        training_step: big_model_attn_gan.py:742-766).  Updates the state in
        place; returns it with the JAX task's log keys as floats."""
        x = self.batch_images(batch)
        logs = self.generator_phase(state, x)
        logs.update(self.discriminator_phase(state, x))
        return state, _floats(logs)

    def generator_phase(self, state: TrainState, x: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """The autoencoder's update (the JAX task's ``generator_step``):
        the discriminator's weights take no gradient and its statistic
        updates are not kept (update_stats off).  Updates the state in
        place; returns its log values as 0-d tensors."""
        cfg = self.cfg
        model, disc = state["model"], state["disc"]
        disc_factor = self._disc_factor(state["step"])
        disc.requires_grad_(False)
        try:
            qloss, recon, rec_loss, perp, _ = self._ae_losses(model, x)
            g_loss = -torch.mean(disc(recon))
            last = model.decoder.conv_out.weight
            nll_g, = torch.autograd.grad(rec_loss, last, retain_graph=True)
            g_g, = torch.autograd.grad(g_loss, last, retain_graph=True)
            d_weight = adaptive_gan_weight(
                torch.linalg.vector_norm(nll_g),
                torch.linalg.vector_norm(g_g), cfg.disc_weight,
                cfg.min_adapt_weight, cfg.max_adapt_weight).detach()
            loss = (rec_loss + cfg.codebook_weight * qloss
                    + d_weight * disc_factor * g_loss)
            opt_ae = state["opt_ae"]
            opt_ae.zero_grad(set_to_none=True)
            loss.backward()
            opt_ae.step()
        finally:
            disc.requires_grad_(True)
        return {"train/aeloss": loss, "train/quant_loss": qloss,
                "train/rec_loss": rec_loss, "train/d_weight": d_weight,
                "train/g_loss": g_loss, "train/perplexity": perp,
                "train/disc_factor": torch.tensor(disc_factor,
                                                  device=x.device)}

    def discriminator_phase(self, state: TrainState, x: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
        """The discriminator's update (the JAX task's
        ``discriminator_step``), on the autoencoder the state holds; then
        ``step`` advances.  Updates the state in place; returns its log
        values as 0-d tensors."""
        model, disc = state["model"], state["disc"]
        disc_factor = self._disc_factor(state["step"])
        with torch.no_grad():
            recon = model(x)[1]
        logits_real = disc(x, update_stats=True)
        logits_fake = disc(recon, update_stats=True)
        d_loss = disc_factor * hinge_d_loss(logits_real, logits_fake)
        opt_disc = state["opt_disc"]
        opt_disc.zero_grad(set_to_none=True)
        d_loss.backward()
        opt_disc.step()
        state["step"] += 1
        return {"train/disc_loss": d_loss,
                "train/logits_real": torch.mean(logits_real),
                "train/logits_fake": torch.mean(logits_fake)}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """(logs, reconstruction (B, H, W, 1), indices (B, h, w)):
        ``val/aeloss = rec_loss + quant_loss``, no codebook weight
        (vqvae_task.py:168-173 of the JAX package)."""
        x = self.batch_images(batch)
        qloss, recon, rec_loss, perp, idx = self._ae_losses(state["model"], x)
        logs = _floats({"val/aeloss": rec_loss + qloss,
                        "val/rec_loss": rec_loss, "val/quant_loss": qloss,
                        "val/perplexity": perp})
        return logs, recon, idx
