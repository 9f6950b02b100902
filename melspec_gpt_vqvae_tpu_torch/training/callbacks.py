"""Epoch-end and logging callbacks of GPT-VAE training.

Counterpart of melspec_gpt_vqvae_tpu/training/callbacks.py:190-262 and
303-344: ``metrics_epoch_end`` (the reference's ``callbeck_of_my_dreams``,
GPT_VAE_callbacks.py:421-522: corpus MI and AU at each validation's end)
and ``VAETextLogger`` (the token rows of an original, its greedy and
"beam" reconstructions and a latent interpolation, as TensorBoard text).
The JAX logger also renders spectrograms and audio through a frozen
VQ-VAE and vocoder; that media logging is not ported (ROADMAP A8), so
this one logs the token text only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .logging import TBLogger


class VAETextLogger:
    """``media_cb`` of ``runner.fit_vae``: logs ``{split}/original_codes``,
    ``{split}/greedy_reconstruction``, ``{split}/beam_reconstruction`` and
    ``{split}/interpolation_{i}`` of the batch's first item (and second,
    for the interpolation), with the noise from a generator of its own."""

    INTERPOLATION_STEPS = 5

    def __init__(self, task, log: TBLogger):
        self.task = task
        self.log = log
        self.generator = torch.Generator(device=task.device).manual_seed(0)

    def _log_codes(self, tag: str, seq, step: int):
        self.log.text(tag, str(np.asarray(torch.as_tensor(seq).cpu())
                               .tolist()), step)

    def __call__(self, state, batch, step: int, split: str):
        if "codes" not in batch:
            return
        one = {"codes": np.asarray(batch["codes"])[:1]}
        self._log_codes(f"{split}/original_codes",
                        self.task.batch_tokens(one), step)
        for strategy in ("greedy", "beam"):
            self._log_codes(f"{split}/{strategy}_reconstruction",
                            self.task.reconstruct(state, one, strategy,
                                                  self.generator), step)
        self.log_interpolation(state, batch, step, split=split)

    def log_interpolation(self, state, batch, step: int, split: str = "val"):
        """Greedy decodes between the first two items' latents (the
        ``--test_interpolation`` path, GPT_VAE_callbacks.py:324-386)."""
        codes = np.asarray(batch["codes"])
        if codes.shape[0] < 2:
            return
        outs = self.task.interpolate(state, {"codes": codes[:1]},
                                     {"codes": codes[1:2]},
                                     steps=self.INTERPOLATION_STEPS,
                                     generator=self.generator)
        for i, seq in enumerate(outs):
            self._log_codes(f"{split}/interpolation_{i}", seq, step)


def metrics_epoch_end(task, dm, log: TBLogger,
                      limit_batches: Optional[int] = None) -> Callable:
    """``epoch_end_cb`` of ``runner.fit_vae``: the corpus MI and AU of the
    validation tokens the epoch's pass kept (read from the loader again
    only when none are handed in), ``extras["pre_mi"]`` set to the MI, and
    the metrics logged."""

    def cb(state, epoch: int, agg: Dict[str, float], extras: Dict[str, Any],
           tokens=None):
        if tokens is None:
            tokens = []
            for i, b in enumerate(dm.val_dataloader()):
                if limit_batches and i >= limit_batches:
                    break
                tokens.append(task.batch_tokens(b))
        mi, au, _ = task.calc_mi_au(state, tokens)
        if not tokens and not np.isfinite(mi):
            return
        extras["pre_mi"] = mi
        step = int(state["step"])
        log.scalar("metrics/mutual_info", mi, step)
        log.scalar("metrics/active_units", au, step)
        if agg:
            log.scalar("metrics/ppl", agg["ppl"], step)
            log.scalar("metrics/nll", agg["nll"], step)
        log.scalar("metrics/starting_best_loss", extras["best_loss"], step)
        print(f"epoch {epoch}: mutual_info {mi:.4f} active_units {au}")

    return cb
