"""The GPT-VAE CLI's dumps: the port's own copy of ``reconstruct`` and
``visualize_latent`` of the repository's root ``utils.py`` (reference
utils.py:19-47, 216-247), which the port does not import."""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gpt_vae import encoder_forward


def reconstruct(task, state, loader, strategy: str, fname: str,
                generator: Optional[torch.Generator] = None):
    """Reconstruct every batch of ``loader`` with ``strategy`` and write
    one line of space-separated tokens a clip."""
    g = (generator if generator is not None
         else torch.Generator(device=task.device).manual_seed(0))
    with open(fname, "w") as f:
        for b in loader:
            rec = task.reconstruct(state, b, strategy, g).cpu().numpy()
            for row in rec:
                f.write(" ".join(str(int(t)) for t in row) + "\n")


@torch.no_grad()
def visualize_latent(task, state, loader, fname: str = "latent.txt"):
    """Write each clip's label and posterior mean, one line a clip;
    returns the (label, mean) rows."""
    rows = []
    for b in loader:
        x = task.batch_tokens(b)
        mu, _ = encoder_forward(state["params"], task.cfgs, x)
        labels = b.get("label", ["?"] * x.shape[0])
        rows += list(zip(labels, mu.float().cpu().numpy()))
    with open(fname, "w") as f:
        for lbl, vec in rows:
            f.write(str(lbl) + "\t" + " ".join(f"{v:.6f}" for v in vec)
                    + "\n")
    return rows
