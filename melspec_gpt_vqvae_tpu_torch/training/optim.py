"""The minGPT two-group AdamW on a nested dict of parameter tensors.

Counterpart of melspec_gpt_vqvae_tpu/training/optim.py:25-80.  The JAX
package chains optax ``scale_by_adam`` -> ``add_decayed_weights`` (masked)
-> ``scale(-lr)`` inside ``inject_hyperparams``; ``torch.optim.AdamW``
makes the same decoupled update, ``p <- p - lr * (adam(g) + wd * p)``,
with the decayed leaves in one parameter group and the rest in another.
The live learning rate is the groups' ``lr``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``("blocks/attn_qkv/w", tensor)`` pairs of a nested dict, in its
    insertion order."""
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from named_leaves(v, name)
        else:
            yield name, v


def _is_decayed(name: str) -> bool:
    if not name.endswith("/w"):
        return False
    return "blocks" in name or name.endswith("head/w")


def decay_mask(params) -> Dict:
    """The params' nested dict with True where weight decay applies: the
    matmul weights ``blocks/*/w`` and ``head/w``; biases, LayerNorms and
    the token / position / class embeddings are not decayed (the
    reference's whitelist walk, minGPT.py:626-649)."""
    def walk(tree, prefix):
        return {k: (walk(v, f"{prefix}/{k}" if prefix else k)
                    if isinstance(v, dict)
                    else _is_decayed(f"{prefix}/{k}" if prefix else k))
                for k, v in tree.items()}
    return walk(params, "")


def gpt_adamw(params, learning_rate: float, weight_decay: float = 0.01,
              betas=(0.9, 0.95)) -> torch.optim.AdamW:
    """AdamW over the leaves of ``params`` with the minGPT decay partition:
    group 0 decayed, group 1 not; eps 1e-8 as optax's ``scale_by_adam``."""
    leaves = list(named_leaves(params))
    groups = [
        {"params": [t for n, t in leaves if _is_decayed(n)],
         "weight_decay": weight_decay},
        {"params": [t for n, t in leaves if not _is_decayed(n)],
         "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=learning_rate, betas=tuple(betas),
                             eps=1e-8)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    """The live learning rate (the groups share it)."""
    return float(optimizer.param_groups[0]["lr"])


def with_lr(optimizer: torch.optim.Optimizer,
            lr: float) -> torch.optim.Optimizer:
    """Set the live learning rate of every group (the reference's
    ``set_lr``, Lit_GPT_VAE.py:949-953); updates in place and returns the
    optimizer."""
    for g in optimizer.param_groups:
        g["lr"] = float(lr)
    return optimizer
