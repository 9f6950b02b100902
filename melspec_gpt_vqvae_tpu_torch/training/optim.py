"""Optimizers on a nested dict of parameter tensors.

Counterpart of melspec_gpt_vqvae_tpu/training/optim.py:25-112.  The JAX
package chains optax ``scale_by_adam`` -> ``add_decayed_weights`` (masked)
-> ``scale(-lr)`` inside ``inject_hyperparams``; ``torch.optim.AdamW``
makes the same decoupled update, ``p <- p - lr * (adam(g) + wd * p)``,
with the decayed leaves in one parameter group and the rest in another.
``make_optimizer`` adds optax's ``adam``, ``sgd`` (with momentum) and
``adafactor`` (``Adafactor``: optax's algorithm and defaults, written
here) and global-norm clipping; ``vqvae_adam`` the VQ-GAN's Adam.  The live learning rate is the groups'
``lr`` for every one of them.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
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


def unflatten(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """The nested layout of ``like`` filled from ``{"a/b/c": tensor}``."""
    return {k: (unflatten(v, flat, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict)
                else flat[f"{prefix}/{k}" if prefix else k])
            for k, v in like.items()}


def _is_adam(opt: torch.optim.Optimizer) -> bool:
    return isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))


def optimizer_state_tree(opt: torch.optim.Optimizer, params) -> Dict:
    """The optimizer's state over ``params`` as nested dicts of the live
    tensors, detached.  Adam and AdamW: ``mu`` and ``nu`` laid out as the
    params (zeros before the first step) and their step ``count``, the
    form of the JAX ``ScaleByAdamState``; any other optimizer: ``opt``,
    each leaf's state dict by the leaf's name."""
    leaves = list(named_leaves(params))
    if not _is_adam(opt):
        return {"opt": {name: {k: (v.detach() if torch.is_tensor(v) else v)
                               for k, v in opt.state.get(t, {}).items()}
                        for name, t in leaves}}
    mu, nu, count = {}, {}, 0
    for name, t in leaves:
        st = opt.state.get(t, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(t)).detach()
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(t)).detach()
        if "step" in st:
            count = int(st["step"])
    return {"mu": unflatten(params, mu), "nu": unflatten(params, nu),
            "count": count}


def load_optimizer_state(opt: torch.optim.Optimizer, params,
                         tree: Dict) -> None:
    """Put ``optimizer_state_tree``'s state, copied onto each parameter's
    device and dtype, into ``opt`` over ``params`` (the same layout)."""
    def to(v, t):
        return torch.as_tensor(v).to(t.device, t.dtype, copy=True)
    if "opt" in tree:
        for name, t in named_leaves(params):
            st = tree["opt"].get(name)
            if st:
                opt.state[t] = {k: (v.clone() if k == "step" else to(v, t))
                                if torch.is_tensor(v) else v
                                for k, v in st.items()}
        return
    count = int(tree["count"])
    if not count:
        return
    mu, nu = dict(named_leaves(tree["mu"])), dict(named_leaves(tree["nu"]))
    for name, t in named_leaves(params):
        opt.state[t] = {"step": torch.tensor(float(count)),
                        "exp_avg": to(mu[name], t),
                        "exp_avg_sq": to(nu[name], t)}


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


def clip_by_global_norm_(named, max_norm: float, mesh=None) -> None:
    """Scale every gradient by ``max_norm / norm`` where the global norm of
    all gradients is at least ``max_norm`` (optax
    ``clip_by_global_norm``).  ``named``: ``(name, tensor)`` leaves.  Under
    a ``mesh`` that splits parameters (a model or pipe axis of more than
    one rank) the squares of the leaves cut over that axis are summed over
    its group and those of the leaves every rank holds whole counted once.
    Runs after the gradients' DP all-reduce, so every data rank clips
    alike."""
    from ..parallel.mesh import MODEL_AXIS, PIPE_AXIS, split_axis
    grads = [(n, t.grad) for n, t in named if t.grad is not None]
    if not grads:
        return
    whole = parts = torch.zeros((), device=grads[0][1].device)
    for n, g in grads:
        sq = torch.sum(g.float() ** 2)
        if split_axis(mesh, n) is None:
            whole = whole + sq
        else:
            parts = parts + sq
    if mesh is not None and mesh.sharded:
        mesh.all_reduce_(parts, MODEL_AXIS if mesh.size(MODEL_AXIS) > 1
                         else PIPE_AXIS)
    norm = torch.sqrt(whole + parts)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for _, g in grads:
        g.mul_(scale.to(g.dtype))


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest axes (second largest, largest) of a leaf whose
    second moment is factored, or None (optax ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate)`` with its defaults: a second
    moment factored into row and column means over a leaf's two largest
    axes when both are >= 128 (else kept whole), decay 1 - t^-0.8, eps
    1e-30, the update clipped to block RMS 1, scaled by the learning rate
    and by the leaf's RMS (at least 1e-3), no momentum, no weight decay
    (optax factorized.py, clipping.py, transform.py).  Not
    ``torch.optim.Adafactor``, which is another algorithm."""

    MIN_DIM_TO_FACTOR, DECAY, EPS, CLIP, MIN_SCALE = 128, 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group["lr"])

    def _update(self, p, lr: float):
        g, st = p.grad, self.state[p]
        dims = _factored_dims(tuple(p.shape), self.MIN_DIM_TO_FACTOR)
        if not st:
            st["step"] = torch.tensor(0.0)
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                st["v_row"] = torch.zeros_like(p.sum(dims[1]))
                st["v_col"] = torch.zeros_like(p.sum(dims[0]))
        decay = 1.0 - (float(st["step"]) + 1.0) ** (-self.DECAY)
        g2 = g * g + self.EPS
        if dims is None:
            st["v"].mul_(decay).add_((1.0 - decay) * g2)
            u = g * st["v"] ** -0.5
        else:
            d1, d0 = dims
            st["v_row"].mul_(decay).add_((1.0 - decay) * g2.mean(d0))
            st["v_col"].mul_(decay).add_((1.0 - decay) * g2.mean(d1))
            r = d1 - 1 if d1 > d0 else d1
            row = (st["v_row"] / st["v_row"].mean(r, keepdim=True)) ** -0.5
            u = g * row.unsqueeze(d0) * (st["v_col"] ** -0.5).unsqueeze(d1)
        u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)) / self.CLIP,
                                1.0)
        u = u * lr * torch.clamp_min(torch.sqrt(torch.mean(p * p)),
                                     self.MIN_SCALE)
        p.sub_(u)
        st["step"] += 1.0


def make_optimizer(name: str, params, learning_rate: float,
                   weight_decay: float = 0.01, betas=(0.9, 0.95),
                   momentum: float = 0.0,
                   grad_clip: Optional[float] = None, mesh=None
                   ) -> torch.optim.Optimizer:
    """The optimizer ``name`` over the leaves of ``params``
    (optim.py:83-112 of the JAX package): ``adamw`` the minGPT two-group
    AdamW (``gpt_adamw``), ``adam`` optax's Adam (eps 1e-8), ``sgd`` with
    ``momentum`` (none at 0), ``adafactor`` (``Adafactor``).
    ``grad_clip`` clips the gradients to that global norm before every
    step; under a ``mesh`` that splits parameters, over every rank's
    parts (``clip_by_global_norm_``).  optax's ``adafactor`` factors and
    clips over whole leaves, so it refuses such a mesh."""
    named = list(named_leaves(params))
    leaves = [t for _, t in named]
    if name == "adafactor" and mesh is not None and mesh.sharded:
        raise ValueError("the adafactor optimizer over parameters split by "
                         "a model or pipe axis is not supported: its "
                         "factored moments and update clipping need whole "
                         "leaves (use adamw, adam or sgd, or a data-only "
                         "--mesh)")
    if name == "adamw":
        opt = gpt_adamw(params, learning_rate, weight_decay, betas)
    elif name == "adam":
        opt = torch.optim.Adam(leaves, lr=learning_rate, betas=tuple(betas),
                               eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(leaves, lr=learning_rate,
                              momentum=momentum or 0.0)
    elif name == "adafactor":
        opt = Adafactor(leaves, lr=learning_rate)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if grad_clip:
        opt.register_step_pre_hook(
            lambda o, args, kwargs: clip_by_global_norm_(named, grad_clip,
                                                         mesh))
    return opt


def vqvae_adam(params, learning_rate: float) -> torch.optim.Optimizer:
    """Adam with betas (0.5, 0.9) and eps 1e-8 over the leaves of
    ``params``, for both VQ-GAN optimizers (optim.py:115-118 of the JAX
    package; reference: big_model_attn_gan.py:834-844)."""
    return make_optimizer("adam", params, learning_rate, betas=(0.5, 0.9))
