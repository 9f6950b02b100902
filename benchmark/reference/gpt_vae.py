"""Plain GPT-VAE training step in float32: the ELBO of the reference's
``transformer/Lit_GPT_VAE.py`` and the decoupled AdamW of minGPT's two
parameter groups.

The encoder is a GPT over the whole block with no causal mask, no dropout
and a ``2 * nz`` head whose last position gives the posterior's mean and
log variance; the decoder is a causal GPT that reads the latent as one
prepended embedding and predicts every token (position i predicts token
i).  The loss of a batch is the mean over its rows of the summed token
cross entropy plus ``kl_weight`` times the Gaussian KL.  The latent noise
is handed in; the decoder's dropout masks come from a generator
(gpt.forward).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import gpt

Matmul = gpt.Matmul


def vae_configs(model: Dict) -> Tuple[Dict, Dict]:
    """(encoder, decoder) GPT configs of a GPT-VAE's base ``model``
    (Lit_GPT_VAE.py:42-43)."""
    enc = dict(model, n_unmasked=model["block_size"],
               last_linear=2 * model["n_embd"], embd_pdrop=0.0,
               resid_pdrop=0.0, attn_pdrop=0.0)
    dec = dict(model, block_size=model["block_size"] + 1, n_unmasked=0,
               last_linear=None)
    return enc, dec


def param_shapes(model: Dict) -> Dict[str, tuple]:
    enc, dec = vae_configs(model)
    out = {f"encoder/{k}": s for k, s in gpt.param_shapes(enc).items()}
    out.update({f"decoder/{k}": s for k, s in gpt.param_shapes(dec).items()})
    return out


def elbo(params: Dict, model: Dict, x: torch.Tensor, eps: torch.Tensor,
         kl_weight: float, generator: Optional[torch.Generator],
         matmul: Matmul = gpt._mm) -> torch.Tensor:
    """Scalar training loss of tokens ``x`` (B, T) with the latent noise
    ``eps`` (B, 1, nz)."""
    enc, dec = vae_configs(model)
    h = gpt.forward(params["encoder"], enc, x, matmul=matmul)
    mu, logvar = h[:, -1, :].chunk(2, dim=-1)
    z = mu + eps[:, 0] * torch.exp(0.5 * logvar)
    logits = gpt.forward(params["decoder"], dec, x[:, :-1], z[:, None, :],
                         generator=generator, matmul=matmul)
    rec = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          x.reshape(-1).long(), reduction="none")
    rec = rec.reshape(x.shape).sum(-1)
    kl = 0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - logvar - 1.0, dim=1)
    return (rec + kl_weight * kl).mean()


def decayed(name: str) -> bool:
    """minGPT's whitelist (minGPT.py:626-649): the block matrices and the
    head are decayed; biases, norms and embeddings are not."""
    return name.endswith("/w") and ("blocks" in name
                                    or name.endswith("head/w"))


class AdamW:
    """``p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)`` over named
    float32 leaves, written out (no fused kernel)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas, eps: float = 1e-8):
        self.leaves = leaves
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.m = {n: torch.zeros_like(t) for n, t in leaves.items()}
        self.v = {n: torch.zeros_like(t) for n, t in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for n, p in self.leaves.items():
            g = grads[n]
            if decayed(n):
                p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


def train_steps(flat: Dict[str, torch.Tensor], model: Dict, train: Dict,
                steps: List[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Generator, float]],
                matmul: Matmul = gpt._mm) -> Dict:
    """Run ``steps`` = [(tokens, eps, dropout generator, kl_weight)] from
    the float32 leaves ``flat`` (updated in place) with AdamW at
    ``train``'s learning rate, weight decay and betas.  Returns the losses,
    the first step's gradient norm by leaf and every leaf's norm of change
    over the steps, as float64 host numbers."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in flat.items()}
    start = {n: t.detach().clone() for n, t in leaves.items()}
    opt = AdamW(leaves, train["learning_rate"], train["weight_decay"],
                train["betas"])
    params = gpt.nest(leaves)
    losses, first_grad = [], {}
    with gpt.fp32_scope():
        for i, (x, eps, gen, kl_w) in enumerate(steps):
            loss = elbo(params, model, x, eps, kl_w, gen, matmul)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            if i == 0:
                first_grad = {n: float(g.double().norm())
                              for n, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
            del loss, grads
    change = {n: float((leaves[n].detach() - start[n]).double().norm())
              for n in leaves}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product with both operands rounded to float8 e4m3 under a
    per-tensor scale that maps the tensor's largest magnitude to 448, then
    multiplied in float32: the control's precision for a configuration that
    states bfloat16 products."""
    return _fp8(a) @ _fp8(b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    q = (x * s).to(torch.float8_e4m3fn).float() / s
    # straight-through: the backward sees the rounded operand's gradient
    return x + (q - x).detach()

