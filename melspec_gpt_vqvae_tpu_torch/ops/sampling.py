"""Token-sampling primitives (temperature / top-k / top-p / categorical /
greedy).

Counterpart of melspec_gpt_vqvae_tpu/ops/sampling.py (reference
transformer/minGPT.py:287-291, 345-358).  Randomness comes from an explicit
``torch.Generator``; it never reproduces JAX's bits, so the tests hold the
sampler by its filtered distribution (``filtered_log_probs``) and greedy
decoding by exact tokens.
"""

from __future__ import annotations

from typing import Optional

import torch


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the top-k logits to -inf (reference: minGPT.py:287-291);
    k is clamped to the vocab size."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def top_p_logits(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches ``p`` (the most probable token is always kept)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    k = torch.sum(cum_before < p, dim=-1, keepdim=True)   # >= 1 always
    kth = torch.gather(sorted_logits, -1, k - 1)
    return torch.where(logits < kth, float("-inf"), logits)


def _filter(logits, temperature, top_k, top_p):
    logits = logits / temperature
    if top_k is not None:
        logits = top_k_logits(logits, top_k)
    if top_p is not None and top_p < 1.0:
        logits = top_p_logits(logits, top_p)
    return logits


def categorical(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draw over the last axis by the Gumbel-max trick, as
    ``jax.random.categorical`` does, from uniforms ``u`` of logits'
    shape."""
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(generator: Optional[torch.Generator],
                  logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  sample: bool = True,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampling step over the last (vocab) axis -> int64 tokens.

    ``sample=False`` is argmax (the reference's ``torch.topk(probs, k=1)``);
    otherwise a categorical draw after temperature and top-k / top-p
    filtering, from the uniforms ``u`` or, when None, uniforms drawn from
    ``generator`` (which must live on logits' device).
    """
    logits = _filter(logits.float(), temperature, top_k, top_p)
    if not sample:
        return torch.argmax(logits, dim=-1)
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    return categorical(logits, u)


def filtered_log_probs(logits: torch.Tensor, *, temperature: float = 1.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None) -> torch.Tensor:
    """Log-probabilities of the distribution ``sample_logits`` draws from."""
    return torch.log_softmax(_filter(logits, temperature, top_k, top_p),
                             dim=-1)
