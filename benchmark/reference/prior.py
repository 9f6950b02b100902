"""Plain GPT-VAE prior decoder in float32: the decoder's logits over a
latent and the tokens decoded from it, teacher-forced.

The decoder of the reference's ``transformer/Lit_GPT_VAE.py`` reads the
latent z as one prepended embedding and predicts every token (position i
predicts token i; the block is one longer than the clip's 265 codes).
Sampling from the prior (Lit_GPT_VAE.py:611-617) draws z ~ N(0, I) and
decodes; the reference here takes the latents and the tokens a program
decoded and gives the logits each position saw, through ``gpt.forward``
with every product in float32 and TF32 off.  No cache, no kernel, no
batching beyond cutting the rows into blocks that fit.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import gpt
from .gpt_vae import vae_configs


def decoder_config(model: Dict) -> Dict:
    """The decoder's GPT config of a GPT-VAE's base ``model``: one more
    position for the latent, causal, the vocabulary's head."""
    return vae_configs(model)[1]


def param_shapes(model: Dict) -> Dict[str, tuple]:
    """The decoder's leaves (the encoder is never run by the prior)."""
    return gpt.param_shapes(decoder_config(model))


def prior_logits(p: gpt.Params, model: Dict, z: torch.Tensor,
                 tokens: torch.Tensor, rows: int = 8,
                 **kw) -> torch.Tensor:
    """The decoder's float32 logits (N, T, V) over the latents ``z`` (N,
    nz) and ``tokens`` (N, T): position 0 reads z alone, position i the
    latent and tokens 0..i-1; ``rows`` sequences at a time (``kw``:
    ``gpt.forward``'s lower-precision hooks).  The last token is fed in no
    further (its logits would predict past the clip)."""
    cfg = decoder_config(model)
    out = []
    with torch.no_grad(), gpt.fp32_scope():
        for i in range(0, tokens.shape[0], rows):
            cond = z[i:i + rows].float()[:, None, :]
            out.append(gpt.forward(p, cfg, tokens[i:i + rows, :-1], cond,
                                   **kw))
    return torch.cat(out)
