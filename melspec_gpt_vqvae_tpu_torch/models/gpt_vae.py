"""GPT-VAE: an unmasked-GPT Gaussian encoder and a causal GPT decoder that
reads the latent as one soft token, with the ELBO, free bits, IW-NLL,
mutual information and active units.

Counterpart of melspec_gpt_vqvae_tpu/models/gpt_vae.py (reference
transformer/encoders.py:11-170, decoders.py:10-124, Lit_GPT_VAE.py:108-525),
function for function over a ``{"encoder", "decoder"}`` dict of two GPT
parameter trees (models/gpt.py).  Where the JAX functions take a PRNG key,
these take a ``torch.Generator`` and draw from it in order; the Gaussian
noise of ``reparameterize``, ``elbo_loss``, ``training_loss``, ``nll_iw``
and ``mi_from_posteriors`` can instead be handed in as ``eps``, so that a
test gives both packages the same draws (their generators never agree).
Both GPT stacks run ``gpt_apply``: kernel F where ``use_flash_train``, the
plain differentiable attention where autograd records otherwise, and
kernel A in an evaluation forward; decoding goes through ``gpt_generate``
(the captured decode program on the card).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from ..configs import GPTConfig, VAEConfig
from .gpt import (cross_entropy_loss, gpt_apply, gpt_generate,
                  gpt_param_template, init_gpt_params)

Params = Dict[str, object]

DECODE_SEGMENTS = 4    # vae_decode's cache segments (the JAX default)
MI_CHUNK = 512         # rows of z a step of mi_from_posteriors


class VAEConfigs(NamedTuple):
    """The encoder's and decoder's GPT configs (Lit_GPT_VAE.py:42-43): the
    encoder unmasked over the whole block, a 2 x n_embd head and no
    dropout; the decoder causal with one more position for the latent."""

    encoder: GPTConfig
    decoder: GPTConfig
    vae: VAEConfig

    @property
    def nz(self) -> int:
        return self.encoder.n_embd


def make_vae_configs(base: GPTConfig, vae: VAEConfig) -> VAEConfigs:
    enc = base.replace(n_unmasked=base.block_size,
                       last_linear=2 * base.n_embd,
                       embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    dec = base.replace(block_size=base.block_size + 1, n_unmasked=0,
                       last_linear=None)
    return VAEConfigs(enc, dec, vae)


def init_vae_params(cfgs: VAEConfigs, generator: torch.Generator,
                    device=None) -> Params:
    """Random encoder, then decoder parameters from ``generator``
    (``init_gpt_params``)."""
    return {"encoder": init_gpt_params(cfgs.encoder, generator, device),
            "decoder": init_gpt_params(cfgs.decoder, generator, device)}


def vae_param_template(cfgs: VAEConfigs) -> Params:
    """The parameter dict as ``meta`` tensors (shapes and dtypes only)."""
    return {"encoder": gpt_param_template(cfgs.encoder),
            "decoder": gpt_param_template(cfgs.decoder)}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_forward(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T) tokens -> (mean (B, nz), logvar (B, nz)): the last
    position's output halved (encoders.py:21-42); ``fix_var > 0`` fixes
    the log variance.  ``mesh``, here and in every function below that
    takes it, runs both GPT stacks over its ranks (``gpt_apply``'s: the
    pipeline schedule on a ``pipe`` axis, this rank's heads on a ``model``
    axis), as the JAX functions' ``pp=(mesh, n_micro)``."""
    logits = gpt_apply(params["encoder"], cfgs.encoder, x, mesh=mesh)
    mean, logvar = logits[:, -1, :].chunk(2, dim=-1)
    if cfgs.vae.fix_var > 0:
        logvar = torch.full_like(mean, math.log(cfgs.vae.fix_var))
    return mean, logvar


def _normal(shape, like: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    dev = generator.device if generator is not None else like.device
    return torch.randn(shape, generator=generator, device=dev,
                       dtype=like.dtype).to(like.device)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   nsamples: int = 1,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, nz) -> (B, nsamples, nz) = mu + eps * std, eps ~ N(0, I) from
    ``generator`` unless given (encoders.py:81-104)."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = _normal((mu.shape[0], nsamples, mu.shape[1]), mu, generator)
    return mu[:, None, :] + eps * std[:, None, :]


def gaussian_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) summed over dims -> (B,) (encoders.py:77)."""
    return 0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - logvar - 1.0, dim=1)


def gaussian_kl_per_dim(mu: torch.Tensor,
                        logvar: torch.Tensor) -> torch.Tensor:
    """(B, nz) KL per dimension (fb = 2, Lit_GPT_VAE.py:277-285)."""
    return 0.5 * (mu ** 2 + torch.exp(logvar) - logvar - 1.0)


def encode(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
           nsamples: int = 1, generator: Optional[torch.Generator] = None,
           eps: Optional[torch.Tensor] = None, mesh=None):
    """-> (z (B, ns, nz), KL (B,)) (encoders.py:62-79)."""
    mu, logvar = encoder_forward(params, cfgs, x, mesh)
    z = reparameterize(mu, logvar, nsamples, generator, eps)
    return z, gaussian_kl(mu, logvar)


def eval_inference_dist(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                        z: torch.Tensor, param=None,
                        mesh=None) -> torch.Tensor:
    """log q(z|x) -> (B, nsamples) (encoders.py:106-134); ``param`` a
    precomputed (mu, logvar)."""
    nz = z.shape[2]
    mu, logvar = (encoder_forward(params, cfgs, x, mesh) if param is None
                  else param)
    mu, logvar = mu[:, None, :], logvar[:, None, :]
    dev = z - mu
    return (-0.5 * torch.sum(dev ** 2 / torch.exp(logvar), dim=-1)
            - 0.5 * (nz * math.log(2 * math.pi) + torch.sum(logvar, -1)))


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def decoder_logits(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                   z_one: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   mesh=None) -> torch.Tensor:
    """Teacher-forced logits (B, T, V) for one latent z_one (B, nz): the
    input is [z, x[:, :-1]], so position i predicts x_i
    (decoders.py:23-38)."""
    return gpt_apply(params["decoder"], cfgs.decoder, x[:, :-1],
                     z_one[:, None, :], train=train, generator=generator,
                     mesh=mesh)


def reconstruct_error(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                      z: torch.Tensor, *, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      mesh=None) -> torch.Tensor:
    """Summed cross entropy per (batch, sample) -> (B, ns)
    (decoders.py:40-68); the samples' dropout masks are drawn in turn."""
    errs = [cross_entropy_loss(decoder_logits(
        params, cfgs, x, z[:, i], train=train, generator=generator,
        mesh=mesh), x,
        reduce="none").sum(-1) for i in range(z.shape[1])]
    return torch.stack(errs, dim=1)


def log_probability(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                    z: torch.Tensor, mesh=None) -> torch.Tensor:
    """log p(x|z) = -reconstruct_error (decoders.py:71-81)."""
    return -reconstruct_error(params, cfgs, x, z, mesh=mesh)


def vae_decode(params: Params, cfgs: VAEConfigs, z: torch.Tensor,
               strategy: str = "greedy", top_k: Optional[int] = None,
               temperature: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               segments: int = DECODE_SEGMENTS, *, graph=None,
               wq: Optional[Dict] = None, mesh=None) -> torch.Tensor:
    """Token sequences (B, block_size) from z (B, nz) or (B, ns, nz), its
    first sample the decoder's prompt, through ``gpt_generate`` in
    ``segments`` cache segments (the captured decode program on the
    card).  "greedy" and "sample" are argmax; "beam" is top-k sampling
    (top_k 100 unless given), as in the reference
    (Lit_GPT_VAE.py:108-143).  ``graph`` and ``wq`` go to
    ``gpt_generate``: a ``decode_graph.DecodeGraphs`` keeps the captures,
    and the decoder's int8 block weights can be passed in, for a caller
    that decodes the same shape again.  ``mesh``: ``gpt_generate``'s (the
    decoder cut over ``model`` by parallel/mesh.py::shard_gpt_for_serving,
    ``wq`` by ``shard_block_weights``; ``z`` this rank's rows)."""
    cond = z[:, 0:1, :] if z.ndim == 3 else z[:, None, :]
    steps = cfgs.encoder.block_size
    kw = dict(steps=steps, segments=segments, graph=graph, wq=wq, mesh=mesh)
    if strategy == "beam":
        return gpt_generate(params["decoder"], cfgs.decoder, generator, cond,
                            None, sample=True,
                            top_k=top_k if top_k is not None else 100,
                            temperature=temperature or 1.0, **kw)
    return gpt_generate(params["decoder"], cfgs.decoder, generator, cond,
                        None, sample=False, **kw)


def reconstruct(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                strategy: str = "greedy",
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode, draw one z, decode (Lit_GPT_VAE.py:157-173)."""
    mu, logvar = encoder_forward(params, cfgs, x)
    z = reparameterize(mu, logvar, 1, generator, eps)
    return vae_decode(params, cfgs, z, strategy, generator=generator)


def sample_from_prior(cfgs: VAEConfigs, nsamples: int,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """(nsamples, nz) ~ N(0, I) (Lit_GPT_VAE.py:611-617)."""
    dev = generator.device if generator is not None else device
    return torch.randn((nsamples, cfgs.nz), generator=generator,
                       device=dev).to(device or dev)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def elbo_loss(params: Params, cfgs: VAEConfigs, x: torch.Tensor, kl_weight,
              nsamples: int = 1, *, train: bool = False,
              generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None, mesh=None):
    """-> (loss (B,), rec (B,), kl (B,)) (Lit_GPT_VAE.py:176-195): the
    latent noise is drawn first, then the decoder's dropout masks."""
    z, kl = encode(params, cfgs, x, nsamples, generator, eps, mesh)
    rec = reconstruct_error(params, cfgs, x, z, train=train,
                            generator=generator if train else None,
                            mesh=mesh).mean(1)
    return rec + kl_weight * kl, rec, kl


def loss_iw(params: Params, cfgs: VAEConfigs, x: torch.Tensor, kl_weight,
            nsamples: int = 50, ns: int = 10,
            generator: Optional[torch.Generator] = None,
            eps: Optional[torch.Tensor] = None, mesh=None):
    """Importance-weighted objective -> (loss, nll, kl), each (B,): the
    differentiable IW NLL plus ``kl_weight`` x the analytic KL
    (modules/Lit_vae.py:542)."""
    mu, logvar = encoder_forward(params, cfgs, x, mesh)
    kl = gaussian_kl(mu, logvar)
    nll = nll_iw(params, cfgs, x, nsamples, ns, generator,
                 posterior=(mu, logvar), eps=eps, mesh=mesh)
    return nll + kl_weight * kl, nll, kl


def training_loss(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
                  kl_weight, *, nsamples: int = 1, train: bool = True,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None, mesh=None):
    """Scalar training loss and its report by the free-bits mode fb in
    {0, 1, 2, 3} and beta = 0 (a plain autoencoder, or the IW objective
    with ``iw_train_nsamples``) (Lit_GPT_VAE.py:246-315).  ``eps`` is
    ``reparameterize``'s noise, or with the IW objective ``nll_iw``'s."""
    vae = cfgs.vae
    aux: Dict[str, torch.Tensor] = {}
    kw = dict(train=train, generator=generator, eps=eps, mesh=mesh)
    if vae.beta == 0 and vae.iw_train_nsamples > 0:
        loss, rec, kl = loss_iw(params, cfgs, x, kl_weight,
                                nsamples=vae.iw_train_nsamples,
                                ns=max(1, vae.iw_train_ns),
                                generator=generator, eps=eps, mesh=mesh)
    elif vae.beta == 0:
        loss, rec, kl = elbo_loss(params, cfgs, x, 0.0, nsamples, **kw)
    elif vae.fb == 0:
        loss, rec, kl = elbo_loss(params, cfgs, x, kl_weight, nsamples, **kw)
    elif vae.fb == 1:
        _, rec, kl = elbo_loss(params, cfgs, x, kl_weight, nsamples, **kw)
        loss = rec + (kl > vae.target_kl).to(kl.dtype) * kl_weight * kl
    elif vae.fb == 2:
        mu, logvar = encoder_forward(params, cfgs, x, mesh)
        z = reparameterize(mu, logvar, nsamples, generator, eps)
        kl_dim = gaussian_kl_per_dim(mu, logvar)
        mask = (kl_dim > vae.target_kl / float(cfgs.nz)).to(kl_dim.dtype)
        fake_kl = torch.sum(mask * kl_dim, dim=1)
        rec = reconstruct_error(params, cfgs, x, z, train=train,
                                generator=generator if train else None,
                                mesh=mesh).mean(1)
        loss = rec + kl_weight * fake_kl
        kl = kl_dim.sum(1)
        aux["fake_loss_kl"] = fake_kl.mean()
    elif vae.fb == 3:
        _, rec, kl = elbo_loss(params, cfgs, x, kl_weight, nsamples, **kw)
        loss = rec + (kl.mean() > vae.target_kl).to(kl.dtype) \
            * kl_weight * kl
    else:
        raise ValueError(f"unknown fb mode {vae.fb}")
    aux["loss_rc"] = rec.sum()
    aux["loss_kl"] = kl.sum()
    return loss.mean(), aux


# ---------------------------------------------------------------------------
# Importance-weighted NLL
# ---------------------------------------------------------------------------


def log_prior(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) summed over the last dim."""
    return torch.sum(-0.5 * z ** 2 - 0.5 * math.log(2 * math.pi), dim=-1)


def nll_iw(params: Params, cfgs: VAEConfigs, x: torch.Tensor,
           nsamples: int = 500, ns: int = 10,
           generator: Optional[torch.Generator] = None, *,
           posterior=None, eps: Optional[torch.Tensor] = None,
           mesh=None) -> torch.Tensor:
    """IW estimate of -log p(x) per item -> (B,), from nsamples // ns
    chunks of ns samples z ~ q(z|x) (utils.py:50-77, Lit_vae.py:610-668).
    ``posterior`` a precomputed (mu, logvar); ``eps`` (chunks, B, ns, nz)
    the noise of every chunk."""
    mu, logvar = (posterior if posterior is not None
                  else encoder_forward(params, cfgs, x, mesh))
    chunks = max(1, nsamples // ns)
    lls = []
    for c in range(chunks):
        z = reparameterize(mu, logvar, ns, generator,
                           None if eps is None else eps[c])
        lls.append(log_probability(params, cfgs, x, z, mesh) + log_prior(z)
                   - eval_inference_dist(params, cfgs, x, z,
                                         param=(mu, logvar)))
    lls = torch.cat(lls, dim=1)                          # (B, chunks * ns)
    return -(torch.logsumexp(lls, dim=1) - math.log(lls.shape[1]))


# ---------------------------------------------------------------------------
# Mutual information and active units
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_float32():
    """Float32 products without TF32 inside, whatever the global setting
    (the JAX package's ``precision=HIGHEST``)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def mi_from_posteriors(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """I(x, z) from a corpus of posteriors (N, nz) (calc_mi v3,
    Lit_GPT_VAE.py:395-482): one z per row, log q(z_i) the log-mean over
    the corpus's Gaussians.  The Mahalanobis sum is expanded into two
    products, ``(z^2) @ (1/var)^T - 2 z @ (mu/var)^T + sum mu^2/var``, over
    chunks of MI_CHUNK rows of z (memory O(MI_CHUNK N)), after centring z and
    mu on the posterior mean; the products are full float32."""
    n, nz = mu.shape
    neg_entropy = torch.mean(-0.5 * nz * math.log(2 * math.pi)
                             - 0.5 * torch.sum(1 + logvar, dim=-1))
    if eps is None:
        eps = _normal(mu.shape, mu, generator)
    z = mu + eps * torch.exp(0.5 * logvar)
    center = mu.mean(0)
    zc, muc = z - center, mu - center
    inv_var = torch.exp(-logvar)
    a = inv_var.t()
    b = (muc * inv_var).t()
    cvec = (torch.sum(muc ** 2 * inv_var, dim=-1)
            + nz * math.log(2 * math.pi) + torch.sum(logvar, dim=-1))
    parts = []
    with _full_float32():
        for lo in range(0, n, MI_CHUNK):
            zk = zc[lo:lo + MI_CHUNK]
            quad = zk ** 2 @ a - 2.0 * (zk @ b)
            parts.append(torch.logsumexp(-0.5 * (quad + cvec[None, :]), 1)
                         - math.log(n))
    return neg_entropy - torch.cat(parts).mean()


def active_units_from_means(means: torch.Tensor, delta: float = 0.01):
    """(number of dims whose posterior-mean variance over the corpus is >=
    delta, the variances) (calc_au, Lit_GPT_VAE.py:485-525)."""
    au_var = torch.sum((means - means.mean(0, keepdim=True)) ** 2, 0) \
        / (means.shape[0] - 1)
    return torch.sum(au_var >= delta), au_var


@torch.no_grad()
def corpus_mi_and_au(params: Params, cfgs: VAEConfigs,
                     batches: Iterable[torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None, mesh=None):
    """The posteriors of every (B, T) token batch, then (MI, AU, the AU
    variances); (nan, 0, zeros) below two rows.  A collective under a
    mesh: the posteriors are pooled over its data group
    (``parallel.reduce.pool_posteriors``), so that the statistics cover
    the whole corpus, as the reference computes them on every rank
    (callbacks/GPT_VAE_callbacks.py:429-436)."""
    from ..parallel.reduce import pool_posteriors
    mus, logvars = [], []
    for x in batches:
        mu, logvar = encoder_forward(params, cfgs, x, mesh)
        mus.append(mu)
        logvars.append(logvar)
    pooled = pool_posteriors(mus, logvars, cfgs.nz, mesh)
    if pooled is None:
        return float("nan"), 0, torch.zeros(cfgs.nz)
    mu, logvar = pooled
    mi = mi_from_posteriors(mu, logvar, generator, eps)
    au, au_var = active_units_from_means(mu)
    return float(mi), int(au), au_var
