"""The legacy LSTM-VAE family: encoder, decoder, VAE losses, decoding, the
LSTM language model and the latent-probe discriminators.

Counterpart of melspec_gpt_vqvae_tpu/models/lstm_vae.py (reference
modules/encoders/enc_lstm.py:10-83, decoders/dec_lstm.py:17-357,
lm/lm_lstm.py, discriminators/discriminator_linear.py, Lit_vae.py:542-723)
over nested dicts of tensors in the JAX package's layout, so that bridge.py
carries a JAX tree across leaf for leaf: an LSTM is ``{"wx": (in, 4 nh),
"wh": (nh, 4 nh), "b": (4 nh,)}`` with the gates in torch's order i, f, g,
o, a linear map ``{"w": (in, out)}``.

The recurrence is the JAX package's ``lstm_cell`` stepped once a token in
a Python loop (no Pallas kernel is on this path, and none here); the input
products of a teacher-forced sequence are taken for all its steps at once.
Where the JAX functions take a PRNG key these take a ``torch.Generator``
and draw from it in order -- the latent noise first, then the decoder's
dropout masks (inverted dropout on the input embeddings and on the
outputs) -- and the Gaussian noise of ``reparameterize`` and of the IW
estimates can be handed in as ``eps``, as in models/gpt_vae.py, so that a
test gives both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs import LSTMConfig, VAEConfig
from .gpt import cross_entropy_loss, tree_to
from .gpt_vae import (gaussian_kl, gaussian_kl_per_dim, log_prior,
                      reparameterize)

Params = Dict[str, object]


def _uniform(generator: torch.Generator, shape, scale: float):
    dev = generator.device
    return (torch.rand(shape, generator=generator, device=dev) * 2.0
            - 1.0) * scale


# ---------------------------------------------------------------------------
# LSTM cell
# ---------------------------------------------------------------------------


def _lstm(leaf, input_size: int, hidden: int) -> Params:
    return {"wx": leaf((input_size, 4 * hidden), 0.01),
            "wh": leaf((hidden, 4 * hidden), 0.01),
            "b": leaf((4 * hidden,), None)}


def _vae_tree(cfg: LSTMConfig, leaf) -> Params:
    """The LSTM-VAE's nested parameter dict, each leaf ``leaf(shape,
    scale)``: a uniform weight in +-scale, or zeros where scale is None
    (lstm_vae.py:59-137)."""
    return {
        "encoder": {"embed": leaf((cfg.vocab_size, cfg.ni), 0.1),
                    "lstm": _lstm(leaf, cfg.ni, cfg.enc_nh),
                    "linear": {"w": leaf((cfg.enc_nh, 2 * cfg.nz), 0.01)}},
        "decoder": {"embed": leaf((cfg.vocab_size, cfg.ni), 0.1),
                    "trans": {"w": leaf((cfg.nz, cfg.dec_nh), 0.01)},
                    "lstm": _lstm(leaf, cfg.ni + cfg.nz, cfg.dec_nh),
                    "pred": {"w": leaf((cfg.dec_nh, cfg.vocab_size),
                                       0.01)}}}


def _init_leaf(generator: torch.Generator):
    def leaf(shape, scale):
        if scale is None:
            return torch.zeros(shape, device=generator.device)
        return _uniform(generator, shape, scale)
    return leaf


def lstm_cell(p: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              xw: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step (lstm_vae.py:69-74): gates ``x wx + h wh + b`` split i, f,
    g, o; ``xw`` is ``x wx`` where the caller took it already."""
    if xw is None:
        xw = x @ p["wx"]
    gates = xw + h @ p["wh"] + p["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_run(p: Params, xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """xs (B, T, in) -> (outputs (B, T, nh), (h_T, c_T))."""
    xw = xs @ p["wx"]
    h, c, ys = h0, c0, []
    for t in range(xs.shape[1]):
        h, c = lstm_cell(p, None, h, c, xw[:, t])
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the keep-mask drawn from ``generator``; the
    identity without one or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


# ---------------------------------------------------------------------------
# Encoder and decoder
# ---------------------------------------------------------------------------


def init_lstm_vae(cfg: LSTMConfig, generator: torch.Generator,
                  device=None) -> Params:
    """Random encoder, then decoder parameters from ``generator`` (drawn on
    its device, then moved to ``device``): uniform in +-0.1 for the
    embeddings and +-0.01 for the matrices, zero biases."""
    return tree_to(_vae_tree(cfg, _init_leaf(generator)), device=device)


def lstm_vae_param_template(cfg: LSTMConfig) -> Params:
    """The parameter dict as ``meta`` tensors (shapes, no memory)."""
    return _vae_tree(cfg, lambda shape, scale: torch.empty(shape,
                                                           device="meta"))


def lstm_encoder_forward(p: Params, cfg: LSTMConfig, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T) -> (mean, logvar), each (B, nz), from the last hidden state
    (enc_lstm.py:47-73); ``fix_var > 0`` fixes the log variance."""
    emb = p["embed"][x.long()]
    h0 = emb.new_zeros((x.shape[0], cfg.enc_nh))
    _, (h, _) = lstm_run(p["lstm"], emb, h0, h0)
    mean, logvar = (h @ p["linear"]["w"]).chunk(2, dim=-1)
    if cfg.fix_var > 0:
        logvar = torch.full_like(mean, math.log(cfg.fix_var))
    return mean, logvar


def lstm_encode(p: Params, cfg: LSTMConfig, x: torch.Tensor,
                nsamples: int = 1,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
    """-> (z (B, nsamples, nz), KL (B,))."""
    mu, logvar = lstm_encoder_forward(p, cfg, x)
    return (reparameterize(mu, logvar, nsamples, generator, eps),
            gaussian_kl(mu, logvar))


def _dec_init_state(p: Params, z: torch.Tensor):
    c0 = z @ p["trans"]["w"]
    return torch.tanh(c0), c0


def lstm_decode_logits(p: Params, cfg: LSTMConfig, src: torch.Tensor,
                       z: torch.Tensor, *, train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Teacher-forced logits (dec_lstm.py:98-143): src (B, T), z (B, nz)
    -> (B, T, V), z concatenated to every input embedding, c0 = z W and
    h0 = tanh(c0); in training the input embeddings' and the outputs'
    dropout masks are drawn from ``generator`` in that order."""
    g = generator if train else None
    emb = _dropout(p["embed"][src.long()], cfg.dec_dropout_in, g)
    zt = z[:, None, :].expand(emb.shape[0], emb.shape[1], z.shape[-1])
    h0, c0 = _dec_init_state(p, z)
    out, _ = lstm_run(p["lstm"], torch.cat([emb, zt], dim=-1), h0, c0)
    return _dropout(out, cfg.dec_dropout_out, g) @ p["pred"]["w"]


def lstm_reconstruct_error(p: Params, cfg: LSTMConfig, x: torch.Tensor,
                           z: torch.Tensor, *, train: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """x (B, T) with <s> ... </s>, z (B, ns, nz) -> summed cross entropy per
    (item, sample) (B, ns) (dec_lstm.py:145-181); the samples' dropout
    masks are drawn in turn."""
    src, tgt = x[:, :-1], x[:, 1:]
    errs = [cross_entropy_loss(lstm_decode_logits(
        p, cfg, src, z[:, i], train=train, generator=generator), tgt,
        reduce="none").sum(-1) for i in range(z.shape[1])]
    return torch.stack(errs, dim=1)


def lstm_log_probability(p: Params, cfg: LSTMConfig, x: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
    return -lstm_reconstruct_error(p, cfg, x, z)


def _next_token(logits: torch.Tensor, greedy: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if greedy:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float(), dim=-1)
    if generator is not None and generator.device != probs.device:
        probs = probs.to(generator.device)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        logits.device)


@torch.no_grad()
def lstm_sample_decode(p: Params, cfg: LSTMConfig, z: torch.Tensor,
                       greedy: bool = False,
                       generator: Optional[torch.Generator] = None):
    """Greedy or ancestral decoding of ``max_len`` steps from <s>
    (dec_lstm.py:304-357) -> (tokens (B, max_len), lengths (B,)): a row
    ends at its first </s>, the positions after it hold </s>, and its
    length counts the steps up to and including that one."""
    b = z.shape[0]
    h, c = _dec_init_state(p, z)
    tok = torch.full((b,), cfg.bos_id, dtype=torch.long, device=z.device)
    alive = torch.ones(b, dtype=torch.bool, device=z.device)
    toks, lengths = [], torch.zeros(b, dtype=torch.long, device=z.device)
    for _ in range(cfg.max_len):
        inp = torch.cat([p["embed"][tok], z], dim=-1)
        h, c = lstm_cell(p["lstm"], inp, h, c)
        nxt = _next_token(h @ p["pred"]["w"], greedy, generator)
        nxt = torch.where(alive, nxt, cfg.eos_id)
        lengths += alive
        alive = alive & (nxt != cfg.eos_id)
        toks.append(nxt)
        tok = nxt
    return torch.stack(toks, dim=1), lengths


@torch.no_grad()
def lstm_beam_search(p: Params, cfg: LSTMConfig, z: torch.Tensor,
                     beam: int = 5):
    """The true beam search, batched over (item, beam) (dec_lstm.py:195-302
    keeps Python hypothesis lists): beam 0 starts alone, the others dead at
    -1e30; a finished beam extends only by </s> at no cost; each step keeps
    the ``beam`` best of beam x V candidates.  Returns the best hypothesis
    of each item: (tokens (B, max_len), its log probability (B,))."""
    b, nz = z.shape
    V, L = cfg.vocab_size, cfg.max_len
    h, c = _dec_init_state(p, z)
    nh = h.shape[-1]
    h = h[:, None].expand(b, beam, nh).reshape(b * beam, nh)
    c = c[:, None].expand(b, beam, nh).reshape(b * beam, nh)
    dev = z.device
    tok = torch.full((b, beam), cfg.bos_id, dtype=torch.long, device=dev)
    scores = torch.where(torch.arange(beam, device=dev) == 0, 0.0,
                         -1e30).expand(b, beam)
    finished = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    toks = torch.full((b, beam, L), cfg.eos_id, dtype=torch.long, device=dev)
    zb = z[:, None].expand(b, beam, nz)
    eos_only = torch.full((V,), -1e30, device=dev)
    eos_only[cfg.eos_id] = 0.0
    for t in range(L):
        inp = torch.cat([p["embed"][tok], zb], dim=-1).reshape(b * beam, -1)
        h2, c2 = lstm_cell(p["lstm"], inp, h, c)
        logp = torch.log_softmax((h2 @ p["pred"]["w"]).reshape(b, beam, V),
                                 dim=-1)
        logp = torch.where(finished[..., None], eos_only, logp)
        scores, idx = (scores[..., None] + logp).reshape(b, beam * V).topk(
            beam, dim=1)
        src, tok = idx // V, idx % V
        take = src[..., None].expand(b, beam, nh)
        h = h2.reshape(b, beam, nh).gather(1, take).reshape(b * beam, nh)
        c = c2.reshape(b, beam, nh).gather(1, take).reshape(b * beam, nh)
        toks = toks.gather(1, src[..., None].expand(b, beam, L))
        toks[:, :, t] = tok
        finished = finished.gather(1, src) | (tok == cfg.eos_id)
    best = scores.argmax(dim=1)
    rows = torch.arange(b, device=dev)
    return toks[rows, best], scores[rows, best]


# ---------------------------------------------------------------------------
# VAE losses
# ---------------------------------------------------------------------------


def lstm_vae_loss(p: Params, cfg: LSTMConfig, x: torch.Tensor, kl_weight,
                  nsamples: int = 1, *, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None):
    """-> (loss, rec, kl), each (B,) (Lit_vae.py loss): the latent noise
    first, then in training the decoder's dropout masks."""
    z, kl = lstm_encode(p["encoder"], cfg, x, nsamples, generator, eps)
    rec = lstm_reconstruct_error(p["decoder"], cfg, x, z, train=train,
                                 generator=generator if train else None
                                 ).mean(1)
    return rec + kl_weight * kl, rec, kl


def lstm_eval_inference_dist(p: Params, cfg: LSTMConfig, x: torch.Tensor,
                             z: torch.Tensor, param=None) -> torch.Tensor:
    """log q(z|x) -> (B, nsamples); ``param`` a precomputed (mu, logvar),
    else the encoder ``p`` is run."""
    nz = z.shape[2]
    mu, logvar = (param if param is not None
                  else lstm_encoder_forward(p, cfg, x))
    mu, logvar = mu[:, None, :], logvar[:, None, :]
    dev = z - mu
    return (-0.5 * torch.sum(dev ** 2 / torch.exp(logvar), dim=-1)
            - 0.5 * (nz * math.log(2 * math.pi) + torch.sum(logvar, -1)))


def lstm_nll_iw(p: Params, cfg: LSTMConfig, x: torch.Tensor,
                nsamples: int = 100, ns: int = 10,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                posterior=None) -> torch.Tensor:
    """IW estimate of -log p(x) per item -> (B,) (Lit_vae.py:610-643), from
    nsamples // ns chunks of ns samples; ``eps`` (chunks, B, ns, nz) the
    noise of every chunk; ``posterior`` a precomputed (mu, logvar)."""
    mu, logvar = (posterior if posterior is not None
                  else lstm_encoder_forward(p["encoder"], cfg, x))
    lls = []
    for k in range(max(1, nsamples // ns)):
        z = reparameterize(mu, logvar, ns, generator,
                           None if eps is None else eps[k])
        lls.append(lstm_log_probability(p["decoder"], cfg, x, z)
                   + log_prior(z)
                   - lstm_eval_inference_dist(None, cfg, x, z,
                                              param=(mu, logvar)))
    lls = torch.cat(lls, dim=1)
    return -(torch.logsumexp(lls, dim=1) - math.log(lls.shape[1]))


def lstm_loss_iw(p: Params, cfg: LSTMConfig, x: torch.Tensor, kl_weight,
                 nsamples: int = 50, ns: int = 10,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None):
    """The IW training objective -> (loss, nll, kl), each (B,)
    (Lit_vae.py:542-608)."""
    mu, logvar = lstm_encoder_forward(p["encoder"], cfg, x)
    kl = gaussian_kl(mu, logvar)
    nll = lstm_nll_iw(p, cfg, x, nsamples, ns, generator, eps,
                      posterior=(mu, logvar))
    return nll + kl_weight * kl, nll, kl


def lstm_training_loss(p: Params, cfg: LSTMConfig, vae: VAEConfig,
                       x: torch.Tensor, kl_weight, *, nsamples: int = 1,
                       train: bool = True,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None):
    """Scalar training loss and its report by the free-bits mode fb in
    {0, 1, 2, 3}, beta = 0 (a plain autoencoder, or the IW objective with
    ``iw_train_nsamples``) (Lit_vae.py:204-272), as
    ``gpt_vae.training_loss``.  ``eps`` is ``reparameterize``'s noise, or
    with the IW objective ``lstm_nll_iw``'s."""
    aux: Dict[str, torch.Tensor] = {}

    def elbo(kw):
        return lstm_vae_loss(p, cfg, x, kw, nsamples, train=train,
                             generator=generator, eps=eps)

    if vae.beta == 0 and vae.iw_train_nsamples > 0:
        loss, rec, kl = lstm_loss_iw(p, cfg, x, kl_weight,
                                     nsamples=vae.iw_train_nsamples,
                                     ns=max(1, vae.iw_train_ns),
                                     generator=generator, eps=eps)
    elif vae.beta == 0:
        loss, rec, kl = elbo(0.0)
    elif vae.fb == 0:
        loss, rec, kl = elbo(kl_weight)
    elif vae.fb == 1:
        _, rec, kl = elbo(kl_weight)
        loss = rec + (kl > vae.target_kl).to(kl.dtype) * kl_weight * kl
    elif vae.fb == 2:
        mu, logvar = lstm_encoder_forward(p["encoder"], cfg, x)
        z = reparameterize(mu, logvar, nsamples, generator, eps)
        kl_dim = gaussian_kl_per_dim(mu, logvar)
        mask = (kl_dim > vae.target_kl / float(cfg.nz)).to(kl_dim.dtype)
        fake_kl = torch.sum(mask * kl_dim, dim=1)
        rec = lstm_reconstruct_error(p["decoder"], cfg, x, z, train=train,
                                     generator=generator if train else None
                                     ).mean(1)
        loss = rec + kl_weight * fake_kl
        kl = kl_dim.sum(1)
        aux["fake_loss_kl"] = fake_kl.mean()
    elif vae.fb == 3:
        _, rec, kl = elbo(kl_weight)
        loss = rec + (kl.mean() > vae.target_kl).to(kl.dtype) \
            * kl_weight * kl
    else:
        raise ValueError(f"unknown fb mode {vae.fb}")
    aux["loss_rc"] = rec.sum()
    aux["loss_kl"] = kl.sum()
    return loss.mean(), aux


@torch.no_grad()
def mh_sample_posterior(p: Params, cfg: LSTMConfig, x: torch.Tensor,
                        nsamples: int = 10, burn_in: int = 5,
                        step_size: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        noise=None) -> torch.Tensor:
    """Metropolis-Hastings samples of the true posterior p(z|x)
    (Lit_vae.py:723): the chain starts at a draw of q(z|x), proposes
    z' ~ N(z, step_size^2 I) and accepts by log p(x|z) + log p(z); the
    first ``burn_in`` states are dropped -> (B, nsamples, nz).  ``noise``
    = (start (B, nz), proposals (S, B, nz), uniforms (S, B)) of standard
    normals and uniforms replaces the draws from ``generator``, S =
    burn_in + nsamples."""
    mu, logvar = lstm_encoder_forward(p["encoder"], cfg, x)
    b, nz = mu.shape
    steps = burn_in + nsamples
    if noise is None:
        dev = generator.device if generator is not None else mu.device
        noise = tuple(f(shape, generator=generator, device=dev).to(mu.device)
                      for f, shape in ((torch.randn, (b, nz)),
                                       (torch.randn, (steps, b, nz)),
                                       (torch.rand, (steps, b))))
    start, props, unif = noise
    z = mu + torch.exp(0.5 * logvar) * start

    def log_joint(z):
        return (lstm_log_probability(p["decoder"], cfg, x, z[:, None, :])
                [:, 0] + log_prior(z))

    lj, zs = log_joint(z), []
    for s in range(steps):
        prop = z + step_size * props[s]
        lj_prop = log_joint(prop)
        accept = torch.log(unif[s]) < lj_prop - lj
        z = torch.where(accept[:, None], prop, z)
        lj = torch.where(accept, lj_prop, lj)
        zs.append(z)
    return torch.stack(zs[burn_in:], dim=1)


# ---------------------------------------------------------------------------
# LSTM language model and latent-probe discriminators
# ---------------------------------------------------------------------------


def init_lstm_lm(cfg: LSTMConfig, generator: torch.Generator) -> Params:
    leaf = _init_leaf(generator)
    return {"embed": leaf((cfg.vocab_size, cfg.ni), 0.1),
            "lstm": _lstm(leaf, cfg.ni, cfg.dec_nh),
            "pred": {"w": leaf((cfg.dec_nh, cfg.vocab_size), 0.01)}}


def lstm_lm_nll(p: Params, cfg: LSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-item summed NLL of the unconditional LSTM language model
    (lm_lstm.py:14)."""
    src, tgt = x[:, :-1], x[:, 1:]
    emb = p["embed"][src.long()]
    h0 = emb.new_zeros((x.shape[0], p["lstm"]["wh"].shape[0]))
    out, _ = lstm_run(p["lstm"], emb, h0, h0)
    return cross_entropy_loss(out @ p["pred"]["w"], tgt,
                              reduce="none").sum(-1)


def init_linear_discriminator(generator: torch.Generator, nz: int,
                              ncls: int) -> Params:
    dev = generator.device
    return {"w": 0.01 * torch.randn((nz, ncls), generator=generator,
                                    device=dev),
            "b": torch.zeros(ncls, device=dev)}


def linear_discriminator_logits(p: Params, mean: torch.Tensor) -> torch.Tensor:
    """(discriminator_linear.py:7)"""
    return mean @ p["w"] + p["b"]


def init_mlp_discriminator(generator: torch.Generator, nz: int, ncls: int,
                           hidden: int = 128) -> Params:
    dev = generator.device
    return {"w1": 0.01 * torch.randn((nz, hidden), generator=generator,
                                     device=dev),
            "b1": torch.zeros(hidden, device=dev),
            "w2": 0.01 * torch.randn((hidden, ncls), generator=generator,
                                     device=dev),
            "b2": torch.zeros(ncls, device=dev)}


def mlp_discriminator_logits(p: Params, mean: torch.Tensor) -> torch.Tensor:
    """(discriminator_linear.py:35)"""
    return torch.relu(mean @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
