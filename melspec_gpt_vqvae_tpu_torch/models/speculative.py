"""Speculative decoding: a small draft GPT proposes ``gamma`` tokens per
round, the target verifies them in one chunked cached forward, and a
corrected accept/reject step keeps the output distributed exactly as the
target's (speculative sampling, Leviathan et al. 2023 / Chen et al. 2023).

Counterpart of melspec_gpt_vqvae_tpu/models/speculative.py, with the same
three equivalences (tests/test_torch_port_speculative.py):

  * the chunk forward equals the same tokens fed one by one through
    ``gpt_decode_step`` (logits and cache);
  * draft == target gives exactly ``gpt_generate``'s tokens for the same
    generator: both draw the per-position sampling uniforms up front as one
    (steps, B, V) tensor, and position i samples from row i (the JAX
    package's per-position keys);
  * greedy mode (``sample=False``) gives exactly greedy ``gpt_generate``'s
    tokens for any draft.

The batch advances by the minimum acceptance count over its lanes each
round; lanes that accepted more keep their accepted token at the cut.
The round loop runs on the host, which reads that count once a round.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import GPTConfig

from ..ops.decode_attention import decode_attend_int8
from ..ops.sampling import categorical, filtered_log_probs, sample_logits
from .gpt import (Params, _layer, _layer_norm, _mm, _write_kv,
                  gpt_decode_step, gpt_prefill, init_kv_cache,
                  quantize_block_weights)


def gpt_decode_chunk(params: Params, cfg: GPTConfig, cache: Dict,
                     tokens: torch.Tensor, wq: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """Cached forward over a chunk of c tokens at positions ``cache['len']
    .. len + c - 1``, causal within the chunk and over the cached prefix
    (speculative.py:48-174).  tokens (B, c) -> (logits (B, c, out), cache
    with len += c).  Over a model-dtype cache the attention is plain torch,
    as it is XLA einsums in the JAX package; over a quantised cache it is
    the single step's own attention (kernel E on the card) at each of the
    c positions, which keeps greedy speculative decoding exact there too.
    The attention math is the JAX chunk's either way."""
    pos = cache["len"]
    b, c = tokens.shape
    hd, nh = cfg.head_dim, cfg.n_head
    # positions past the block clamp, as the JAX chunk's do
    pidx = torch.clamp(pos + torch.arange(c, device=tokens.device), 0,
                       params["pos_emb"].shape[0] - 1)
    x = params["tok_emb"][tokens.long()] + params["pos_emb"][pidx][None]
    quantised = cfg.cache_dtype in ("int8", "int4")
    if not quantised:
        valid = (torch.arange(cache["k"].shape[3], device=x.device)[None, :]
                 <= (pos + torch.arange(c, device=x.device))[:, None])
        scale = 1.0 / hd ** 0.5
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        pw = None if wq is None else _layer(wq, l)
        h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
        q, k, v = (a.reshape(b, c, nh, hd).transpose(1, 2)        # (B,H,c,hd)
                   for a in _mm(h, p, pw, "attn_qkv").chunk(3, -1))
        _write_kv(cache, cfg, l, pos, k, v)
        if quantised:
            # kernel E once per chunk position: position j attends t <=
            # pos + j of the same cache the single step reads, so a
            # verified token's attention is bit for bit the step's
            o = torch.stack([decode_attend_int8(
                q[:, :, j], cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], l, pos + j) for j in range(c)], dim=2)
        else:
            k_l, v_l = cache["k"][l], cache["v"][l]
            scores = (q.float() @ k_l.float().transpose(-1, -2)) * scale
            probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
            o = probs.to(v_l.dtype).float() @ v_l.float()
        o = o.to(x.dtype).transpose(1, 2).reshape(b, c, cfg.n_embd)
        x = x + _mm(o, p, pw, "attn_proj")
        h2 = _layer_norm(x, p["ln2_s"], p["ln2_b"])
        x = x + _mm(F.gelu(_mm(h2, p, pw, "mlp_up")), p, pw, "mlp_down")
    cache["len"] = pos + c
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


def gpt_speculative_generate(
        params: Params, cfg: GPTConfig, draft_params: Params,
        draft_cfg: GPTConfig, generator: Optional[torch.Generator],
        cond_emb: torch.Tensor, draft_cond_emb: torch.Tensor,
        given: Optional[torch.Tensor] = None, *, steps: int, gamma: int = 4,
        temperature: float = 1.0, top_k: Optional[int] = None,
        top_p: Optional[float] = None, sample: bool = True
        ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """KV-cached speculative generation (speculative.py:177-344).  Returns
    ``(tokens (B, T0 + steps) int64, stats)``, the tokens distributed
    exactly as ``gpt_generate(params, cfg, ...)``'s, stats = {"rounds",
    "drafted", "accepted"} (acceptance rate = accepted / drafted).

    Randomness: the per-position uniforms (steps, B, V) are drawn first,
    as ``gpt_generate`` draws them; then, from the same generator, one row
    of acceptance uniforms and one row of residual-draw uniforms per round
    (a round emits at least one token, so ``steps`` rows suffice).
    """
    b, p_len = cond_emb.shape[0], cond_emb.shape[1]
    t0 = 0 if given is None else given.shape[1]
    gamma = max(1, min(gamma, steps)) if steps > 1 else 1
    dev = cond_emb.device
    max_len = p_len + t0 + steps + gamma + 1
    t_cache = init_kv_cache(cfg, b, max_len=max_len, device=dev)
    d_cache = init_kv_cache(draft_cfg, b, max_len=max_len, device=dev)
    t_logits, t_cache = gpt_prefill(params, cfg, t_cache, given, cond_emb)
    _, d_cache = gpt_prefill(draft_params, draft_cfg, d_cache, given,
                             draft_cond_emb)
    wq = (quantize_block_weights(params["blocks"])
          if cfg.decode_weight_dtype == "int8" else None)
    dwq = (quantize_block_weights(draft_params["blocks"])
           if draft_cfg.decode_weight_dtype == "int8" else None)
    skw = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    u_pos = u_acc = u_res = None
    if sample:
        vocab = t_logits.shape[-1]
        u_pos = torch.rand((steps, b, vocab), generator=generator,
                           device=dev)
        u_acc = torch.rand((steps, b, gamma), generator=generator,
                           device=dev)
        u_res = torch.rand((steps, b, vocab), generator=generator,
                           device=dev)

    def draw(logits, i):
        """Sample output position i from logits with its own uniforms
        (positions past the end clamp: their tokens are dropped)."""
        u = None if u_pos is None else u_pos[min(i, steps - 1)]
        return sample_logits(None, logits, sample=sample, u=u, **skw)

    y_prev = draw(t_logits, 0)
    out = torch.zeros((b, steps + gamma + 1), dtype=torch.long, device=dev)
    out[:, 0] = y_prev
    produced, rounds, accepted = 1, 0, 0
    while produced < steps:
        # the draft proposes gamma tokens (y_prev first, then its own)
        tok, xs, q_lps = y_prev, [], []
        for i in range(gamma):
            logits, d_cache = gpt_decode_step(draft_params, draft_cfg,
                                              d_cache, tok, dwq)
            tok = draw(logits, produced + i)
            xs.append(tok)
            q_lps.append(filtered_log_probs(logits.float(), **skw))
        # catch-up: when every proposal is accepted the rewound draft cache
        # must also hold x_gamma's keys and values
        _, d_cache = gpt_decode_step(draft_params, draft_cfg, d_cache, tok,
                                     dwq)
        xs = torch.stack(xs, dim=1)                      # (B, gamma)
        q_lps = torch.stack(q_lps, dim=1)                # (B, gamma, V)

        # the target verifies [y_prev, x_1 .. x_gamma] in one chunk
        t_len0 = t_cache["len"]
        logits_c, t_cache = gpt_decode_chunk(
            params, cfg, t_cache, torch.cat([y_prev[:, None], xs], dim=1), wq)
        p_lps = filtered_log_probs(logits_c.float(), **skw)  # (B, g+1, V)

        # accept / reject
        p_at_x = p_lps[:, :gamma].gather(-1, xs[..., None])[..., 0]
        q_at_x = q_lps.gather(-1, xs[..., None])[..., 0]
        if sample:
            accepts = torch.log(u_acc[rounds]) \
                < torch.clamp_max(p_at_x - q_at_x, 0.0)
        else:
            accepts = xs == torch.argmax(p_lps[:, :gamma], dim=-1)
        a_lane = torch.cumprod(accepts.long(), dim=1).sum(dim=1)   # (B,)
        n = int(a_lane.min())                            # round advance

        # next token at the cut: lanes that accepted x_{n+1} keep it,
        # lanes that rejected there draw from the residual max(p - q, 0),
        # and when every proposal was accepted the bonus token samples the
        # target at its own output position (speculative.py:277-313)
        x_next = xs[:, min(n, gamma - 1)]
        if not sample:
            y = torch.argmax(p_lps[:, n], dim=-1)
        elif n == gamma:
            y = draw(logits_c[:, gamma], produced + gamma)
        else:
            p_cut, q_cut = p_lps[:, n], q_lps[:, n]
            resid = torch.clamp_min(torch.exp(p_cut) - torch.exp(q_cut), 0.0)
            rsum = resid.sum(dim=-1, keepdim=True)
            resid_lp = torch.where(
                rsum > 0, torch.log(resid / rsum.clamp_min(1e-38) + 1e-38),
                p_cut)
            y = categorical(torch.where((a_lane == n)[:, None], resid_lp,
                                        p_cut), u_res[rounds])
        y = torch.where(a_lane > n, x_next, y)

        out[:, produced:produced + n] = xs[:, :n]
        out[:, produced + n] = y
        # rewind both caches to the accepted prefix (stale keys and values
        # past len are never attended and are overwritten later)
        t_cache["len"] = d_cache["len"] = t_len0 + 1 + n
        produced += n + 1
        y_prev = y
        rounds += 1
        accepted += n

    toks = out[:, :steps]
    if t0 > 0:
        toks = torch.cat([given.long(), toks], dim=1)
    return toks, {"rounds": rounds, "drafted": rounds * gamma,
                  "accepted": accepted}
