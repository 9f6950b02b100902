"""Class-conditional GPT, inference: eval forward and KV-cached decode.

Counterpart of melspec_gpt_vqvae_tpu/models/gpt.py (reference
transformer/minGPT.py:30-212, 331-360).  Parameters are a dict of tensors
in the JAX package's layout -- blocks stacked on a leading layer axis,
``(L, in, out)`` matrices, a fused ``attn_qkv`` -- so bridge.py carries a
JAX param tree across leaf for leaf; the layer loop is a Python loop where
the JAX package scans.

Decode keeps a preallocated KV cache of layout (L, B, H, T, hd) in the
model dtype (float32 or bfloat16) and updates it in place: the JAX
functions return a new cache, these write the new slots into the given one
and return it.  ``cache["len"]`` is a Python int, so the decode loop makes
no host-device round trip.  Prefill attention is kernel A on the card
(ops/attention.py); the decode step's attention over the cache is plain
torch, as the JAX step's is XLA einsums (gpt.py:545-551).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from melspec_gpt_vqvae_tpu.configs import GPTConfig

from ..ops.attention import attend
from ..ops.sampling import sample_logits

Params = Dict[str, object]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator,
                    device=None) -> Params:
    """Random parameters as the reference initialises them
    (minGPT.py:159-166): weights ~ N(0, 0.02), biases zero, LayerNorm
    (1, 0), a zero position embedding.  Drawn in float32 from ``generator``
    (on its own device) and then moved to ``device`` in ``cfg.dtype``, so a
    seed gives the same weights on every device."""
    d, l4, L = cfg.n_embd, 4 * cfg.n_embd, cfg.n_layer
    gdev = generator.device

    def norm(*shape):
        return 0.02 * torch.randn(shape, generator=generator, device=gdev)

    def zeros(*shape):
        return torch.zeros(shape, device=gdev)

    def ones(*shape):
        return torch.ones(shape, device=gdev)

    params = {
        "tok_emb": norm(cfg.vocab_size, d),
        "pos_emb": zeros(cfg.block_size, d),
        "blocks": {
            "ln1_s": ones(L, d), "ln1_b": zeros(L, d),
            "attn_qkv": {"w": norm(L, d, 3 * d), "b": zeros(L, 3 * d)},
            "attn_proj": {"w": norm(L, d, d), "b": zeros(L, d)},
            "ln2_s": ones(L, d), "ln2_b": zeros(L, d),
            "mlp_up": {"w": norm(L, d, l4), "b": zeros(L, l4)},
            "mlp_down": {"w": norm(L, l4, d), "b": zeros(L, d)},
        },
        "ln_f_s": ones(d), "ln_f_b": zeros(d),
        "head": {"w": norm(d, cfg.output_size)},
    }
    if cfg.class_size is not None:
        params["class_emb"] = norm(cfg.class_size, d)
    return tree_to(params, device=device, dtype=DTYPES[cfg.dtype])


def tree_to(tree, **kw):
    """Apply ``Tensor.to(**kw)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    return tree.to(**kw)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _layer(blocks, l: int) -> Params:
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l]) for k, v in blocks.items()}


def _mlp(h, p):
    m = F.gelu(h @ p["mlp_up"]["w"] + p["mlp_up"]["b"])   # exact erf
    return m @ p["mlp_down"]["w"] + p["mlp_down"]["b"]


def class_embed(params: Params, class_idx: torch.Tensor) -> torch.Tensor:
    """(B,) or (B, 1) class index -> (B, 1, D) conditioning embedding
    (reference GPTClass: minGPT.py:203-212)."""
    if class_idx.ndim == 2:
        class_idx = class_idx[:, 0]
    return params["class_emb"][class_idx.long()][:, None, :]


def _embed(params, cfg, idx, cond_emb):
    parts = []
    if cond_emb is not None:
        parts.append(cond_emb.to(params["tok_emb"].dtype))
    if idx is not None and idx.shape[1] > 0:
        parts.append(params["tok_emb"][idx.long()])
    x = torch.cat(parts, dim=1)
    t = x.shape[1]
    if t > cfg.block_size:
        raise ValueError(f"sequence {t} exceeds block_size {cfg.block_size}")
    return x + params["pos_emb"][:t]


def _attn_block(x, p, cfg):
    """Pre-LN attention half of a block; returns (x', k, v) with k, v of
    layout (B, H, T, hd)."""
    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    qkv = h @ p["attn_qkv"]["w"] + p["attn_qkv"]["b"]
    q, k, v = (_split_heads(a, cfg.n_head) for a in qkv.chunk(3, dim=-1))
    res = attend(q, k, v, cfg.n_unmasked)
    y = _merge_heads(res) @ p["attn_proj"]["w"] + p["attn_proj"]["b"]
    return x + y, k, v


def gpt_apply(params: Params, cfg: GPTConfig, idx: Optional[torch.Tensor],
              cond_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval forward (no dropout).  idx (B, T) tokens or None; cond_emb
    (B, P, D) prepended embeddings.  Returns logits (B, P + T, out)."""
    if cfg.mixed_precision:
        raise NotImplementedError("mixed-precision training forward is not "
                                  "ported (ROADMAP A7)")
    x = _embed(params, cfg, idx, cond_emb)
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        x, _, _ = _attn_block(x, p, cfg)
        x = x + _mlp(_layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"]


# ---------------------------------------------------------------------------
# KV-cached autoregressive decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: Optional[int] = None,
                  device=None) -> Dict:
    """Zeroed (L, B, H, T, hd) key and value caches in the model dtype."""
    if cfg.cache_dtype != "auto":
        raise NotImplementedError(
            f"cache_dtype={cfg.cache_dtype!r}: the int8/int4 KV cache is not "
            "ported yet (ROADMAP A1, with kernel E)")
    shape = (cfg.n_layer, batch, cfg.n_head, max_len or cfg.block_size,
             cfg.head_dim)
    dtype = DTYPES[cfg.dtype]
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def gpt_prefill(params: Params, cfg: GPTConfig, cache: Dict,
                idx: Optional[torch.Tensor],
                cond_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (cond + given tokens) once, writing its keys and
    values into ``cache``.  Returns (logits at the last position (B, out),
    cache)."""
    x = _embed(params, cfg, idx, cond_emb)
    t0 = x.shape[1]
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        x, k, v = _attn_block(x, p, cfg)
        cache["k"][l, :, :, :t0] = k
        cache["v"][l, :, :, :t0] = v
        x = x + _mlp(_layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
    cache["len"] = t0
    x = _layer_norm(x[:, -1], params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


def gpt_decode_step(params: Params, cfg: GPTConfig, cache: Dict,
                    token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One cached decode step.  token (B,) -> (logits (B, out), cache).
    Attention covers the whole cache length with positions after the
    current one masked, as in the JAX step."""
    pos = cache["len"]
    x = params["tok_emb"][token.long()] + params["pos_emb"][pos]   # (B, D)
    b = x.shape[0]
    max_len = cache["k"].shape[3]
    valid = torch.arange(max_len, device=x.device) <= pos
    scale = 1.0 / cfg.head_dim ** 0.5
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
        q, k, v = (h @ p["attn_qkv"]["w"] + p["attn_qkv"]["b"]).chunk(3, -1)
        cache["k"][l, :, :, pos] = k.reshape(b, cfg.n_head, cfg.head_dim)
        cache["v"][l, :, :, pos] = v.reshape(b, cfg.n_head, cfg.head_dim)
        k_l, v_l = cache["k"][l], cache["v"][l]
        qh = q.reshape(b, cfg.n_head, 1, cfg.head_dim).float()
        scores = (qh @ k_l.float().transpose(-1, -2))[:, :, 0] * scale
        probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
        o = (probs.to(v_l.dtype).float()[:, :, None] @ v_l.float())
        y = o.reshape(b, cfg.n_embd).to(x.dtype) @ p["attn_proj"]["w"] \
            + p["attn_proj"]["b"]
        x = x + y
        x = x + _mlp(_layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
    cache["len"] = pos + 1
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


def _grow_cache(cache: Dict, new_len: int) -> Dict:
    """Zero-pad the cache's position axis to ``new_len`` (segmented
    decode)."""
    cur = cache["k"].shape[3]
    if new_len <= cur:
        return cache
    pad = (0, 0, 0, new_len - cur)
    return {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad),
            "len": cache["len"]}


def gpt_generate(params: Params, cfg: GPTConfig,
                 generator: Optional[torch.Generator],
                 cond_emb: torch.Tensor,
                 given: Optional[torch.Tensor] = None, *, steps: int,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, sample: bool = True,
                 segments: int = 1) -> torch.Tensor:
    """KV-cached autoregressive generation: one prefill, then ``steps``
    cached single-token steps (the reference re-runs the full forward per
    token, minGPT.py:331-358).

    ``segments > 1`` grows the cache in stages so attention reads scale
    with the valid prefix; the capacities follow the JAX formula exactly
    (gpt.py:624-660), so one segment and several give the same tokens.
    Returns (B, T0 + steps) int64 tokens.
    """
    if cfg.decode_weight_dtype != "auto":
        raise NotImplementedError("int8 streamed decode weights are not "
                                  "ported yet (ROADMAP A1)")
    b, p = cond_emb.shape[0], cond_emb.shape[1]
    t0 = 0 if given is None else given.shape[1]
    total_len = p + t0 + steps
    segments = max(1, min(segments, steps))
    caps = sorted({min(total_len, max(
        p + t0 + 1, -(-total_len * (i + 1) // segments)))
        for i in range(segments)})

    cache = init_kv_cache(cfg, b, max_len=caps[0], device=cond_emb.device)
    logits, cache = gpt_prefill(params, cfg, cache, given, cond_emb)
    toks = []
    for i, cap in enumerate(caps):
        cache = _grow_cache(cache, cap)
        seg = min(steps - len(toks), cap - (p + t0) - len(toks))
        if i == len(caps) - 1:
            seg = steps - len(toks)
        for _ in range(max(seg, 0)):
            tok = sample_logits(generator, logits, temperature=temperature,
                                top_k=top_k, top_p=top_p, sample=sample)
            logits, cache = gpt_decode_step(params, cfg, cache, tok)
            toks.append(tok)
    out = torch.stack(toks, dim=1)
    if t0 > 0:
        out = torch.cat([given.long(), out], dim=1)
    return out
