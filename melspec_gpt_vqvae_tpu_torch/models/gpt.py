"""Class-conditional GPT: training and eval forward, KV-cached decode.

Counterpart of melspec_gpt_vqvae_tpu/models/gpt.py (reference
transformer/minGPT.py:30-212, 331-360).  Parameters are a dict of tensors
in the JAX package's layout -- blocks stacked on a leading layer axis,
``(L, in, out)`` matrices, a fused ``attn_qkv`` -- so bridge.py carries a
JAX param tree across leaf for leaf; the layer loop is a Python loop where
the JAX package scans.  For training the leaves are tensors with
``requires_grad``, and ``gpt_apply(train=True, generator=)`` draws the
dropout masks from one ``torch.Generator``: the embedding's first, then
per layer the attention's, the projection's and the MLP's (gpt.py:110-179,
235-294).  With ``use_flash_train`` the attention of every forward, train
and eval, is kernel F (ops/flash_attention.py); otherwise a training
forward runs the plain differentiable ``attend_xla`` and an eval forward
kernel A (ops/attention.py), as the JAX package's XLA and Pallas paths.

Decode keeps a preallocated KV cache of layout (L, B, H, T, hd) and
updates it in place: the JAX functions return a new cache, these write the
new slots into the given one and return it.  ``cache["len"]`` is a Python
int, so the decode loop makes no host-device round trip.  The cache holds
the model dtype (``cache_dtype="auto"``), or absmax-quantised int8 values
or int4 nibble pairs with bfloat16 scales per (layer, batch, head,
position) (``"int8"``, ``"int4"``), as in the JAX package.  Prefill
attention is kernel A on the card (ops/attention.py).  The decode step's
attention is kernel E over a quantised cache (ops/decode_attention.py) and
plain torch over a model-dtype cache, as the JAX step's is XLA einsums
(gpt.py:545-551).  ``decode_weight_dtype="int8"`` streams per-channel int8
block weights through an int8 x int8 -> int32 product (``_int8_mm``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import GPTConfig

from ..ops.attention import attend, attend_xla, bernoulli_u8
from ..ops.decode_attention import decode_attend_int8
from ..ops.decode_attention import unpack4 as _unpack4  # noqa: F401
from ..ops.flash_attention import flash_attention, make_dropout_mask
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


def count_params(params: Params) -> int:
    """Number of parameter values in a nested dict of tensors."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def _layers(blocks) -> list:
    """The stacked block parameters as one dict per layer.  ``unbind``
    gives every layer a view whose backward stacks the layer gradients
    into one (L, ...) tensor, where indexing layer by layer would add L
    full-size gradient tensors."""
    per = {k: ({kk: vv.unbind(0) for kk, vv in v.items()}
               if isinstance(v, dict) else v.unbind(0))
           for k, v in blocks.items()}
    return [{k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[l]) for k, v in per.items()}
            for l in range(len(blocks["ln1_s"]))]


def _qkv(x, p, cfg):
    """Pre-LN fused projection -> q, k, v of layout (B, H, T, hd)."""
    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    qkv = h @ p["attn_qkv"]["w"] + p["attn_qkv"]["b"]
    return (_split_heads(a, cfg.n_head) for a in qkv.chunk(3, dim=-1))


def _attn_block(x, p, cfg):
    """Pre-LN attention half of an inference block; returns (x', k, v)
    with k, v of layout (B, H, T, hd)."""
    q, k, v = _qkv(x, p, cfg)
    res = attend(q, k, v, cfg.n_unmasked)
    y = _merge_heads(res) @ p["attn_proj"]["w"] + p["attn_proj"]["b"]
    return x + y, k, v


def _dropout(x, rate: float, generator: Optional[torch.Generator],
             train: bool):
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = bernoulli_u8(generator, 1.0 - rate, x.shape)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _block(x, p, cfg: GPTConfig, train: bool,
           generator: Optional[torch.Generator]):
    """One pre-LN block of ``gpt_apply`` (gpt.py:132-179).  The attention
    branch is taken as the JAX block takes it: kernel F whenever
    ``use_flash_train`` (with a keep-mask only in training), else the
    plain ``attend_xla`` in training and kernel A in eval."""
    q, k, v = _qkv(x, p, cfg)
    if cfg.use_flash_train:
        rate = cfg.attn_pdrop if train else 0.0
        b, h, t = q.shape[:3]
        mask = make_dropout_mask(generator if train else None,
                                 (b, h, t, t), rate)
        res = flash_attention(q.float(), k.float(), v.float(), mask,
                              cfg.n_unmasked, 1.0 - rate).to(x.dtype)
    elif train:
        res = attend_xla(q, k, v, cfg.n_unmasked,
                         dropout_rate=cfg.attn_pdrop, generator=generator)
    else:
        res = attend(q, k, v, cfg.n_unmasked)
    y = _merge_heads(res) @ p["attn_proj"]["w"] + p["attn_proj"]["b"]
    x = x + _dropout(y, cfg.resid_pdrop, generator, train)
    m = _mlp(_layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
    return x + _dropout(m, cfg.resid_pdrop, generator, train)


def gpt_apply(params: Params, cfg: GPTConfig, idx: Optional[torch.Tensor],
              cond_emb: Optional[torch.Tensor] = None, *,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full forward.  idx (B, T) tokens or None; cond_emb (B, P, D)
    prepended embeddings.  ``train`` with a ``generator`` applies the three
    dropout rates (a training forward without a generator has no dropout,
    as the JAX one without an rng).  Returns logits (B, P + T, out); the
    JAX function's second result, the attention maps, is not ported."""
    if cfg.mixed_precision:
        raise NotImplementedError("mixed-precision training forward is not "
                                  "ported (ROADMAP A7)")
    x = _embed(params, cfg, idx, cond_emb)
    train = bool(train) and generator is not None
    x = _dropout(x, cfg.embd_pdrop, generator, train)
    for p in _layers(params["blocks"]):
        x = _block(x, p, cfg, train, generator)
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       reduce: str = "mean") -> torch.Tensor:
    """F.cross_entropy over the last axis in float32 (gpt.py:297-307)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if reduce == "mean":
        return nll.mean()
    if reduce == "sum":
        return nll.sum()
    return nll


# ---------------------------------------------------------------------------
# KV-cached autoregressive decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: Optional[int] = None,
                  device=None) -> Dict:
    """Zeroed (L, B, H, T, hd) key and value caches: in the model dtype, or
    int8 values (uint8 (..., hd/2) for int4) with bfloat16 (L, B, H, T)
    scales (gpt.py:302-325)."""
    shape = (cfg.n_layer, batch, cfg.n_head, max_len or cfg.block_size,
             cfg.head_dim)
    if cfg.cache_dtype in ("int8", "int4"):
        int4 = cfg.cache_dtype == "int4"
        vshape = shape[:-1] + (cfg.head_dim // 2,) if int4 else shape
        vdtype = torch.uint8 if int4 else torch.int8
        return {"k": torch.zeros(vshape, dtype=vdtype, device=device),
                "v": torch.zeros(vshape, dtype=vdtype, device=device),
                "k_scale": torch.zeros(shape[:4], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:4], dtype=torch.bfloat16,
                                       device=device),
                "len": 0}
    if cfg.cache_dtype != "auto":
        raise ValueError(f"cache_dtype={cfg.cache_dtype!r}: expected 'auto', "
                         "'int8' or 'int4'")
    dtype = DTYPES[cfg.dtype]
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division also on the card, where PyTorch turns
    division by a Python number into a multiply by its reciprocal (which
    may differ by one bit, and the quantisers must round as JAX does)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _quantize_kv(x: torch.Tensor):
    """(..., hd) -> (int8 values, float32 absmax scale over hd)
    (gpt.py:328-334).  Rounds half to even, as jnp.round does."""
    x = x.float()
    scale = torch.clamp_min(_div(x.abs().amax(-1), 127.0), 1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _quantize_kv4(x: torch.Tensor):
    """(..., hd) -> (uint8 nibble-packed int4 values (..., hd/2), float32
    absmax scale over hd) (gpt.py:337-347): values clip to [-7, 7], even
    head dims go to the low nibble, odd ones to the high nibble."""
    x = x.float()
    scale = torch.clamp_min(_div(x.abs().amax(-1), 7.0), 1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -7, 7).to(torch.int32)
    packed = (q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)
    return packed.to(torch.uint8), scale


def _write_kv(cache: Dict, cfg: GPTConfig, l: int, pos: int,
              k: torch.Tensor, v: torch.Tensor) -> None:
    """Write (B, H, c, hd) keys and values into layer ``l`` of the cache
    at positions pos .. pos + c - 1, quantising them for an int8 / int4
    cache: the values from the float32 scale, the scale stored in
    bfloat16 (gpt.py:401-414, 501-516)."""
    sl = slice(pos, pos + k.shape[2])
    if cfg.cache_dtype in ("int8", "int4"):
        quant = _quantize_kv4 if cfg.cache_dtype == "int4" else _quantize_kv
        for name, x in (("k", k), ("v", v)):
            q, scale = quant(x)
            cache[name][l, :, :, sl] = q
            cache[name + "_scale"][l, :, :, sl] = scale.to(torch.bfloat16)
    else:
        cache["k"][l, :, :, sl] = k
        cache["v"][l, :, :, sl] = v


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
        _write_kv(cache, cfg, l, 0, k, v)
        x = x + _mlp(_layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
    cache["len"] = t0
    x = _layer_norm(x[:, -1], params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


def quantize_block_weights(blocks: Params) -> Dict:
    """Per-output-channel absmax int8 quantisation of the four block
    matrices (gpt.py:426-438): ``{name: {"q": (L, in, out) int8, "s":
    (L, out) float32}}``.  Each layer's ``q`` is stored column-major (its
    ``in`` axis contiguous), the layout the card's int8 product takes."""
    def q(w):
        w = w.float()
        scale = torch.clamp_min(_div(w.abs().amax(1), 127.0), 1e-8)
        wq = torch.clamp(torch.round(w / scale[:, None, :]), -127, 127)
        wq = wq.to(torch.int8).transpose(1, 2).contiguous().transpose(1, 2)
        return {"q": wq, "s": scale}
    return {name: q(blocks[name]["w"])
            for name in ("attn_qkv", "attn_proj", "mlp_up", "mlp_down")}


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> exact int32 sums, by ``torch._int_mm``
    (cuBLASLt on the card, oneDNN on the CPU).  cuBLASLt needs more than 16
    rows: there the rows are zero-padded to a multiple of 8, at least 32,
    and dropped again (zero rows are exact)."""
    m = a.shape[0]
    if a.is_cuda:
        a = F.pad(a, (0, 0, 0, max(32, -(-m // 8) * 8) - m))
    return torch._int_mm(a, b)[:m]


def _int8_mm(x: torch.Tensor, wq: torch.Tensor,
             ws: torch.Tensor) -> torch.Tensor:
    """x (M, in) @ int8 weights (in, out) with per-row absmax activation
    quantisation and exact int32 accumulation, rescaled in float32 as
    ``acc * xs * ws`` from left to right (gpt.py:441-450)."""
    xf = x.float()
    xs = torch.clamp_min(_div(xf.abs().amax(-1), 127.0), 1e-8)
    xq = torch.clamp(torch.round(xf / xs[:, None]), -127, 127)
    acc = _int_matmul(xq.to(torch.int8), wq)
    return acc.float() * xs[:, None] * ws[None, :]


def _mm(a: torch.Tensor, p: Params, pw: Optional[Dict],
        name: str) -> torch.Tensor:
    """One block matrix product with bias: in the model dtype, or through
    the int8 weights ``pw`` of this layer (gpt.py:484-494)."""
    if pw is None:
        return a @ p[name]["w"] + p[name]["b"]
    out = _int8_mm(a.reshape(-1, a.shape[-1]), pw[name]["q"], pw[name]["s"])
    return out.reshape(*a.shape[:-1], -1).to(a.dtype) + p[name]["b"]


def gpt_decode_step(params: Params, cfg: GPTConfig, cache: Dict,
                    token: torch.Tensor, wq: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """One cached decode step.  token (B,) -> (logits (B, out), cache).
    Attention covers the positions up to the current one, as the JAX step
    masks the rest; ``wq`` are the int8 block weights of
    ``quantize_block_weights`` (None: the model-dtype weights)."""
    pos = cache["len"]
    # the position embedding index clamps as the JAX step's
    # dynamic_index_in_dim does (speculative drafts run past the block)
    x = params["tok_emb"][token.long()] \
        + params["pos_emb"][min(pos, cfg.block_size - 1)]       # (B, D)
    b = x.shape[0]
    max_len = cache["k"].shape[3]
    quantised = cfg.cache_dtype in ("int8", "int4")
    if not quantised:
        valid = torch.arange(max_len, device=x.device) <= pos
        scale = 1.0 / cfg.head_dim ** 0.5
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        pw = None if wq is None else _layer(wq, l)
        h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
        q, k, v = (a.reshape(b, cfg.n_head, 1, cfg.head_dim)
                   for a in _mm(h, p, pw, "attn_qkv").chunk(3, -1))
        _write_kv(cache, cfg, l, pos, k, v)
        if quantised:
            o = decode_attend_int8(q[:, :, 0], cache["k"], cache["v"],
                                   cache["k_scale"], cache["v_scale"], l, pos)
        else:
            k_l, v_l = cache["k"][l], cache["v"][l]
            scores = (q.float() @ k_l.float().transpose(-1, -2))[:, :, 0] \
                * scale
            probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
            o = (probs.to(v_l.dtype).float()[:, :, None] @ v_l.float())
        x = x + _mm(o.reshape(b, cfg.n_embd).to(x.dtype), p, pw, "attn_proj")
        h2 = _layer_norm(x, p["ln2_s"], p["ln2_b"])
        x = x + _mm(F.gelu(_mm(h2, p, pw, "mlp_up")), p, pw, "mlp_down")
    cache["len"] = pos + 1
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


def _grow_cache(cache: Dict, new_len: int) -> Dict:
    """Zero-pad the cache's position axis to ``new_len`` (segmented
    decode), scales included (gpt.py:577-590)."""
    cur = cache["k"].shape[3]
    if new_len <= cur:
        return cache
    out = dict(cache)
    for name in ("k", "v"):
        out[name] = F.pad(cache[name], (0, 0, 0, new_len - cur))
    for name in ("k_scale", "v_scale"):
        if name in cache:
            out[name] = F.pad(cache[name], (0, new_len - cur))
    return out


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
    With ``decode_weight_dtype="int8"`` the block weights are quantised
    once per call (gpt.py:633-636).  The sampling uniforms of all
    positions are drawn from ``generator`` up front, one (steps, B, V)
    tensor, so that speculative decoding can reuse them position for
    position.  Returns (B, T0 + steps) int64 tokens.
    """
    b, p = cond_emb.shape[0], cond_emb.shape[1]
    t0 = 0 if given is None else given.shape[1]
    total_len = p + t0 + steps
    segments = max(1, min(segments, steps))
    caps = sorted({min(total_len, max(
        p + t0 + 1, -(-total_len * (i + 1) // segments)))
        for i in range(segments)})

    cache = init_kv_cache(cfg, b, max_len=caps[0], device=cond_emb.device)
    logits, cache = gpt_prefill(params, cfg, cache, given, cond_emb)
    wq = (quantize_block_weights(params["blocks"])
          if cfg.decode_weight_dtype == "int8" else None)
    u = (torch.rand((steps,) + logits.shape, generator=generator,
                    device=logits.device) if sample else None)
    toks = []
    for i, cap in enumerate(caps):
        cache = _grow_cache(cache, cap)
        seg = min(steps - len(toks), cap - (p + t0) - len(toks))
        if i == len(caps) - 1:
            seg = steps - len(toks)
        for _ in range(max(seg, 0)):
            tok = sample_logits(None, logits, temperature=temperature,
                                top_k=top_k, top_p=top_p, sample=sample,
                                u=None if u is None else u[len(toks)])
            logits, cache = gpt_decode_step(params, cfg, cache, tok, wq)
            toks.append(tok)
    out = torch.stack(toks, dim=1)
    if t0 > 0:
        out = torch.cat([given.long(), out], dim=1)
    return out
