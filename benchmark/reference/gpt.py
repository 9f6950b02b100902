"""Plain minGPT forward in float32, over the parameter layout the benchmark
draws its weights in.

The layout is the one the program serves and trains (a nested dict: the
token, position and class embeddings, the blocks stacked on a leading
layer axis with ``(L, in, out)`` matrices and a fused ``q | k | v``
projection, the final LayerNorm and the head).  The arithmetic follows the
reference's ``transformer/minGPT.py``: pre-LN blocks, the causal mask
widened to a bidirectional window over the first ``n_unmasked`` positions,
softmax attention scaled by ``1 / sqrt(head_dim)``, an exact-erf GELU MLP,
LayerNorm eps 1e-5, dropout on the embedding, on the attention
probabilities and on both residual branches.  No cache, no kernel, no
quantisation: every product in float32 with TF32 off (``fp32_scope``).

Dropout masks are drawn from the caller's ``torch.Generator`` in the order
the GPT draws them (the embedding's, then per layer the attention
probabilities', the projection's and the MLP's), each as the Bernoulli
draw of ``keep_mask``, so that a generator seeded alike gives the masks a
training step of the program draws.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, object]


@contextlib.contextmanager
def fp32_scope():
    """Float32 products with TF32 off in cuBLAS and cuDNN; the caller's
    flags restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """``{"blocks/attn_qkv/w": shape, ...}`` of a GPT of ``cfg`` (the keys
    of the configuration file's ``model``); ``output_size`` is
    ``last_linear`` where given, else the vocabulary."""
    d, L = cfg["n_embd"], cfg["n_layer"]
    out = cfg.get("last_linear") or cfg["vocab_size"]
    shapes = {
        "tok_emb": (cfg["vocab_size"], d), "pos_emb": (cfg["block_size"], d),
        "blocks/ln1_s": (L, d), "blocks/ln1_b": (L, d),
        "blocks/attn_qkv/w": (L, d, 3 * d), "blocks/attn_qkv/b": (L, 3 * d),
        "blocks/attn_proj/w": (L, d, d), "blocks/attn_proj/b": (L, d),
        "blocks/ln2_s": (L, d), "blocks/ln2_b": (L, d),
        "blocks/mlp_up/w": (L, d, 4 * d), "blocks/mlp_up/b": (L, 4 * d),
        "blocks/mlp_down/w": (L, 4 * d, d), "blocks/mlp_down/b": (L, d),
        "ln_f_s": (d,), "ln_f_b": (d,), "head/w": (d, out)}
    if cfg.get("class_size"):
        shapes["class_emb"] = (cfg["class_size"], d)
    return shapes


def nest(flat: Dict[str, torch.Tensor]) -> Params:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    out: Dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def flatten(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def keep_mask(generator: torch.Generator, keep_prob: float,
              shape) -> torch.Tensor:
    """Bool Bernoulli(keep_prob) mask from the narrowest exact draw: one
    uniform byte an element where keep_prob is a multiple of 1/256, else
    16 uniform bits (P rounded to the nearest 1/65536), else a float
    uniform; on the generator's device."""
    dev = generator.device
    t = keep_prob * 256.0
    if 0 <= t < 256 and t == round(t):
        bits = torch.empty(shape, dtype=torch.uint8, device=dev)
        return bits.random_(0, 256, generator=generator) < int(round(t))
    t16 = int(round(keep_prob * 65536.0))
    if not 0 <= t16 < 65536:
        return torch.rand(shape, generator=generator, device=dev) < keep_prob
    bits = torch.empty(shape, dtype=torch.int32, device=dev)
    return bits.random_(0, 65536, generator=generator) < t16


def _dropout(x, rate, generator):
    if generator is None or rate <= 0.0:
        return x
    keep = keep_mask(generator, 1.0 - rate, x.shape)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def window_mask(t: int, n_unmasked: int, device) -> torch.Tensor:
    """(T, T) bool, True = attend: causal, all-to-all over the first
    ``n_unmasked`` positions (minGPT.py:64-69)."""
    m = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    nu = min(int(n_unmasked), t)
    if nu > 0:
        m[:nu, :nu] = True
    return m


Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def round_int(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """``x`` rounded to symmetric ``bits``-bit integers under an absmax
    scale over ``dim`` (one scale a row or column), then scaled back."""
    top = 2 ** (bits - 1) - 1
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / top
    return torch.clamp(torch.round(x / s), -top, top) * s


def int4_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product with int4 operands: the activation rows and the weight
    columns each under their own absmax scale (the int8 product's scheme
    at 4 bits)."""
    return round_int(a, 4, -1) @ round_int(b, 4, 0)


def int4_kv(x: torch.Tensor) -> torch.Tensor:
    """Keys or values rounded as an int4 cache holds them: one scale a
    (batch, head, position) row."""
    return round_int(x, 4, -1)


def forward(p: Params, cfg: Dict, idx: Optional[torch.Tensor],
            cond: Optional[torch.Tensor] = None, *,
            generator: Optional[torch.Generator] = None,
            matmul: Matmul = _mm,
            kv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> torch.Tensor:
    """Logits (B, P + T, out) of tokens ``idx`` (B, T) after the prepended
    embeddings ``cond`` (B, P, D), in float32.  With a ``generator`` the
    configuration's three dropout rates apply (a training forward).
    ``matmul`` computes each of the block's four products and ``kv``
    rounds the attention's keys and values (a lower precision in a control
    run); norms, softmax and the head stay float32."""
    f = {k: v.float() for k, v in flatten(p).items()}
    parts = []
    if cond is not None:
        parts.append(cond.float())
    if idx is not None and idx.shape[1] > 0:
        parts.append(f["tok_emb"][idx.long()])
    x = torch.cat(parts, dim=1)
    b, t, d = x.shape
    x = x + f["pos_emb"][:t]
    x = _dropout(x, cfg.get("embd_pdrop", 0.0), generator)
    h_n = cfg["n_head"]
    hd = d // h_n
    mask = window_mask(t, cfg.get("n_unmasked", 0), x.device)
    attn_rate = cfg.get("attn_pdrop", 0.0)
    resid_rate = cfg.get("resid_pdrop", 0.0)
    for l in range(cfg["n_layer"]):
        def w(name):
            return f[f"blocks/{name}"][l]
        h = F.layer_norm(x, (d,), w("ln1_s"), w("ln1_b"), 1e-5)
        qkv = matmul(h.reshape(-1, d), w("attn_qkv/w")).reshape(b, t, 3 * d)
        qkv = qkv + w("attn_qkv/b")
        q, k, v = (a.reshape(b, t, h_n, hd).transpose(1, 2)
                   for a in qkv.chunk(3, dim=-1))
        if kv is not None:
            k, v = kv(k), kv(v)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        if generator is not None and attn_rate > 0.0:
            keep = keep_mask(generator, 1.0 - attn_rate, att.shape)
            att = torch.where(keep, att / (1.0 - attn_rate), 0.0)
        y = (att @ v).transpose(1, 2).reshape(b * t, d)
        y = matmul(y, w("attn_proj/w")).reshape(b, t, d) + w("attn_proj/b")
        x = x + _dropout(y, resid_rate, generator)
        h2 = F.layer_norm(x, (d,), w("ln2_s"), w("ln2_b"), 1e-5)
        m = F.gelu(matmul(h2.reshape(-1, d), w("mlp_up/w")).reshape(
            b, t, 4 * d) + w("mlp_up/b"))
        m = matmul(m.reshape(-1, 4 * d), w("mlp_down/w")).reshape(b, t, d)
        m = m + w("mlp_down/b")
        x = x + _dropout(m, resid_rate, generator)
    x = F.layer_norm(x, (d,), f["ln_f_s"], f["ln_f_b"], 1e-5)
    return x @ f["head/w"]


def class_logits(p: Params, cfg: Dict, classes: torch.Tensor,
                 tokens: torch.Tensor, rows: int = 8, **kw) -> torch.Tensor:
    """The class-conditional GPT's float32 logits (N, T, V) over the
    class token and ``tokens`` (N, T) -- position i predicts token i --
    ``rows`` sequences at a time (``kw``: ``forward``'s lower-precision
    hooks).  The last token is fed in no further (its logits would
    predict past the clip)."""
    out = []
    emb = p["class_emb"].float()
    with torch.no_grad(), fp32_scope():
        for i in range(0, tokens.shape[0], rows):
            cls = classes[i:i + rows].long()
            toks = tokens[i:i + rows, :-1]
            out.append(forward(p, cfg, toks, emb[cls][:, None, :], **kw))
    return torch.cat(out)
