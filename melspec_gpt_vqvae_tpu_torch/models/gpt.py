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
and eval, is kernel F (ops/flash_attention.py); otherwise a forward that
autograd records runs the plain differentiable ``attend_xla`` and an eval
forward kernel A (ops/attention.py), as the JAX package's XLA and Pallas
paths.  ``mixed_precision`` takes the block's four products with bfloat16
operands and float32 results (``_dot``: one cuBLAS call on the card);
``remat`` recomputes each block in the backward by the JAX package's
policies (``_block_remat``), every recomputed region drawing its dropout
masks again from the generator state it began at.

Decode keeps a preallocated KV cache of layout (L, B, H, T, hd) and
updates it in place: the JAX functions return a new cache, these write the
new slots into the given one and return it.  ``cache["len"]`` is a Python
int in the eager loop (no host-device round trip), and a one-element int64
tensor on the cache's device in the captured loop: there one decode step
and the sampling before it are one CUDA graph, replayed once a token
(models/decode_graph.py), as the JAX package's decode loop is one
``lax.scan``; the step then reads its position from device memory and
advances it there.  The cache holds
the model dtype (``cache_dtype="auto"``), or absmax-quantised int8 values
or int4 nibble pairs with bfloat16 scales per (layer, batch, head,
position) (``"int8"``, ``"int4"``), as in the JAX package.  Prefill
attention is kernel A on the card (ops/attention.py).  The decode step's
attention is kernel E over a quantised cache (ops/decode_attention.py) and
plain torch over a model-dtype cache, as the JAX step's is XLA einsums
(gpt.py:545-551).  ``decode_weight_dtype="int8"`` streams per-channel int8
block weights through an int8 x int8 -> int32 product (``_int8_mm``; on
the card ops/int8_linear.py's kernels: one launch at small M, else two
kernels around cuBLASLt's product).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..configs import GPTConfig

from ..ops import decode_attention as _da
from ..ops import int8_linear as _il
from ..ops.attention import attend, attend_xla, bernoulli_u8
from ..ops.decode_attention import quantize_kv as _quantize_kv
from ..ops.decode_attention import quantize_kv4 as _quantize_kv4
from ..ops.decode_attention import true_div as _div
from ..ops.decode_attention import unpack4 as _unpack4  # noqa: F401
from ..ops.flash_attention import flash_attention
from ..ops.quant import int_matmul
from ..ops.sampling import sample_logits
from ..utils import profiling
from . import decode_graph

Params = Dict[str, object]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _param_tree(cfg: GPTConfig, norm, zeros, ones) -> Params:
    """The GPT's nested parameter dict, its leaves made by ``norm`` (the
    weights), ``zeros`` and ``ones``, each called with a shape."""
    d, l4, L = cfg.n_embd, 4 * cfg.n_embd, cfg.n_layer
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
    return params


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator,
                    device=None) -> Params:
    """Random parameters as the reference initialises them
    (minGPT.py:159-166): weights ~ N(0, 0.02), biases zero, LayerNorm
    (1, 0), a zero position embedding.  Drawn in float32 from ``generator``
    (on its own device) and then moved to ``device`` in ``cfg.dtype``, so a
    seed gives the same weights on every device."""
    gdev = generator.device
    params = _param_tree(
        cfg,
        lambda *s: 0.02 * torch.randn(s, generator=generator, device=gdev),
        lambda *s: torch.zeros(s, device=gdev),
        lambda *s: torch.ones(s, device=gdev))
    return tree_to(params, device=device, dtype=DTYPES[cfg.dtype])


def gpt_param_template(cfg: GPTConfig) -> Params:
    """The parameter dict as shapes and dtypes only: ``meta`` tensors that
    hold no memory (the template a checkpoint is restored against)."""
    def leaf(*shape):
        return torch.empty(shape, dtype=DTYPES[cfg.dtype], device="meta")
    return _param_tree(cfg, leaf, leaf, leaf)


def tree_to(tree, **kw):
    """Apply ``Tensor.to(**kw)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    return tree.to(**kw)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    """Layer norm in x's dtype (float32 over bfloat16 parameters under
    mixed precision, as the JAX package's promotes)."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype),
                        bias.to(x.dtype), eps)


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _layer(blocks, l: int) -> Params:
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l]) for k, v in blocks.items()}


def _tp(mesh):
    """The mesh a decode runs tensor parallel over (one with a ``model``
    axis), else None."""
    return mesh if mesh is not None and mesh.has("model") else None


def _sum_model(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-cut product's partial sums (a fresh tensor) summed in place
    over the model group; ``y`` itself without ``tp``.  Inference only:
    training goes through ``_FromModel``."""
    if tp is not None:
        y = y.contiguous()
        tp.all_reduce_(y, "model")
    return y


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


def _attn_block(x, p, cfg, tp=None):
    """Pre-LN attention half of an inference block; returns (x', k, v)
    with k, v of layout (B, H, T, hd).  Under ``tp`` (``p`` the full
    layer, ``_full_layer``) the attention runs on this rank's heads, whose
    outputs are all-gathered over the model group for the projection, and
    k, v are this rank's heads."""
    q, k, v = _qkv(x, p, cfg)
    if tp is not None:
        lo, h = _head_range(cfg, tp)
        q, k, v = (a[:, lo:lo + h].contiguous() for a in (q, k, v))
    res = attend(q, k, v, cfg.n_unmasked)
    if tp is not None:
        from ..parallel.mesh import head_counts
        res = torch.cat(tp.all_gather(
            res, "model", head_counts(cfg.n_head, tp.size("model")), dim=1),
            dim=1)
    y = _merge_heads(res) @ p["attn_proj"]["w"] + p["attn_proj"]["b"]
    return x + y, k, v


def _full_layer(blocks: Params, l: int, cfg: GPTConfig, tp) -> Params:
    """Layer ``l``'s full weights from this rank's Megatron shard: every
    cut leaf all-gathered over the model group (the parts of a head cut
    as large as each rank's heads) and joined (parallel/mesh.py::
    tp_gather).  Only the prefill does this, once a request, so that its
    float products have the single device's shapes and hence its rounding
    (a row-parallel sum would not); the decode steps stay cut."""
    from ..parallel.mesh import cut_dim, tp_gather, tp_rule, tp_sizes
    m, r = tp.size("model"), tp.coord("model")

    def leaf(name, t):
        t = t[l:l + 1]
        rule = tp_rule(name)
        if rule is None:
            return t[0]
        sizes = tp_sizes(name, t, cfg.n_head, m, r)
        return tp_gather(name, tp.all_gather(t, "model", sizes,
                                             cut_dim(rule)))[0]
    return {k: ({kk: leaf(f"blocks/{k}/{kk}", vv) for kk, vv in v.items()}
                if isinstance(v, dict) else v[l])
            for k, v in blocks.items()}


def _dropout(x, rate: float, generator: Optional[torch.Generator],
             train: bool):
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = bernoulli_u8(generator, 1.0 - rate, x.shape)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _MixedMM(torch.autograd.Function):
    """(M, K) @ (K, N) with bfloat16 operands and a float32 product from
    one cuBLAS call that accumulates in float32 (``torch.mm(...,
    out_dtype=torch.float32)``): the card's form of ``_dot``.  The
    backward multiplies the gradient, rounded to bfloat16, by the other
    bfloat16 operand and returns the products rounded to bfloat16, as the
    JAX package's ``convert_element_type`` transposes round them.  JAX
    multiplies the float32 gradient unrounded (cuBLAS has no float32 x
    bfloat16 product); a TPU's one-pass product rounds it as this does."""

    @staticmethod
    def forward(ctx, a, w):
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(ab, wb)
        ctx.dtypes = (a.dtype, w.dtype)
        return torch.mm(ab, wb, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = (gb @ wb.t()).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            gw = (ab.t() @ gb).to(ctx.dtypes[1])
        return ga, gw


def _dot(a: torch.Tensor, w: torch.Tensor, mixed: bool) -> torch.Tensor:
    """A block's matrix product ``a (..., K) @ w (K, N)`` (gpt.py:127-136).
    Under ``mixed_precision`` the operands are bfloat16 and the product
    float32, never a bfloat16 product widened: on the card one cuBLAS call
    (``_MixedMM``); on the CPU, which has no such call, the float32
    product of the bfloat16-rounded operands, the same function (a product
    of two bfloat16 values is exact in float32), whose autograd backward
    is the JAX package's."""
    if not mixed:
        return a @ w
    if a.is_cuda:
        out = _MixedMM.apply(a.reshape(-1, a.shape[-1]), w)
        return out.reshape(*a.shape[:-1], w.shape[1])
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def _head_range(cfg: GPTConfig, tp) -> Tuple[int, int]:
    """(first head, head count) of this rank over the model axis
    (parallel/mesh.py::head_range: uneven where the axis does not divide
    the heads)."""
    from ..parallel.mesh import head_range
    return head_range(cfg.n_head, tp.size("model"), tp.coord("model"))


def _local_heads(p, cfg: GPTConfig, tp) -> int:
    """The heads a block's weights hold: all of them, or under tensor
    parallelism this rank's share, read off the local ``attn_qkv``."""
    heads = p["attn_qkv"]["w"].shape[-1] // (3 * cfg.head_dim)
    if heads != cfg.n_head and tp is None:
        raise ValueError(f"attn_qkv holds {heads} of {cfg.n_head} heads: a "
                         "model-sharded block needs its mesh")
    return heads


def _head_keep(generator: Optional[torch.Generator], rate: float, shape,
               cfg: GPTConfig, tp) -> Optional[torch.Tensor]:
    """The attention's bool keep-mask (B, H, T, T) of the ``shape[1]``
    heads this rank holds (None without dropout): the mask of every head
    is drawn and, under tensor parallelism, this rank's are cut from it,
    so that the generator, the same on every rank of the model group,
    moves as on one device and each head keeps a mask of its own
    (Megatron's two-generator rule, from one generator)."""
    if generator is None or rate <= 0.0:
        return None
    b, h, t, s = shape
    keep = bernoulli_u8(generator, 1.0 - rate, (b, cfg.n_head, t, s))
    lo = _head_range(cfg, tp)[0] if tp is not None else 0
    return keep[:, lo:lo + h].contiguous()


class _ToModel(torch.autograd.Function):
    """Megatron's f, before a column-parallel product (``attn_qkv``,
    ``mlp_up``): the identity forward; backward, the input's gradient (a
    part on each model rank) summed over the model group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.tp.all_reduce_(g, "model")
        return g, None


class _FromModel(torch.autograd.Function):
    """Megatron's g, after a row-parallel product (``attn_proj``,
    ``mlp_down``): forward, the partial products summed over the model
    group; backward, the identity.  The replicated bias is added after it,
    once."""

    @staticmethod
    def forward(ctx, x, tp):
        y = x.contiguous().clone()
        tp.all_reduce_(y, "model")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _attn_half(x, p, cfg: GPTConfig, train: bool,
               generator: Optional[torch.Generator],
               return_attn: bool = False, tp=None):
    """The attention of a block: (B, T, D) residual -> (B, H, T, hd)
    attention output (the JAX block's ``attn_out``).  The branch is taken
    as the JAX block takes it: kernel F whenever ``use_flash_train`` (with
    a keep-mask only in training), else the plain ``attend_xla`` wherever
    autograd records (a training forward, or the GPT-VAE encoder's
    dropout-free forward inside a train step) and kernel A in eval.
    ``return_attn`` takes the plain ``attend_xla`` whatever the config and
    returns (output, its float32 probabilities (B, H, T, T)), as the JAX
    block does for the attention maps (gpt.py:148).  ``tp`` (a mesh with a
    ``model`` axis) runs this rank's heads: H is its share."""
    mixed = cfg.mixed_precision
    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    if tp is not None:
        h = _ToModel.apply(h, tp)
    qkv = _dot(h, p["attn_qkv"]["w"], mixed) + p["attn_qkv"]["b"]
    heads = _local_heads(p, cfg, tp)
    q, k, v = (_split_heads(a, heads) for a in qkv.chunk(3, dim=-1))
    if return_attn:
        return attend_xla(q, k, v, cfg.n_unmasked,
                          dropout_rate=cfg.attn_pdrop if train else 0.0,
                          generator=generator, return_attn=True)
    rate = cfg.attn_pdrop if train else 0.0
    b, hh, t = q.shape[:3]
    keep = _head_keep(generator if train else None, rate, (b, hh, t, t),
                      cfg, tp)
    if cfg.use_flash_train:
        mask = None if keep is None else keep.view(torch.uint8)
        return flash_attention(q.float(), k.float(), v.float(), mask,
                               cfg.n_unmasked, 1.0 - rate).to(x.dtype)
    if train or q.requires_grad:
        return attend_xla(q, k, v, cfg.n_unmasked, dropout_rate=rate,
                          keep=keep)
    return attend(q, k, v, cfg.n_unmasked)


def _rest_half(x, res, p, cfg: GPTConfig, train: bool,
               generator: Optional[torch.Generator], tp=None):
    """The rest of a block after its attention output ``res``: projection,
    residual, MLP, residual, with their two dropouts.  Under ``tp`` the
    projection and ``mlp_down`` sum their partial products over the model
    group before their bias, and the dropouts act on the replicated
    residual stream (the same generator, the same masks on every rank of
    the group)."""
    mixed = cfg.mixed_precision
    y = _dot(_merge_heads(res), p["attn_proj"]["w"], mixed)
    if tp is not None:
        y = _FromModel.apply(y, tp)
    y = y + p["attn_proj"]["b"]
    x = x + _dropout(y, cfg.resid_pdrop, generator, train)
    h2 = _layer_norm(x, p["ln2_s"], p["ln2_b"])
    if tp is not None:
        h2 = _ToModel.apply(h2, tp)
    m = F.gelu(_dot(h2, p["mlp_up"]["w"], mixed) + p["mlp_up"]["b"])
    m = _dot(m, p["mlp_down"]["w"], mixed)
    if tp is not None:
        m = _FromModel.apply(m, tp)
    m = m + p["mlp_down"]["b"]
    return x + _dropout(m, cfg.resid_pdrop, generator, train)


def _block(x, p, cfg: GPTConfig, train: bool,
           generator: Optional[torch.Generator], tp=None):
    """One pre-LN block of ``gpt_apply`` (gpt.py:141-187); its dropout
    masks are drawn from ``generator`` in the order attention,
    projection, MLP."""
    return _rest_half(x, _attn_half(x, p, cfg, train, generator, tp=tp), p,
                      cfg, train, generator, tp)


_SAVED_DOTS = ("mm", "addmm")


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    results of the block's matrix products (``aten.mm`` / ``addmm``: the
    JAX package's dots without batch dimensions), recompute the rest (the
    attention's batched products included)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op.overloadpacket.__name__ in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, generator: Optional[torch.Generator], *args,
           save_dots: bool = False):
    """``fn(generator, *args)`` under ``torch.utils.checkpoint``: its
    activations are dropped after the forward and recomputed in the
    backward.  ``checkpoint`` restores only the global RNG, so the region
    draws its dropout masks from a generator of its own, set to
    ``generator``'s state as the region begins; the recompute starts again
    from that state and draws the same masks, and ``generator`` is left
    where the forward left the region's, as if ``fn`` had drawn from it
    (the JAX package splits a key a layer up front, gpt.py:250-257)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if save_dots:
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)
    if generator is None:
        return checkpoint(lambda *a: fn(None, *a), *args,
                          use_reentrant=False, preserve_rng_state=False,
                          **kw)
    start, end = generator.get_state(), []

    def region(*a):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = fn(g, *a)
        end[:] = [g.get_state()]
        return out
    out = checkpoint(region, *args, use_reentrant=False,
                     preserve_rng_state=False, **kw)
    generator.set_state(end[0])
    return out


def _block_remat(x, p, cfg: GPTConfig, train: bool,
                 generator: Optional[torch.Generator], tp=None):
    """``_block`` recomputed in the backward (``make_block_body``,
    gpt.py:214-232), by ``cfg.remat_policy``: ``full`` keeps only the
    block's input; ``attn`` keeps the attention output as well -- two
    regions, the attention and the rest -- so the projection's and the
    MLP's backward read it and only the attention's replays it; ``dots``
    keeps the results of the four matrix products."""
    policy = cfg.remat_policy
    if policy == "attn":
        res = _remat(lambda g, x: _attn_half(x, p, cfg, train, g, tp=tp),
                     generator, x)
        return _remat(lambda g, x, res: _rest_half(x, res, p, cfg, train, g,
                                                   tp), generator, x, res)
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy={policy!r}: expected 'full', 'attn' "
                         "or 'dots'")
    return _remat(lambda g, x: _block(x, p, cfg, train, g, tp), generator,
                  x, save_dots=policy == "dots")


def embed_tokens(params: Params, cfg: GPTConfig,
                 idx: Optional[torch.Tensor],
                 cond_emb: Optional[torch.Tensor], train: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The block stack's input: the embeddings (float32 under mixed
    precision) with the embedding dropout of a training forward."""
    x = _embed(params, cfg, idx, cond_emb)
    if cfg.mixed_precision:
        x = x.float()
    return _dropout(x, cfg.embd_pdrop, generator, train)


def gpt_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The block stack's output -> logits: ``ln_f`` and the head."""
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"].to(x.dtype)


def gpt_apply(params: Params, cfg: GPTConfig, idx: Optional[torch.Tensor],
              cond_emb: Optional[torch.Tensor] = None, *,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              return_attn: bool = False, mesh=None):
    """Full forward.  idx (B, T) tokens or None; cond_emb (B, P, D)
    prepended embeddings.  ``train`` with a ``generator`` applies the three
    dropout rates (a training forward without a generator has no dropout,
    as the JAX one without an rng).  ``cfg.mixed_precision`` takes the
    block products in bfloat16 with float32 results and keeps the residual
    stream, layer norms, softmax and head in float32 (``embed_tokens``
    casts the embedding to float32); ``cfg.remat`` recomputes each block
    in the backward (``_block_remat``) when autograd records.  Returns
    logits (B, P + T, out); with ``return_attn`` (the eval-only path of
    the attention maps: plain attention, no remat) (logits, the last
    layer's float32 attention probabilities (B, H, P + T, P + T)), as the
    JAX function's scan carry keeps the last layer's (gpt.py:255-275).

    ``mesh`` (parallel/mesh.py) runs the forward over its ranks: a ``pipe``
    axis through the GPipe schedule (``parallel.pipeline.gpt_apply_pp``,
    the logits on every stage), a ``model`` axis with this rank's share of
    the heads and MLP columns in ``params``' blocks (Megatron).  The
    attention maps stay a single-device path: ``return_attn`` takes no
    mesh."""
    train = bool(train) and generator is not None
    if mesh is not None and mesh.has("pipe") and not return_attn:
        from ..parallel.pipeline import gpt_apply_pp
        return gpt_apply_pp(params, cfg, idx, cond_emb, mesh=mesh,
                            train=train, generator=generator)
    tp = (mesh if mesh is not None and mesh.has("model") and not return_attn
          else None)
    x = embed_tokens(params, cfg, idx, cond_emb, train, generator)
    block = (_block_remat if cfg.remat and torch.is_grad_enabled()
             and not return_attn else _block)
    att = None
    for p in _layers(params["blocks"]):
        if return_attn:
            res, att = _attn_half(x, p, cfg, train, generator, True)
            x = _rest_half(x, res, p, cfg, train, generator)
        else:
            x = block(x, p, cfg, train, generator, tp)
    logits = gpt_head(params, x)
    return (logits, att) if return_attn else logits


def gpt_attention_maps(params: Params, cfg: GPTConfig, idx: torch.Tensor,
                       cond_emb: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The last layer's attention probabilities (B, H, T, T) of an eval
    forward, for logging (gpt.py:668-673); the plain attention, no kernel."""
    with torch.no_grad():
        return gpt_apply(params, cfg, idx, cond_emb, return_attn=True)[1]


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
                  device=None, heads: Optional[int] = None) -> Dict:
    """Zeroed (L, B, H, T, hd) key and value caches: in the model dtype, or
    int8 values (uint8 (..., hd/2) for int4) with bfloat16 (L, B, H, T)
    scales (gpt.py:302-325).  ``heads``: H of a rank that holds a share of
    the heads (tensor parallelism), else ``cfg.n_head``."""
    shape = (cfg.n_layer, batch, heads or cfg.n_head,
             max_len or cfg.block_size, cfg.head_dim)
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


def _cache_rows(cfg: GPTConfig, k: torch.Tensor, v: torch.Tensor) -> Dict:
    """(B, H, c, hd) keys and values as the cache stores them, by cache
    name: the model dtype, or for an int8 / int4 cache the values from the
    float32 scale and the scale in bfloat16 (gpt.py:401-414, 501-516)."""
    if cfg.cache_dtype not in ("int8", "int4"):
        return {"k": k, "v": v}
    quant = _quantize_kv4 if cfg.cache_dtype == "int4" else _quantize_kv
    (qk, sk), (qv, sv) = quant(k), quant(v)
    return {"k": qk, "v": qv, "k_scale": sk.to(torch.bfloat16),
            "v_scale": sv.to(torch.bfloat16)}


def _write_kv(cache: Dict, cfg: GPTConfig, l: int, pos,
              k: torch.Tensor, v: torch.Tensor) -> None:
    """Write (B, H, c, hd) keys and values (``_cache_rows``) into layer
    ``l`` of the cache at positions pos .. pos + c - 1.  ``pos`` is a
    Python int (a slice assignment) or a one-element int64 tensor on the
    cache's device (an ``index_copy_`` along the position axis, which a
    captured program can replay at any position)."""
    rows = _cache_rows(cfg, k, v)
    if isinstance(pos, torch.Tensor):
        idx = pos + torch.arange(k.shape[2], device=pos.device)
        for name, x in rows.items():
            cache[name][l].index_copy_(2, idx, x)
    else:
        sl = slice(pos, pos + k.shape[2])
        for name, x in rows.items():
            cache[name][l, :, :, sl] = x


def gpt_prefill(params: Params, cfg: GPTConfig, cache: Dict,
                idx: Optional[torch.Tensor],
                cond_emb: Optional[torch.Tensor] = None, *, mesh=None
                ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (cond + given tokens) once, writing its keys and
    values into ``cache``.  Returns (logits at the last position (B, out),
    cache).  ``mesh`` with a ``model`` axis: ``params`` hold this rank's
    heads and MLP columns (parallel/mesh.py::shard_gpt_for_serving) and
    the cache its heads; each layer's weights are gathered for the
    products (``_full_layer``) and the attention runs on this rank's
    heads (``_attn_block``), so the logits and cache are the single
    device's bit for bit."""
    tp = _tp(mesh)
    x = _embed(params, cfg, idx, cond_emb)
    t0 = x.shape[1]
    for l in range(cfg.n_layer):
        p = (_layer(params["blocks"], l) if tp is None
             else _full_layer(params["blocks"], l, cfg, tp))
        x, k, v = _attn_block(x, p, cfg, tp)
        _write_kv(cache, cfg, l, 0, k, v)
        x = x + _mlp(_layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
    cache["len"] = t0
    x = _layer_norm(x[:, -1], params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


BLOCK_MATRICES = ("attn_qkv", "attn_proj", "mlp_up", "mlp_down")


def quantize_block_weight(w: torch.Tensor) -> Dict:
    """One stacked block matrix (L, in, out) -> ``{"q": (L, in, out) int8,
    "s": (L, out) float32}``, per-output-channel absmax over the whole
    ``in`` axis (gpt.py:426-438), computed where ``w`` lies.  Each layer's
    ``q`` is stored column-major (its ``in`` axis contiguous), the layout
    the card's int8 product takes."""
    w = w.float()
    scale = torch.clamp_min(_div(w.abs().amax(1), 127.0), 1e-8)
    wq = torch.clamp(torch.round(w / scale[:, None, :]), -127, 127)
    wq = wq.to(torch.int8).transpose(1, 2).contiguous().transpose(1, 2)
    return {"q": wq, "s": scale}


def quantize_block_weights(blocks: Params) -> Dict:
    """``quantize_block_weight`` of the four block matrices: ``{name:
    {"q", "s"}}``."""
    return {name: quantize_block_weight(blocks[name]["w"])
            for name in BLOCK_MATRICES}


def _int8_mm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
             tp=None) -> torch.Tensor:
    """x (M, in) @ int8 weights (in, out) with per-row absmax activation
    quantisation and exact int32 accumulation, rescaled in float32 as
    ``acc * xs * ws`` from left to right (gpt.py:441-450).  ``tp``: the
    row-cut product of tensor parallelism, x this rank's slice of the
    features -- the scales are all-reduced with MAX (the whole row's
    absmax) before quantising and the int32 sums with SUM before the
    rescale, which keeps it the single device's product bit for bit."""
    xf = x.float()
    xs = torch.clamp_min(_div(xf.abs().amax(-1), 127.0), 1e-8)
    if tp is not None:
        tp.all_reduce_(xs, "model", op="max")
    xq = torch.clamp(torch.round(xf / xs[:, None]), -127, 127)
    acc = int_matmul(xq.to(torch.int8), wq.t())
    if tp is not None:
        tp.all_reduce_(acc, "model")
    return acc.float() * xs[:, None] * ws[None, :]


_ROW_CUT = ("attn_proj", "mlp_down")


def _mm(a: torch.Tensor, p: Params, pw: Optional[Dict],
        name: str, fused: bool = False, tp=None) -> torch.Tensor:
    """One block matrix product with bias: in the model dtype, or through
    the int8 weights ``pw`` of this layer (gpt.py:484-494).  ``fused``
    takes the int8 product through ops/int8_linear.py::int8_linear (on
    the card one launch of ``int8_linear_splitk`` at most
    ``SPLITK_MAX_ROWS`` rows, else two kernels around the cuBLASLt
    product; on the CPU, or with the kernels off, the lines below, bit
    for bit).  Under ``tp`` the row-cut products (``attn_proj``,
    ``mlp_down``) sum over the model group before their bias (always the
    chain), the others are this rank's columns."""
    tp = tp if name in _ROW_CUT else None
    if pw is None:
        return _sum_model(a @ p[name]["w"], tp) + p[name]["b"]
    a2 = a.reshape(-1, a.shape[-1])
    if fused:
        out = _il.int8_linear(a2, pw[name]["q"], pw[name]["s"], p[name]["b"],
                              tp)
        return out.reshape(*a.shape[:-1], -1)
    out = _int8_mm(a2, pw[name]["q"], pw[name]["s"], tp)
    return out.reshape(*a.shape[:-1], -1).to(a.dtype) + p[name]["b"]


def _step_input(params: Params, cfg: GPTConfig, token: torch.Tensor,
                pos) -> torch.Tensor:
    """Token plus position embedding (B, D) of a decode step.  The
    position clamps as the JAX step's dynamic_index_in_dim does
    (speculative drafts run past the block); a device position is read by
    an ``index_select``."""
    if isinstance(pos, torch.Tensor):
        pe = params["pos_emb"].index_select(
            0, pos.clamp(max=cfg.block_size - 1))[0]
    else:
        pe = params["pos_emb"][min(pos, cfg.block_size - 1)]
    return params["tok_emb"][token.long()] + pe


def _dense_attend(q: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                  valid: torch.Tensor, scale: float) -> torch.Tensor:
    """One query row (B, H, 1, hd) over a model-dtype cache layer (B, H, T,
    hd), ``valid`` (T,) the attended positions (gpt.py:545-551)."""
    scores = (q.float() @ k_l.float().transpose(-1, -2))[:, :, 0] * scale
    probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
    return probs.to(v_l.dtype).float()[:, :, None] @ v_l.float()


def _step_layers(params: Params, cfg: GPTConfig, x: torch.Tensor,
                 wq: Optional[Dict], fused: bool, attend,
                 tp=None) -> torch.Tensor:
    """The layer math of one decode step, the one copy of it that the eager
    loop, the captured program and the exported program share: x (B, D)
    -> logits (B, out).  ``attend(l, q, k, v)`` takes layer ``l``'s
    (B, H, 1, hd) query, key and value, puts the key and value into the
    cache as its caller keeps it, and returns the attention output
    (B, H, [1,] hd); ``fused`` routes the int8 products through
    ops/int8_linear.py (``_mm``).  ``tp``: H is this rank's share of the
    heads, and the row-cut products sum over the model group."""
    b = x.shape[0]
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        pw = None if wq is None else _layer(wq, l)
        heads = _local_heads(p, cfg, tp)
        h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
        q, k, v = (a.reshape(b, heads, 1, cfg.head_dim)
                   for a in _mm(h, p, pw, "attn_qkv", fused).chunk(3, -1))
        o = attend(l, q, k, v)
        x = x + _mm(o.reshape(b, heads * cfg.head_dim).to(x.dtype), p, pw,
                    "attn_proj", fused, tp)
        h2 = _layer_norm(x, p["ln2_s"], p["ln2_b"])
        x = x + _mm(F.gelu(_mm(h2, p, pw, "mlp_up", fused)), p, pw,
                    "mlp_down", fused, tp)
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"]


def split_pairs(cfg: GPTConfig, b: int, mesh=None) -> Optional[int]:
    """The (b, h) pairs of one device's decode over a mesh's global batch
    and every head: what kernel E's split rule reads on every rank, so
    that a rank's attention sums are one card's (None without a mesh)."""
    return None if mesh is None else b * mesh.size("data") * cfg.n_head


def gpt_decode_step(params: Params, cfg: GPTConfig, cache: Dict,
                    token: torch.Tensor, wq: Optional[Dict] = None, *,
                    mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One cached decode step.  token (B,) -> (logits (B, out), cache).
    Attention covers the positions up to the current one, as the JAX step
    masks the rest; ``wq`` are the int8 block weights of
    ``quantize_block_weights`` (None: the model-dtype weights).  With the
    kernels off (``_build.kernels(False)``) the plain versions of kernel E
    and of the int8 product's kernels run, which read no host position
    either.

    ``cache["len"]`` a Python int is the eager step: the new slot is
    written by ``_write_kv`` at a host position, kernel E only attends.
    ``cache["len"]`` a one-element int64 tensor is the step a captured
    program replays: nothing in it depends on a host value.  The position
    embedding is an ``index_select``, a model-dtype cache takes the new
    slot by ``index_copy_``, over a quantised cache kernel E quantises and
    writes the slot itself before it attends, the int8 products go
    through ops/int8_linear.py, and the position is advanced in place.
    Both give the same logits and cache bit for bit, and the same as
    ``gpt_decode_step_functional``: the three share ``_step_layers``.

    ``mesh`` with a ``model`` axis: this rank's heads (of ``params``,
    ``wq`` and the cache), the row-cut products summed over the group
    (``_mm``); the logits come out the same on every rank of the group."""
    pos = cache["len"]
    on_device = isinstance(pos, torch.Tensor)
    quantised = cfg.cache_dtype in ("int8", "int4")
    if not quantised:
        valid = torch.arange(cache["k"].shape[3], device=token.device) <= pos
        scale = 1.0 / cfg.head_dim ** 0.5
    qc = ([cache[n] for n in ("k", "v", "k_scale", "v_scale")]
          if quantised else None)
    pairs = split_pairs(cfg, token.shape[0], mesh)

    def attend(l, q, k, v):
        if quantised and on_device:
            return _da.decode_attend_int8(q[:, :, 0], *qc, l, pos,
                                          k_new=k[:, :, 0], v_new=v[:, :, 0],
                                          split_pairs=pairs)
        _write_kv(cache, cfg, l, pos, k, v)
        if quantised:
            return _da.decode_attend_int8(q[:, :, 0], *qc, l, pos,
                                          split_pairs=pairs)
        return _dense_attend(q, cache["k"][l], cache["v"][l], valid, scale)

    logits = _step_layers(params, cfg, _step_input(params, cfg, token, pos),
                          wq, on_device, attend, _tp(mesh))
    if on_device:
        pos.add_(1)
    else:
        cache["len"] = pos + 1
    return logits, cache


def gpt_decode_step_functional(params: Params, cfg: GPTConfig, layers: Dict,
                               pos: torch.Tensor, token: torch.Tensor,
                               wq: Optional[Dict] = None
                               ) -> Tuple[torch.Tensor, Dict]:
    """``gpt_decode_step`` at a device position, as a pure function: the
    cache is ``layers`` (cache name -> tuple of one tensor a layer, (B, H,
    T, ...)), and the new cache comes back beside the logits, every layer
    a new tensor (``index_copy``, not ``index_copy_``); ``pos`` (1,) int64
    is read, not advanced.  The body of the exported program's decode
    ``scan`` (export.py), where no input may be written.  It calls no
    kernel wrapper, whatever the scope: the int8 products are
    ``_int8_mm``, the attention the plain one, which is the captured
    step's arithmetic with the kernels off, bit for bit."""
    quantised = cfg.cache_dtype in ("int8", "int4")
    new = {name: list(ts) for name, ts in layers.items()}
    if not quantised:
        valid = torch.arange(new["k"][0].shape[2], device=token.device) <= pos
        scale = 1.0 / cfg.head_dim ** 0.5

    def attend(l, q, k, v):
        for name, x in _cache_rows(cfg, k, v).items():
            new[name][l] = new[name][l].index_copy(2, pos, x)
        if quantised:
            return _da.decode_attend_int8_xla(
                q[:, :, 0], *(new[n][l][None] for n in
                              ("k", "v", "k_scale", "v_scale")), 0, pos)
        return _dense_attend(q, new["k"][l], new["v"][l], valid, scale)

    logits = _step_layers(params, cfg, _step_input(params, cfg, token, pos),
                          wq, False, attend)
    return logits, {name: tuple(ts) for name, ts in new.items()}


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


def _check_full(params: Params, cfg: GPTConfig, mesh) -> None:
    """Refuse to quantise a model-sharded block: a row-cut product's
    per-channel scales are the absmax over all of its input rows, which
    one rank does not hold (cut ``quantize_block_weights`` of the full
    weights with parallel/mesh.py::shard_block_weights)."""
    if local_heads(params, cfg, mesh) != cfg.n_head:
        raise ValueError("int8 block weights of a model-sharded GPT: pass "
                         "wq= cut from the full weights' "
                         "(parallel.mesh.shard_block_weights)")


class BlockWeightCache:
    """``quantize_block_weights`` kept beside the weights it came from: the
    pass over the block matrices is made on first use and again only after
    a matrix was replaced, moved, cast or changed in place (its
    ``_version``).  The matrices are held until then, so identity cannot be
    confused by a reused address.  A write through ``.data`` moves no
    version: call ``drop`` after one."""

    def __init__(self):
        self._held = None   # (matrices, their marks, quantised)
        self.passes = 0     # times the weights were quantised

    def get(self, blocks: Params) -> Dict:
        mats = [blocks[n]["w"] for n in BLOCK_MATRICES]
        marks = [(m._version, m.dtype, m.device) for m in mats]
        hit = self._held
        if hit is None or hit[1] != marks \
                or any(a is not b for a, b in zip(hit[0], mats)):
            hit = (mats, marks, quantize_block_weights(blocks))
            self._held = hit
            self.passes += 1
        return hit[2]

    def drop(self) -> None:
        self._held = None


def _segment_plan(start: int, steps: int, segments: int):
    """[(capacity, steps decoded at it)] of a decode of ``steps`` tokens
    after ``start`` prompt positions: the JAX formula's capacities
    (gpt.py:624-660) and how far each one carries the loop."""
    total_len = start + steps
    segments = max(1, min(segments, steps))
    caps = sorted({min(total_len, max(
        start + 1, -(-total_len * (i + 1) // segments)))
        for i in range(segments)})
    plan, done = [], 0
    for i, cap in enumerate(caps):
        seg = min(steps - done, cap - start - done)
        if i == len(caps) - 1:
            seg = steps - done
        plan.append((cap, max(seg, 0)))
        done += max(seg, 0)
    return plan


class _GenerateSession:
    """The static buffers of one ``gpt_generate`` shape and the programs
    over them (models/decode_graph.py): the KV cache at its full length,
    the position, the step counter, the logits the next token is sampled
    from, the uniforms of every step and the tokens.  One program serves a
    quantised cache (kernel E reads ``t <= pos`` whatever the capacity);
    a model-dtype cache has one a capacity, over a view of the first
    ``cap`` positions, because its attention reads the whole capacity and
    must sum as the eager segmented loop does."""

    def __init__(self, params, cfg, wq, batch, total_len, caps, steps,
                 sample, skw, device, mesh=None):
        self.device = device
        self.cache = init_kv_cache(cfg, batch, max_len=total_len,
                                   device=device,
                                   heads=local_heads(params, cfg, mesh))
        self.pos = torch.zeros(1, dtype=torch.int64, device=device)
        self.cache["len"] = self.pos
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        head = params["head"]["w"]
        self.logits = torch.zeros((batch, head.shape[1]), dtype=head.dtype,
                                  device=device)
        self.tokens = torch.zeros((batch, steps), dtype=torch.int64,
                                  device=device)
        self.u = (torch.full((steps,) + self.logits.shape, 0.5,
                             device=device) if sample else None)
        self.held = (params, wq)   # the addresses the programs bake in
        quantised = cfg.cache_dtype in ("int8", "int4")
        pool = (torch.cuda.graph_pool_handle() if device.type == "cuda"
                else None)

        def body(cache):
            def run():
                u = (None if self.u is None
                     else self.u.index_select(0, self.step)[0])
                tok = sample_logits(None, self.logits, sample=sample, u=u,
                                    **skw)
                self.tokens.index_copy_(1, self.step, tok[:, None])
                logits, _ = gpt_decode_step(params, cfg, cache, tok, wq,
                                            mesh=mesh)
                self.logits.copy_(logits)
                self.step.add_(1)
            return run

        def reset():
            self.pos.zero_()
            self.step.zero_()

        self._by_cap = {}
        for cap in ([total_len] if quantised else caps):
            view = dict(self.cache)
            if cap < total_len:
                view["k"] = self.cache["k"][:, :, :, :cap]
                view["v"] = self.cache["v"][:, :, :, :cap]
            self._by_cap[cap] = decode_graph.Program(
                body(view), device, reset, pool,
                None if mesh is None else mesh.warm_collectives)
        self._any = None if not quantised else self._by_cap[total_len]
        self.programs = list(self._by_cap.values())

    def begin(self, logits, u, start):
        """Load a request: the prefill's logits, the uniforms, the prompt
        length (the prefill has written ``self.cache``)."""
        self.logits.copy_(logits)
        if self.u is not None:
            self.u.copy_(u)
        self.pos.fill_(start)
        self.step.zero_()

    def replay(self, cap):
        (self._any or self._by_cap[cap]).replay()


def local_heads(params: Params, cfg: GPTConfig, mesh=None) -> int:
    """The heads ``params`` hold: all of them, or under a ``model`` axis
    this rank's share."""
    return _local_heads(_layer(params["blocks"], 0), cfg, _tp(mesh))


def draw_uniforms(generator: Optional[torch.Generator], n: int, b: int,
                  width: int, device, mesh=None) -> torch.Tensor:
    """(n, b, width) uniforms of this rank's ``b`` rows: drawn for the
    global batch (``b`` times the mesh's data axis) and cut to this rank's
    ``local_batch_slice``, so that a data-parallel decode samples the
    tokens one device samples from the same generator state; the model
    ranks of a data coordinate draw the same rows."""
    d = 1 if mesh is None else mesh.size("data")
    u = torch.rand((n, b * d, width), generator=generator, device=device)
    if d == 1:
        return u
    i = mesh.coord("data")
    return u[:, i * b:(i + 1) * b].contiguous()


def _generate_on_device(params, cfg, generator, cond_emb, given, steps,
                        segments, sample, skw, wq, holder, mesh=None):
    """``gpt_generate`` through a session of ``holder``: one eager prefill
    into the session's cache, then one replay a token.  The session is
    keyed by the kernel switch of the enclosing scope, which its programs
    bake in: one captured with the kernels off is never replayed with them
    on, nor the other way round; and by the mesh, whose communicators the
    programs record."""
    b, p = cond_emb.shape[0], cond_emb.shape[1]
    start = p + (0 if given is None else given.shape[1])
    plan = _segment_plan(start, steps, segments)
    caps = tuple(c for c, _ in plan)
    dev = cond_emb.device
    key = ("generate", decode_graph.tensors_token(params, wq), cfg, b,
           start + steps, caps, steps, sample, tuple(sorted(skw.items())),
           str(dev), None if mesh is None else mesh.token,
           _build.kernel_setting())
    sess = holder.session(key, lambda: _GenerateSession(
        params, cfg, wq, b, start + steps, caps, steps, sample, skw, dev,
        mesh))
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in sess.cache:
            sess.cache[name].zero_()
    # the prefill writes at host positions and sets a host length: hand it
    # the session's tensors under a dict of its own
    logits, _ = gpt_prefill(params, cfg, dict(sess.cache), given, cond_emb,
                            mesh=mesh)
    with profiling.span("gpt.decode"):
        u = (draw_uniforms(generator, steps, b, logits.shape[-1], dev, mesh)
             if sample else None)
        sess.begin(logits, u, start)
        for cap, seg in plan:
            for _ in range(seg):
                sess.replay(cap)
        return sess.tokens.clone()


def gpt_generate_eager(params, cfg, generator, cond_emb, given, steps,
                       segments, sample, skw, wq, mesh=None):
    """``gpt_generate``'s eager loop: a Python loop of ``gpt_decode_step``
    at host positions over a cache that grows by segments.  Returns (the
    new tokens (B, steps), the cache as the last step left it)."""
    b, p = cond_emb.shape[0], cond_emb.shape[1]
    t0 = 0 if given is None else given.shape[1]
    plan = _segment_plan(p + t0, steps, segments)
    cache = init_kv_cache(cfg, b, max_len=plan[0][0], device=cond_emb.device,
                          heads=local_heads(params, cfg, mesh))
    logits, cache = gpt_prefill(params, cfg, cache, given, cond_emb,
                                mesh=mesh)
    with profiling.span("gpt.decode"):
        u = (draw_uniforms(generator, steps, b, logits.shape[-1],
                           logits.device, mesh) if sample else None)
        toks = []
        for cap, seg in plan:
            cache = _grow_cache(cache, cap)
            for _ in range(seg):
                tok = sample_logits(None, logits, sample=sample,
                                    u=None if u is None else u[len(toks)],
                                    **skw)
                logits, cache = gpt_decode_step(params, cfg, cache, tok, wq,
                                                mesh=mesh)
                toks.append(tok)
        return torch.stack(toks, dim=1), cache


def gpt_generate(params: Params, cfg: GPTConfig,
                 generator: Optional[torch.Generator],
                 cond_emb: torch.Tensor,
                 given: Optional[torch.Tensor] = None, *, steps: int,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, sample: bool = True,
                 segments: int = 1, wq: Optional[Dict] = None,
                 graph=None, mesh=None) -> torch.Tensor:
    """KV-cached autoregressive generation: one prefill, then ``steps``
    cached single-token steps (the reference re-runs the full forward per
    token, minGPT.py:331-358).

    ``segments > 1`` grows the cache in stages so attention reads scale
    with the valid prefix; the capacities follow the JAX formula exactly
    (gpt.py:624-660), so one segment and several give the same tokens.
    With ``decode_weight_dtype="int8"`` the block weights are quantised
    once per call (gpt.py:633-636) unless the caller passes them as ``wq``
    (``BlockWeightCache`` keeps them across calls).  The sampling uniforms
    of all positions are drawn from ``generator`` up front, one
    (steps, B, V) tensor, so that speculative decoding can reuse them
    position for position.  Returns (B, T0 + steps) int64 tokens.

    ``graph`` chooses the loop.  None: on CUDA tensors the captured
    program (models/decode_graph.py: the sampling and the decode step of a
    token are one CUDA graph, replayed once a token, as the JAX loop is
    one ``lax.scan``), on CPU tensors the eager loop.  False: the eager
    loop, a Python loop of ``gpt_decode_step`` at host positions, on
    either device.  True: the device-position step on either device --
    captured on the card, run eagerly on the CPU (the same arithmetic,
    which the CPU tests hold against the JAX package).  A
    ``decode_graph.DecodeGraphs``: as True, its captures kept for the next
    call of the same shape (without one every call captures anew).  The
    loops give the same tokens; a failed capture raises.

    Inside ``_build.kernels(False)`` the decode runs through the plain
    versions of kernels A and E and of the int8 product's kernels,
    captured on the card all the same; the capture is keyed by the scope's
    switch.

    ``mesh`` (parallel/mesh.py) serves over ranks that step together:
    ``cond_emb`` and ``given`` are this rank's rows of the global batch
    (its ``local_batch_slice`` over ``data``), ``params`` and ``wq`` this
    rank's heads over ``model`` (``shard_gpt_for_serving``,
    ``shard_block_weights``: pass ``wq``, cut from the full weights'),
    and the sampling uniforms are the global batch's rows of this rank
    (``draw_uniforms``), so the tokens are the single device's.  A
    captured program records the collectives.
    """
    b, p = cond_emb.shape[0], cond_emb.shape[1]
    t0 = 0 if given is None else given.shape[1]
    skw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    if wq is None and cfg.decode_weight_dtype == "int8":
        _check_full(params, cfg, mesh)
        wq = quantize_block_weights(params["blocks"])
    if graph is None:
        graph = cond_emb.is_cuda
    if graph is not False:
        holder = graph if isinstance(graph, decode_graph.DecodeGraphs) \
            else decode_graph.DecodeGraphs()
        with torch.no_grad():
            out = _generate_on_device(params, cfg, generator, cond_emb,
                                      given, steps, segments, sample, skw,
                                      wq, holder, mesh)
    else:
        out, _ = gpt_generate_eager(params, cfg, generator, cond_emb, given,
                                    steps, segments, sample, skw, wq, mesh)
    if t0 > 0:
        out = torch.cat([given.long(), out], dim=1)
    return out


def gpt_generate_scan(params: Params, cfg: GPTConfig, cond_emb: torch.Tensor,
                      u: Optional[torch.Tensor], *, steps: int,
                      temperature: float = 1.0, top_k: Optional[int] = None,
                      top_p: Optional[float] = None, sample: bool = True,
                      segments: int = 1, wq: Optional[Dict] = None
                      ) -> torch.Tensor:
    """``gpt_generate`` as a pure function of tensors, the form that
    ``torch.export`` takes (export.py): one prefill, then the decode loop
    as ``torch._higher_order_ops.scan``s, the counterpart of the
    ``lax.scan``s of the JAX package's segmented ``gpt_generate``
    (gpt.py:624-660 there) -- one scan a capacity of ``_segment_plan``
    over a model-dtype cache, one at the full length over a quantised one,
    as the captured session keeps them.  The body samples a token and runs
    ``gpt_decode_step_functional``; the cache (one tensor a layer), the
    position and the logits are its carry.  ``u`` (steps, B, V) float32
    are the sampling uniforms that ``gpt_generate`` draws from its
    generator (None with ``sample=False``); the int8 block weights are
    quantised inside, as the JAX program quantises them per call.  Greedy
    and sampled tokens equal ``gpt_generate``'s with the kernels off.
    Returns (B, steps) int64."""
    from torch._higher_order_ops.scan import scan

    b, p = cond_emb.shape[0], cond_emb.shape[1]
    dev = cond_emb.device
    skw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    if wq is None and cfg.decode_weight_dtype == "int8":
        wq = quantize_block_weights(params["blocks"])
    quantised = cfg.cache_dtype in ("int8", "int4")
    plan = ([(p + steps, steps)] if quantised
            else _segment_plan(p, steps, segments))
    cache = init_kv_cache(cfg, b, max_len=plan[0][0], device=dev)
    logits, cache = gpt_prefill(params, cfg, cache, None, cond_emb)
    # one tensor a layer, so that a step writes (and copies) one layer's
    # slot, not the stacked cache
    layers = {name: tuple(t.clone() for t in cache[name].unbind(0))
              for name in cache if name != "len"}
    pos = torch.full((1,), p, dtype=torch.int64, device=dev)

    def body(carry, x):
        layers, pos, logits = carry
        tok = sample_logits(None, logits, sample=sample,
                            u=x if sample else None, **skw)
        logits, layers = gpt_decode_step_functional(params, cfg, layers, pos,
                                                    tok, wq)
        return (layers, pos + 1, logits), tok

    toks, done = [], 0
    for cap, seg in plan:
        if seg == 0:
            continue
        layers = {name: tuple(F.pad(t, (0, 0) * (t.ndim - 3) + (
            0, cap - t.shape[2])) for t in ts) for name, ts in layers.items()}
        xs = (u[done:done + seg] if sample
              else torch.arange(seg, device=dev))
        (layers, pos, logits), ys = scan(body, (layers, pos, logits), xs)
        toks.append(ys)
        done += seg
    return torch.cat(toks, dim=0).transpose(0, 1)
