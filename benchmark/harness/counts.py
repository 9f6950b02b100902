"""The table of peaks and the operations and bytes of the program's work,
counted from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates without
sparsity, at its 700 W limit.  A roofline share is the least time the
card could take (the larger of the bytes over the memory rate and the
operations over the peak of their type) over the measured time; each
input is counted as read once and each output as written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 494e12, "bf16": 989e12,
                  "fp8": 1979e12, "int8": 1979e12}


def bound_s(n_bytes: float, n_ops: float, kind: str) -> float:
    """The least seconds the card could take over ``n_bytes`` and
    ``n_ops`` operations of type ``kind``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


# ---------------------------------------------------------------------------
# kernel E: one decode step's attention over a quantised cache
# ---------------------------------------------------------------------------

CACHE_BYTES = {"int8": 1.0, "int4": 0.5}


def decode_attention_bytes(b: int, h: int, hd: int, rows: int,
                           cache: str = "int8", q_bytes: int = 2,
                           scale_bytes: int = 2, o_bytes: int = 4) -> float:
    """Bytes of one launch of kernel E at one layer: the ``rows`` cached
    keys and values (the new one included) and their scales, the query and
    the new key and value in, the float32 output out."""
    kv = 2 * rows * b * h * hd * CACHE_BYTES[cache]
    scales = 2 * rows * b * h * scale_bytes
    return kv + scales + 3 * b * h * hd * q_bytes + b * h * hd * o_bytes


def decode_attention_ops(b: int, h: int, hd: int, rows: int) -> float:
    """One multiply-add (2 operations) per cached value for the scores,
    one for the weighted sum of the values."""
    return 4.0 * b * h * rows * hd


def decode_attention_bound(b: int, h: int, hd: int, n_layer: int,
                           positions: Iterable[int],
                           cache: str = "int8") -> float:
    """Least seconds of kernel E over the decode steps at ``positions``
    (a step at position p reads rows 0..p), every layer."""
    t = 0.0
    for p in positions:
        t += bound_s(decode_attention_bytes(b, h, hd, p + 1, cache),
                     decode_attention_ops(b, h, hd, p + 1), "f32")
    return t * n_layer


# ---------------------------------------------------------------------------
# kernel B: a MelGAN stage's resblock stack
# ---------------------------------------------------------------------------

def resblock_stack_ops(b: int, c: int, t: int, n_blocks: int = 3) -> float:
    """A block is a dilated kernel-3 conv and two 1x1 convs (5 C^2
    multiply-adds a sample)."""
    return 2.0 * 5 * n_blocks * c * c * b * t


def resblock_stack_bytes(b: int, c: int, t: int, n_blocks: int = 3,
                         elt: int = 2) -> float:
    """The stage's input and output and its blocks' weights and biases."""
    return (2 * b * c * t + n_blocks * (5 * c * c + 3 * c)) * elt


def melgan_stages(n_mel_frames: int, ngf: int, ratios) -> list:
    """(C, T) of each upsample stage's resblock stack for one clip."""
    out, t, mult = [], n_mel_frames, 2 ** len(ratios)
    for r in ratios:
        t *= r
        out.append((mult * ngf // 2, t))
        mult //= 2
    return out


# ---------------------------------------------------------------------------
# kernel F: training attention, forward and backward
# ---------------------------------------------------------------------------

def visible_pairs(t: int, n_unmasked: int) -> int:
    """(query, key) pairs the minGPT mask lets through."""
    nu = min(int(n_unmasked), t)
    causal = t * (t + 1) // 2
    return causal + nu * (nu - 1) // 2


def flash_fwd_bytes(b, h, t, hd, masked: bool) -> float:
    """q, k, v and O (float32), the row log-sum-exp, the uint8 keep-mask."""
    return 4 * b * h * t * hd * 4 + b * h * t * 4 + (b * h * t * t
                                                     if masked else 0)


def flash_bwd_bytes(b, h, t, hd, masked: bool) -> float:
    """The forward's tensors, dO in and dQ, dK, dV out."""
    return flash_fwd_bytes(b, h, t, hd, masked) + 4 * b * h * t * hd * 4


def flash_fwd_ops(b, h, t, hd, n_unmasked) -> float:
    """Q K^T and P V over the visible pairs."""
    return 4.0 * b * h * visible_pairs(t, n_unmasked) * hd


def flash_bwd_ops(b, h, t, hd, n_unmasked) -> float:
    """The scores again, dV, dP, dQ and dK."""
    return 10.0 * b * h * visible_pairs(t, n_unmasked) * hd


def flash_bound(shape: Tuple[int, int, int, int], n_unmasked: int,
                masked: bool, backward: bool) -> float:
    b, h, t, hd = shape
    if backward:
        return bound_s(flash_bwd_bytes(b, h, t, hd, masked),
                       flash_bwd_ops(b, h, t, hd, n_unmasked), "tf32")
    return bound_s(flash_fwd_bytes(b, h, t, hd, masked),
                   flash_fwd_ops(b, h, t, hd, n_unmasked), "tf32")


# ---------------------------------------------------------------------------
# whole steps: useful operations
# ---------------------------------------------------------------------------

def gpt_fwd_flops(n_params: int, b: int, t: int, n_layer: int,
                  d: int) -> float:
    """One GPT pass: 2 P a token for the products plus the two attention
    products, 4 B T^2 D a layer (the step meter's arithmetic of the
    program's utils/profiling.py)."""
    return 2.0 * n_params * b * t + 4.0 * n_layer * b * t * t * d


def gpt_param_count(shapes: Dict[str, tuple]) -> int:
    return sum(int(torch.Size(s).numel()) for s in shapes.values())


def decode_flops_per_clip(model: Dict, positions: int) -> float:
    """The class GPT's products over one clip's ``positions`` positions
    (the prefill's and each decode step's whose logits choose a token):
    the block matrices and the head, 2 operations a weight a position,
    and the attention's two products over the positions before."""
    d, L, v = model["n_embd"], model["n_layer"], model["vocab_size"]
    per_pos = 2.0 * (L * 12 * d * d + d * v)
    attn = sum(4.0 * d * (p + 1) * L for p in range(positions))
    return per_pos * positions + attn


def conv_flops(module: torch.nn.Module, *inputs: torch.Tensor) -> float:
    """Operations of the products (convolutions, matrix products) of one
    forward of ``module`` on ``inputs``, counted by torch's flop counter
    from shapes (``meta`` tensors compute nothing)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        module(*inputs)
    return float(fc.get_total_flops())
