"""One MelGAN upsample stage's stack of dilated ResnetBlocks.

Counterpart of melspec_gpt_vqvae_tpu/ops/vocoder_pallas.py and of the
``FloatConvs`` / ``FusedConvs`` resblock executors in
melspec_gpt_vqvae_tpu/models/quantized.py:100-151:

  * ``resblock_stack`` -- the plain PyTorch version: the blocks one conv at
    a time in the working dtype (``FloatConvs.resblock_stack``);
  * ``fused_resblock_stack`` -- kernel B (csrc/vocoder_stack.cu) for CUDA
    tensors: the whole stack on a time tile in shared memory, one read and
    one write of the activation per stage (bfloat16: products on the tensor
    cores from weights packed by ``pack_bf16``); the plain version for CPU
    tensors.  The module that owns the blocks packs their weights once
    (models/vocoder.py::MelGANGenerator.packed_stage) and hands them in.

Each block reflect-pads its own input at the sequence ends (reference
vocoder/modules.py:30), and the kernel does the same by reading mirrored
columns, so no edge patch (the JAX package's ``FusedConvs`` clamped-window
fix) is needed.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .. import _build

_SMEM_BUDGET = 110 * 1024   # float32 kernel: two blocks per SM
_SMEM_MAX = 227 * 1024      # what one block can use (232,448 bytes)
N_SM = 132                  # streaming multiprocessors of an H100
BF16_CHANNELS = (32, 64, 128, 256)
_SLICE = 32                 # input channels per packed weight slice
_STAGES = 3                 # weight slices in the kernel's shared-memory ring


def resblock_stack(x: torch.Tensor, blocks: Sequence[nn.Module]):
    """x (B, C, T) through ``blocks`` (MelGANResnetBlock) one by one."""
    for blk in blocks:
        x = blk(x)
    return x


def _convs(blk):
    return blk.block_conv1, blk.shortcut, blk.block_conv2


def pack_f32(blocks, device) -> torch.Tensor:
    """Per block [w3 (tap, c_in, c_out) | b3 | w2 (c_in, c_out) | b2 |
    ws (c_in, c_out) | bs], float32, the layout the float32 kernel of
    csrc/vocoder_stack.cu reads."""
    parts = []
    for blk in blocks:
        c1, sc, c2 = _convs(blk)
        parts += [c1.weight.permute(2, 1, 0).reshape(-1), c1.bias,
                  c2.weight[:, :, 0].t().reshape(-1), c2.bias,
                  sc.weight[:, :, 0].t().reshape(-1), sc.bias]
    return torch.cat([p.detach().float() for p in parts]).to(device)


def pack_bf16(blocks, device):
    """The bfloat16 kernel's operands: (w, bias).

    ``w`` (n_blocks, 5 C / 32, C, 32) bfloat16: slices of 32 input channels,
    each [c_out][c_in] as the tensor-core B operand wants it, in the order
    the kernel consumes them -- conv3 tap 0, 1, 2, then the shortcut, then
    conv1, each over c_in in steps of 32.  bfloat16 weights pack exactly;
    float32 weights are rounded to nearest even.  ``bias`` (n_blocks, 3, C)
    float32: b3, bs, b2."""
    ws, bs = [], []
    for blk in blocks:
        c1, sc, c2 = _convs(blk)
        c = c1.weight.shape[0]
        mats = [c1.weight[:, :, k] for k in range(3)] \
            + [sc.weight[:, :, 0], c2.weight[:, :, 0]]
        # (c_out, c_in) -> (c_in / 32, c_out, 32)
        ws.append(torch.cat([m.detach().reshape(c, c // _SLICE, _SLICE)
                             .permute(1, 0, 2) for m in mats]))
        bs.append(torch.stack([c1.bias, sc.bias, c2.bias]).detach())
    w = torch.stack(ws).to(device=device, dtype=torch.bfloat16).contiguous()
    return w, torch.stack(bs).to(device=device, dtype=torch.float32) \
        .contiguous()


def unpack_bf16(w: torch.Tensor, bias: torch.Tensor):
    """Inverse of ``pack_bf16``: per block (conv3 weight (C, C, 3), b3,
    shortcut weight (C, C, 1), bs, conv1 weight (C, C, 1), b2)."""
    n, slices, c, _ = w.shape
    s = c // _SLICE
    out = []
    for j in range(n):
        mats = [w[j, i * s:(i + 1) * s].permute(1, 0, 2).reshape(c, c)
                for i in range(5)]
        out.append((torch.stack(mats[:3], dim=-1), bias[j, 0],
                    mats[3][:, :, None], bias[j, 1],
                    mats[4][:, :, None], bias[j, 2]))
    return out


def pack(blocks, device, dtype):
    """The kernel's weight operand for activations of ``dtype``:
    ``pack_bf16``'s (w, bias) for bfloat16, ``pack_f32``'s block for
    float32."""
    if dtype == torch.bfloat16:
        return pack_bf16(blocks, device)
    return pack_f32(blocks, device)


def _tile(c: int, itemsize: int, halo: int) -> int:
    """float32 kernel, samples per block: the largest multiple of 16 whose
    three C x (tile + 2 halo) buffers fit the two-blocks-per-SM budget, and
    at least 16."""
    cols = _SMEM_BUDGET // (3 * c * itemsize)
    tile = max(16, (cols - 2 * halo) // 16 * 16)
    if 3 * c * itemsize * (tile + 2 * halo) > _SMEM_MAX:
        raise ValueError(f"resblock kernel: C={c} does not fit shared memory")
    return tile


def bf16_tile(c: int, t: int, batch: int, dils: Sequence[int]) -> int:
    """bfloat16 kernel, samples per block.  One block per SM with the whole
    227 KB: two time-major buffers of (tile + 2 halo) x (C + 8), the chunk
    buffer of 32 * kWM rows (kWM = 8 / max(1, C / 64) warps along time) and
    the ring of weight slices.  Block j of the stack computes
    tile + 2 (halo - d_0 - .. - d_j) samples in whole chunks.  Among the
    tile counts that fit, take the one with the least (waves of blocks over
    the SMs) x (rows a block computes), so neither the last wave nor the
    last chunk is mostly idle."""
    halo = sum(dils)
    row = 2 * (c + 8)                                   # bytes per column
    chunk = 32 * (8 // max(1, c // 64))
    fixed = chunk * row + _STAGES * c * 2 * (_SLICE + 8)
    tile_max = min(t, (_SMEM_MAX - fixed) // (2 * row) - 2 * halo)
    if tile_max < max(dils):
        raise ValueError(f"resblock kernel: C={c} does not fit shared memory")

    def cost(n):
        tile, rows, e = -(-t // n), 0, halo
        for d in dils:
            e -= d
            rows += -(-(tile + 2 * e) // chunk) * chunk
        return -(-n * batch // N_SM) * rows

    least = -(-t // tile_max)
    n = min(range(least, min(t, least + 4 * N_SM) + 1),
            key=lambda n: (cost(n), n))
    return -(-t // n)


def fused_resblock_stack(x: torch.Tensor, blocks: Sequence[nn.Module],
                         packed=None) -> torch.Tensor:
    """A stage's resblock stack: kernel B on CUDA tensors, ``resblock_stack``
    on CPU tensors or with the kernels off (``_build.use_kernel``).
    x (B, C, T) float32 or bfloat16, blocks' weights in the same dtype.  bfloat16 runs on the tensor cores (C in 32, 64, 128, 256),
    float32 as float FMA.  ``packed`` is ``pack(blocks, x.device, x.dtype)``
    kept by the caller; without it the weights are packed for this launch."""
    if not _build.use_kernel(x):
        return resblock_stack(x, blocks)
    b, c, t = x.shape
    dils = [blk.dilation for blk in blocks]
    if not 1 <= len(dils) <= 3 or c % 32 or t <= max(dils):
        raise ValueError(f"resblock kernel takes 1-3 blocks, C a multiple of "
                         f"32 and T > max dilation; got dilations {dils}, "
                         f"C={c}, T={t}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resblock kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if blocks[0].block_conv1.weight.dtype != x.dtype:
        raise TypeError(f"resblock kernel: x is {x.dtype}, the weights "
                        f"{blocks[0].block_conv1.weight.dtype}")
    x = x.contiguous()
    if packed is None:
        packed = pack(blocks, x.device, x.dtype)
    d = dils + [0] * (3 - len(dils))
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        if c not in BF16_CHANNELS:
            raise ValueError(f"the bfloat16 resblock kernel takes C in "
                             f"{BF16_CHANNELS}, got {c}")
        w, bias = packed
        tile = bf16_tile(c, t, b, dils)
        _build.launch("msgv_resblock_stack_bf16", x.device, x.data_ptr(),
                      out.data_ptr(), w.data_ptr(), bias.data_ptr(), b, c, t,
                      tile, len(dils), d[0], d[1], d[2])
    else:
        w = packed
        tile = _tile(c, x.element_size(), sum(dils))
        _build.launch("msgv_resblock_stack", x.device, x.data_ptr(),
                      out.data_ptr(), w.data_ptr(), b, c, t, tile, len(dils),
                      d[0], d[1], d[2])
    fused_resblock_stack.launches += 1
    return out


fused_resblock_stack.launches = 0
