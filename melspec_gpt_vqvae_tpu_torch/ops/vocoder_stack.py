"""One MelGAN upsample stage's stack of dilated ResnetBlocks.

Counterpart of melspec_gpt_vqvae_tpu/ops/vocoder_pallas.py and of the
``FloatConvs`` / ``FusedConvs`` resblock executors in
melspec_gpt_vqvae_tpu/models/quantized.py:100-151:

  * ``resblock_stack`` -- the plain PyTorch version: the blocks one conv at
    a time in the working dtype (``FloatConvs.resblock_stack``);
  * ``fused_resblock_stack`` -- kernel B (csrc/vocoder_stack.cu) for CUDA
    tensors: the whole stack on a time tile in shared memory, one read and
    one write of the activation per stage; the plain version for CPU
    tensors.

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

_SMEM_BUDGET = 110 * 1024   # two blocks per SM
_SMEM_MAX = 227 * 1024


def resblock_stack(x: torch.Tensor, blocks: Sequence[nn.Module]):
    """x (B, C, T) through ``blocks`` (MelGANResnetBlock) one by one."""
    for blk in blocks:
        x = blk(x)
    return x


def _pack(blocks, device) -> torch.Tensor:
    """Per block [w3 (tap, c_in, c_out) | b3 | w2 (c_in, c_out) | b2 |
    ws (c_in, c_out) | bs], float32, the layout csrc/vocoder_stack.cu
    reads."""
    parts = []
    for blk in blocks:
        c1, c2, sc = blk.block_conv1, blk.block_conv2, blk.shortcut
        parts += [c1.weight.permute(2, 1, 0).reshape(-1), c1.bias,
                  c2.weight[:, :, 0].t().reshape(-1), c2.bias,
                  sc.weight[:, :, 0].t().reshape(-1), sc.bias]
    return torch.cat([p.detach().float() for p in parts]).to(device)


def _tile(c: int, itemsize: int, halo: int) -> int:
    """Samples per block: the largest multiple of 16 whose three
    C x (tile + 2 halo) buffers fit the two-blocks-per-SM budget, and at
    least 16."""
    cols = _SMEM_BUDGET // (3 * c * itemsize)
    tile = max(16, (cols - 2 * halo) // 16 * 16)
    if 3 * c * itemsize * (tile + 2 * halo) > _SMEM_MAX:
        raise ValueError(f"resblock kernel: C={c} does not fit shared memory")
    return tile


def fused_resblock_stack(x: torch.Tensor,
                         blocks: Sequence[nn.Module]) -> torch.Tensor:
    """A stage's resblock stack: kernel B on CUDA tensors, ``resblock_stack``
    on CPU tensors.  x (B, C, T) float32 or bfloat16, blocks' weights in the
    same dtype."""
    if _build.on_cpu(x):
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
    x = x.contiguous()
    w = _pack(blocks, x.device)
    tile = _tile(c, x.element_size(), sum(dils))
    d = dils + [0] * (3 - len(dils))
    out = torch.empty_like(x)
    _build.launch("msgv_resblock_stack", x.device, x.data_ptr(),
                  out.data_ptr(), w.data_ptr(), b, c, t, tile, len(dils),
                  d[0], d[1], d[2], int(x.dtype == torch.bfloat16))
    fused_resblock_stack.launches += 1
    return out


fused_resblock_stack.launches = 0
