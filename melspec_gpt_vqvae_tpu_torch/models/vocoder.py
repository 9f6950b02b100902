"""MelGAN generator vocoder (inference path).

Counterpart of melspec_gpt_vqvae_tpu/models/vocoder.py (reference
vocoder/modules.py:23-80): reflect pad 3 + kernel-7 conv stem, one
ConvTranspose1d upsample stage per ratio (8, 8, 2, 2), each followed by
``n_residual_layers`` dilated ResnetBlocks (dilation 3**j), then LeakyReLU,
reflect pad 3, a kernel-7 conv to one channel and tanh.

Internally (B, C, T).  ``torch.nn.ConvTranspose1d(k=2r, stride=r,
padding=r//2 + r%2, output_padding=r%2)`` is exactly the JAX module's VALID
transpose followed by its crop (vocoder.py:63-72).  Each stage's resblock
stack runs through ops/vocoder_stack.py::fused_resblock_stack (kernel B on
the card), with the stage's weights packed once for the kernel and kept
here, beside the weights they were made from (``packed_stage``).
Submodule names follow the flax parameter tree (``conv_in``, ``up_{i}``,
``res_{i}_{j}``, ``conv_out``), so bridge.py maps weights by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import _build
from ..configs import VocoderConfig

from ..ops.vocoder_stack import fused_resblock_stack, pack


class MelGANResnetBlock(nn.Module):
    """(reference: vocoder/modules.py:23-36)"""

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.block_conv1 = nn.Conv1d(dim, dim, 3, dilation=dilation)
        self.block_conv2 = nn.Conv1d(dim, dim, 1)
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(x, 0.2)
        h = F.pad(h, (self.dilation, self.dilation), mode="reflect")
        h = F.leaky_relu(self.block_conv1(h), 0.2)
        return self.shortcut(x) + self.block_conv2(h)


class MelGANGenerator(nn.Module):
    """mel (B, T, n_mel) in [0, 1] -> waveform (B, T * prod(ratios))
    (reference: vocoder/modules.py:38-80)."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.cfg = cfg
        mult = 2 ** len(cfg.ratios)
        self.conv_in = nn.Conv1d(cfg.n_mel_channels, mult * cfg.ngf, 7)
        for i, r in enumerate(cfg.ratios):
            ch = mult * cfg.ngf // 2
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                mult * cfg.ngf, ch, 2 * r, stride=r,
                padding=r // 2 + r % 2, output_padding=r % 2))
            for j in range(cfg.n_residual_layers):
                self.add_module(f"res_{i}_{j}", MelGANResnetBlock(ch, 3 ** j))
            mult //= 2
        self.conv_out = nn.Conv1d(cfg.ngf, 1, 7)
        self._packed = {}   # stage -> (parameters, their marks, packed)
        self.packs = 0      # times a stage's weights were packed

    def stage_blocks(self, i: int):
        return [getattr(self, f"res_{i}_{j}")
                for j in range(self.cfg.n_residual_layers)]

    def packed_stage(self, i: int):
        """Stage ``i``'s weights as kernel B reads them
        (ops/vocoder_stack.py::pack), for the weights' own device and dtype.
        Packed on first use and again after a parameter was replaced, moved,
        cast or changed in place (its ``_version``).  The old parameters are
        held until then, so identity cannot be confused by a reused address.
        A write through ``.data`` moves no version: call ``drop_packed``
        after one."""
        blocks = self.stage_blocks(i)
        params = [p for blk in blocks for p in blk.parameters()]
        marks = [(p._version, p.dtype, p.device) for p in params]
        hit = self._packed.get(i)
        if hit is None or hit[1] != marks \
                or any(a is not b for a, b in zip(hit[0], params)):
            hit = (params, marks, pack(blocks, params[0].device,
                                       params[0].dtype))
            self._packed[i] = hit
            self.packs += 1
        return hit[2]

    def drop_packed(self):
        """Forget the packed weights; the next forward packs them anew."""
        self._packed.clear()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """With the kernels off (``_build.kernels(False)``) each stage's
        stack runs as plain convs (cuDNN on the card) in place of kernel
        B."""
        x = F.pad(mel.transpose(1, 2), (3, 3), mode="reflect")
        x = self.conv_in(x)
        for i in range(len(self.cfg.ratios)):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, 0.2))
            x = fused_resblock_stack(
                x, self.stage_blocks(i),
                self.packed_stage(i) if _build.use_kernel(x) else None)
        x = F.pad(F.leaky_relu(x, 0.2), (3, 3), mode="reflect")
        return torch.tanh(self.conv_out(x))[:, 0]
