"""Plain float32 VQ-VAE decoder and MelGAN generator: code grid ->
log-mel spectrogram -> waveform.

The VQ-VAE decoder follows the reference's ``vqvae/big_model_attn_gan.py``
(codebook lookup, a 1x1 post-quantisation conv, GroupNorm(32, eps 1e-6) +
swish ResnetBlocks, single-head attention at the configured resolutions, a
nearest-2x upsample and conv per level); MelGAN follows
``vocoder/modules.py`` (reflect pad 3 and a kernel-7 stem, per ratio a
ConvTranspose1d of kernel 2r and stride r then ``n_residual_layers``
dilated ResnetBlocks, LeakyReLU 0.2, reflect pad 3, a kernel-7 conv to one
channel, tanh).  Submodule and parameter names are the ones the weights
are drawn under (``state_dict`` keys), so one set of seeded tensors loads
into this module and into the program's alike.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _group_norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, c), c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _group_norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _group_norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm1 = _group_norm(c)
        self.q, self.k = nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1)
        self.v, self.proj_out = nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm1(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
        att = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=2)
        out = torch.bmm(att, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv1(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Decoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        mult = cfg["ch_mult"]
        res = cfg["resolution"] // 2 ** (len(mult) - 1)
        c = cfg["ch"] * mult[-1]
        self.conv_in = nn.Conv2d(cfg["z_channels"], c, 3, padding=1)
        self.order: List[str] = []
        self._add("mid_block_1", ResnetBlock(c, c))
        self._add("mid_attn_1", AttnBlock(c))
        self._add("mid_block_2", ResnetBlock(c, c))
        for i in reversed(range(len(mult))):
            c_out = cfg["ch"] * mult[i]
            for j in range(cfg["num_res_blocks"] + 1):
                self._add(f"up_{i}_block_{j}", ResnetBlock(c, c_out))
                c = c_out
                if res in cfg["attn_resolutions"]:
                    self._add(f"up_{i}_attn_{j}", AttnBlock(c))
            if i != 0:
                self._add(f"up_{i}_upsample", Upsample(c))
                res *= 2
        self.norm_out = _group_norm(c)
        self.conv_out = nn.Conv2d(c, cfg["out_ch"], 3, padding=1)

    def _add(self, name, module):
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, z):
        h = self.conv_in(z)
        for name in self.order:
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class _Codebook(nn.Module):
    def __init__(self, k: int, d: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(k, d))


class VQDecode(nn.Module):
    """(B, code_h, code_w) code grid -> (B, H, W) spectrogram in [-1, 1]
    range of the decoder's output channel 0."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        self.quantize = _Codebook(cfg["num_embeddings"], cfg["embedding_dim"])
        self.post_quant_conv = nn.Conv2d(cfg["embedding_dim"],
                                         cfg["z_channels"], 1)
        self.decoder = Decoder(cfg)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        quant = self.quantize.embedding[grid.long()]      # (B, h, w, D)
        x = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        return self.decoder(x)[:, 0]


class MelGANResnetBlock(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.block_conv1 = nn.Conv1d(dim, dim, 3, dilation=dilation)
        self.block_conv2 = nn.Conv1d(dim, dim, 1)
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        h = F.pad(F.leaky_relu(x, 0.2), (self.dilation, self.dilation),
                  mode="reflect")
        h = F.leaky_relu(self.block_conv1(h), 0.2)
        return self.shortcut(x) + self.block_conv2(h)


class MelGAN(nn.Module):
    """mel (B, n_mel, T) in [0, 1] -> waveform (B, T * prod(ratios))."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        mult = 2 ** len(cfg["ratios"])
        ngf = cfg["ngf"]
        self.conv_in = nn.Conv1d(cfg["n_mel_channels"], mult * ngf, 7)
        for i, r in enumerate(cfg["ratios"]):
            ch = mult * ngf // 2
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                mult * ngf, ch, 2 * r, stride=r, padding=r // 2 + r % 2,
                output_padding=r % 2))
            for j in range(cfg["n_residual_layers"]):
                self.add_module(f"res_{i}_{j}", MelGANResnetBlock(ch, 3 ** j))
            mult //= 2
        self.conv_out = nn.Conv1d(ngf, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(F.pad(mel, (3, 3), mode="reflect"))
        for i in range(len(self.cfg["ratios"])):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, 0.2))
            for j in range(self.cfg["n_residual_layers"]):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = F.pad(F.leaky_relu(x, 0.2), (3, 3), mode="reflect")
        return torch.tanh(self.conv_out(x))[:, 0]


def spec_to_mel01(spec: torch.Tensor) -> torch.Tensor:
    """Decoder output (B, H, W) in [-1, 1] -> the vocoder's [0, 1] input
    (B, H, W) (the dataset's scaling, datasets/vas.py:81)."""
    return torch.clamp((spec + 1.0) / 2.0, 0.0, 1.0)


def weight_specs(module: nn.Module) -> List[Tuple[str, tuple, str, int]]:
    """(state_dict name, shape, kind, fan-in) of every parameter, in a
    fixed order: kind is "conv" (a kernel; fan-in as the flax LeCun
    initialiser reads it, a transposed conv's over its output channels and
    taps), "bias", "norm_scale", "norm_bias" or "codebook"."""
    out = []
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, nn.ConvTranspose1d):
            w = m.weight
            out.append((pre + "weight", tuple(w.shape), "conv",
                        w.shape[1] * w.shape[2]))
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            w = m.weight
            out.append((pre + "weight", tuple(w.shape), "conv",
                        int(w[0].numel())))
        elif isinstance(m, nn.GroupNorm):
            out.append((pre + "weight", tuple(m.weight.shape), "norm_scale",
                        0))
            out.append((pre + "bias", tuple(m.bias.shape), "norm_bias", 0))
            continue
        elif isinstance(m, _Codebook):
            out.append((pre + "embedding", tuple(m.embedding.shape),
                        "codebook", 0))
            continue
        else:
            continue
        if m.bias is not None:
            out.append((pre + "bias", tuple(m.bias.shape), "bias", 0))
    return out


@torch.no_grad()
def detok(vq: VQDecode, melgan: MelGAN, tokens: torch.Tensor, code_h: int,
          code_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GPT-order tokens (B, code_h * code_w) -> (spectrograms (B, H, W),
    waveforms (B, samples)), float32.  The GPT's order is time-major: the
    grid is ``tokens.reshape(B, code_w, code_h)`` transposed."""
    grid = tokens.reshape(-1, code_w, code_h).transpose(1, 2)
    spec = vq(grid)
    wav = melgan(spec_to_mel01(spec))
    return spec, wav
