"""SpecVQGAN-style VQ-VAE: encoder, decoder, quantiser and the GAN pieces.

Counterpart of melspec_gpt_vqvae_tpu/models/vqvae.py (reference
vqvae/big_model_attn_gan.py:8-392, 465-514, 538-660): GroupNorm(min(32,
C), eps 1e-6) + swish ResnetBlocks, single-head 2-D self-attention, a
right/bottom-padded stride-2 Downsample, a nearest-2x Upsample, the
L2-argmin quantiser with its two latent losses and straight-through
output, whose nearest-index search is kernel C on the card (ops/vq.py),
and for training the PatchGAN ``NLayerDiscriminator``, the hinge loss, the
adaptive generator weight and the code-usage histogram.

Modules compute in NCHW.  The public methods of ``VQModel`` and the
quantiser keep the JAX package's layouts: ``encode`` / ``forward`` /
``encode_to_indices`` take (B, H, W, 1), latents are (B, h, w, D), and
``decode`` / ``decode_code`` / ``forward`` return (B, H, W, out_ch).
Submodule names follow the flax parameter tree (``down_{i}_block_{j}``,
``mid_attn_1``, ``Conv_0``, ``BatchNorm_0``, ...), so bridge.py maps
weights by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import VQVAEConfig

from ..ops.vq import vq_lookup, vq_nearest_index


def _group_norm(c: int) -> nn.GroupNorm:
    """GroupNorm(32) at reference widths; the group count is clamped for
    narrow test configs."""
    return nn.GroupNorm(min(32, c), c, eps=1e-6)


class ResnetBlock(nn.Module):
    """GroupNorm-swish-conv x2 with a 1x1 shortcut on channel change
    (reference: big_model_attn_gan.py:75-135)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                             if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over all H*W positions
    (reference: big_model_attn_gan.py:397-450); plain matmuls with float32
    scores, as the JAX module leaves this to XLA."""

    def __init__(self, c: int):
        super().__init__()
        self.norm1 = _group_norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm1(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
        att = torch.softmax(torch.bmm(q.float(), k.float()) * c ** -0.5, 2)
        out = torch.bmm(att.to(v.dtype).float(), v.float()).to(x.dtype)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 conv
    (reference: big_model_attn_gan.py:145-162)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv1(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a conv (reference: big_model_attn_gan.py:171-186)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv1(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Encoder(nn.Module):
    """(B, 1, H, W) -> (B, z, H/16, W/16)
    (reference: big_model_attn_gan.py:190-282)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.layers = []
        c, res = cfg.ch, cfg.resolution
        num_res = len(cfg.ch_mult)
        for i in range(num_res):
            c_out = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks):
                self._add(f"down_{i}_block_{j}", ResnetBlock(c, c_out))
                c = c_out
                if res in cfg.attn_resolutions:
                    self._add(f"down_{i}_attn_{j}", AttnBlock(c))
            if i != num_res - 1:
                self._add(f"down_{i}_downsample", Downsample(c))
                res //= 2
        self._add("mid_block_1", ResnetBlock(c, c))
        self._add("mid_attn_1", AttnBlock(c))
        self._add("mid_block_2", ResnetBlock(c, c))
        self.norm_out = _group_norm(c)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(c, z_out, 3, padding=1)

    def _add(self, name, module):
        self.add_module(name, module)
        self.layers.append(module)

    def forward(self, x):
        h = self.conv_in(x)
        for layer in self.layers:
            h = layer(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """(B, z, h, w) -> (B, out_ch, 16 h, 16 w)
    (reference: big_model_attn_gan.py:291-392)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        num_res = len(cfg.ch_mult)
        res = cfg.resolution // 2 ** (num_res - 1)
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, c, 3, padding=1)
        self.layers = []
        self._add("mid_block_1", ResnetBlock(c, c))
        self._add("mid_attn_1", AttnBlock(c))
        self._add("mid_block_2", ResnetBlock(c, c))
        for i in reversed(range(num_res)):
            c_out = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                self._add(f"up_{i}_block_{j}", ResnetBlock(c, c_out))
                c = c_out
                if res in cfg.attn_resolutions:
                    self._add(f"up_{i}_attn_{j}", AttnBlock(c))
            if i != 0:
                self._add(f"up_{i}_upsample", Upsample(c))
                res *= 2
        self.norm_out = _group_norm(c)
        self.conv_out = nn.Conv2d(c, cfg.out_ch, 3, padding=1)

    _add = Encoder._add

    def forward(self, z):
        h = self.conv_in(z)
        for layer in self.layers:
            h = layer(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """Codebook + L2-argmin quantisation
    (reference: big_model_attn_gan.py:8-71)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.embedding = nn.Parameter(
            torch.zeros(num_embeddings, embedding_dim))

    def forward(self, z: torch.Tensor):
        """NHWC latents (B, h, w, D) -> (loss, quantised straight-through
        (B, h, w, D), (perplexity, int32 indices (B, h, w))).  The nearest
        index takes detached inputs (kernel C has no gradient), as the JAX
        package stops the gradient of its argmin's inputs."""
        b, h, w, d = z.shape
        idx = vq_nearest_index(z.detach().reshape(-1, d),
                               self.embedding.detach())
        quant = vq_lookup(idx, self.embedding).reshape(z.shape)
        e_latent_loss = torch.mean((quant.detach() - z) ** 2)
        q_latent_loss = torch.mean((quant - z.detach()) ** 2)
        loss = q_latent_loss + self.commitment_cost * e_latent_loss
        quant_st = z + (quant - z).detach()
        k = self.embedding.shape[0]
        onehot_mean = codebook_usage_counts(idx, k).float() / idx.numel()
        perplexity = torch.exp(-torch.sum(
            onehot_mean * torch.log(onehot_mean + 1e-10)))
        return loss, quant_st, (perplexity, idx.reshape(b, h, w))

    def nearest_index(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents (B, D, h, w) -> int32 code grid (B, h, w)."""
        b, d, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, d)
        return vq_nearest_index(flat, self.embedding).reshape(b, h, w)

    def get_codebook_entry(self, indices: torch.Tensor, shape):
        """indices (N,) -> NHWC latents of ``shape`` (b, h, w, c)
        (reference: big_model_attn_gan.py:56-71)."""
        return vq_lookup(indices, self.embedding).reshape(shape)


class VQModel(nn.Module):
    """``LitVQVAE`` (reference: big_model_attn_gan.py:538-634)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim,
                                        cfg.commitment_cost)
        z_enc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = nn.Conv2d(z_enc, cfg.embedding_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embedding_dim, cfg.z_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 1) -> pre-quant latents (B, h, w, D)."""
        z = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return z.permute(0, 2, 3, 1)

    def encode_to_indices(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 1) -> code grid (B, h, w) int32
        (reference: feature_extraction/extract_codes.py:48-50).  With the
        kernels off the plain argmin runs on the card."""
        z = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return self.quantize.nearest_index(z)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """Quantised latents (B, h, w, D) -> (B, H, W, out_ch)."""
        out = self.decoder(self.post_quant_conv(quant.permute(0, 3, 1, 2)))
        return out.permute(0, 2, 3, 1)

    def decode_code(self, code_grid: torch.Tensor) -> torch.Tensor:
        """(B, h, w) indices -> reconstruction (B, H, W, out_ch)."""
        b, h, w = code_grid.shape
        return self.decode(self.quantize.get_codebook_entry(
            code_grid.reshape(-1), (b, h, w, self.cfg.embedding_dim)))

    def forward(self, x: torch.Tensor):
        """x (B, H, W, 1) -> (quantiser loss, reconstruction (B, H, W,
        out_ch), (perplexity, indices (B, h, w)))."""
        loss, quant, info = self.quantize(self.encode(x))
        return loss, self.decode(quant), info


# ---------------------------------------------------------------------------
# PatchGAN discriminator + GAN losses (training path)
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.99): parameters ``scale``
    and ``bias``, running statistics ``mean`` and ``var`` (buffers).  In
    train mode it normalises with the batch's statistics and the biased
    variance (``F.batch_norm`` without running buffers), and with
    ``update_stats`` moves the running ones by flax's rule, ``ra = 0.99 ra
    + 0.01 batch``, the variance biased too (torch's ``BatchNorm2d`` keeps
    the unbiased one at momentum 0.1).  In eval mode it normalises with
    the running statistics, as flax's ``use_running_average``."""

    EPS, MOMENTUM = 1e-5, 0.99

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.EPS)
        if update_stats:
            with torch.no_grad():
                xd = x.detach().float()
                mean = xd.mean((0, 2, 3))
                var = (xd * xd).mean((0, 2, 3)) - mean * mean
                m = self.MOMENTUM
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var.clamp_min(0.0))
        return F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0,
                            self.EPS)


class NLayerDiscriminator(nn.Module):
    """PatchGAN (reference: big_model_attn_gan.py:465-514): 4x4 convs with
    padding 1, leaky ReLU 0.2; ``Conv_0`` (stride 2, bias), ``Conv_1`` ..
    ``Conv_{n-1}`` (stride 2) and ``Conv_n`` (stride 1) without bias, each
    followed by ``BatchNorm_{i-1}``, and the 1-channel ``Conv_{n+1}``
    (stride 1, bias)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.Conv_0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        c = ndf
        for n in range(1, n_layers + 1):
            c_out = ndf * min(2 ** n, 8)
            setattr(self, f"Conv_{n}",
                    nn.Conv2d(c, c_out, 4, stride=2 if n < n_layers else 1,
                              padding=1, bias=False))
            setattr(self, f"BatchNorm_{n - 1}", BatchNorm(c_out))
            c = c_out
        setattr(self, f"Conv_{n_layers + 1}",
                nn.Conv2d(c, 1, 4, stride=1, padding=1))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        """x (B, H, W, C) -> logits (B, h, w, 1), the flax layouts.  In
        train mode each BatchNorm uses the batch's statistics and, with
        ``update_stats``, moves its running ones."""
        h = F.leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"Conv_{n}")(h)
            h = F.leaky_relu(getattr(self, f"BatchNorm_{n - 1}")(
                h, update_stats), 0.2)
        h = getattr(self, f"Conv_{self.n_layers + 1}")(h)
        return h.permute(0, 2, 3, 1)


def hinge_d_loss(logits_real, logits_fake):
    """(reference: big_model_attn_gan.py:643-647)"""
    loss_real = torch.mean(F.relu(1.0 - logits_real))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake))
    return 0.5 * (loss_real + loss_fake)


def adaptive_gan_weight(nll_grad_norm, g_grad_norm, disc_weight,
                        min_w=0.0, max_w=1e4):
    """d_weight = |grad nll| / (|grad g| + 1e-4), clipped, times
    ``disc_weight`` (reference: big_model_attn_gan.py:649-660).  Callers
    take the two gradient norms at the decoder's last conv kernel."""
    w = nll_grad_norm / (g_grad_norm + 1e-4)
    return torch.clamp(w, min_w, max_w) * disc_weight


def codebook_usage_counts(indices, num_embeddings: int) -> torch.Tensor:
    """Histogram of code usage, int64 (num_embeddings,) (reference
    counters: big_model_attn_gan.py:581,630-633,795-804)."""
    return torch.bincount(indices.reshape(-1).long(),
                          minlength=num_embeddings)
