"""The int8 decode stage: quantised inference mirrors of the VQ decoder (and
encoder) and of the MelGAN vocoder.

Counterpart of melspec_gpt_vqvae_tpu/models/quantized.py.  The JAX package
keeps this stage as an opt-in experiment (``--int8_decode``): its quality
gate passes, but on the TPU it runs slower than bfloat16 end to end
(per-conv requantisation and the vocoder's small-channel long convs).
It runs int8 ACTIVATIONS through the conv stacks, so every quantised conv
has a calibrated activation scale.

Pure functions walk the same layer structure as the port's modules
(models/vqvae.py ``Decoder`` / ``Encoder``, models/vocoder.py
``MelGANGenerator``), over those modules' own weights, with every hot conv
routed through a pluggable executor:

  * ``FloatConvs``  -- the plain convolutions; equal to the modules'
    forward (the correctness anchor);
  * ``CalibConvs``  -- float convs that also record each conv input's
    absmax, or a high quantile of |x| (the calibration pass);
  * ``Int8Convs``   -- calibrated int8 convs (ops/quant.py).

GroupNorm, the attention blocks and the nearest resize call the modules
themselves.  Kept float, as in the JAX package: the attention blocks'
1x1 convs, ``post_quant_conv`` / ``quant_conv`` and both final
``conv_out`` layers.  The vocoder's ConvTranspose upsamples quantise
through an exact polyphase rewrite into a width-2 regular conv
(``build_qstate(int8_transpose=...)``).  The JAX package's
``FusedConvs`` (its fused vocoder kernel) has its counterpart in
models/vocoder.py (kernel B); the int8 stage replaces it when it is on.

A conv is named by its module path with the port's module names
(``vq/decoder/mid_block_1/conv1``, ``voc/res_0_1/block_conv1``); the JAX
package's flax names map onto them as bridge.py maps weights
(``Conv_0`` -> ``conv1``, ``Conv_1`` -> ``conv2``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import VocoderConfig, VQVAEConfig
from ..ops.quant import (_interleave_phases, conv_float, conv_int8,
                         conv_transpose_polyphase, polyphase_from_transpose,
                         quantize_weight)

# the JAX package's default activation-scale calibration quantile
# (models/quantized.py:59-63 there: 0.9999 clips the heavy activation
# tail for +1.8 dB spectrogram SNR over absmax)
DEFAULT_PERCENTILE = 0.9999


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x.reshape(-1), q)`` (method "linear") as a float32
    0-d tensor, in its float32 arithmetic: position ``q * (n - 1)``,
    the two order statistics around it by ``torch.topk`` (only the tail
    above the position is selected, not the whole tensor sorted), and
    ``low * (1 - w) + high * w``."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    pos = np.float32(q) * np.float32(n - 1)
    low = int(min(max(np.floor(pos), 0), n - 1))
    high = int(min(max(np.ceil(pos), 0), n - 1))
    w_high = np.float32(pos - np.float32(np.floor(pos)))
    w_low = np.float32(1.0) - w_high
    top = torch.topk(flat, n - low, sorted=True).values   # descending
    lo_v, hi_v = top[n - 1 - low], top[n - 1 - high]
    return lo_v * float(w_low) + hi_v * float(w_high)


# ---------------------------------------------------------------------------
# conv executors
# ---------------------------------------------------------------------------


class FloatConvs:
    """Plain float convs (the parity anchor).  ``polyphase_transpose``
    takes the MelGAN upsamples through the exact width-2 polyphase conv
    (ops/quant.py ``conv_transpose_polyphase``) instead of the module's
    ConvTranspose1d."""

    polyphase_transpose = False

    def conv(self, path: str, x: torch.Tensor, m, **kw) -> torch.Tensor:
        return conv_float(x, m.weight, m.bias, **kw)

    def conv_transpose(self, path: str, x: torch.Tensor, m, ch: int,
                       r: int) -> torch.Tensor:
        """MelGAN upsample: the module (torch's crop built in), or its
        exact polyphase form."""
        if self.polyphase_transpose:
            return conv_transpose_polyphase(x, m.weight, m.bias, r)
        return m(x)

    def resblock_stack(self, path: str, x: torch.Tensor, blocks,
                       dilations) -> torch.Tensor:
        """One MelGAN upsample stage's chain of dilated ResnetBlocks
        (reference vocoder/modules.py:23-36), conv by conv."""
        for j, (blk, d) in enumerate(zip(blocks, dilations)):
            h = F.pad(F.leaky_relu(x, 0.2), (d, d), mode="reflect")
            h = self.conv(f"{path}_{j}/block_conv1", h, blk.block_conv1,
                          dilation=d)
            h = F.leaky_relu(h, 0.2)
            h = self.conv(f"{path}_{j}/block_conv2", h, blk.block_conv2)
            s = self.conv(f"{path}_{j}/shortcut", x, blk.shortcut)
            x = s + h
        return x


class CalibConvs(FloatConvs):
    """Float convs that record each conv input's absmax (0-d tensors on
    the activations' device, keyed by the conv's path).  ``percentile <
    1.0`` records that quantile of |x| instead of the max: heavy-tailed
    activations waste int8 resolution on rare outliers under pure
    absmax."""

    def __init__(self, percentile: float = 1.0):
        self.absmax: Dict[str, torch.Tensor] = {}
        self.percentile = percentile

    def _record(self, path: str, x: torch.Tensor) -> None:
        ax = x.float().abs()
        m = (ax.max() if self.percentile >= 1.0
             else quantile_linear(ax, self.percentile))
        prev = self.absmax.get(path)
        self.absmax[path] = m if prev is None else torch.maximum(prev, m)

    def conv(self, path, x, m, **kw):
        self._record(path, x)
        return super().conv(path, x, m, **kw)

    def conv_transpose(self, path, x, m, ch, r):
        self._record(path, x)
        return super().conv_transpose(path, x, m, ch, r)


class Int8Convs(FloatConvs):
    """Calibrated int8 convs over a qstate (``make_qstate``).  Inherits the
    conv-by-conv ``resblock_stack``, which routes every block conv through
    the int8 ``conv`` below."""

    def __init__(self, qstate: Dict):
        self.qstate = qstate

    def conv(self, path, x, m, **kw):
        return conv_int8(x, self.qstate["w8"][path], self.qstate["ws"][path],
                         m.bias, self.qstate["acts"][path], **kw)

    def conv_transpose(self, path, x, m, ch, r):
        """Polyphase int8 transpose conv; the float module where the path
        was not quantised (``int8_transpose=False`` builds)."""
        if path not in self.qstate["w8"]:
            return FloatConvs().conv_transpose(path, x, m, ch, r)
        y = conv_int8(F.pad(x, (1, 1)), self.qstate["w8"][path],
                      self.qstate["ws"][path], m.bias.repeat(r),
                      self.qstate["acts"][path])
        return _interleave_phases(y, r, ch, x.shape[2])


# ---------------------------------------------------------------------------
# VQ-VAE mirrors
# ---------------------------------------------------------------------------


def _resnet_block(blk, path: str, x: torch.Tensor, ex) -> torch.Tensor:
    """models/vqvae.py::ResnetBlock at inference."""
    h = ex.conv(f"{path}/conv1", F.silu(blk.norm1(x)), blk.conv1, padding=1)
    h = ex.conv(f"{path}/conv2", F.silu(blk.norm2(h)), blk.conv2, padding=1)
    if blk.nin_shortcut is not None:
        x = ex.conv(f"{path}/nin_shortcut", x, blk.nin_shortcut)
    return x + h


def decoder_apply(dec, cfg: VQVAEConfig, z: torch.Tensor,
                  ex) -> torch.Tensor:
    """models/vqvae.py::Decoder.forward (NCHW) through ``ex``."""
    num_res = len(cfg.ch_mult)
    curr_res = cfg.resolution // 2 ** (num_res - 1)
    h = ex.conv("vq/decoder/conv_in", z, dec.conv_in, padding=1)
    h = _resnet_block(dec.mid_block_1, "vq/decoder/mid_block_1", h, ex)
    h = dec.mid_attn_1(h)
    h = _resnet_block(dec.mid_block_2, "vq/decoder/mid_block_2", h, ex)
    for i_level in reversed(range(num_res)):
        for i_block in range(cfg.num_res_blocks + 1):
            name = f"up_{i_level}_block_{i_block}"
            h = _resnet_block(getattr(dec, name), f"vq/decoder/{name}", h,
                              ex)
            if curr_res in cfg.attn_resolutions:
                h = getattr(dec, f"up_{i_level}_attn_{i_block}")(h)
        if i_level != 0:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            name = f"up_{i_level}_upsample"
            h = ex.conv(f"vq/decoder/{name}/conv1", h,
                        getattr(dec, name).conv1, padding=1)
            curr_res *= 2
    # the final conv stays float: it writes the spectrogram
    return conv_float(F.silu(dec.norm_out(h)), dec.conv_out.weight,
                      dec.conv_out.bias, padding=1)


def decode_code_apply(vq, cfg: VQVAEConfig, code_grid: torch.Tensor,
                      ex) -> torch.Tensor:
    """models/vqvae.py::VQModel.decode_code: (B, h, w) codes -> (B, H, W,
    out_ch)."""
    b, h, w = code_grid.shape
    quant = vq.quantize.get_codebook_entry(code_grid.reshape(-1),
                                           (b, h, w, cfg.embedding_dim))
    z = conv_float(quant.permute(0, 3, 1, 2), vq.post_quant_conv.weight,
                   vq.post_quant_conv.bias)
    return decoder_apply(vq.decoder, cfg, z, ex).permute(0, 2, 3, 1)


def encoder_apply(enc, cfg: VQVAEConfig, x: torch.Tensor,
                  ex) -> torch.Tensor:
    """models/vqvae.py::Encoder.forward (NCHW) through ``ex``.  Kept
    float, as in the JAX package: the attention blocks and ``conv_out``
    (it feeds the argmin, where quantisation noise near a decision
    boundary flips codes)."""
    curr_res = cfg.resolution
    num_res = len(cfg.ch_mult)
    h = ex.conv("vq/encoder/conv_in", x, enc.conv_in, padding=1)
    for i_level in range(num_res):
        for i_block in range(cfg.num_res_blocks):
            name = f"down_{i_level}_block_{i_block}"
            h = _resnet_block(getattr(enc, name), f"vq/encoder/{name}", h,
                              ex)
            if curr_res in cfg.attn_resolutions:
                h = getattr(enc, f"down_{i_level}_attn_{i_block}")(h)
        if i_level != num_res - 1:
            # right / bottom padded stride-2 downsample
            name = f"down_{i_level}_downsample"
            h = ex.conv(f"vq/encoder/{name}/conv1", F.pad(h, (0, 1, 0, 1)),
                        getattr(enc, name).conv1, stride=2)
            curr_res //= 2
    h = _resnet_block(enc.mid_block_1, "vq/encoder/mid_block_1", h, ex)
    h = enc.mid_attn_1(h)
    h = _resnet_block(enc.mid_block_2, "vq/encoder/mid_block_2", h, ex)
    return conv_float(F.silu(enc.norm_out(h)), enc.conv_out.weight,
                      enc.conv_out.bias, padding=1)


def encode_to_indices_apply(vq, cfg: VQVAEConfig, x: torch.Tensor,
                            ex) -> torch.Tensor:
    """models/vqvae.py::VQModel.encode_to_indices: mel (B, H, W, 1) in
    [-1, 1] -> code grid (B, h, w) int32; the nearest index stays the
    float32 search (kernel C on the card)."""
    z = encoder_apply(vq.encoder, cfg, x.permute(0, 3, 1, 2), ex)
    z = conv_float(z, vq.quant_conv.weight, vq.quant_conv.bias)
    return vq.quantize.nearest_index(z)


# ---------------------------------------------------------------------------
# MelGAN mirror
# ---------------------------------------------------------------------------


def melgan_apply(melgan, cfg: VocoderConfig, mel: torch.Tensor,
                 ex) -> torch.Tensor:
    """models/vocoder.py::MelGANGenerator.forward through ``ex``: mel
    (B, T, n_mel) in [0, 1] -> waveform (B, T * prod(ratios))."""
    mult = 2 ** len(cfg.ratios)
    x = F.pad(mel.transpose(1, 2), (3, 3), mode="reflect")
    x = ex.conv("voc/conv_in", x, melgan.conv_in)
    for i, r in enumerate(cfg.ratios):
        ch = mult * cfg.ngf // 2
        x = ex.conv_transpose(f"voc/up_{i}", F.leaky_relu(x, 0.2),
                              getattr(melgan, f"up_{i}"), ch, r)
        x = ex.resblock_stack(f"voc/res_{i}", x, melgan.stage_blocks(i),
                              tuple(3 ** j
                                    for j in range(cfg.n_residual_layers)))
        mult //= 2
    x = F.pad(F.leaky_relu(x, 0.2), (3, 3), mode="reflect")
    # the final conv stays float: one output channel, the waveform
    x = conv_float(x, melgan.conv_out.weight, melgan.conv_out.bias)
    return torch.tanh(x)[:, 0]


# ---------------------------------------------------------------------------
# calibration + qstate
# ---------------------------------------------------------------------------


def _accumulate(acc: Dict[str, np.ndarray], absmax: Dict[str, torch.Tensor]):
    for k, v in absmax.items():
        acc[k] = np.maximum(acc.get(k, np.float32(0.0)),
                            np.float32(v.item()))


@torch.inference_mode()
def calibrate(vq, melgan, vcfg: VQVAEConfig, vocfg: VocoderConfig,
              code_grids: torch.Tensor, batch: int = 16,
              percentile: float = 1.0) -> Dict[str, np.ndarray]:
    """Per-conv activation absmax (or quantile) over calibration code grids
    (N, code_h, code_w) on the modules' device: the decoded spectrograms
    feed the vocoder's calibration.  Returns {path: float32} on the host,
    the maximum over the batches."""
    acc: Dict[str, np.ndarray] = {}
    for i in range(0, code_grids.shape[0], batch):
        ex = CalibConvs(percentile)
        spec = decode_code_apply(vq, vcfg, code_grids[i:i + batch], ex)[..., 0]
        mel01 = torch.clamp((spec.float() + 1.0) / 2.0, 0.0, 1.0)
        melgan_apply(melgan, vocfg, mel01.to(spec.dtype).transpose(1, 2), ex)
        _accumulate(acc, ex.absmax)
    return acc


def _resolve(modules: Dict, path: str):
    parts = path.split("/")
    node = modules[parts[0]]
    for part in parts[1:]:
        node = getattr(node, part)
    return node


@torch.no_grad()
def make_qstate(vq, melgan, acts: Dict[str, np.ndarray],
                transposes: Optional[Dict[str, int]] = None) -> Dict:
    """Quantise every calibrated conv's weights and pack the scales:
    {"acts": {path: s_x 0-d float32}, "w8": {path: int8 kernel}, "ws":
    {path: per-output-channel float32 scale}}, on the weights' device.
    ``transposes`` maps ConvTranspose paths to their stride ``r``; their
    kernels are rewritten to the polyphase regular-conv form first."""
    transposes = transposes or {}
    modules = {"vq": vq, "voc": melgan}
    qstate = {"acts": {}, "w8": {}, "ws": {}}
    for path, absmax in acts.items():
        kernel = _resolve(modules, path).weight
        if path in transposes:
            kernel = polyphase_from_transpose(kernel, transposes[path])
        w8, s_w = quantize_weight(kernel)
        qstate["w8"][path] = w8
        qstate["ws"][path] = s_w
        qstate["acts"][path] = torch.tensor(
            max(float(absmax), 1e-12) / 127.0, dtype=torch.float32,
            device=kernel.device)
    return qstate


def build_qstate(vq, melgan, vcfg: VQVAEConfig, vocfg: VocoderConfig, *,
                 n_calib: int = 32, batch: int = 16, seed: int = 0,
                 int8_transpose: bool = True,
                 percentile: float = DEFAULT_PERCENTILE) -> Dict:
    """Calibrate on seeded uniform random code grids (numpy's generator,
    so the JAX package's seed gives the same grids) and build the qstate:
    the ``int8_decode`` entry point of the pipeline.  ``int8_transpose``
    also quantises the vocoder's ConvTranspose upsamples through the
    polyphase rewrite; off, they stay float (``Int8Convs`` falls back per
    path)."""
    rng = np.random.default_rng(seed)
    grids = torch.as_tensor(rng.integers(
        0, vcfg.num_embeddings, (n_calib, vcfg.code_h, vcfg.code_w)),
        device=vq.quantize.embedding.device)
    acts = calibrate(vq, melgan, vcfg, vocfg, grids, batch=batch,
                     percentile=percentile)
    tr = {f"voc/up_{i}": r for i, r in enumerate(vocfg.ratios)}
    if not int8_transpose:
        acts = {k: v for k, v in acts.items() if k not in tr}
        tr = {}
    return make_qstate(vq, melgan, acts, transposes=tr)


@torch.inference_mode()
def build_encode_qstate(vq, vcfg: VQVAEConfig, mels: torch.Tensor, *,
                        batch: int = 16,
                        percentile: float = DEFAULT_PERCENTILE) -> Dict:
    """Calibrate the encoder on mel inputs (N, H, W, 1) in [-1, 1] and build
    its qstate (the int8 tokenize variant; not the parity path)."""
    acc: Dict[str, np.ndarray] = {}
    for i in range(0, mels.shape[0], batch):
        ex = CalibConvs(percentile)
        encoder_apply(vq.encoder, vcfg, mels[i:i + batch].permute(0, 3, 1, 2),
                      ex)
        _accumulate(acc, ex.absmax)
    return make_qstate(vq, None, acc)
