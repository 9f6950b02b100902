"""Reference checkpoints into the port: the VQ-VAE, the MelGAN and minGPT.

Counterpart of melspec_gpt_vqvae_tpu/utils/convert.py:29-299.  The
reference keeps three frozen artifacts (SURVEY.md §5): the VQ-VAE's raw
``state_dict`` (big_model_attn_gan.py names: ``_encoder.down.{i}.block.{j}``,
``_vq_vae._embedding.weight``, ``quant_conv``, ...), the MelGAN
``best_netG.pt`` beside its ``args.yml``, and Lightning minGPT checkpoints.
The source is torch already, so conv weights keep their (O, I, k...) and
ConvTranspose (I, O, k) layouts and only the names change; weight-norm
``weight_g`` / ``weight_v`` pairs are folded (w = g v / |v|), and minGPT's
``Linear`` weights go from (out, in) to the port's (in, out) with q, k, v
fused in that order (convert.py:253-254 there).

Native checkpoints of the JAX package (orbax directories) need JAX to
read: ``scripts/torch_convert_orbax.py`` turns them into files these
loaders take on a machine without it.  A file whose names are already the
port's (what that script writes) loads as it is.  The VQ-VAE loader also
takes the port's own VQ-GAN runs (train_vqvae.py), the counterpart of the
JAX loader's native directory: a checkpoint directory that the port's
``CheckpointManager`` wrote, a run directory holding
``checkpoints/version_N``, or one of its ``.pt`` files.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import torch

from ..configs import VocoderConfig, VQVAEConfig
from ..models.vocoder import MelGANGenerator
from ..models.vqvae import VQModel

ORBAX_HINT = ("{path} is not a reference-format checkpoint (an orbax "
              "directory of the JAX package?); the port reads no orbax: "
              "convert it with scripts/torch_convert_orbax.py on a host "
              "with JAX")


def _load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's tensors by name: a raw ``state_dict``, the
    ``state_dict`` entry of a Lightning checkpoint, or the autoencoder
    (``state["ae_params"]``) of a port VQ-GAN checkpoint.  The reference's
    files hold more than tensors, hence ``weights_only=False``: load only
    files you trust, as with the reference itself."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("state"), dict) \
            and "ae_params" in obj["state"]:
        obj = obj["state"]["ae_params"]
    return {k: v.detach() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _fold_weight_norm(sd: Dict[str, torch.Tensor],
                      prefix: str) -> torch.Tensor:
    """w = g v / |v|, the norm over every dim but the first (torch's
    ``weight_norm`` default, dim 0)."""
    g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g * v / norm


def _module_keys(cls, cfg):
    """The state-dict names of ``cls(cfg)``, built on the meta device (no
    memory, no initialisation)."""
    with torch.device("meta"):
        return list(cls(cfg).state_dict().keys())


def _take(sd, names, reference_name, what):
    """``{name: sd[reference_name(name)]}`` as float32, or a ValueError
    that lists what the checkpoint lacks."""
    missing = [reference_name(n) for n in names
               if reference_name(n) not in sd]
    if missing:
        raise ValueError(f"{what}: the checkpoint lacks {len(missing)} "
                         f"tensors, e.g. {missing[:4]}")
    return {n: sd[reference_name(n)].float() for n in names}


# ---------------------------------------------------------------------------
# VQ-VAE
# ---------------------------------------------------------------------------


def _norm_name(leaf: str, attention: bool) -> str:
    # the port names an attention block's GroupNorm norm1 (the flax tree's
    # GroupNorm_0); the reference names it norm
    return re.sub(r"^norm1\.", "norm.", leaf) if attention else leaf


def _vq_reference_name(name: str) -> str:
    """The reference's name (big_model_attn_gan.py) of a port VQModel
    state-dict entry."""
    if name == "quantize.embedding":
        return "_vq_vae._embedding.weight"
    side, _, rest = name.partition(".")
    if side not in ("encoder", "decoder"):
        return name                          # quant_conv, post_quant_conv
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)\.(.*)", rest)
    if m:
        level, i, kind, j, leaf = m.groups()
        rest = f"{level}.{i}.{kind}.{j}.{_norm_name(leaf, kind == 'attn')}"
    elif m := re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)"
                           r"\.conv1\.(.*)", rest):
        rest = f"{m[1]}.{m[2]}.{m[3]}.conv.{m[4]}"
    elif m := re.fullmatch(r"mid_(block|attn)_(\d)\.(.*)", rest):
        rest = f"mid.{m[1]}_{m[2]}.{_norm_name(m[3], m[1] == 'attn')}"
    return f"_{side}.{rest}"


def convert_vqvae_state_dict(sd: Dict[str, torch.Tensor],
                             cfg: VQVAEConfig) -> Dict[str, torch.Tensor]:
    """The reference ``LitVQVAE`` state dict -> the port's ``VQModel``
    state dict (the discriminator and the losses are not needed for
    inference and are left out).  A state dict that already has the
    port's names is taken as it is."""
    names = _module_keys(VQModel, cfg)
    if all(n in sd for n in names):
        return {n: sd[n].float() for n in names}
    return _take(sd, names, _vq_reference_name, "VQ-VAE")


def _vqgan_checkpoint(path: str):
    """The ``last.pt`` of a port VQ-GAN run: in ``path`` itself (a
    checkpoint directory) or in the newest ``checkpoints/version_N`` under
    it (a run directory) that holds one; None if there is none."""
    if os.path.isfile(os.path.join(path, "last.pt")):
        return os.path.join(path, "last.pt")
    ckpts = os.path.join(path, "checkpoints")
    versions = (sorted((d for d in os.listdir(ckpts)
                        if d.startswith("version_")),
                       key=lambda d: int(d.split("_")[-1]), reverse=True)
                if os.path.isdir(ckpts) else [])
    for v in versions:
        if os.path.isfile(os.path.join(ckpts, v, "last.pt")):
            return os.path.join(ckpts, v, "last.pt")
    return None


def load_vqvae_params(path: str, cfg: VQVAEConfig) -> VQModel:
    """The frozen VQ-VAE from a reference torch checkpoint (.pt / .ckpt),
    or the autoencoder of a port VQ-GAN run (its ``state["ae_params"]``;
    a directory as ``_vqgan_checkpoint`` finds it).  A directory that is
    neither (an orbax one) is refused."""
    if os.path.isdir(path):
        found = _vqgan_checkpoint(path)
        if found is None:
            raise ValueError(ORBAX_HINT.format(path=path))
        path = found
    model = VQModel(cfg)
    model.load_state_dict(convert_vqvae_state_dict(
        _load_torch_state_dict(path), cfg), strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# MelGAN vocoder
# ---------------------------------------------------------------------------


def _melgan_reference_names(cfg: VocoderConfig) -> Dict[str, str]:
    """Port module -> the reference Sequential's weight-normed layer
    (vocoder/modules.py:45-76: [pad, conv, (leaky, convT,
    res * n) * len(ratios), leaky, pad, conv, tanh]; a resblock's convs
    are its ``block.2``, ``block.4`` and ``shortcut``)."""
    out = {"conv_in": "model.1"}
    idx = 2
    for i in range(len(cfg.ratios)):
        idx += 1                                    # LeakyReLU
        out[f"up_{i}"] = f"model.{idx}"
        idx += 1
        for j in range(cfg.n_residual_layers):
            for conv, ref in (("block_conv1", "block.2"),
                              ("block_conv2", "block.4"),
                              ("shortcut", "shortcut")):
                out[f"res_{i}_{j}.{conv}"] = f"model.{idx}.{ref}"
            idx += 1
    out["conv_out"] = f"model.{idx + 2}"            # LeakyReLU, pad
    return out


def convert_melgan_state_dict(sd: Dict[str, torch.Tensor],
                              cfg: VocoderConfig) -> Dict[str, torch.Tensor]:
    """The reference ``Generator``'s Sequential state dict -> the port's
    ``MelGANGenerator`` state dict, weight norm folded.  A state dict that
    already has the port's names is taken as it is."""
    names = _module_keys(MelGANGenerator, cfg)
    if all(n in sd for n in names):
        return {n: sd[n].float() for n in names}
    out = {}
    for port, ref in _melgan_reference_names(cfg).items():
        if f"{ref}.weight_v" not in sd:
            raise ValueError(f"MelGAN: the checkpoint lacks {ref}.weight_v "
                             f"(for {port})")
        out[f"{port}.weight"] = _fold_weight_norm(sd, ref).float()
        out[f"{port}.bias"] = sd[f"{ref}.bias"].float()
    return out


def read_vocoder_args(path: str) -> VocoderConfig:
    """The generator's geometry from a MelGAN ``args.yml``: the reference
    dumps its ``argparse.Namespace`` there, one ``key: value`` a line, so
    three lines are read as text (no YAML parser needed)."""
    fields = ("n_mel_channels", "ngf", "n_residual_layers")
    found = {}
    with open(path) as f:
        for line in f:
            key, sep, value = line.partition(":")
            if sep and key.strip() in fields and not line[0].isspace():
                found[key.strip()] = int(value.strip())
    missing = [k for k in fields if k not in found]
    if missing:
        raise ValueError(f"{path}: no {missing} line")
    return VocoderConfig(**found)


def load_vocoder_params(path: str) -> Tuple[MelGANGenerator, VocoderConfig]:
    """The frozen MelGAN from a reference log directory (``best_netG.pt``
    and ``args.yml``; reference load_vocoder, GPT_callbacks.py:66-79)."""
    weights = os.path.join(path, "best_netG.pt")
    if not (os.path.isdir(path) and os.path.exists(weights)):
        raise ValueError(ORBAX_HINT.format(path=path)
                         + " (a MelGAN directory holds best_netG.pt and "
                         "args.yml)")
    cfg = read_vocoder_args(os.path.join(path, "args.yml"))
    model = MelGANGenerator(cfg)
    model.load_state_dict(convert_melgan_state_dict(
        _load_torch_state_dict(weights), cfg), strict=True)
    return model.eval(), cfg


# ---------------------------------------------------------------------------
# GPT (a Lightning minGPT checkpoint -> the port's nested dict)
# ---------------------------------------------------------------------------


def convert_gpt_state_dict(sd: Dict[str, torch.Tensor], n_layer: int,
                           prefix: str = "transformer.") -> Dict:
    """The reference minGPT state dict -> the port's parameter dict
    (models/gpt.py): (L, in, out) stacked block matrices, q, k and v
    fused in that order, ``embedder.weight`` as ``class_emb``.  ``prefix``
    selects the model (``transformer.`` for ``Lit_minGPT``,
    ``encoder.transformer.`` etc. in a GPT-VAE)."""
    def w(name):
        return sd[f"{prefix}{name}"].float()

    def lin(name):
        return w(f"{name}.weight").t()

    def stack(fn):
        return torch.stack([fn(i) for i in range(n_layer)]).contiguous()

    def qkv(i, part):
        names = [f"blocks.{i}.attn.{n}" for n in ("query", "key", "value")]
        if part == "w":
            return torch.cat([lin(n) for n in names], dim=1)
        return torch.cat([w(f"{n}.bias") for n in names])

    blocks = {
        "ln1_s": stack(lambda i: w(f"blocks.{i}.ln1.weight")),
        "ln1_b": stack(lambda i: w(f"blocks.{i}.ln1.bias")),
        "attn_qkv": {"w": stack(lambda i: qkv(i, "w")),
                     "b": stack(lambda i: qkv(i, "b"))},
        "attn_proj": {"w": stack(lambda i: lin(f"blocks.{i}.attn.proj")),
                      "b": stack(lambda i: w(f"blocks.{i}.attn.proj.bias"))},
        "ln2_s": stack(lambda i: w(f"blocks.{i}.ln2.weight")),
        "ln2_b": stack(lambda i: w(f"blocks.{i}.ln2.bias")),
        "mlp_up": {"w": stack(lambda i: lin(f"blocks.{i}.mlp.0")),
                   "b": stack(lambda i: w(f"blocks.{i}.mlp.0.bias"))},
        "mlp_down": {"w": stack(lambda i: lin(f"blocks.{i}.mlp.2")),
                     "b": stack(lambda i: w(f"blocks.{i}.mlp.2.bias"))},
    }
    params = {"tok_emb": w("tok_emb.weight"), "pos_emb": w("pos_emb")[0],
              "blocks": blocks, "ln_f_s": w("ln_f.weight"),
              "ln_f_b": w("ln_f.bias"),
              "head": {"w": lin("head").contiguous()}}
    for name in (f"{prefix.split('.')[0]}.embedder.weight",
                 "embedder.weight"):
        if name in sd:
            params["class_emb"] = sd[name].float()
            break
    return params
