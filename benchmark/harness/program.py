"""The system under test, built from a configuration file: the program's
preset, held to the file's numbers, its dtypes as the file states them,
and the benchmark's seeded weights placed into the program's own objects.

Only this module and the traffic generators import the program
(``melspec_gpt_vqvae_tpu_torch``); the reference never does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from reference import detok as ref_detok
from reference import gpt as ref_gpt
from reference import gpt_vae as ref_vae

from . import weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_file_value(v):
    return list(v) if isinstance(v, tuple) else v


def hold_to_file(obj, numbers: Dict, what: str) -> None:
    """Every number of the file's group ``numbers`` equals the program's
    (a preset that drifted from the file would measure another model)."""
    for k, v in numbers.items():
        have = _as_file_value(getattr(obj, k))
        if have != v:
            raise SystemExit(f"{what}.{k}: the program's preset has {have!r}, "
                             f"the configuration file {v!r}")


def experiment(cfg: Dict, overrides: Dict = None):
    """The program's ExperimentConfig of the file's ``preset``, with the
    file's ``program_overrides`` (and a test's ``overrides``) applied and
    its ``dtypes`` set; each group of numbers held to the file."""
    from melspec_gpt_vqvae_tpu_torch.configs import load_preset
    ov = dict(cfg.get("program_overrides", {}), **(overrides or {}))
    exp = load_preset(*cfg["preset"], **ov)
    exp = dataclasses.replace(exp, model=exp.model.replace(**cfg["dtypes"]))
    hold_to_file(exp.model, cfg["model"], "model")
    for group in ("vqvae", "vocoder", "vae"):
        if group in cfg:
            obj = dataclasses.replace(getattr(exp, group), **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in cfg[group].items()})
            exp = dataclasses.replace(exp, **{group: obj})
    if "train" in cfg:
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, **{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg["train"].items()}))
    return exp


# ---------------------------------------------------------------------------
# weights: drawn by the benchmark from the seed, on the device
# ---------------------------------------------------------------------------

def gpt_weights(model: Dict, seed: int, device, dtype) -> Dict:
    """The class GPT's parameter tree in the served type."""
    flat = weights.draw(weights.gpt_specs(ref_gpt.param_shapes(model)), seed,
                        "gpt", device, dtype)
    return ref_gpt.nest(flat)


def vae_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The GPT-VAE's encoder and decoder leaves, float32 (flat names)."""
    return weights.draw(weights.gpt_specs(ref_vae.param_shapes(model)), seed,
                        "gpt_vae", device, torch.float32)


def detok_weights(cfg: Dict, seed: int, device, dtype):
    """(VQ decoder tensors, MelGAN tensors) by state_dict name, drawn for
    the reference modules' parameters in the served type."""
    with torch.device("meta"):
        vq = ref_detok.VQDecode(cfg["vqvae"])
        mg = ref_detok.MelGAN(cfg["vocoder"])
    vq_w = weights.draw(weights.conv_specs(ref_detok.weight_specs(vq)), seed,
                        "vqvae", device, dtype)
    mg_w = weights.draw(weights.conv_specs(ref_detok.weight_specs(mg)), seed,
                        "melgan", device, dtype)
    return vq_w, mg_w


def _fill(module: torch.nn.Module, tensors: Dict[str, torch.Tensor],
          device) -> torch.nn.Module:
    """``module`` (built on ``meta``) on ``device`` with ``tensors`` loaded
    by name; parameters and buffers it has beyond them (the encoder side
    of the VQ-VAE, which generation never runs) are zeros."""
    module = module.to_empty(device=device)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            t.zero_()
    missing = set(tensors) - set(module.state_dict())
    if missing:
        raise SystemExit(f"the program's module has no {sorted(missing)[:4]}")
    module.load_state_dict(tensors, strict=False)
    return module


def program_detok(exp, vq_w, mg_w, device):
    """The program's VQModel and MelGANGenerator holding the drawn
    weights."""
    from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANGenerator
    from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel
    with torch.device("meta"):
        vq = VQModel(exp.vqvae)
        mg = MelGANGenerator(exp.vocoder)
    return _fill(vq, vq_w, device), _fill(mg, mg_w, device)


def reference_detok(cfg: Dict, vq_w, mg_w, device):
    """The reference's float32 modules holding the same weights."""
    with torch.device("meta"):
        vq = ref_detok.VQDecode(cfg["vqvae"])
        mg = ref_detok.MelGAN(cfg["vocoder"])
    vq = vq.to_empty(device=device)
    mg = mg.to_empty(device=device)
    vq.load_state_dict({k: v.float() for k, v in vq_w.items()})
    mg.load_state_dict({k: v.float() for k, v in mg_w.items()})
    return vq.eval(), mg.eval()


def class_pipeline(cfg: Dict, seed: int, device, chunk: int,
                   overrides: Dict = None,
                   int8_decode: bool = False) -> Tuple[object, object]:
    """(exp, GenerationPipeline) as ``serving.build_pipeline`` makes it
    for the card (the preset, the served dtypes, ``segments``, ``chunk``),
    holding the benchmark's weights.  ``int8_decode``: the program's int8
    decode stage in place of the bfloat16 convs and kernel B (a control
    run's lower precision)."""
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    exp = experiment(cfg, overrides)
    serving = cfg["serving"]
    gpt = gpt_weights(cfg["model"], seed, device, DTYPES[cfg["dtypes"]
                                                         ["dtype"]])
    vq_w, mg_w = detok_weights(cfg, seed, device,
                               DTYPES[serving["conv_dtype"]])
    vq, mg = program_detok(exp, vq_w, mg_w, device)
    pipe = GenerationPipeline(
        exp, gpt, vq, mg, segments=serving["segments"], chunk=chunk,
        bf16=serving["conv_dtype"] == "bfloat16", device=device,
        int8_decode=int8_decode)
    return exp, pipe
