"""Carry weights across from the JAX package, and random initialisation.

The JAX package keeps the GPT as a nested dict of arrays and the conv nets
as flax parameter trees.  This module maps them onto the port, one tensor
per JAX leaf, taking the leaves as numpy arrays (``np.asarray`` of a JAX
array) so that it never imports JAX:

  * GPT: the same nested dict -- stacked (L, in, out) block matrices with
    the fused ``attn_qkv`` (melspec_gpt_vqvae_tpu/models/gpt.py:61-84) --
    as tensors;
  * VQ-VAE and MelGAN: a ``state_dict`` whose names are the flax paths with
    ``kernel``/``scale`` -> ``weight`` and the flax auto-names
    ``GroupNorm_0/1``, ``Conv_0/1`` -> ``norm1/2``, ``conv1/2``.  Conv
    kernels change layout: flax HWIO -> torch OIHW; a 1-D conv's (k, I, O)
    -> (O, I, k); and a ``ConvTranspose(transpose_kernel=True)`` kernel's
    (k, O, I) -> torch ConvTranspose1d's (I, O, k)
    (models/vocoder.py:66-68) -- both 1-D cases reverse the axes.

``load_state_dict(strict=True)`` then checks that every module tensor is
covered once with the right shape.  The PatchGAN discriminator keeps the
flax names themselves (``Conv_0``, ``BatchNorm_0`` with ``scale`` /
``bias`` and the running ``mean`` / ``var``); only ``kernel`` ->
``weight`` changes there.

A JAX ``GPTTask`` train state crosses as the port's ``state_tree`` form
(training/gpt_task.py): the params, the AdamW moments and count of the
optax ``inject_hyperparams`` state's ``inner_state[0]``
(``ScaleByAdamState``), its live learning rate and the step; a JAX
``VAETask`` state adds its ``kl_weight`` (training/vae_task.py).  A JAX
``VQVAETask`` state (``{ae_params, disc_params, disc_stats, opt_ae,
opt_disc, step}``, its two optax Adam states included) crosses as the
port's ``VQVAETask.state_tree`` (``vqgan_train_state_from_jax``) and back
into the JAX layout with numpy leaves (``vqgan_train_state_to_numpy``).
A JAX ``LSTMVAETask`` state crosses as the port's
``LSTMVAETask.state_tree`` (``lstm_vae_train_state_from_jax``): the
params (same nested layout), the optimiser's state -- an SGD momentum
trace as torch's ``momentum_buffer`` per leaf, or Adam's moments -- its
live learning rate, the step and ``kl_weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import configs
from .configs import VocoderConfig, VQVAEConfig
from .models.vocoder import MelGANGenerator
from .models.vqvae import BatchNorm, VectorQuantizer, VQModel

_RENAME = {"GroupNorm_0": "norm1", "GroupNorm_1": "norm2",
           "Conv_0": "conv1", "Conv_1": "conv2",
           "kernel": "weight", "scale": "weight"}
_UNRENAME = {"norm1": "GroupNorm_0", "norm2": "GroupNorm_1",
             "conv1": "Conv_0", "conv2": "Conv_1"}
# the discriminator keeps its flax names; only a conv's kernel is renamed
_DISC_RENAME = {"kernel": "weight"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def config_from_jax(cfg, cls=None):
    """A config of the JAX package -- any dataclass of its ``configs``
    module, or the ``dataclasses.asdict`` of one together with ``cls`` --
    as the port's class of the same name, field by field.  The two
    packages' classes are distinct, so a test builds one config and hands
    each package its own.  Nested configs (``ExperimentConfig``'s) convert
    by the port field's declared class; a field the port does not know, or
    a class it has no counterpart of, raises."""
    if cls is None:
        cls = getattr(configs, type(cfg).__name__, None)
        if not (dataclasses.is_dataclass(cfg) and dataclasses.is_dataclass(cls)):
            raise TypeError(f"no port config class for {type(cfg).__name__}; "
                            "pass cls= with a dict of fields")
        cfg = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    elif not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a config dataclass of the port")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(cfg) - set(fields))
    if unknown:
        raise ValueError(f"{cls.__name__}: the port does not know "
                         f"field(s) {unknown}")
    out = {}
    for name, value in cfg.items():
        sub = getattr(configs, str(fields[name].type), None)
        if dataclasses.is_dataclass(sub) and (
                isinstance(value, Mapping) or dataclasses.is_dataclass(value)):
            value = config_from_jax(value, None if dataclasses.is_dataclass(
                value) else sub)
        out[name] = value
    return cls(**out)


def gpt_params_from_jax(params: Mapping) -> Dict:
    """JAX GPT param tree (numpy leaves) -> the port's nested dict of
    float32 CPU tensors (``models.gpt.tree_to`` moves it); a GPT-VAE's
    ``{"encoder", "decoder"}`` tree of two GPTs crosses the same way."""
    if isinstance(params, Mapping):
        return {k: gpt_params_from_jax(v) for k, v in params.items()}
    return _tensor(params)


def train_state_from_jax(params: Mapping, opt_state, step,
                         kl_weight=None) -> Dict:
    """A JAX ``GPTTask`` state -- params, the ``gpt_adamw`` opt state
    (``InjectStatefulHyperparamsState``) and step -- as the port's
    ``state_tree`` dict of float32 CPU tensors, for
    ``GPTTask.load_state``; with a ``kl_weight``, a JAX ``VAETask`` state
    with the AdamW optimizer (its ``{"encoder", "decoder"}`` params and
    moments), for ``VAETask.load_state``.  Reads the opt state by
    attribute, so it needs no JAX import."""
    adam = opt_state.inner_state[0]
    tree = {"params": gpt_params_from_jax(params),
            "mu": gpt_params_from_jax(adam.mu),
            "nu": gpt_params_from_jax(adam.nu),
            "count": int(np.asarray(adam.count)),
            "lr": float(np.asarray(opt_state.hyperparams["learning_rate"])),
            "step": int(np.asarray(step))}
    if kl_weight is not None:
        tree["kl_weight"] = torch.tensor(np.float32(np.asarray(kl_weight)))
    return tree


def train_state_to_numpy(tree: Dict) -> Dict:
    """A ``state_tree`` dict with numpy leaves in place of tensors."""
    if isinstance(tree, dict):
        return {k: train_state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def conv_state_dict(params: Mapping, rename: Mapping = _RENAME
                    ) -> Dict[str, torch.Tensor]:
    """flax VQModel / MelGANGenerator params (or any tree of conv nets,
    with the discriminator's ``_DISC_RENAME``) -> torch state dict."""
    sd = {}
    for path, leaf in _leaves(params):
        t = _tensor(leaf)
        if path[-1] == "kernel":
            if t.ndim not in (3, 4):
                raise ValueError(f"unexpected kernel rank at {path}")
            t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.permute(2, 1, 0)
        name = ".".join(rename.get(p, p) for p in path)
        if name in sd:
            raise ValueError(f"two JAX leaves map to {name}")
        sd[name] = t.contiguous()
    return sd


def conv_tree_from_state_dict(sd: Mapping[str, torch.Tensor],
                              disc: bool = False) -> Dict:
    """The inverse of ``conv_state_dict`` for 2-D conv nets: a torch state
    dict (the VQ-VAE's names, or with ``disc`` the discriminator's) -> the
    flax tree with numpy leaves, conv kernels OIHW -> HWIO.  A 4-D
    ``weight`` is a conv kernel; a 1-D one a GroupNorm's ``scale``."""
    tree: Dict = {}
    for name, t in sd.items():
        a = t.detach().cpu().numpy()
        *mods, leaf = name.split(".")
        if leaf == "weight":
            if a.ndim == 4:
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            elif a.ndim == 1:
                leaf = "scale"
            else:
                raise ValueError(f"unexpected weight rank at {name}")
        if not disc:
            mods = [_UNRENAME.get(p, p) for p in mods]
        node = tree
        for p in mods:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def _optax_state(opt_state, attr: str = "mu"):
    """The optax state inside ``opt_state`` (a chain's tuple, an
    ``inject_hyperparams`` state's ``inner_state``) that has ``attr``:
    ``mu`` finds the ``ScaleByAdamState`` (``count``, ``mu``, ``nu``),
    ``trace`` an SGD momentum ``TraceState``.  Read by attribute; None if
    absent."""
    if hasattr(opt_state, attr):
        return opt_state
    if hasattr(opt_state, "inner_state"):
        return _optax_state(opt_state.inner_state, attr)
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _optax_state(part, attr)
            if found is not None:
                return found
    return None


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax state, or None."""
    return _optax_state(opt_state, "mu")


def lstm_vae_params_from_jax(params: Mapping) -> Dict:
    """A JAX LSTM-VAE param tree (``{"encoder", "decoder"}`` of ``embed``,
    ``lstm`` {wx, wh, b}, ``linear`` / ``trans`` / ``pred`` {w}) as the
    port's nested dict of float32 CPU tensors: the layouts are the same."""
    return gpt_params_from_jax(params)


def lstm_vae_train_state_from_jax(state: Mapping) -> Dict:
    """A JAX ``LSTMVAETask`` state (params, the ``make_optimizer`` state,
    step, kl_weight) as the port's ``LSTMVAETask.state_tree``: Adam's
    ``mu`` / ``nu`` / ``count``, or for SGD the momentum trace of each leaf
    as its ``momentum_buffer`` (torch's first momentum step sets the
    buffer to the gradient, as optax's trace from zeros does); no entry
    without momentum."""
    from .training.optim import named_leaves
    opt = state["opt_state"]
    tree = {"params": lstm_vae_params_from_jax(state["params"]),
            "lr": float(np.asarray(opt.hyperparams["learning_rate"])),
            "step": int(np.asarray(state["step"])),
            "kl_weight": torch.tensor(np.float32(np.asarray(
                state["kl_weight"])))}
    adam, trace = _adam_state(opt), _optax_state(opt, "trace")
    if adam is not None:
        tree.update(mu=gpt_params_from_jax(adam.mu),
                    nu=gpt_params_from_jax(adam.nu),
                    count=int(np.asarray(adam.count)))
    else:
        tree["opt"] = ({} if trace is None else {
            name: {"momentum_buffer": t} for name, t in
            named_leaves(gpt_params_from_jax(trace.trace))})
    return tree


def vqgan_train_state_from_jax(state: Mapping) -> Dict:
    """A JAX ``VQVAETask`` state (numpy or JAX leaves) as the port's
    ``VQVAETask.state_tree``: torch-named tensors for both nets and both
    Adams' moments (kernels HWIO -> OIHW), the discriminator's BatchNorm
    statistics, the Adams' counts and the step."""
    def adam(opt, rename):
        a = _adam_state(opt)
        if a is None:
            raise ValueError("no Adam state (count, mu, nu) in the JAX "
                             "optimizer state")
        return {"mu": conv_state_dict(a.mu, rename),
                "nu": conv_state_dict(a.nu, rename),
                "count": int(np.asarray(a.count))}
    return {"ae_params": conv_state_dict(state["ae_params"]),
            "disc_params": conv_state_dict(state["disc_params"],
                                           _DISC_RENAME),
            "disc_stats": conv_state_dict(state["disc_stats"], _DISC_RENAME),
            "opt_ae": adam(state["opt_ae"], _RENAME),
            "opt_disc": adam(state["opt_disc"], _DISC_RENAME),
            "step": int(np.asarray(state["step"]))}


def vqgan_train_state_to_numpy(tree: Mapping) -> Dict:
    """The inverse of ``vqgan_train_state_from_jax``: a port
    ``VQVAETask.state_tree`` in the JAX task's layout with numpy leaves
    (flax names, HWIO kernels); each Adam as ``{"count", "mu", "nu"}``."""
    def adam(opt, disc):
        return {"count": np.int32(opt["count"]),
                "mu": conv_tree_from_state_dict(opt["mu"], disc),
                "nu": conv_tree_from_state_dict(opt["nu"], disc)}
    return {"ae_params": conv_tree_from_state_dict(tree["ae_params"]),
            "disc_params": conv_tree_from_state_dict(tree["disc_params"],
                                                     True),
            "disc_stats": conv_tree_from_state_dict(tree["disc_stats"], True),
            "opt_ae": adam(tree["opt_ae"], False),
            "opt_disc": adam(tree["opt_disc"], True),
            "step": np.int32(tree["step"])}


def load_vqvae(params: Mapping, cfg: VQVAEConfig) -> VQModel:
    model = VQModel(cfg)
    model.load_state_dict(conv_state_dict(params), strict=True)
    return model.eval()


def load_melgan(params: Mapping, cfg: VocoderConfig) -> MelGANGenerator:
    model = MelGANGenerator(cfg)
    model.load_state_dict(conv_state_dict(params), strict=True)
    return model.eval()


@torch.no_grad()
def init_conv_net_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place, like the flax defaults the JAX package
    initialises with: conv kernels N(0, 1 / fan_in) (LeCun), zero biases
    where a conv has one, GroupNorm (1, 0), BatchNorm scale 1, bias 0 and
    statistics mean 0, var 1, the codebook U(-1/K, 1/K)
    (models/vqvae.py:184-190).  Drawn on ``generator``'s device, so a seed
    gives the same weights wherever the model lives afterwards."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            w = m.weight
            fan_in = w[0].numel() if not isinstance(
                m, nn.ConvTranspose1d) else w.shape[1] * w.shape[2]
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
        elif isinstance(m, VectorQuantizer):
            k = m.embedding.shape[0]
            u = torch.rand(m.embedding.shape, generator=generator,
                           device=generator.device)
            m.embedding.copy_((2.0 * u - 1.0) / k)
    return model
