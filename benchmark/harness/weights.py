"""Seeded weights and seeds, made on the device in a few large draws.

Every tensor of a tree comes from one ``torch.randn`` over the tree's
total size on a generator of the device, cut in order and scaled by its
kind; the result is cast to the type the weights are served or trained
in.  The same seed gives the same tensors on the same device, so the
reference can draw them again after the program's state is freed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``'s stream of a run of ``seed`` (any whole
    number, wider than 32 bits included)."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def draw(specs: Iterable[Tuple[str, tuple, float, float]], seed: int,
         tag: str, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{name: mean + std * N(0, 1)}`` of shape ``shape`` for each
    ``(name, shape, std, mean)``, in ``dtype``."""
    specs = list(specs)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in specs]
    z = torch.randn(sum(sizes), generator=generator(seed, tag, device),
                    device=device)
    out, o = {}, 0
    for (name, shape, std, mean), n in zip(specs, sizes):
        t = z[o:o + n].view(shape)
        out[name] = (t * std + mean).to(dtype)
        o += n
    del z
    return out


def gpt_specs(shapes: Dict[str, tuple], std: float = 0.02):
    """A GPT's leaves: N(0, std) matrices, embeddings and biases,
    LayerNorm scales 1 + N(0, std) -- biases and norms away from their
    initial values, so that every term of the block reaches the output."""
    for name, shape in shapes.items():
        leaf = name.rsplit("/", 1)[-1]
        mean = 1.0 if leaf in ("ln1_s", "ln2_s", "ln_f_s") else 0.0
        yield name, shape, std, mean


def conv_specs(weight_specs):
    """A conv net's leaves from ``reference.detok.weight_specs``: kernels
    N(0, 1 / fan_in) (LeCun, as the flax initialisers), biases and norm
    shifts N(0, 0.02), norm scales 1 + N(0, 0.02), the codebook N(0, 1)."""
    for name, shape, kind, fan_in in weight_specs:
        if kind == "conv":
            yield name, shape, fan_in ** -0.5, 0.0
        elif kind == "norm_scale":
            yield name, shape, 0.02, 1.0
        elif kind == "codebook":
            yield name, shape, 1.0, 0.0
        else:
            yield name, shape, 0.02, 0.0
