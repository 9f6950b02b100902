"""Serving layer: weights -> GenerationPipeline, and a thread-safe service.

Counterpart of melspec_gpt_vqvae_tpu/serving.py without its HTTP server:
``build_pipeline`` makes the pipeline from random weights (seeded) or from
JAX parameter trees carried across by bridge.py, with the bfloat16 model
dtype and KV cache on the card (``sample.py --kv_cache auto
--int8_weights 0``); ``GenerationService`` pads requests to a fixed batch,
serialises generation with a lock, sheds load past a bounded queue and
seeds each request's ``torch.Generator``.

Not ported yet, and refused with NotImplementedError: the int8 / int4 KV
cache and int8 streamed weights, mesh serving, speculative decoding, the
int8 decode stage and the HTTP server (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from melspec_gpt_vqvae_tpu.configs import (ExperimentConfig, load_preset,
                                           parse_overrides)

from . import bridge
from .models.gpt import DTYPES, init_gpt_params, tree_to
from .models.vocoder import MelGANGenerator
from .models.vqvae import VQModel
from .pipeline import GenerationPipeline


def random_weights(exp: ExperimentConfig, seed: int):
    """Seeded random (gpt_params, VQModel, MelGANGenerator) on the CPU, in
    ``exp.model.dtype`` for the GPT and float32 for the conv nets; the same
    seed gives the same weights on every machine."""
    g = torch.Generator().manual_seed(seed)
    gpt = init_gpt_params(exp.model, g)
    vq = bridge.init_conv_net_(VQModel(exp.vqvae), g)
    voc = bridge.init_conv_net_(MelGANGenerator(exp.vocoder), g)
    return gpt, vq, voc


def build_pipeline(dataset: str = "vas", *, init_random: bool = False,
                   params: Optional[Mapping] = None, override: str = "",
                   seed: int = 783435, segments: int = 8, chunk: int = 128,
                   kv_cache: str = "auto", int8_weights: int = 0,
                   device=None, mesh_spec: str = "",
                   draft_random: str = "", int8_decode: bool = False):
    """Construct the GenerationPipeline on ``device`` (default: CUDA when
    present).  Weights are random (``init_random``, from ``seed``) or
    ``params = {"gpt": ..., "vqvae": ..., "vocoder": ...}``, the JAX
    package's parameter trees with numpy leaves.  Returns ``(exp, pipe)``.
    """
    if kv_cache != "auto" or int8_weights:
        raise NotImplementedError("int8/int4 KV cache and int8 streamed "
                                  "weights are not ported yet (ROADMAP)")
    if mesh_spec or draft_random or int8_decode:
        raise NotImplementedError("mesh serving, speculative decoding and "
                                  "the int8 decode stage are not ported "
                                  "yet (ROADMAP)")
    if init_random == (params is not None):
        raise ValueError("pass exactly one of init_random=True or params")
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    exp = load_preset("GPT", dataset, **parse_overrides(override))
    exp = dataclasses.replace(exp, model=exp.model.replace(
        dtype="bfloat16" if device.type == "cuda" else "float32",
        cache_dtype="auto", decode_weight_dtype="auto"))
    if init_random:
        gpt, vq, voc = random_weights(exp, seed)
    else:
        gpt = bridge.gpt_params_from_jax(params["gpt"])
        vq = bridge.load_vqvae(params["vqvae"], exp.vqvae)
        voc = bridge.load_melgan(params["vocoder"], exp.vocoder)
    gpt = tree_to(gpt, device=device, dtype=DTYPES[exp.model.dtype])
    pipe = GenerationPipeline(exp, gpt, vq, voc, segments=segments,
                              chunk=chunk)
    return exp, pipe


def serve(*args, **kwargs):
    raise NotImplementedError("HTTP serving of the port is not ported yet "
                              "(ROADMAP); use GenerationService directly")


class ServiceOverloaded(RuntimeError):
    """Raised when the bounded request queue is full: shedding load beats
    unbounded queueing on one card."""


class GenerationService:
    """Thread-safe, fixed-batch wrapper around a GenerationPipeline."""

    def __init__(self, exp: ExperimentConfig, pipe: GenerationPipeline, *,
                 batch: int = 8, seed: int = 783435,
                 temperature: float = 1.0, top_k: Optional[int] = 100,
                 top_p: Optional[float] = None, max_queue: int = 16):
        self.exp = exp
        self.pipe = pipe
        self.batch = max(1, int(batch))
        self.defaults = {"temperature": temperature,
                         "top_k": top_k or None,   # 0 disables, like top_p
                         "top_p": top_p}
        self._lock = threading.Lock()
        self._seeds = torch.Generator().manual_seed(seed)
        self.started = time.time()
        self.requests = 0
        self.shed = 0
        self.max_queue = max(1, int(max_queue))
        self._pending = 0
        self._pending_lock = threading.Lock()

    def generate(self, classes, *, temperature=None, top_k=None, top_p=None,
                 sample: bool = True,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One clip per entry of ``classes`` (padded to the serving batch,
        split when longer)."""
        cs = np.asarray(classes, np.int32)
        if cs.ndim != 1 or len(cs) == 0:
            raise ValueError("classes must be a non-empty 1-D list")
        if (cs < 0).any() or (cs >= self.exp.model.class_size).any():
            raise ValueError(
                f"class indices must be in [0, {self.exp.model.class_size})")
        t = self.defaults["temperature"] if temperature is None \
            else float(temperature)
        if not t > 0.0:
            raise ValueError("temperature must be > 0 (use sample=False for "
                             "greedy decode)")
        k = self.defaults["top_k"] if top_k is None else (int(top_k) or None)
        p = self.defaults["top_p"] if top_p is None else float(top_p)
        p = p if (p and 0.0 < p < 1.0) else None
        with self._pending_lock:
            if self._pending >= self.max_queue:
                self.shed += 1
                raise ServiceOverloaded(
                    f"request queue full ({self.max_queue} in flight); "
                    "retry later")
            self._pending += 1
        try:
            return self._generate_locked(cs, t, k, p, sample, seed)
        finally:
            with self._pending_lock:
                self._pending -= 1

    def _generate_locked(self, cs, t, k, p, sample, seed):
        wavs, toks, specs = [], [], []
        with self._lock:
            for i in range(0, len(cs), self.batch):
                part = cs[i:i + self.batch]
                n = len(part)
                if n < self.batch:   # pad to the fixed serving batch
                    part = np.concatenate(
                        [part, np.repeat(part[-1:], self.batch - n)])
                s = ((int(seed) + i) & 0xFFFFFFFF if seed is not None else
                     int(torch.randint(2 ** 62, (1,), generator=self._seeds)))
                gen = torch.Generator(device=self.pipe.device).manual_seed(s)
                out = self.pipe.generate(part, gen, temperature=t, top_k=k,
                                         top_p=p, sample=sample)
                wavs.append(out["wavs"][:n])
                toks.append(out["tokens"][:n])
                specs.append(out["specs"][:n])
            self.requests += 1
        return {"wavs": np.concatenate(wavs),
                "tokens": np.concatenate(toks),
                "specs": np.concatenate(specs)}

    def warmup(self):
        """Run one request in each sample mode before taking traffic (the
        first calls on the card build the kernels and warm the caches)."""
        t0 = time.time()
        for mode in (True, False):
            self.generate([0], sample=mode)
        print(f"warmup: {time.time() - t0:.1f}s (batch {self.batch})")
