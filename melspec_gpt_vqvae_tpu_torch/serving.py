"""Serving layer: weights -> GenerationPipeline, and a thread-safe service.

Counterpart of melspec_gpt_vqvae_tpu/serving.py without its HTTP server:
``build_pipeline`` makes the pipeline from random weights (seeded) or from
JAX parameter trees carried across by bridge.py, with the JAX package's
defaults: on the card (the default device) the bfloat16 model dtype, an
int8 KV cache and int8 streamed block weights (serving.py:95-102); on the
CPU, which is used only when the caller names it, float32 and neither;
optionally with a speculative draft.  ``GenerationService`` pads requests
to a fixed batch, serialises generation with a lock, sheds load past a
bounded queue, seeds each request's ``torch.Generator`` and sums the
speculative stats of a request.

Not ported yet, and refused with NotImplementedError (ROADMAP queue A):
mesh serving (A12), the int8 decode stage (A6), draft weights from a run
checkpoint (``draft_experiment``, A3) and the HTTP server (A4).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import bridge
from .configs import ExperimentConfig, load_preset, parse_overrides
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
                   kv_cache: Optional[str] = None,
                   int8_weights: Optional[int] = None, device=None,
                   mesh_spec: str = "", draft_random: str = "",
                   draft_override: str = "", gamma: int = 4,
                   draft_experiment: Optional[str] = None,
                   int8_decode: bool = False, graph: bool = True):
    """Construct the GenerationPipeline on ``device``: None means the
    card, and without one this raises -- the CPU is taken only when asked
    for with ``device="cpu"``.  Weights are random (``init_random``, from ``seed``) or
    ``params = {"gpt": ..., "vqvae": ..., "vocoder": ...}``, the JAX
    package's parameter trees with numpy leaves.  ``kv_cache`` is "auto",
    "int8" or "int4" (None: "int8" on the card, "auto" on the CPU);
    ``int8_weights`` streams int8 block weights in decode (None: on the
    card).  A speculative draft comes from ``params["draft"]`` or, with
    ``draft_random`` (overrides such as "n_layer=4"), random weights from
    ``seed + 1``; its config is the target's overrides plus
    ``draft_override`` and ``draft_random`` (serving.py:115-146).
    ``graph=False`` makes the pipeline decode with the eager loop instead
    of the captured program (pipeline.py), for a comparison.
    Returns ``(exp, pipe)``.
    """
    if mesh_spec or int8_decode or draft_experiment:
        raise NotImplementedError("mesh serving, the int8 decode stage and "
                                  "draft weights from a run checkpoint are "
                                  "not ported yet (ROADMAP A12, A6, A3)")
    if init_random == (params is not None):
        raise ValueError("pass exactly one of init_random=True or params")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('build_pipeline: no CUDA card is visible; the '
                           'port serves on the card unless the caller asks '
                           'for the CPU with device="cpu"')
    on_card = device.type == "cuda"
    kv = kv_cache or ("int8" if on_card else "auto")
    if kv not in ("auto", "int8", "int4"):
        raise ValueError(f"kv_cache={kv!r}: expected 'auto', 'int8' or "
                         "'int4'")
    int8_w = int8_weights if int8_weights is not None else int(on_card)
    dtypes = dict(dtype="bfloat16" if on_card else "float32",
                  cache_dtype=kv,
                  decode_weight_dtype="int8" if int8_w else "auto")
    exp = load_preset("GPT", dataset, **parse_overrides(override))
    exp = dataclasses.replace(exp, model=exp.model.replace(**dtypes))
    if init_random:
        gpt, vq, voc = random_weights(exp, seed)
    else:
        gpt = bridge.gpt_params_from_jax(params["gpt"])
        vq = bridge.load_vqvae(params["vqvae"], exp.vqvae)
        voc = bridge.load_melgan(params["vocoder"], exp.vocoder)
    gpt = tree_to(gpt, device=device, dtype=DTYPES[exp.model.dtype])

    draft, draft_cfg = None, None
    carried = params is not None and "draft" in params
    if draft_override and not (draft_random or carried):
        raise ValueError("draft_override needs draft_random or "
                         "params['draft']")
    if draft_random or carried:
        d_ov = {**parse_overrides(override),
                **parse_overrides(draft_override),
                **parse_overrides(draft_random)}
        draft_cfg = load_preset("GPT", dataset, **d_ov).model.replace(
            **dtypes)
        for f in ("vocab_size", "block_size", "class_size"):
            if getattr(draft_cfg, f) != getattr(exp.model, f):
                raise ValueError(
                    f"draft {f}={getattr(draft_cfg, f)} must equal the "
                    f"target's {getattr(exp.model, f)} (the speculative "
                    "accept/reject compares the two distributions)")
        draft = (bridge.gpt_params_from_jax(params["draft"]) if carried else
                 init_gpt_params(draft_cfg,
                                 torch.Generator().manual_seed(seed + 1)))
        draft = tree_to(draft, device=device, dtype=DTYPES[draft_cfg.dtype])
    pipe = GenerationPipeline(exp, gpt, vq, voc, segments=segments,
                              chunk=chunk, draft_params=draft,
                              draft_cfg=draft_cfg, gamma=gamma, graph=graph)
    return exp, pipe


def serve(*args, **kwargs):
    raise NotImplementedError("HTTP serving of the port is not ported yet "
                              "(ROADMAP A4); use GenerationService directly")


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
        agg = {"rounds": 0, "drafted": 0, "accepted": 0}
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
                for f in agg:   # whole-request stats, not the last part's
                    agg[f] += out.get("spec_stats", {}).get(f, 0)
            self.requests += 1
        res = {"wavs": np.concatenate(wavs),
               "tokens": np.concatenate(toks),
               "specs": np.concatenate(specs)}
        if agg["drafted"]:
            agg["accept_rate"] = round(agg["accepted"] / agg["drafted"], 4)
            res["spec_stats"] = agg
        return res

    def warmup(self):
        """Run one request in each sample mode before taking traffic (the
        first calls on the card build the kernels and warm the caches)."""
        t0 = time.time()
        for mode in (True, False):
            self.generate([0], sample=mode)
        print(f"warmup: {time.time() - t0:.1f}s (batch {self.batch})")
