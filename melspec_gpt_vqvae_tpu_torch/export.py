"""Ahead-of-time export of the serving pipeline as a ``torch.export``
artifact.

Counterpart of melspec_gpt_vqvae_tpu/export.py: the whole generate ->
VQ-decode -> vocode program traced once and saved with
``torch.export.save``, so that a server process loads and runs it with
only PyTorch and the weights -- no retracing, no capture, no model code on
the request path.  The contract is the JAX package's (export.py:12-28
there):

  * the sampling knobs (temperature / top_k / top_p / sample) and the
    serving batch are baked in: export one artifact per serving
    configuration (``ArtifactPipeline`` sends a request with other knobs
    or another batch back as a ValueError, which the HTTP server answers
    with 400);
  * the weights are inputs, not constants: the GPT's nested dict as a
    flat list of tensors, the VQ-VAE's and the MelGAN's state dicts
    through ``torch.func.functional_call``; the file holds the graph
    (its nodes' stack traces dropped), not the weights, and one artifact
    serves any checkpoint of the same geometry;
  * single device, no speculative draft, no int8 decode stage (each
    raises, with the JAX package's messages);
  * kernel-free by construction: the trace runs inside
    ``_build.kernels(False)``, so every wrapper takes its plain PyTorch
    version (the ctypes launches of the port's kernels cannot be traced),
    and ``export_serving`` walks every graph of the program, the decode
    loop's nested bodies included, and raises on anything but an ATen or
    prims op, ``operator.getitem`` or one of torch's own higher-order ops
    (``check_kernel_free``, the counterpart of export.py:124-134 there).

Where the port differs from the JAX artifact:

  * randomness: ``torch.export`` takes no ``torch.Generator`` and has no
    counterpart of the JAX artifact's uint32 seed, so with ``sample=True``
    the program takes the sampling uniforms ``u`` (steps, B, V) float32 as
    an input; ``ArtifactPipeline.generate`` draws them from the request's
    generator exactly as ``gpt_generate`` draws them, so one seed gives
    the live pipeline's sampled tokens.  Greedy artifacts take no ``u``;
  * the decode loop is ``torch._higher_order_ops.scan``, one per capacity
    of the segmented decode (models/gpt.py::gpt_generate_scan), not an
    unrolled loop;
  * one device type: an exported graph records the device of the tensors
    it creates, so the artifact is exported on the device type that serves
    it, which the sidecar records; there is no counterpart of JAX's
    cross-platform ``platforms=``.
"""

from __future__ import annotations

import json
import operator
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import _build
from .models.gpt import class_embed, gpt_generate_scan

EXPORT_SCRIPT = "scripts/torch_export_serving.py"


def gpt_leaves(params: Dict, prefix: str = "") -> Tuple[List[str],
                                                        List[torch.Tensor]]:
    """(dotted names, tensors) of the GPT's nested parameter dict, keys in
    sorted order at every level: the flat list the artifact takes."""
    names, leaves = [], []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            n, l = gpt_leaves(v, f"{prefix}{k}.")
            names += n
            leaves += l
        else:
            names.append(prefix + k)
            leaves.append(v)
    return names, leaves


def _unflatten(names: List[str], leaves) -> Dict:
    out: Dict = {}
    for name, leaf in zip(names, leaves):
        node = out
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def serving_inputs(pipe) -> Tuple[List[torch.Tensor], Dict, Dict]:
    """The pipeline's weights as the artifact takes them: (GPT leaves in
    ``gpt_leaves`` order, VQ-VAE state dict, MelGAN state dict)."""
    return (gpt_leaves(pipe.gpt_params)[1], dict(pipe.vq.state_dict()),
            dict(pipe.melgan.state_dict()))


class _Call(nn.Module):
    """``fn(module, *args)`` as a module's forward, for
    ``torch.func.functional_call`` over a method other than forward."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.m, *args)


def _apply(module: nn.Module, state: Dict, fn, *args):
    return torch.func.functional_call(
        _Call(module, fn), {f"m.{k}": v for k, v in state.items()}, args)


class ServingProgram(nn.Module):
    """The pipeline's end-to-end computation as a function of ``(gpt
    leaves, vq state, voc state, classes (B,) int64[, u (steps, B, V)
    float32])`` -> ``(tokens (B, steps) int64, specs (B, H, W), wavs (B,
    samples))``: the exportable unit.  It holds no weight of its own: the
    pipeline's modules are kept outside the module tree and called with
    the given state dicts."""

    def __init__(self, pipe, *, temperature: float, top_k: Optional[int],
                 top_p: Optional[float], sample: bool):
        super().__init__()
        self._pipe = (pipe,)        # not a submodule: no weight is lifted
        self.names = gpt_leaves(pipe.gpt_params)[0]
        self.knobs = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                          sample=sample)
        self.steps = pipe.vcfg.code_h * pipe.vcfg.code_w

    def forward(self, gpt, vq_state, voc_state, classes, u=None):
        pipe = self._pipe[0]
        params = _unflatten(self.names, gpt)
        toks = gpt_generate_scan(params, pipe.gcfg,
                                 class_embed(params, classes), u,
                                 steps=self.steps, segments=pipe.segments,
                                 **self.knobs)
        specs = _apply(pipe.vq, vq_state, lambda m, t: pipe.decode_chunk(t),
                       toks)
        wavs = _apply(pipe.melgan, voc_state,
                      lambda m, s: pipe.vocode_chunk(s), specs)
        return toks, specs, wavs


def serving_fn(pipe, *, temperature: float = 1.0, top_k: Optional[int] = 100,
               top_p: Optional[float] = None,
               sample: bool = True) -> ServingProgram:
    """The pipeline's computation as the exportable module (see
    ``ServingProgram``); refuses what the artifact does not cover."""
    if pipe.draft_params is not None:
        raise ValueError("AOT export does not cover speculative decoding "
                         "(draft weights are a second tree; export the "
                         "plain pipeline)")
    if pipe.qstate is not None:
        raise ValueError("AOT export does not cover the int8-decode "
                         "experiment")
    return ServingProgram(pipe, temperature=temperature, top_k=top_k,
                          top_p=top_p, sample=sample)


def example_inputs(pipe, batch: int, sample: bool) -> tuple:
    """The program's inputs at ``batch`` on the pipeline's device: its
    weights, class ids and, with ``sample``, the uniforms."""
    gpt, vq, voc = serving_inputs(pipe)
    args = (gpt, vq, voc, torch.zeros(batch, dtype=torch.int64,
                                       device=pipe.device))
    if sample:
        steps = pipe.vcfg.code_h * pipe.vcfg.code_w
        vocab = pipe.gpt_params["head"]["w"].shape[1]
        args += (torch.full((steps, batch, vocab), 0.5, device=pipe.device),)
    return args


def _allowed(target) -> bool:
    if target is operator.getitem:
        return True
    if isinstance(target, torch._ops.HigherOrderOperator):
        return not target.name().startswith("triton")
    return (isinstance(target, torch._ops.OpOverload)
            and target.namespace in ("aten", "prims"))


def _graph_modules(ep: torch.export.ExportedProgram):
    """(name, graph module) of every graph of ``ep``: the top graph and
    the nested bodies of its higher-order ops."""
    return [(name, gm) for name, gm in ep.graph_module.named_modules()
            if isinstance(gm, torch.fx.GraphModule)]


def check_kernel_free(ep: torch.export.ExportedProgram) -> int:
    """Walk every graph of ``ep`` (the top graph and the nested bodies of
    its ``scan`` / ``while_loop`` / ``cond``) and raise RuntimeError naming
    the first ``call_function`` node whose target is not an ATen or prims
    op, ``operator.getitem`` or one of torch's own higher-order ops: a
    custom op, a kernel of the port or a Triton kernel would pin the
    artifact to what it was traced with.  Returns the graphs walked."""
    graphs = _graph_modules(ep)
    for name, gm in graphs:
        for node in gm.graph.nodes:
            if node.op == "call_function" and not _allowed(node.target):
                raise RuntimeError(
                    f"exported program holds {node.target} (node "
                    f"{node.name!r} of graph {name or '<top>'!r}): only "
                    "ATen / prims ops, getitem and torch's higher-order ops "
                    "may reach the artifact; a kernel leaked into the "
                    "kernel-free export trace (export.serving_fn)")
    return len(graphs)


def export_serving(pipe, batch: int, *, temperature: float = 1.0,
                   top_k: Optional[int] = 100, top_p: Optional[float] = None,
                   sample: bool = True) -> torch.export.ExportedProgram:
    """Trace the pipeline at ``batch`` on its own device, with the kernels
    off, and return the ``torch.export.ExportedProgram`` after
    ``check_kernel_free``."""
    fn = serving_fn(pipe, temperature=temperature, top_k=top_k, top_p=top_p,
                    sample=sample)
    with _build.kernels(False):
        ep = torch.export.export(fn, example_inputs(pipe, batch, sample))
    # the example inputs are the pipeline's weights: torch.export.save
    # would write them into the artifact; the nodes' Python stack traces
    # (debug metadata) would be three quarters of its bytes
    ep.example_inputs = None
    for _, gm in _graph_modules(ep):
        for node in gm.graph.nodes:
            node.meta.pop("stack_trace", None)
    check_kernel_free(ep)
    return ep


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def tree_dtypes(pipe) -> Dict[str, List[str]]:
    """Per-leaf dtypes of the pipeline's three weight sets, in the order
    the artifact takes them: written to the sidecar, so that a server
    built under another dtype policy (float32 on the CPU, bfloat16 on the
    card) casts its weights to what the artifact was traced with."""
    gpt, vq, voc = serving_inputs(pipe)
    return {"gpt": [_dtype_name(t) for t in gpt],
            "vq": [_dtype_name(t) for t in vq.values()],
            "voc": [_dtype_name(t) for t in voc.values()]}


def _cast_tree(tree, dtypes: List[str], name: str):
    """A list of tensors or a state dict cast leaf by leaf to ``dtypes``;
    a different leaf count is a different geometry and raises."""
    items = list(tree.items()) if isinstance(tree, dict) else list(
        enumerate(tree))
    if len(items) != len(dtypes):
        raise ValueError(
            f"artifact expects {len(dtypes)} {name} leaves, live pipeline "
            f"has {len(items)} -- geometry mismatch (wrong checkpoint/preset "
            "for this artifact)")
    cast = [(k, t if _dtype_name(t) == d else t.to(getattr(torch, d)))
            for (k, t), d in zip(items, dtypes)]
    return dict(cast) if isinstance(tree, dict) else [t for _, t in cast]


def save_exported(ep: torch.export.ExportedProgram, path: str,
                  meta: Optional[dict] = None) -> int:
    """Save to ``path``; returns its bytes.  ``meta`` (the baked serving
    knobs, the device type, the weight dtypes) goes to a ``path +
    ".json"`` sidecar, against which a server validates requests."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    torch.export.save(ep, path)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=1)
    return os.path.getsize(path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load an artifact written by ``save_exported``; call it with
    ``.module()(gpt_leaves, vq_state, voc_state, classes[, u])``, the
    weights of exactly the exported geometry and dtypes."""
    return torch.export.load(path)


def load_artifact(path: str):
    """(exported program, meta or None), meta from the ``.json`` sidecar."""
    meta = None
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return load_exported(path), meta


class ArtifactPipeline:
    """``GenerationPipeline.generate``-shaped adapter over a loaded artifact,
    so that ``serving.GenerationService`` (and so the HTTP server) serves
    the exported program.  The batch and the sampling knobs are what
    export baked in: a request with others is refused (re-export for
    another configuration), where the live pipeline would capture anew."""

    def __init__(self, exported, meta: dict, gpt, vq_state, voc_state,
                 device: torch.device, vocab: int):
        self.exported = exported
        self.program = exported.module()
        self.meta = dict(meta)
        self.gpt, self.vq_state, self.voc_state = gpt, vq_state, voc_state
        self.device = device
        self.vocab = vocab
        self.batch = int(meta["batch"])
        self.steps = int(meta["steps"])
        # GenerationService.warmup honours this: only the baked mode exists
        self.sample_modes = (bool(meta["sample"]),)

    @classmethod
    def from_file(cls, path: str, pipe) -> "ArtifactPipeline":
        """Wrap ``path`` around the weights of an already built
        ``GenerationPipeline`` on the device type the artifact was exported
        for, cast leaf by leaf to the dtypes the sidecar records: an
        artifact exported from a float32 pipeline serves a bfloat16 one's
        weights, and the other way round."""
        exported, meta = load_artifact(path)
        if meta is None:
            raise ValueError(f"{path}.json sidecar missing -- export with "
                             f"{EXPORT_SCRIPT} (it records the baked batch "
                             "and sampling knobs)")
        if meta["device"] != pipe.device.type:
            raise ValueError(
                f"{path} was exported for {meta['device']!r} and the "
                f"pipeline runs on {pipe.device.type!r}: an exported graph "
                f"holds the device it was traced on; export on this device "
                f"type ({EXPORT_SCRIPT} --device {pipe.device.type})")
        gpt, vq, voc = serving_inputs(pipe)
        wd = meta.get("weight_dtypes")
        if wd is not None:
            gpt = _cast_tree(gpt, wd["gpt"], "gpt")
            vq = _cast_tree(vq, wd["vq"], "vq")
            voc = _cast_tree(voc, wd["voc"], "voc")
        return cls(exported, meta, gpt, vq, voc, pipe.device,
                   pipe.gpt_params["head"]["w"].shape[1])

    def _check(self, name, requested, baked):
        if requested != baked:
            raise ValueError(
                f"{name}={requested!r} differs from the artifact's baked "
                f"{name}={baked!r}; re-export ({EXPORT_SCRIPT}) for a "
                "different serving configuration")

    def generate(self, classes, generator: Optional[torch.Generator], *,
                 temperature: float = 1.0, top_k: Optional[int] = 100,
                 top_p: Optional[float] = None,
                 sample: bool = True) -> Dict[str, np.ndarray]:
        """classes (batch,) -> dict(tokens, specs, wavs) as host numpy
        arrays, as ``GenerationPipeline.generate``; the uniforms of a
        sampled request come from ``generator`` as ``gpt_generate`` draws
        them."""
        m = self.meta
        self._check("temperature", float(temperature),
                    float(m["temperature"]))
        self._check("top_k", top_k or None, m["top_k"] or None)
        self._check("top_p", top_p or None, m["top_p"] or None)
        self._check("sample", bool(sample), bool(m["sample"]))
        cls = torch.as_tensor(np.asarray(classes), dtype=torch.int64,
                              device=self.device)
        if cls.shape != (self.batch,):
            raise ValueError(f"artifact batch is {self.batch}, got "
                             f"{tuple(cls.shape)} classes")
        args = [self.gpt, self.vq_state, self.voc_state, cls]
        if sample:
            args.append(torch.rand((self.steps, self.batch, self.vocab),
                                   generator=generator, device=self.device))
        with torch.inference_mode():
            toks, specs, wavs = self.program(*args)
        return {"tokens": toks.to(torch.int32).cpu().numpy(),
                "specs": specs.float().cpu().numpy(),
                "wavs": wavs.float().cpu().numpy()}


def artifact_meta(pipe, batch: int, *, temperature: float,
                  top_k: Optional[int], top_p: Optional[float], sample: bool,
                  dataset: str) -> dict:
    """The sidecar of an artifact exported from ``pipe``: the JAX
    package's keys (batch, knobs, dataset, weight dtypes) plus the device
    type and the decode steps."""
    return {"batch": batch, "temperature": temperature,
            "top_k": top_k or None, "top_p": top_p,
            "sample": sample, "dataset": dataset,
            "weight_dtypes": tree_dtypes(pipe),
            "device": pipe.device.type,
            "steps": pipe.vcfg.code_h * pipe.vcfg.code_w}
