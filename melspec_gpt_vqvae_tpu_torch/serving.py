"""Serving layer: checkpoint -> GenerationPipeline, a thread-safe service
and the HTTP server.

Counterpart of melspec_gpt_vqvae_tpu/serving.py.  ``build_pipeline`` makes
the pipeline from a GPT run checkpoint of the port's own ``train_gpt``
(``lightning_logs/{experiment}-{dataset}/checkpoints/version_*``), from
random weights (seeded) or from JAX parameter trees carried across by
bridge.py; with ``model="GPT_VAE"`` the pipeline samples a GPT-VAE's prior
through its decoder (a ``train_gpt_vae`` run's, random, or carried).  The
frozen VQ-VAE and MelGAN come from reference-format files
(utils/convert.py) or from random weights.  It takes the JAX package's
defaults: on the card (the default device) the bfloat16 model dtype, an
int8 KV cache and int8 streamed block weights (serving.py:95-102); on the
CPU, which is used only when the caller names it, float32 and neither;
optionally with a speculative draft, from a run checkpoint or random, and
optionally with the calibrated int8 decode stage (``int8_decode``).
``GenerationService`` pads requests to a fixed batch, serialises
generation with a lock, sheds load past a bounded queue, seeds each
request's ``torch.Generator`` and sums the speculative stats of a request.
``serve`` puts the service behind a standard-library HTTP server with the
JAX package's routes and bodies (serving.py:300-413 there).  export.py
serves a ``torch.export`` artifact of the pipeline through the same
service (``ArtifactPipeline``).

Over a mesh (``build_pipeline(mesh_spec=...)``, one process a GPU under
``torchrun``) rank 0 takes the requests: before each batch it broadcasts
what the batch is (classes, sampling knobs, seed) and every rank generates
it together; the other ranks run ``GenerationService.follow``, a loop that
waits for the next batch and returns when rank 0 sends the stop message
(``stop_followers``).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Mapping, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import bridge
from .configs import ExperimentConfig, load_preset, parse_overrides
from .models.gpt import DTYPES, gpt_param_template, init_gpt_params, tree_to
from .models.gpt_vae import make_vae_configs
from .models.vocoder import MelGANGenerator
from .models.vqvae import VQModel
from .parallel import mesh as pm
from .pipeline import GenerationPipeline, wav_bytes
from .training.checkpoint import CheckpointManager
from .utils import convert, profiling


def random_weights(exp: ExperimentConfig, seed: int):
    """Seeded random (gpt_params, VQModel, MelGANGenerator) on the CPU, in
    ``exp.model.dtype`` for the GPT and float32 for the conv nets; the same
    seed gives the same weights on every machine."""
    g = torch.Generator().manual_seed(seed)
    gpt = init_gpt_params(exp.model, g)
    vq = bridge.init_conv_net_(VQModel(exp.vqvae), g)
    voc = bridge.init_conv_net_(MelGANGenerator(exp.vocoder), g)
    return gpt, vq, voc


def _restore_gpt_params(exp: ExperimentConfig, dataset: str,
                        experiment: str, resume: str,
                        part: Optional[str] = None):
    """(GPT params, epoch) of a run checkpoint of the port
    (``lightning_logs/{experiment}-{dataset}/checkpoints/version_*``, the
    newest version first, ``CheckpointManager``'s fallback to earlier
    ones kept).  ``resume`` is 'best', 'last' or a checkpoint file.  The
    file is mapped, not read: only ``["state"]["params"]`` is touched (at
    the VAS width 1.2 GB of a 3.6 GB train state) -- with ``part``
    ("decoder" of a GPT-VAE run) only that subtree of it.  The params are
    held to ``exp.model``'s geometry; a mismatch raises the ValueError
    with the ``--override`` hint.  Leaves are float32 CPU tensors, as
    saved."""
    root = os.path.join("lightning_logs", f"{experiment}-{dataset}",
                        "checkpoints")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"no checkpoints dir at {root} (wrong --experiment, or the run "
            "never saved, e.g. --ckpt_every -1)")
    versions = sorted((d for d in os.listdir(root)
                       if d.startswith("version_")),
                      key=lambda d: int(d.split("_")[-1]))
    if not versions:
        raise FileNotFoundError(f"no checkpoints under {root}")
    ckpt = CheckpointManager(os.path.join(root, versions[-1]))
    template = gpt_param_template(exp.model)
    if part is not None:
        template = {part: template}
    out = ckpt.restore(resume, template={"state": {"params": template},
                                         "epoch": 0}, mmap=True)
    params = out["state"]["params"]
    return (params if part is None else params[part]), int(out["epoch"])


def build_pipeline(dataset: str = "vas", *, model: str = "GPT",
                   experiment: Optional[str] = None,
                   resume: str = "best", init_random: bool = False,
                   params: Optional[Mapping] = None,
                   vqvae_ckpt: Optional[str] = None,
                   vocoder_ckpt: Optional[str] = None, override: str = "",
                   seed: int = 783435, segments: int = 8, chunk: int = 128,
                   kv_cache: Optional[str] = None,
                   int8_weights: Optional[int] = None, device=None,
                   mesh_spec: str = "",
                   draft_experiment: Optional[str] = None,
                   draft_resume: str = "best", draft_override: str = "",
                   draft_random: str = "", gamma: int = 4,
                   int8_decode: bool = False, graph: bool = True,
                   use_kernels: Optional[bool] = None):
    """Construct the GenerationPipeline on ``device``: None means the
    card, and without one this raises -- the CPU is taken only when asked
    for with ``device="cpu"``.

    The GPT comes from exactly one of: ``experiment`` (a run checkpoint,
    ``resume`` 'best', 'last' or a file: ``_restore_gpt_params``),
    ``init_random`` (random weights from ``seed``) or ``params = {"gpt":
    ..., "vqvae": ..., "vocoder": ...}``, the JAX package's parameter trees
    with numpy leaves.  The VQ-VAE and the MelGAN come from
    ``vqvae_ckpt`` / ``vocoder_ckpt`` (reference-format files,
    utils/convert.py; the vocoder's geometry from its ``args.yml``), else
    from ``params``, else random from ``seed``.  ``kv_cache`` is "auto",
    "int8" or "int4" (None: "int8" on the card, "auto" on the CPU);
    ``int8_weights`` streams int8 block weights in decode (None: on the
    card).  A speculative draft comes from ``draft_experiment`` (its
    checkpoint ``draft_resume``), ``params["draft"]`` or, with
    ``draft_random`` (overrides such as "n_layer=4"), random weights from
    ``seed + 1``; its config is the target's overrides plus
    ``draft_override`` and ``draft_random`` (serving.py:115-146).
    ``graph=False`` makes the pipeline decode with the eager loop instead
    of the captured program (pipeline.py), for a comparison;
    ``use_kernels`` is the pipeline's kernel switch (False: no kernel of
    the port runs); ``int8_decode`` calibrates the int8 decode stage and
    runs the VQ decode and the vocoder through it (in place of kernel B).
    ``mesh_spec`` ("data=2,model=2"; the product is the world size) serves
    over the ranks of a process group, joined here
    (``parallel.mesh.maybe_init_distributed``: the group ``torchrun``
    describes, NCCL on the card -- this rank's ``cuda:LOCAL_RANK`` -- and
    gloo only with ``device="cpu"``; or the group the caller joined):
    every rank builds the same pipeline and keeps its shard
    (``GenerationPipeline(mesh=)``, ``pipe.mesh``): the GPT and draft
    trees stay on the host, where each rank cuts them leaf by leaf and
    moves its parts alone to its card.
    ``model`` names the preset: "GPT", the class-conditional GPT, or
    "GPT_VAE", a GPT-VAE served from its prior: ``exp.model`` is then the
    decoder's config (``make_vae_configs``) and the GPT weights are the
    decoder's -- of a ``train_gpt_vae`` run (``experiment``), random, or
    ``params["gpt"]["decoder"]`` of a JAX GPT-VAE tree; the encoder is
    never built, and a draft is refused.
    Prints where each set of weights came from, as the JAX loader does.
    Returns ``(exp, pipe)``.
    """
    if (experiment is not None) + bool(init_random) + (params is not None) \
            != 1:
        raise ValueError("pass exactly one of experiment=, "
                         "init_random=True or params=")
    if model not in ("GPT", "GPT_VAE"):
        raise ValueError(f"model={model!r}: expected 'GPT' or 'GPT_VAE'")
    prior = model == "GPT_VAE"
    if prior and (draft_experiment or draft_random or draft_override
                  or (params is not None and "draft" in params)):
        raise ValueError("a GPT-VAE's prior is sampled without a draft "
                         "(speculative decoding is for class prompts)")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('build_pipeline: no CUDA card is visible; the '
                           'port serves on the card unless the caller asks '
                           'for the CPU with device="cpu"')
    mesh = None
    if mesh_spec:
        device = pm.maybe_init_distributed(device)
        mesh = pm.make_mesh(pm.parse_mesh(mesh_spec), device)
        print(f"mesh: {mesh.shape} (rank {mesh.rank}, {device})")
    on_card = device.type == "cuda"
    kv = kv_cache or ("int8" if on_card else "auto")
    if kv not in ("auto", "int8", "int4"):
        raise ValueError(f"kv_cache={kv!r}: expected 'auto', 'int8' or "
                         "'int4'")
    int8_w = int8_weights if int8_weights is not None else int(on_card)
    dtypes = dict(dtype="bfloat16" if on_card else "float32",
                  cache_dtype=kv,
                  decode_weight_dtype="int8" if int8_w else "auto")
    exp = load_preset(model, dataset, **parse_overrides(override))
    exp = dataclasses.replace(exp, model=exp.model.replace(**dtypes))
    if prior:   # the decoder alone: prior sampling never runs the encoder
        exp = dataclasses.replace(
            exp, model=make_vae_configs(exp.model, exp.vae).decoder)

    # --- GPT weights ------------------------------------------------------
    vq = voc = None
    what = "GPT-VAE decoder" if prior else "GPT"
    if init_random:
        gpt, vq, voc = random_weights(exp, seed)
        print(f"{what}: random init (--init_random)")
    elif params is not None:
        gpt = bridge.gpt_params_from_jax(
            params["gpt"]["decoder"] if prior else params["gpt"])
        print(f"{what}: JAX parameter tree")
    else:
        gpt, epoch = _restore_gpt_params(exp, dataset, experiment, resume,
                                         "decoder" if prior else None)
        print(f"{what}: restored {resume} (epoch {epoch})")
    # the trees stay on the host: the pipeline places them (over a mesh,
    # cut leaf by leaf, this rank's parts alone)
    gpt = tree_to(gpt, dtype=DTYPES[exp.model.dtype])

    # --- optional speculative draft ----------------------------------------
    draft, draft_cfg = None, None
    carried = params is not None and "draft" in params
    if draft_override and not (draft_experiment or draft_random or carried):
        raise ValueError("draft_override needs draft_experiment, "
                         "draft_random or params['draft']")
    if draft_experiment or draft_random or carried:
        d_ov = {**parse_overrides(override),
                **parse_overrides(draft_override),
                **parse_overrides(draft_random)}
        d_exp = load_preset("GPT", dataset, **d_ov)
        d_exp = dataclasses.replace(d_exp,
                                    model=d_exp.model.replace(**dtypes))
        draft_cfg = d_exp.model
        for f in ("vocab_size", "block_size", "class_size"):
            if getattr(draft_cfg, f) != getattr(exp.model, f):
                raise ValueError(
                    f"draft {f}={getattr(draft_cfg, f)} must equal the "
                    f"target's {getattr(exp.model, f)} (the speculative "
                    "accept/reject compares the two distributions)")
        if draft_experiment:
            draft, d_epoch = _restore_gpt_params(d_exp, dataset,
                                                 draft_experiment,
                                                 draft_resume)
            print(f"draft GPT: restored {draft_experiment} (epoch "
                  f"{d_epoch}, {draft_cfg.n_layer}L, gamma={gamma})")
        elif carried:
            draft = bridge.gpt_params_from_jax(params["draft"])
            print(f"draft GPT: JAX parameter tree ({draft_cfg.n_layer}L, "
                  f"gamma={gamma})")
        else:
            draft = init_gpt_params(draft_cfg,
                                    torch.Generator().manual_seed(seed + 1))
            print(f"draft GPT: random init ({draft_cfg.n_layer}L, "
                  f"gamma={gamma})")
        draft = tree_to(draft, dtype=DTYPES[draft_cfg.dtype])

    # --- frozen decoders -------------------------------------------------
    if experiment is not None and not (vqvae_ckpt and vocoder_ckpt):
        g = torch.Generator().manual_seed(seed)
        vq = bridge.init_conv_net_(VQModel(exp.vqvae), g)
        voc = bridge.init_conv_net_(MelGANGenerator(exp.vocoder), g)
    if vqvae_ckpt:
        vq = convert.load_vqvae_params(vqvae_ckpt, exp.vqvae)
        print(f"VQ-VAE: {vqvae_ckpt}")
    elif params is not None:
        vq = bridge.load_vqvae(params["vqvae"], exp.vqvae)
    else:
        print("VQ-VAE: random init (pass --vqvae_ckpt for real audio)")
    if vocoder_ckpt:
        voc, voc_cfg = convert.load_vocoder_params(vocoder_ckpt)
        exp = dataclasses.replace(exp, vocoder=voc_cfg)
        print(f"vocoder: {vocoder_ckpt}")
    elif params is not None:
        voc = bridge.load_melgan(params["vocoder"], exp.vocoder)
    else:
        print("vocoder: random init (pass --vocoder_ckpt for real audio)")

    pipe = GenerationPipeline(exp, gpt, vq, voc, segments=segments,
                              chunk=chunk, draft_params=draft,
                              draft_cfg=draft_cfg, gamma=gamma, graph=graph,
                              use_kernels=use_kernels,
                              int8_decode=int8_decode, mesh=mesh,
                              device=device)
    if int8_decode:
        print(f"int8 decode stage: calibrated in "
              f"{pipe.calibrate_seconds:.2f} s")
    return exp, pipe


class ServiceOverloaded(RuntimeError):
    """Raised when the bounded request queue is full: shedding load beats
    unbounded queueing on one card."""


class GenerationService:
    """Thread-safe, fixed-batch wrapper around a GenerationPipeline.  Over
    a mesh (``pipe.mesh``) the data axis must divide the batch; rank 0's
    service takes the requests and the others ``follow`` it.  Over a
    latent-prompt pipeline (a GPT-VAE's prior, ``pipe.prompt``) a request
    is a count of clips, ``generate(clips=N)``."""

    def __init__(self, exp: ExperimentConfig, pipe: GenerationPipeline, *,
                 batch: int = 8, seed: int = 783435,
                 temperature: float = 1.0, top_k: Optional[int] = 100,
                 top_p: Optional[float] = None, max_queue: int = 16):
        self.exp = exp
        self.pipe = pipe
        self.batch = max(1, int(batch))
        self.mesh = getattr(pipe, "mesh", None)
        self.prior = getattr(pipe, "prompt", "class") == "latent"
        dp = pm.data_size(self.mesh)
        if self.batch % dp:
            raise SystemExit(f"the mesh data axis ({dp}) must divide "
                             f"--batch ({batch})")
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

    def generate(self, classes=None, *, clips: Optional[int] = None,
                 temperature=None, top_k=None, top_p=None,
                 sample: bool = True,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One clip per entry of ``classes``, or over a GPT-VAE's prior
        ``clips`` clips (their ``latents`` returned too); padded to the
        serving batch, split when longer.  Recorded as the span
        ``service.request``, the root of the request's spans."""
        cs = self._prompt(classes, clips)
        with profiling.span("service.request", request=True,
                            clips=cs if self.prior else cs.size,
                            sample=sample):
            return self._generate(cs, temperature, top_k, top_p, sample,
                                  seed)

    def _prompt(self, classes, clips):
        """The request's prompt: its class ids, or over the prior the count
        of clips (the pipeline draws their latents)."""
        if self.prior:
            if classes is not None or clips is None or int(clips) < 1:
                raise ValueError("the GPT-VAE's prior takes clips=N (N >= "
                                 "1) and no classes")
            return int(clips)
        if clips is not None:
            raise ValueError("clips= is a prior request; a class-"
                             "conditional GPT takes classes")
        cs = np.asarray(classes, np.int32)
        if cs.ndim != 1 or len(cs) == 0:
            raise ValueError("classes must be a non-empty 1-D list")
        if (cs < 0).any() or (cs >= self.exp.model.class_size).any():
            raise ValueError(
                f"class indices must be in [0, {self.exp.model.class_size})")
        return cs

    def _generate(self, cs, temperature, top_k, top_p, sample, seed):
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

    @contextlib.contextmanager
    def _locked(self):
        """Hold the service's lock; the wait for it is the span
        ``service.wait``."""
        with profiling.span("service.wait"):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    def _generate_locked(self, cs, t, k, p, sample, seed):
        parts: Dict[str, list] = {}
        agg = {"rounds": 0, "drafted": 0, "accepted": 0}
        with self._locked():
            rows = cs if self.prior else len(cs)
            for i in range(0, rows, self.batch):
                n = min(self.batch, rows - i)
                if self.prior:   # a full serving batch of latents
                    part = self.batch
                else:
                    part = cs[i:i + n]
                    if n < self.batch:   # pad to the fixed serving batch
                        part = np.concatenate(
                            [part, np.repeat(part[-1:], self.batch - n)])
                s = ((int(seed) + i) & 0xFFFFFFFF if seed is not None else
                     int(torch.randint(2 ** 62, (1,), generator=self._seeds)))
                job = {"prompt": part, "temperature": t, "top_k": k,
                       "top_p": p, "sample": sample, "seed": s}
                if self._leads():
                    pm.broadcast_object(job)
                out = self._run(job)
                for f in ("wavs", "tokens", "specs", "latents"):
                    if f in out:
                        parts.setdefault(f, []).append(out[f][:n])
                for f in agg:   # whole-request stats, not the last part's
                    agg[f] += out.get("spec_stats", {}).get(f, 0)
            self.requests += 1
        res = {f: np.concatenate(xs) for f, xs in parts.items()}
        if agg["drafted"]:
            agg["accept_rate"] = round(agg["accepted"] / agg["drafted"], 4)
            res["spec_stats"] = agg
        return res

    def _leads(self) -> bool:
        """True on rank 0 of a mesh of more than one process."""
        return self.mesh is not None and pm.process_count() > 1

    def _run(self, job) -> Optional[Dict[str, np.ndarray]]:
        """One batch (``job``: what rank 0 broadcasts) through the
        pipeline; None off rank 0 of a mesh."""
        gen = torch.Generator(device=self.pipe.device).manual_seed(
            job["seed"])
        return self.pipe.generate(job["prompt"], gen,
                                  temperature=job["temperature"],
                                  top_k=job["top_k"], top_p=job["top_p"],
                                  sample=job["sample"])

    def follow(self) -> int:
        """The loop of a rank other than 0 of a mesh: receive each batch
        rank 0 broadcasts and generate it with the others, until the stop
        message, then drop the pipeline's captured programs (they hold the
        group's communicators).  Returns the batches generated."""
        n = 0
        while True:
            job = pm.broadcast_object(None)
            if job is None:
                graphs = getattr(self.pipe, "graphs", None)
                if graphs is not None:
                    graphs.clear()
                return n
            self._run(job)
            n += 1

    def stop_followers(self) -> None:
        """Rank 0 of a mesh: send the followers the stop message."""
        if self._leads():
            with self._lock:
                pm.broadcast_object(None)

    def warmup(self):
        """Run one request in each sample mode the pipeline serves before
        taking traffic (the first calls on the card build the kernels and
        capture the decode programs).  A pipeline that serves fewer modes
        says so in ``sample_modes``, as the JAX package's artifact
        pipeline does (serving.py:289-297 there)."""
        t0 = time.time()
        one = {"clips": 1} if self.prior else {"classes": [0]}
        for mode in getattr(self.pipe, "sample_modes", (True, False)):
            self.generate(sample=mode, **one)
        print(f"warmup: {time.time() - t0:.1f}s (batch {self.batch})")


class _Handler(BaseHTTPRequestHandler):
    """The JAX package's routes (serving.py:300-405 there):
    ``GET /healthz``, ``GET /generate?class=3`` (audio/wav) and ``POST
    /generate`` with a JSON body; 400 for bad input, 404 for another path,
    503 with ``Retry-After`` when the service sheds load."""

    server_version = "melspec-gpt-vqvae-torch"

    def _send(self, code: int, body: bytes, ctype: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj, headers=()):
        self._send(code, json.dumps(obj).encode(), "application/json",
                   headers)

    def log_message(self, fmt, *args):   # quiet unless asked
        if os.environ.get("SERVE_VERBOSE"):
            super().log_message(fmt, *args)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/healthz":
            svc = self.server.service
            return self._json(200, {
                "status": "ok",
                "platform": svc.pipe.device.type,
                "model": {"n_layer": svc.exp.model.n_layer,
                          "n_embd": svc.exp.model.n_embd,
                          "class_size": svc.exp.model.class_size},
                "batch": svc.batch,
                "uptime_s": round(time.time() - svc.started, 1),
                "requests": svc.requests,
                "queue": {"pending": svc._pending,
                          "max": svc.max_queue, "shed": svc.shed}})
        if url.path == "/generate":
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            if "classes" in params:
                params["classes"] = [int(c) for c in
                                     params["classes"].split(",")]
            return self._generate(params)
        return self._json(404, {"error": f"unknown path {url.path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/generate":
            return self._json(404, {"error": f"unknown path {url.path}"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            params = json.loads(self.rfile.read(n) or b"{}")
        except ValueError as e:    # json.JSONDecodeError is a ValueError
            return self._json(400, {"error": f"bad JSON body: {e}"})
        return self._generate(params)

    def _generate(self, params):
        svc = self.server.service
        try:
            num = int(params.get("num", 1))
            if svc.prior:   # ``num`` clips from the prior; no classes
                classes, n_clips = None, num
                prompt = {"clips": num}
            else:
                classes = params.get("classes",
                                     [int(params.get("class", 0))])
                if isinstance(classes, int):
                    classes = [classes]
                classes = [c for c in classes for _ in range(num)]
                n_clips = len(classes)
                prompt = {"classes": classes}
            if num < 1 or n_clips > 64 * svc.batch:
                raise ValueError("num out of range")
            fmt = params.get("format", "wav" if n_clips == 1 else "json")
            if fmt == "wav" and n_clips != 1:
                # refused before a decode is spent on the batch
                raise ValueError("format=wav needs exactly 1 clip")
            det = params.get("deterministic", False)
            if isinstance(det, str):   # the GET query form
                det = det.lower() in ("1", "true", "yes")
            t0 = time.time()
            out = svc.generate(temperature=params.get("temperature"),
                               top_k=params.get("top_k"),
                               top_p=params.get("top_p"), sample=not det,
                               seed=params.get("seed"), **prompt)
        except ServiceOverloaded as e:
            # shed load rather than queue without bound: clients back off
            return self._json(503, {"error": str(e)},
                              headers=[("Retry-After", "2")])
        except (ValueError, TypeError) as e:
            return self._json(400, {"error": str(e)})
        sr = svc.exp.data.sample_rate
        if fmt == "wav":
            return self._send(200, wav_bytes(out["wavs"][0], sr),
                              "audio/wav")
        clips = [{"wav_base64": base64.b64encode(
                      wav_bytes(w, sr)).decode()} for w in out["wavs"]]
        for clip, c in zip(clips, classes or ()):
            clip["class"] = int(c)
        body = {"clips": clips, "sample_rate": sr,
                "seconds": round(time.time() - t0, 3)}
        if out.get("spec_stats"):
            body["speculative"] = out["spec_stats"]
        return self._json(200, body)


def serve(service: GenerationService, host: str = "127.0.0.1",
          port: int = 8000) -> ThreadingHTTPServer:
    """The HTTP server over ``service`` (returned; call ``serve_forever``
    to answer requests).  Port 0 takes a free port: read it from
    ``server_address``."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.service = service
    return httpd
