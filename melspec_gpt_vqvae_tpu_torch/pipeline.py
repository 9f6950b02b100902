"""Batched generation pipeline: class-conditional GPT sampling (or a
GPT-VAE decoder sampling its prior) -> VQ-VAE decode -> MelGAN vocoder ->
waveforms, plus the tokenize stage in front.

Counterpart of melspec_gpt_vqvae_tpu/pipeline.py (the reference runs this
flow only inside its logging callbacks, transformer/minGPT.py:530-612 and
callbacks/GPT_callbacks.py:93-111).  As there: KV-cached segmented decode,
the conv stages chunked so their activations do not cap the decode batch,
and the conv stacks in bfloat16 on the card while every codebook argmin
stays float32 (ops/vq.py).  PyTorch runs eagerly; the stages are methods a
caller can time one by one, and each is a span of utils/profiling.py
(``pipeline.<stage>``, with the device's time between its two events).
The one program that is kept is the decode loop's body: on the card a
token's sampling and decode step are one captured CUDA graph
(models/decode_graph.py), made at the first request of a shape and
replayed from then on.  With ``int8_decode`` the VQ decode
and vocoder stages run the calibrated int8 convolutions of
models/quantized.py, as the JAX pipeline's int8 decode stage does.  Over a
mesh (``mesh=``) one process a GPU serves: every rank decodes its share
of the batch or of the heads in step with the others, and rank 0 gathers
the clips.
"""

from __future__ import annotations

import io
import threading
import time
import wave
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .configs import ExperimentConfig, MelConfig

from .models import quantized as qz
from .models.decode_graph import DecodeGraphs
from .models.gpt import (BLOCK_MATRICES, BlockWeightCache, class_embed,
                         gpt_generate, quantize_block_weight, tree_to)
from .models.speculative import gpt_speculative_generate
from .models.vocoder import MelGANGenerator
from .models.vqvae import VQModel
from .ops.mel_kernel import waveform_to_mel_fused
from .parallel import mesh as pm
from .utils import profiling


def _chunked(fn, x: torch.Tensor, chunk: int) -> torch.Tensor:
    if not chunk or x.shape[0] <= chunk:
        return fn(x)
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)])


def _served_device(mesh, device) -> torch.device:
    """Where a served rank places its weights: ``device``, else the
    mesh's own (the card under NCCL) -- never inferred from a tree that
    lies on the host.  A device of another kind than the mesh's is
    refused."""
    device = mesh.device if device is None else torch.device(device)
    if device.type != mesh.device.type:
        raise ValueError(f"device {device} is not of the mesh's kind "
                         f"({mesh.device})")
    return device


def _served_weights(mesh, params, cfg, device):
    """(this rank's parts of a served GPT tree, of its int8 block copy or
    None) on ``device``, cut from the full leaves where they lie (the
    host, for the trees ``build_pipeline`` holds) one leaf at a time:
    each block matrix is quantised over its whole ``in`` axis (a row-cut
    product's scales are the whole column's), cut with its scales and
    placed before the next is quantised, so no full block leaf, float or
    int8, reaches the device."""
    wq = None
    if cfg.decode_weight_dtype == "int8":
        wq = {name: pm.shard_block_weight(
            mesh, name, quantize_block_weight(params["blocks"][name]["w"]),
            cfg.n_head, device) for name in BLOCK_MATRICES}
    return pm.shard_gpt_for_serving(mesh, params, cfg.n_head, device), wq


class GenerationPipeline:
    """Class ids -> tokens, spectrograms and waveforms on one device.

    ``gpt_params`` is the nested dict of models/gpt.py, already in the model
    dtype; ``vq`` and ``melgan`` are the port's modules.

    The prompt is a class id (``prompt == "class"``) where ``exp.model``
    has a ``class_size``.  Without one the GPT is a GPT-VAE's decoder
    (``exp.model`` is ``make_vae_configs(base, exp.vae).decoder``,
    ``gpt_params`` its tree) and the prompt is a latent (``"latent"``):
    a request names a count of clips, and ``generate_tokens`` draws their
    latents from the prior with the request's generator
    (``sample_from_prior``, on the device, before the sampling uniforms)
    and hands them to ``gpt_generate`` as the one-position conditioning,
    through the same captured programs, int8 weights and lock as a class
    batch (Lit_GPT_VAE.py:611-617's sample-from-prior path).  With ``bf16``
    (default: on CUDA) the conv modules are cast to bfloat16.  With
    ``draft_params`` and ``draft_cfg`` the tokens come from speculative
    decoding (models/speculative.py), ``gamma`` proposals a round, and
    ``generate`` reports its acceptance as ``spec_stats``
    (pipeline.py:128-146, 227-233 of the JAX package).

    The pipeline owns what decoding keeps across requests: the int8 copies
    of the GPT's (and the draft's) block weights, redone when the weights
    change (``BlockWeightCache``), and the captured decode programs
    (``self.graphs``).  The first request of a shape (batch, sampling
    arguments) pays for its capture.  With ``graph=False`` every request
    runs the eager loop instead (for a comparison; slow on the card).
    The captured programs share static buffers, so ``generate_tokens`` is
    not re-entrant: a lock serialises callers.

    ``device``: where the pipeline runs (None: over a mesh, the mesh's
    device; else where ``gpt_params`` lie); the trees are moved there.
    Pass it when they lie on the host and there is no mesh.

    ``mesh`` (parallel/mesh.py, over ranks that all build this pipeline
    from the same full weights and call ``generate`` with the same
    arguments; the JAX pipeline's pipeline.py:73-122, 213-215): the GPT
    and the draft are cut over ``model`` (``shard_gpt_for_serving``) and
    replicated over ``data``, their int8 block weights quantised once from
    the full weights and cut (``shard_block_weight``) -- where the trees
    lie, one leaf at a time, only this rank's parts moved to ``device``
    (``_served_weights``) -- the class batch
    sliced over ``data`` (``local_batch_slice``; the data axis must divide
    it).  Each data rank of model coordinate 0 decodes and vocodes its
    slice through the replicated VQ-VAE and MelGAN (or the int8 stage's
    replicated state); rank 0's ``generate`` returns the whole batch,
    gathered, and every other rank's None.

    ``use_kernels`` is the counterpart of the JAX pipeline's
    ``use_pallas``, and the one place the port's kernel switch is set:
    each stage runs inside ``_build.kernels(use_kernels)``, which every
    kernel wrapper reads.  None takes each kernel for CUDA tensors; False
    runs every stage through the kernels' plain versions (``attend_xla``,
    the plain decode attention and int8 product, the conv chain of the
    vocoder), the decode loop still captured on the card; True raises on
    the CPU.

    ``int8_decode`` calibrates the int8 decode stage at construction
    (models/quantized.py ``build_qstate``: 32 seeded random code grids,
    batches of 16; ``calibrate_seconds``) and runs ``decode_specs`` and
    ``vocode`` through its int8 convolutions, which take the place of
    kernel B, as the JAX pipeline's int8 stage takes that of its fused
    vocoder (pipeline.py:104-107, 166-195 there).

    Counters: ``class_rows`` and ``latent_rows``, the prompt rows this
    pipeline has decoded (this rank's, over a mesh).
    """

    def __init__(self, exp: ExperimentConfig, gpt_params, vq: VQModel,
                 melgan: MelGANGenerator, *, segments: int = 8,
                 chunk: int = 128, bf16: Optional[bool] = None,
                 draft_params=None, draft_cfg=None, gamma: int = 4,
                 graph: bool = True, use_kernels: Optional[bool] = None,
                 int8_decode: bool = False, mesh=None, device=None):
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("pass both draft_params and draft_cfg, or "
                             "neither")
        self.prompt = "latent" if exp.model.class_size is None else "class"
        if self.prompt == "latent":
            if draft_params is not None:
                raise ValueError("speculative decoding is for class "
                                 "prompts: a GPT-VAE's prior takes no "
                                 "draft")
            if exp.vae.nz != exp.model.n_embd:
                raise ValueError(f"the latent (nz {exp.vae.nz}) is the "
                                 "decoder's one-position prompt: nz must "
                                 f"be n_embd ({exp.model.n_embd})")
        self.mesh = mesh
        self._mesh_wq = {}
        if mesh is not None:
            if mesh.has(pm.PIPE_AXIS):
                raise ValueError("serving takes data and model axes, not "
                                 "pipe")
            device = _served_device(mesh, device)
            pm.check_divisible(mesh, exp.model)
            gpt_params, self._mesh_wq["gpt"] = _served_weights(
                mesh, gpt_params, exp.model, device)
            if draft_params is not None:
                pm.check_divisible(mesh, draft_cfg)
                draft_params, self._mesh_wq["draft"] = _served_weights(
                    mesh, draft_params, draft_cfg, device)
        elif device is not None:
            gpt_params = tree_to(gpt_params, device=device)
            if draft_params is not None:
                draft_params = tree_to(draft_params, device=device)
        self.exp = exp
        self.gcfg = exp.model
        self.vcfg = exp.vqvae
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.gamma = gamma
        self.device = gpt_params["tok_emb"].device
        if bf16 is None:
            bf16 = self.device.type == "cuda"
        dtype = torch.bfloat16 if bf16 else torch.float32
        self.gpt_params = gpt_params
        self.vq = vq.to(device=self.device, dtype=dtype).eval()
        self.melgan = melgan.to(device=self.device, dtype=dtype).eval()
        self.segments = segments
        self.chunk = chunk
        self.bf16 = bf16
        self.graph = graph
        self.use_kernels = use_kernels
        self.graphs = DecodeGraphs()
        self.class_rows = 0
        self.latent_rows = 0
        self.block_weights = BlockWeightCache()
        self.draft_block_weights = BlockWeightCache()
        self._decode_lock = threading.Lock()
        self.qstate = None
        self.calibrate_seconds = None
        if int8_decode:
            t0 = time.perf_counter()
            with _build.kernels(use_kernels):
                self.qstate = qz.build_qstate(self.vq, self.melgan,
                                              self.vcfg, exp.vocoder,
                                              n_calib=32, batch=16)
            self.calibrate_seconds = time.perf_counter() - t0

    def _wq(self, cache: BlockWeightCache, params, cfg, name):
        if cfg.decode_weight_dtype != "int8":
            return None
        if self.mesh is not None:   # cut from the full weights' once
            return self._mesh_wq[name]
        return cache.get(params["blocks"])

    def _local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if self.mesh is None:
            return slice(0, n)
        d = pm.data_size(self.mesh)
        if n % d:
            raise ValueError(f"the mesh data axis ({d}) must divide "
                             f"the batch ({n})")
        return pm.local_batch_slice(n, self.mesh)

    def _prompt(self, classes, generator):
        """(the conditioning embedding (B, 1, D) of this rank's rows, the
        prompt's tensor: class ids, or the latents (B, nz) float32)."""
        if self.prompt == "class":
            cls = torch.as_tensor(np.asarray(classes), dtype=torch.int64,
                                  device=self.device)
            cls = cls[self._local_rows(len(cls))]
            self.class_rows += len(cls)
            return class_embed(self.gpt_params, cls), cls
        n = int(classes)
        rows = self._local_rows(n)
        nz = self.exp.vae.nz
        # the global batch's latents from the request's generator, before
        # its sampling uniforms (``sample_from_prior``'s draw), then this
        # rank's rows
        with profiling.span("pipeline.prior_latents", rows=n, nz=nz):
            dev = self.device if generator is None else generator.device
            z = torch.randn((n, nz), generator=generator,
                            device=dev).to(self.device)
        z = z[rows]
        self.latent_rows += len(z)
        return z[:, None, :], z

    @torch.inference_mode()
    def generate_tokens(self, classes, generator: Optional[torch.Generator],
                        *, temperature: float = 1.0,
                        top_k: Optional[int] = 100,
                        top_p: Optional[float] = None,
                        sample: bool = True) -> Tuple[torch.Tensor, Dict]:
        """classes (N,) -> ((N, code_h * code_w) GPT-order tokens,
        speculative stats ({} without a draft)).  A latent-prompt pipeline
        takes the count of clips N in place of ``classes`` and returns
        ``{"latents": (N, nz) float32}``, the prior draws the tokens were
        decoded from, in place of the stats.  Not re-entrant (the captured
        programs replay over shared buffers): concurrent callers wait for
        each other on the pipeline's lock.  Over a mesh: the tokens (and
        latents) of this rank's rows (``local_batch_slice``) of the global
        batch."""
        # captured programs on the card, the eager loop on the CPU (None)
        graph = False if not self.graph else (
            self.graphs if self.device.type == "cuda" else None)
        kw = dict(steps=self.vcfg.code_h * self.vcfg.code_w,
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  sample=sample, graph=graph, mesh=self.mesh)
        with profiling.span("pipeline.generate_tokens", device=self.device,
                            prompt=self.prompt):
            cond, given = self._prompt(classes, generator)
            with self._decode_lock, _build.kernels(self.use_kernels):
                wq = self._wq(self.block_weights, self.gpt_params,
                              self.gcfg, "gpt")
                if self.draft_params is None:
                    toks = gpt_generate(self.gpt_params, self.gcfg,
                                        generator, cond,
                                        segments=self.segments, wq=wq, **kw)
                    return toks, ({"latents": given}
                                  if self.prompt == "latent" else {})
                return gpt_speculative_generate(
                    self.gpt_params, self.gcfg, self.draft_params,
                    self.draft_cfg, generator, cond,
                    class_embed(self.draft_params, given), gamma=self.gamma,
                    wq=wq, draft_wq=self._wq(self.draft_block_weights,
                                             self.draft_params,
                                             self.draft_cfg, "draft"),
                    **kw)

    def decode_chunk(self, tokens: torch.Tensor) -> torch.Tensor:
        """``decode_specs`` of one chunk, in the caller's kernel scope."""
        # GPT order -> (B, code_h, code_w) raster: the tensor form of
        # utils.codes.sequence_to_grid (melspec_gpt_vqvae_tpu/
        # pipeline.py:163-165; reference minGPT.py:438-456)
        grid = tokens.reshape(-1, self.vcfg.code_w, self.vcfg.code_h)
        grid = grid.transpose(1, 2)
        if self.qstate is not None:
            return qz.decode_code_apply(self.vq, self.vcfg, grid,
                                        qz.Int8Convs(self.qstate))[..., 0]
        return self.vq.decode_code(grid)[..., 0]

    def vocode_chunk(self, specs: torch.Tensor) -> torch.Tensor:
        """``vocode`` of one chunk, in the caller's kernel scope."""
        # dataset scaling [-1, 1] -> [0, 1] mel (datasets/vas.py:81)
        mel01 = torch.clamp((specs.float() + 1.0) / 2.0, 0.0, 1.0)
        mel = mel01.to(self.melgan.conv_in.weight.dtype).transpose(1, 2)
        if self.qstate is not None:
            return qz.melgan_apply(self.melgan, self.exp.vocoder, mel,
                                   qz.Int8Convs(self.qstate))
        return self.melgan(mel)

    @torch.inference_mode()
    def decode_specs(self, tokens: torch.Tensor) -> torch.Tensor:
        """GPT-order tokens (N, S) -> spectrograms (N, H, W) in [-1, 1]."""
        with profiling.span("pipeline.decode_specs", device=self.device), \
                _build.kernels(self.use_kernels):
            return _chunked(self.decode_chunk, tokens, self.chunk)

    @torch.inference_mode()
    def vocode(self, specs: torch.Tensor) -> torch.Tensor:
        """Spectrograms (N, H, W) in [-1, 1] -> waveforms (N, W * hop)."""
        with profiling.span("pipeline.vocode", device=self.device), \
                _build.kernels(self.use_kernels):
            return _chunked(self.vocode_chunk, specs, self.chunk)

    def tokenize(self, wav: torch.Tensor,
                 mel_cfg: Optional[MelConfig] = None) -> torch.Tensor:
        """``tokenize`` through this pipeline's VQ-VAE, inside its kernel
        switch's scope."""
        with _build.kernels(self.use_kernels):
            return tokenize(self.vq, wav, mel_cfg or self.exp.mel)

    def generate(self, classes, generator: Optional[torch.Generator], *,
                 temperature: float = 1.0, top_k: Optional[int] = 100,
                 top_p: Optional[float] = None,
                 sample: bool = True) -> Optional[Dict[str, np.ndarray]]:
        """classes (N,) -> dict(tokens (N, S) int32, specs (N, H, W),
        wavs (N, samples)) as host numpy arrays, plus ``spec_stats``
        (rounds, drafted, accepted, accept_rate) with a draft; a
        latent-prompt pipeline takes the count N and adds ``latents`` (N,
        nz) float32.  Over a mesh every rank calls it with the same
        arguments (the generator seeded alike); rank 0 gets the whole
        batch, the others None."""
        toks, extra = self.generate_tokens(
            classes, generator, temperature=temperature, top_k=top_k,
            top_p=top_p, sample=sample)
        mesh = self.mesh
        if mesh is not None and mesh.coord(pm.MODEL_AXIS) != 0:
            return None   # a replica of its model group's rank 0 rows
        specs = self.decode_specs(toks)
        wavs = self.vocode(specs)
        rows = {"tokens": toks, "specs": specs, "wavs": wavs}
        if "latents" in extra:
            rows["latents"] = extra.pop("latents")
        if mesh is not None:
            rows = {k: pm.gather_rows(mesh, t) for k, t in rows.items()}
            if not pm.is_primary():
                return None
        with profiling.span("pipeline.to_host"):
            out = {"tokens": rows.pop("tokens").to(torch.int32).cpu().numpy()}
            out.update((k, t.float().cpu().numpy()) for k, t in rows.items())
        if extra:
            drafted = max(1, extra["drafted"])
            out["spec_stats"] = {**extra, "drafted": drafted,
                                 "accept_rate": round(
                                     extra["accepted"] / drafted, 4)}
        return out


@torch.inference_mode()
def tokenize(vq: VQModel, wav: torch.Tensor,
             mel_cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """wav (B, samples) -> (B, code_h * code_w) GPT-order codes.

    The tokenize stage that bench.py:86-103 times in front of generation:
    mel (kernel D on the card), centre crop of the 860 frames to the
    VQ-VAE's width (848: frames 6..853), scale to [-1, 1], encode in the
    VQ-VAE's dtype, nearest codebook index in float32 (kernel C), then the
    time-major flatten ``swapaxes(1, 2).reshape(B, -1)``.  With the
    kernels off (``_build.kernels(False)``; ``GenerationPipeline.tokenize``
    enters its pipeline's scope) the rFFT mel and the plain argmin in
    place of D and C.
    """
    mel = waveform_to_mel_fused(wav, mel_cfg)
    lo = (mel.shape[-1] - vq.cfg.resolution) // 2
    mel = mel[:, :, lo:lo + vq.cfg.resolution]
    x = (2.0 * mel - 1.0)[..., None].to(vq.quant_conv.weight.dtype)
    grid = vq.encode_to_indices(x)
    return grid.transpose(1, 2).reshape(grid.shape[0], -1)


def wav_bytes(wav: np.ndarray, sample_rate: int = 22050) -> bytes:
    """PCM16 WAV encoded in memory with the standard library."""
    data = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    pcm = (data * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 22050):
    """PCM16 WAV file (the buffer form above, on disk)."""
    with open(path, "wb") as f:
        f.write(wav_bytes(wav, sample_rate))
