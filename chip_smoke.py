#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the repository root

1. Builds the port's kernels from melspec_gpt_vqvae_tpu_torch/csrc (nvcc,
   sm_90a) and holds each against its plain PyTorch version on the card,
   at the shapes the generation round trip and the evaluation forward
   give it, with TF32 off:
   A attention (48 cases: T = 1 to 266, three windows, float32 and
   bfloat16), B MelGAN resblock stack, C VQ nearest index, D mel, E
   decode attention over the int8 / int4 cache (the position read from
   device memory, with and without the new slot's quantise-and-write; at
   batch 1 the rows of one (b, h) are split over up to 4 CTAs; at 512 x 16
   and 256 x 23 (b, h) pairs the streamed body, half the batch bit-equal
   to the whole); and the
   int8 block product bit for bit against the CPU: the plain chain
   (``_int8_mm``, cuBLASLt), the two kernels around the same product
   (``quantize_rows``, ``rescale_bias``), with the quantising kernel's
   scale pass alone (``row_scales``) and its pass with given scales,
   which tensor parallelism's row-cut products take, and the one-launch
   product at small M (``int8_linear_splitk``) at the VAS and XL block
   shapes, timed against the chain it replaces.  Each kernel is
   timed at the main path's shape: ``ms`` with its wrapper (CUDA events),
   ``device_ms`` the kernel alone (``torch.profiler``), ``plain_ms`` its
   plain version, ``library_ms`` the one PyTorch call that computes the
   same function where there is one (timed here, used nowhere in the
   port), and ``bound_ms``, the least the card could take, from the
   shapes; no bound may exceed a time measured for the same function.
2. Drives the round trip at the full VAS width (24-layer GPT, VQ-VAE,
   MelGAN) with seeded random weights, through ``build_pipeline`` and a
   ``GenerationService``, on each serving path, with the kernels' launch
   counts zeroed before each path and read after it.  Every path decodes
   through the captured program (models/decode_graph.py: a token's
   sampling and decode step are one CUDA graph); the first request of a
   shape pays for the capture, printed apart, and a repeated request shows
   the path without it:
   - the card's default, as in the JAX package: bf16 model, int8 KV cache,
     int8 streamed weights -- tokenize 48 clips of the parity battery,
     then three batch-8 requests (sampled top-k, greedy, sampled again);
     every kernel A-E and the int8 product's two must launch, E exactly
     once a layer and decode step; then a profiled window of decode steps,
     replayed and eager (launches per token, device busy ms, busy share);
   - the captured programs against the eager loop (``graph=False``): equal
     greedy tokens and cache bytes on the int8, int4 and bf16 caches,
     equal sampled tokens for one seed, equal tokens and stats under
     speculative decoding at batch 1 and 8 (6- and 4-layer copies);
   - a captured batch-8 greedy decode (24 layers) with the one-launch
     int8 product against the same decode through the chain: equal
     tokens, cache bytes and 16 steps' logits;
   - the bf16 KV cache with bf16 weights (batch-8 requests);
   - the int4 KV cache (batch-8 requests, sampled top-p);
   - speculative decoding with the 24-layer target and a random 4-layer
     draft, gamma 4, at batch 1 and batch 8 (kernel E runs in the draft's
     steps and in the target's verification).
3. Holds float32 copies (2 GPT layers, same widths) on the card against
   the CPU: the round trip (PR 1's check), and for the int8 and int4
   configurations the quantised cache values, the teacher-forced logits
   and greedy speculative against greedy plain decoding.
4. Trains: kernel F (training attention, forward and backward) against
   its plain version at (8, 16, T, 64) for T = 265, 266, 37 and 1, its
   backward launched twice for bit-equal gradients; then the VAS GPT
   preset at full width with ``use_flash_train=True`` through
   ``train_gpt.main`` on a synthetic VAS tree of the 48 battery clips and
   their codes (a few steps, a validation pass, a checkpoint save), with
   F's launches counted; the checkpoint restored bit for bit; that
   checkpoint evaluated through ``train_gpt.main --train 0 --eval 1
   --resume last`` with ``use_flash_train`` off, so that kernel A runs the
   24 layers at (8, 16, 265, 64) float32, its validation loss held to the
   flash run's and its peak device memory to one train state; steps timed
   against the plain-attention step and the same flash step under mixed
   precision (bfloat16 products with float32 results), each with a
   profiled window of three steps (device ms by kernel class, busy
   against wall); the loss on one repeated batch falling; and one float32
   train step of a 2-layer copy on the card against the CPU.
4b. (Phase ``dist``, after ``training``.)  Distributed training with NCCL
   at world size 1 (a process group from a file store in a temporary
   directory): the class GPT at the VAS preset's full width (kernel F,
   mixed precision) takes one step under ``--mesh data=1`` that must be
   the plain step bit for bit (the loss and every parameter), with NCCL's
   kernels in its profile (their device ms a step printed); the same step
   with dropout 0 under ``pipe=1`` and 4 microbatches within 1e-5 (loss)
   and 5e-5 (parameters) of the plain one, F exactly 24 x 4 forward and
   backward launches, its evaluation without F kernel A exactly 24 x 4;
   the GPT-VAE (``GPT_VAE_vas``, batch 24) one step under
   ``data=1,model=1`` bit for bit the plain one; beside these, ``torchrun
   --standalone --nproc_per_node 1 -m ...train_gpt --mesh data=1`` on the
   training tree at 2 layers (one epoch), whose checkpoint is restored in
   this process with no process group and its validation loss held to the
   logged one within 1e-6; each path's ms a step with the card's name and
   power limit.
4c. (Phase ``serving_mesh``, after ``dist``.)  Serving over a mesh with
   NCCL at world size 1 (a file store): at the VAS width (24 layers,
   bf16, int8 KV cache and weights, captured decode, batch 8) the
   pipeline under ``data=1``, ``model=1`` (the tensor-parallel step:
   the row-cut products' scale pass, MAX and SUM all-reduces recorded in
   the captured program) and ``data=1,model=1`` (the last two through
   ``build_pipeline(mesh_spec=)``, built from the host tree: the block
   weights quantised on the host, which must equal the card's
   quantisation of the same weights bit for bit, and only the rank's
   parts moved to the card) against the meshless one: greedy and
   same-seed sampled tokens bit for bit, specs and wavs equal; A, B, E
   and the int8 product's kernels exactly counted (E 24 x 265 a
   request); one speculative request (24-layer target, random 4-layer
   draft, gamma 4) under ``data=1,model=1`` equal to the meshless one;
   and ``torchrun --nproc_per_node 1 -m ...serve --mesh model=1
   --init_random`` (SERVE_MESH_LAYERS layers, started with the phase)
   answering two HTTP requests, then stopped by an interrupt of its rank
   0 (exit code 0).  At world size 1 NCCL's in-place sums launch
   nothing: scripts/torch_dist_check.py on four cards is where the
   captured all-reduces run.
4d. (Phase ``xl``, after ``serving_mesh``.)  The XL decoder: the
   ``GPT_VAE_vggsound`` decoder at its full width (1472 wide, 23 heads of
   64, vocab 1024) and XL_LAYERS of its 40 layers, bf16 with the int8
   cache and int8 weights, seeded random weights.  Kernel E at 23 heads
   against its plain version at each capacity of an 8-segment decode
   (batch 8, 1 and 256, the benchmark prior cell's batch, with and
   without the slot's write), kernel A at T = 1 over 23 heads, the int8
   product at widths 1472 / 4416 / 5888 and M = 8 and 256 (the M = 256
   chain: ``quantize_rows``, ``int8_linear_chain``) bit for bit the
   CPU's; then the prior's greedy ``vae_decode`` (8 segments,
   the captured program) twice with the kernels (E, A and the int8
   product's kernels exactly counted) and twice without (no launch).
   With int8 weights the two runs part where E's rounding moves an
   activation across a quantisation boundary (the share of equal tokens
   printed); from the same state the first layer's new cache slot must
   be the same bits at every step, and the logits, step for step and
   run free, stay within the configuration's own quantisation error (the
   plain run's distance from float32 weights and cache), recorded on
   E's row as ``xl_int8_weights_on_off``.  With float32 weights over the int8
   cache (E and A the only kernels) the greedy tokens with the kernels
   must equal those without, and the teacher-forced logits agree within
   1e-3.
5. Serves that checkpoint through the port's entry points, from the
   training tree: ``build_pipeline(experiment="smoke", resume="last")``
   (its bf16 params bit for bit the checkpoint's float32 ones, rounded),
   the HTTP server on a free port (``/healthz``, a WAV, a deterministic
   JSON batch equal to the service's own clips; kernel E exactly once a
   layer and step), ``sample.main``, the checkpoint as its own
   speculative draft (every proposal accepted), and a pipeline with
   ``use_kernels=False`` on the same weights: no kernel launched, the
   decode program still captured, its request seconds beside the kernels'
   own; on a float32 2-layer copy with the int8 cache, the kernels against
   their plain versions step for step (logits, cache bytes), and the
   decode, vocoder and tokenize stages.
6. (Run after the serving paths of 2.)  Exports and serves the
   ``torch.export`` artifact, and runs the int8 decode stage, at the VAS
   width on the card's default (int8 KV cache and weights, batch 8) with
   a 6-layer GPT (EXPORT_LAYERS; 24 until the GPT-VAE phase came): two
   ``scripts/torch_export_serving.py`` processes,
   started with the script (their tracing is host work), write a greedy
   and a sampled (top_k 100) artifact; phase ``export`` loads both
   (``ArtifactPipeline``), walks every graph of the loaded programs for
   anything but ATen / prims ops, getitem and torch's higher-order ops,
   and holds their tokens, greedy and sampled for one seed, equal to the
   live pipeline with ``use_kernels=False`` (the share equal to the
   kernels' own printed), with no kernel launched; export seconds,
   artifact bytes, load and request seconds (artifact, live with and
   without the kernels) printed.  Phase ``artifact_http``: ``serve
   --artifact`` on a free port, 200 and a WAV for the baked knobs, 400
   for another top_k.  Phase ``int8_decode``: ``build_pipeline(
   int8_decode=True)`` (calibration seconds), the float pipeline's tokens
   for one seed, kernel B not launched, the spectrogram's SNR and the
   vocoder's (on the same spectrogram) against the bf16 / kernel-B stage
   >= 20 dB, the whole stage's waveform SNR and the stages' seconds.

7. (Phase ``vae``, last.)  The GPT-VAE: kernel F (keep 0.7 and 1) and
   kernel A (float32) against their plain versions at its shapes, (24, 16,
   265, 64) with n_unmasked 265 (the encoder) and (24, 16, 266, 64) causal
   (the decoder), each timed with its bound; ``train_gpt_vae.main`` on the
   battery's 48 clips (two train batches of 24, one valid batch) trains
   the ``GPT_VAE_vas`` preset at full width (2 x 24 layers, mixed
   precision, remat ``attn``, dropout 0.3) with ``use_flash_train`` for
   4 steps, F's launches counted exactly (remat's recompute of every
   attention region included); its 7.3 GB checkpoint restored bit for
   bit, ``kl_weight`` included; ``--train 0 --eval 1 --resume last``
   (kernel A in both stacks, MI, AU, NLL, PPL), ``--test 1 --iw_nsamples
   20`` and greedy ``--reconstruct_from last`` through the captured decode
   program, each timed with the kernels it launched; the loss on a
   repeated batch falling; the step's ms, tokens/s and peak memory with
   mixed precision and remat on and off (profiled windows with remat
   ``attn``); a 2-layer float32 copy's train step, mixed precision off and
   on, against the CPU.

7b. (Phase ``features``, after ``vae``.)  The offline tokenizer through
   its entry points: the 48 battery clips written as wavs (int16 and
   float32, the last one 3 s long) through
   ``feature_extraction.extract_mel_spectrogram.main`` at ``-b 16`` (D
   exactly 3 launches), every mel file held against the plain rFFT mel of
   the wav on the card within 2e-3; ``extract_codes.main`` at ``-b 8`` on
   a reference-format file of the ``VQVAEConfig`` preset's seeded weights
   (C exactly 6), called with TF32 on: it must encode with TF32 off and
   give the flags back; its codes against the plain argmin on the same
   latents (no unexplained flip); a second run writes nothing;
   ``--int8`` (its agreement with the float32 codes printed);
   ``parity_check``'s four variants on 8 clips against its CPU subprocess
   (D 3, C 4); ``mel_to_waveform`` (NNLS, Griffin-Lim 32 iterations) on 8
   mel files, the mel of each waveform within mean |mel - mel2| < 0.05 of
   the file over its active frames.  Each CLI's seconds and clips/s;
   the counts join C's and D's ``launches_by_path``.

8. (Phase ``vqgan``, after ``features``.)  The VQ-GAN first stage:
   ``train_vqvae.main`` on the battery's 48 clips trains the ``VQVAEConfig``
   preset at full width (ch 128, attention at 53, z 256, 128 codes, ndf 64;
   batch 2 of 80 x 848 mels) for 4 steps, the adversarial phase from step
   2, with kernel C exactly twice an iteration and once a validation batch
   and ``d_weight`` inside its clip range; the checkpoint restored bit for
   bit and evaluated through ``--train 0 --eval 1 --resume last``; C's
   indices inside a train step against ``vq_nearest_index_xla`` on the
   same latents (no unexplained flip) and C timed at that shape (N = 530);
   the reconstruction loss on a repeated batch falling (cuDNN's
   deterministic algorithms from the first step to this check: the
   adversarial phase amplifies the default ones' last-bit differences
   until the check goes either way); the step's ms and
   peak memory, a profiled window by launching op, the step with cuDNN's
   TF32 on; a ch-16 copy's train step, float32 on the card against float64
   on the CPU.

9. (Phase ``media``, after ``vqgan``.)  Media logging through frozen
   decoders: ``train_gpt.main`` at the full VAS preset (24 layers,
   ``use_flash_train``, an int8 KV cache) for 2 steps and a validation
   batch with ``--logging_frequency 1``, ``--reconstruct_spec`` phase
   vqgan's run directory and ``--vocoder`` a reference-format MelGAN folder
   of seeded random weights: every GPTImageLogger call's launches exactly
   (A: three prefills; E: every decode step of its three generations plus
   the warm-up runs of its captures; B: 4 a vocoded clip; no C or F), the
   JAX tag set, (80, 848) spectrograms, a (266, 266) attention image and
   217,088-sample WAVs; a callback's seconds beside a train step's; then
   one VAETextLogger call with the same decoders on phase vae's checkpoint
   (A and B counted exactly).  It removes the vae, vqgan and media trees.

10. (Phase ``lstm``, last.)  The LSTM-VAE through ``train_gpt_vae.main
    --model lstm`` at the VAE_vas preset (ni 512, nh 1024, nz 32, batch 8
    grids = 40 sentences of 52) for 4 steps, no kernel launched; the
    checkpoint restored bit for bit; ``--eval 1`` (MI, AU); greedy and beam
    reconstructions and a sample from the prior, each timed; the loss on a
    repeated batch falling; a float32 train step (dropout 0) card vs CPU.

Exits non-zero, printing no result, when there is no CUDA card or any check
fails.  The last three lines of stdout are: a JSON object of the kernels,
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``; the line before them gives the seconds
of each phase.
"""

import base64
import copy
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import wave
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch


T_START = time.perf_counter()
PHASES = []   # (short name, seconds since the script began at its start)


def phase(name, title):
    """Print a phase's title with the seconds since the script began."""
    PHASES.append((name, time.perf_counter() - T_START))
    print(f"[{PHASES[-1][1]:6.1f} s] {title}")


def phase_seconds():
    """Seconds each phase took, the last one up to now."""
    ends = [t for _, t in PHASES[1:]] + [time.perf_counter() - T_START]
    return {name: round(end - t, 1) for (name, t), end in zip(PHASES, ends)}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_PROFILER_WARM = False


def profiled(run, complete, activities=None, tries=3):
    """``run()`` inside a ``torch.profiler`` window; (the window's
    ``key_averages()``, whether ``complete(averages)`` held).  A trace can
    come back without some of its launches (the first window of a process
    while the tracer is still starting, or a buffer dropped under a busy
    host), so the first window of the process is a throwaway one and a
    window that is not ``complete`` is taken again, ``tries`` times in all.
    ``run`` must leave the card idle (synchronise) before it returns."""
    global _PROFILER_WARM
    from torch.profiler import ProfilerActivity, profile
    acts = activities or [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if not _PROFILER_WARM:
        with profile(activities=acts):
            run()
        _PROFILER_WARM = True
    for _ in range(tries):
        with profile(activities=acts) as prof:
            run()
        avgs = prof.key_averages()
        if complete(avgs):
            return avgs, True
    return avgs, False


def queued_ms(fn, reps=20, hold_cycles=20_000_000):
    """Mean milliseconds the card spends on one call of ``fn`` (every kernel
    it launches, and the gaps between them), by CUDA events around ``reps``
    calls queued behind a ``torch.cuda._sleep`` of ``hold_cycles`` cycles
    (~10 ms): the host queues the calls while the card is held, so the
    wrapper's host work does not count as long as ``fn`` does not
    synchronise."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a profiler window must hold at least this share of the CUDA-event time of
# the same calls, or it is taken again: a window can hold every launch with
# too little time (kernel F's backward has read at 0.65 of the events' time).
# The events also time the ~1 us by which queued kernels start apart (calls
# of one small kernel read 0.9-1.0 us more by events than by the profiler
# on the H100), so that much a kernel of the call is taken off them first.
WINDOW_FLOOR, KERNEL_GAP_MS = 0.8, 0.001


def device_ms(fn, names, reps=20):
    """Mean milliseconds that the port's kernels named in ``names``
    (substrings of the ``__global__`` functions in csrc/*.cu) spend on the
    card in one call of ``fn``: their device time in a ``torch.profiler``
    window of ``reps`` calls, free of the wrapper's host work and of any
    PyTorch operator beside them.  A window is taken again (three windows
    in all) unless it holds the launches (one may be lost at its edge) and
    their time a call is at least ``WINDOW_FLOOR`` of ``queued_ms`` of the
    same calls, less ``KERNEL_GAP_MS`` for each kernel a call launches;
    after three refused windows the time is ``queued_ms``
    (every kernel of the call and the gaps between them: an upper bound)
    and the line says so.  ``device_ms.events_ms`` keeps the last call's
    ``queued_ms``."""
    from torch.profiler import DeviceType
    fn()
    torch.cuda.synchronize()
    events_ms = queued_ms(fn, reps)

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def tally(avgs):
        total_us, calls, launches = 0.0, 0, 0
        for ev in avgs:
            if ev.device_type != DeviceType.CUDA:
                continue
            launches += ev.count
            if any(n in ev.key for n in names) and "at::" not in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                total_us += us if us is not None else ev.self_cuda_time_total
                calls += ev.count
        per_call = round(calls / reps)
        # average over the launches the trace holds, times the kernels one
        # call launches
        return ((total_us / 1e3 / calls * per_call if calls else 0.0), calls,
                round(launches / reps))

    def complete(avgs):
        # the trace may lose a launch at the window's edge, or time
        ms, calls, kernels = tally(avgs)
        per_call = round(calls / reps)
        return (per_call >= 1 and calls >= (reps - 1) * per_call
                and ms >= WINDOW_FLOOR * (events_ms - KERNEL_GAP_MS * kernels))

    avgs, ok = profiled(run, complete)
    ms, calls, _ = tally(avgs)
    device_ms.events_ms = events_ms
    if not ok:
        print(f"  torch.profiler held {calls} launches of {names}, "
              f"{ms:.4f} ms a call against {events_ms:.4f} ms by CUDA "
              f"events, three windows in a row: the CUDA-event time taken "
              f"instead")
        return events_ms
    return ms


def kernels_ms(fn, names, reps=100):
    """Mean milliseconds a call of ``fn`` spends in the kernels named in
    ``names`` (each launched once a call), from a ``torch.profiler`` window
    of ``reps`` calls that holds their launches.  No CUDA-event cross-check
    as ``device_ms`` makes: for a chain of launches the events time the
    host's enqueue between them too."""
    from torch.profiler import DeviceType
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def tally(avgs):
        us, calls = 0.0, 0
        for ev in avgs:
            if ev.device_type == DeviceType.CUDA and "at::" not in ev.key \
                    and any(n in ev.key for n in names):
                t = getattr(ev, "self_device_time_total", None)
                us += t if t is not None else ev.self_cuda_time_total
                calls += ev.count
        return us, calls

    avgs, _ = profiled(run, lambda a: tally(a)[1] >= (reps - 1) * len(names))
    us, calls = tally(avgs)
    return us / 1e3 / calls * len(names)


# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 494e12, "bf16": 989e12}


def bound(n_bytes, n_ops, kind):
    """The least milliseconds the card could take: the larger of the bytes
    the function must move (each input read once, each output written
    once) over the memory rate and its operations over the peak rate of
    their type (``kind``: "f32" outside the tensor cores, "tf32" or
    "bf16" on them)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_operations": int(n_ops),
            "bound_operation_type": kind}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def wall(fn):
    """(result, host seconds) of ``fn`` on the card, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def trees_equal(a, b):
    """Nested dicts of tensors and numbers equal bit for bit (tensors
    compared on the CPU)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------


# the __global__ functions of kernel A: a warp a row up to T = 16, tensor-core
# tiles beyond
A_KERNELS = ["attention_kernel", "attention_tile_kernel"]


def check_attention(dev):
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend, attend_xla
    g = torch.Generator(device=dev).manual_seed(0)
    # f32: the JAX package's own bound (tests/test_ops.py); bf16: outputs
    # are rounded to bf16 (2^-8 relative), so 1e-2 of max |out|.  T = 16 /
    # 17 is where the warp-a-row kernel hands over to the tile kernel, 64 /
    # 65 one row tile and one row more, 265 / 266 the longest sequences.
    errs, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for t in (1, 16, 17, 37, 64, 65, 265, 266):
            for nu in (0, 11, t):
                q, k, v = (torch.randn(8, 16, t, 64, generator=g, device=dev)
                           .to(dtype) for _ in range(3))
                ref = attend_xla(q, k, v, nu)
                err = max_err(attend(q, k, v, nu), ref)
                tol = 2e-5 if dtype == torch.float32 else \
                    1e-2 * ref.float().abs().max().item()
                print(f"  A attention {str(dtype)[6:]:8s} T={t:3d} "
                      f"n_unmasked={nu:3d}: max|err| {err:.3g} "
                      f"(tol {tol:.3g})")
                check(err <= tol, f"attention {dtype} T={t} nu={nu}")
                errs[dtype] = max(errs.get(dtype, 0.0), err)
                n += 1
    print(f"  A attention: {n} cases; max|err| float32 "
          f"{errs[torch.float32]:.3g}, bfloat16 {errs[torch.bfloat16]:.3g}")
    # the serving prefill: class prompt only, T = 1, batch 8, bf16; the
    # longest window, T = 266, bf16 (the GPT-VAE encoder's length); and the
    # evaluation forward, T = 265, float32.  The library call: one
    # scaled_dot_product_attention with the same window mask (causal at
    # n_unmasked = 0) in the same dtype; timed here only, the port never
    # calls it.
    import torch.nn.functional as F
    res = {}
    for name, t, dtype, kind in (("t1", 1, torch.bfloat16, "bf16"),
                                 ("t266", 266, torch.bfloat16, "bf16"),
                                 ("t265_f32", 265, torch.float32, "tf32")):
        q = torch.randn(8, 16, t, 64, generator=g, device=dev).to(dtype)
        reps = 200 if t == 1 else 20
        r = {"ms": cuda_ms(lambda: attend(q, q, q, 0), reps=reps),
             "device_ms": device_ms(lambda: attend(q, q, q, 0), A_KERNELS),
             "plain_ms": cuda_ms(lambda: attend_xla(q, q, q, 0), reps=reps),
             "library_ms": cuda_ms(
                 lambda: F.scaled_dot_product_attention(q, q, q,
                                                        is_causal=True),
                 reps=reps),
             # q, k, v in, o out; QK^T and PV over the causal half, on the
             # tensor cores at the rate of the inputs' type
             **bound(4 * nbytes(q), 4 * 8 * 16 * (t * (t + 1) // 2) * 64,
                     kind)}
        print(f"  A timing {str(dtype)[6:]} (8,16,{t},64): kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
        res[name] = r
    return {"max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32], **res["t1"],
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "is_causal=True), same dtype",
            "t266": res["t266"], "t265_f32": res["t265_f32"]}


SPEC_FRAMES = 848   # vocoder input frames of one clip
# depth of the speculative path's target and of its random draft
SPEC_LAYERS, DRAFT_LAYERS = 24, 4


def vocoder_stages(melgan):
    """(C, T) of each upsample stage's resblock stack for one clip: VAS is
    (256, 6784), (128, 54272), (64, 108544), (32, 217088)."""
    stages, t = [], SPEC_FRAMES
    for i, r in enumerate(melgan.cfg.ratios):
        t *= r
        stages.append((melgan.stage_blocks(i)[0].block_conv1.in_channels, t))
    return stages


def check_vocoder_stack(dev, melgan):
    from melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack import (
        fused_resblock_stack, resblock_stack)
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    # f32: 1e-4 absolute; bf16: every intermediate is rounded to bf16 as in
    # the plain version, so differences are a few bf16 ulps: 2e-2 of max|out|
    for dtype in (torch.float32, torch.bfloat16):
        model = copy.deepcopy(melgan).to(device=dev, dtype=dtype)
        for i, (c, t) in enumerate(vocoder_stages(melgan)):
            blocks = model.stage_blocks(i)
            x = torch.randn(2, c, t, generator=g, device=dev).to(dtype)
            with torch.no_grad():
                out = fused_resblock_stack(x, blocks, model.packed_stage(i))
                ref = resblock_stack(x, blocks)
            err = max_err(out, ref)
            edge = max(max_err(out[..., :13], ref[..., :13]),
                       max_err(out[..., -13:], ref[..., -13:]))
            tol = 1e-4 if dtype == torch.float32 else \
                2e-2 * ref.float().abs().max().item()
            print(f"  B resblock stack {str(dtype)[6:]:8s} C={c:3d} T={t:6d}: "
                  f"max|err| {err:.3g}, first/last 13 samples {edge:.3g} "
                  f"(tol {tol:.3g})")
            check(err <= tol and edge <= tol, f"resblock stack {dtype} C={c}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
    # the slice's shapes: one batch-8 request, bf16, all four stages, the
    # weights packed once by the generator that owns them
    model = copy.deepcopy(melgan).to(device=dev, dtype=torch.bfloat16)
    xs = [torch.randn(8, c, t, generator=g, device=dev).bfloat16()
          for c, t in vocoder_stages(melgan)]
    ms = dev_ms = plain = 0.0
    n_bytes = n_ops = 0
    stages = []
    packs = model.packs
    with torch.no_grad():
        for i, x in enumerate(xs):
            blocks = model.stage_blocks(i)

            def run():
                return fused_resblock_stack(x, blocks, model.packed_stage(i))
            k_ms = cuda_ms(run, reps=5)
            d_ms = device_ms(run, ["resblock_stack"], reps=5)
            p_ms = cuda_ms(lambda: resblock_stack(x, blocks), reps=5)
            check(model.packs == packs + i + 1,
                  "resblock stack: weights were packed again per launch")
            c, t = x.shape[1], x.shape[2]
            # x in, out out, the convs' weights; 15 C^2 MACs per sample
            sb = 2 * nbytes(x) + sum(nbytes(p) for b in blocks
                                     for p in b.parameters())
            so = 2 * 15 * c * c * x.shape[0] * t
            print(f"  B timing bf16 B=8 C={c} T={t}: kernel {k_ms:.3f} ms "
                  f"(device {d_ms:.3f}), plain (cuDNN chain) {p_ms:.3f} ms, "
                  f"bound {bound(sb, so, 'bf16')['bound_ms']:.4f} ms")
            stages.append({"C": c, "T": t, "ms": k_ms, "device_ms": d_ms,
                           "plain_ms": p_ms,
                           "bound_ms": bound(sb, so, "bf16")["bound_ms"]})
            ms, dev_ms, plain = ms + k_ms, dev_ms + d_ms, plain + p_ms
            n_bytes, n_ops = n_bytes + sb, n_ops + so
    print(f"  B timing bf16 B=8, four stages: kernel {ms:.3f} ms (device "
          f"{dev_ms:.3f}), plain (cuDNN chain) {plain:.3f} ms")
    return {"max_abs_err": errs[torch.bfloat16], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain,
            **bound(n_bytes, n_ops, "bf16"), "library_ms": None,
            "library_call": None, "stages": stages}


def check_vq(dev):
    from melspec_gpt_vqvae_tpu_torch.ops.vq import (vq_nearest_index,
                                                   vq_nearest_index_xla)
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for k in (128, 1024):
        x = torch.randn(64 * 265, 256, generator=g, device=dev)
        cb = torch.randn(k, 256, generator=g, device=dev)
        out = vq_nearest_index(x, cb)
        ref = vq_nearest_index_xla(x, cb)
        rows = (out != ref).nonzero()[:, 0].cpu().numpy()
        # a row may differ only where its two candidates' float64 distances
        # lie within float32 rounding of the distance's terms
        x64, cb64 = x.double().cpu().numpy(), cb.double().cpu().numpy()
        e2 = (cb64 ** 2).sum(1)
        oi, ri = out.cpu().numpy(), ref.cpu().numpy()
        d_out = e2[oi] - 2 * (x64 * cb64[oi]).sum(1)
        d_ref = e2[ri] - 2 * (x64 * cb64[ri]).sum(1)
        gap = np.abs(d_out - d_ref)
        scale = (x64 ** 2).sum(1) + np.maximum(e2[oi], e2[ri]) + 2 * (
            np.abs(x64) * (np.abs(cb64[oi]) + np.abs(cb64[ri]))).sum(1)
        bad = rows[gap[rows] > 2.0 ** -18 * scale[rows]]
        print(f"  C vq nearest K={k:4d} N={x.shape[0]}: {len(rows)} rows "
              f"differ, all near-ties (float64 gap <= 2^-18 of the terms): "
              f"{len(bad) == 0}")
        check(len(bad) == 0, f"vq K={k}: {len(bad)} rows differ beyond "
                             "rounding")
        worst = max(worst, float(gap.max()))
    # the slice's shape: tokenize of 48 clips, K = 128; and the widest
    # codebook (K = 1024) at N = 64 x 265.  The library call: the plain
    # version's own form, one float32 matmul x @ cb.T (cuBLAS) with the
    # norms added and an argmin, which is vq_nearest_index_xla itself;
    # timed here only, the port calls it on CPU tensors alone.
    res = {}
    for name, n, k in (("main", 48 * 265, 128), ("k1024", 64 * 265, 1024)):
        x = torch.randn(n, 256, generator=g, device=dev)
        cb = torch.randn(k, 256, generator=g, device=dev)
        out = vq_nearest_index(x, cb)
        ms = cuda_ms(lambda: vq_nearest_index(x, cb))
        dms = device_ms(lambda: vq_nearest_index(x, cb),
                        ["vq_nearest_kernel"])
        plain = cuda_ms(lambda: vq_nearest_index_xla(x, cb))
        # x and the codebook in, one index per row out; the N x K x D product
        bd = bound(nbytes(x, cb, out), 2 * n * k * 256, "f32")
        print(f"  C timing N={n} K={k}: kernel {ms:.4f} ms (device "
              f"{dms:.4f}), plain = library form (x @ cb.T, argmin) "
              f"{plain:.4f} ms, bound {bd['bound_ms']:.5f} ms "
              f"({bd['bound_by']})")
        res[name] = {"ms": ms, "device_ms": dms, "plain_ms": plain, **bd,
                     "library_ms": plain}
    return {"max_abs_err": worst, **res["main"],
            "library_call": "vq_nearest_index_xla: x @ cb.T in float32 "
                            "(cuBLAS), + |e|^2, argmin",
            "k1024": res["k1024"]}


def check_mel(dev, wav, mel_cfg):
    from melspec_gpt_vqvae_tpu_torch.ops.mel import (mel_filterbank,
                                                    waveform_to_mel)
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    out = waveform_to_mel_fused(wav, mel_cfg)
    ref = waveform_to_mel(wav, mel_cfg)
    err = max_err(out, ref)
    # the JAX package's bound for its Pallas mel (tests/test_mel.py:137)
    print(f"  D mel 48 battery clips {tuple(out.shape)}: max|err| {err:.3g} "
          "(tol 2e-3)")
    check(out.shape == (48, 80, 860) and err <= 2e-3, "mel kernel")
    ms = cuda_ms(lambda: waveform_to_mel_fused(wav, mel_cfg), reps=10)
    dms = device_ms(lambda: waveform_to_mel_fused(wav, mel_cfg),
                    ["mel_kernel"], reps=10)
    plain = cuda_ms(lambda: waveform_to_mel(wav, mel_cfg), reps=10)
    # waveform in, mel out.  What the function needs: per kept frame the
    # window (n_fft), a real FFT (2.5 n_fft log2 n_fft), the magnitudes (3 a
    # bin) and a multiply-add per non-zero of the triangular filterbank
    n_fft, bins = mel_cfg.n_fft, mel_cfg.n_fft // 2 + 1
    nonzero = int(np.count_nonzero(mel_filterbank(
        mel_cfg.sample_rate, n_fft, mel_cfg.n_mels, mel_cfg.fmin,
        mel_cfg.fmax)))
    per_frame = n_fft + 2.5 * n_fft * float(np.log2(n_fft)) + 3 * bins \
        + 2 * nonzero
    bd = bound(nbytes(wav, out), out.shape[0] * out.shape[2] * per_frame,
               "f32")
    print(f"  D timing B=48: kernel {ms:.3f} ms (device {dms:.3f}), plain "
          f"{plain:.3f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dms,
            "plain_ms": plain, **bd, "library_ms": None,
            "library_call": None}


# the position-axis capacities of a VAS decode in 8 segments (class prompt
# + 265 tokens): the cache lengths kernel E sees on the main path
VAS_CAPS = (34, 67, 100, 133, 167, 200, 233, 266)


def quantised_cache(g, dev, b, t, bits, heads=16):
    """A 2-layer stacked cache (``heads`` heads of 64) of quantised
    unit-normal latents, as the decode step writes it: [k, k_scale, v,
    v_scale], the scales bfloat16."""
    from melspec_gpt_vqvae_tpu_torch.models.gpt import (_quantize_kv,
                                                        _quantize_kv4)
    quant = _quantize_kv if bits == "int8" else _quantize_kv4
    out = []
    for _ in range(2):
        q, s = quant(torch.randn(2, b, heads, t, 64, generator=g,
                                 device=dev))
        out += [q, s.to(torch.bfloat16)]
    return out


def check_bulk_decode_attention(dev, b, h, caps, label):
    """Kernel E's streamed body (``use_streamed``: thousands of (b, h)
    pairs) at batch ``b`` and ``h`` heads of 64 against the plain version,
    at every cache length in ``caps`` and positions 0, T / 2 and T - 1,
    int8 and int4: from device memory and from the host (bit-equal), each
    without and with this step's rows quantised and written in the launch
    (written bytes and scales bit-equal to the plain write, the output
    bit-equal to attending the plain write's cache), q bfloat16 and, at
    the last position of the longest cache, float32, at the JAX package's
    bound (atol = rtol = 1e-4); a position past the cache gives NaN and
    leaves the cache as it was.  A launch over the first half of the batch
    with the whole batch's ``split_pairs`` must give the whole launch's
    rows bit for bit.  Each launch must count in
    ``decode_attend_int8.streamed``.  Then the program's shape (a cache of
    266 positions, pos 265, bf16, the slot written) timed with each body
    beside its bytes bound.  Returns the worst error and the timings."""
    from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as DA
    E = DA.decode_attend_int8
    check(DA.use_streamed(b * h), f"{label}: {b * h} pairs do not stream")
    g = torch.Generator(device=dev).manual_seed(b * h)

    def at(pos):
        return torch.tensor([pos], dtype=torch.int64, device=dev)

    def streamed(fn):
        before = E.streamed
        out = fn()
        check(E.streamed == before + 1, f"{label}: a launch of {b * h} "
              "pairs did not take the streamed body")
        return out

    def close(out, ref, case):
        err = (out - ref).abs()
        check(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()),
              f"{case}: max|err| {err.max().item():.3g}")
        return err.max().item()

    worst, n = 0.0, 0
    for bits in ("int8", "int4"):
        for t in caps:
            k, ks, v, vs = quantised_cache(g, dev, b, t, bits, heads=h)
            for pos in sorted({0, t // 2, t - 1}):
                for qdt in ((torch.bfloat16, torch.float32)
                            if (t, pos) == (caps[-1], t - 1)
                            else (torch.bfloat16,)):
                    case = (f"{label} {bits} B={b} H={h} T={t} pos={pos} "
                            f"q {qdt}")
                    q, k_new, v_new = (torch.randn(
                        b, h, 64, generator=g, device=dev).to(qdt)
                        for _ in range(3))
                    out = streamed(lambda: E(q, k, v, ks, vs, 1, at(pos)))
                    ref = DA.decode_attend_int8_xla(q, k, v, ks, vs, 1, pos)
                    worst = max(worst, close(out, ref, case))
                    check(torch.equal(out, streamed(
                        lambda: E(q, k, v, ks, vs, 1, pos))),
                        f"{case}: host and device position differ")
                    for host in (False, True):
                        mine = [x.clone() for x in (k, v, ks, vs)]
                        plain = [x.clone() for x in (k, v, ks, vs)]
                        DA.write_kv_rows(*plain, 1, pos, k_new, v_new)
                        out_w = streamed(lambda: E(
                            q, *mine, 1, pos if host else at(pos),
                            k_new=k_new, v_new=v_new))
                        check(all(torch.equal(x, y)
                                  for x, y in zip(mine, plain)),
                              f"{case}: the written slot differs from the "
                              "plain write")
                        ref_w = DA.decode_attend_int8_xla(q, *plain, 1, pos)
                        worst = max(worst, close(out_w, ref_w,
                                                 f"{case}, with the write"))
                        check(torch.equal(out_w, E(q, *plain, 1, pos)),
                              f"{case}: attending the row just quantised "
                              "differs from reading it back")
                    n += 1
            # half the batch, the whole batch's split rule: one launch's rows
            pos = t - 1
            q, k_new, v_new = (torch.randn(b, h, 64, generator=g,
                                           device=dev).bfloat16()
                               for _ in range(3))
            whole = [x.clone() for x in (k, v, ks, vs)]
            full = E(q, *whole, 1, at(pos), k_new=k_new, v_new=v_new)
            half = [x[:, :b // 2].contiguous() for x in (k, v, ks, vs)]
            mine = streamed(lambda: E(
                q[:b // 2].contiguous(), *half, 1, at(pos),
                k_new=k_new[:b // 2].contiguous(),
                v_new=v_new[:b // 2].contiguous(), split_pairs=b * h))
            check(torch.equal(mine, full[:b // 2]) and all(
                torch.equal(x, y[:, :b // 2]) for x, y in zip(half, whole)),
                f"{label} {bits} T={t}: half the batch with the whole "
                "batch's split_pairs is not the whole launch's rows")
    # a position past the cache: NaN out, the cache untouched
    k, ks, v, vs = quantised_cache(g, dev, b, caps[0], "int8", heads=h)
    mine = [x.clone() for x in (k, v, ks, vs)]
    q = torch.randn(b, h, 64, generator=g, device=dev).bfloat16()
    out = streamed(lambda: E(q, *mine, 1, at(caps[0]), k_new=q, v_new=q))
    check(bool(out.isnan().all()) and all(
        torch.equal(x, y) for x, y in zip(mine, (k, v, ks, vs))),
        f"{label}: a position outside the cache")
    # the program's shape: the captured decode's cache of 266 positions
    k, ks, v, vs = quantised_cache(g, dev, b, 266, "int8", heads=h)
    q, k_new, v_new = (torch.randn(b, h, 64, generator=g,
                                   device=dev).bfloat16() for _ in range(3))
    p265 = at(265)

    def kernel():
        return E(q, k, v, ks, vs, 1, p265, k_new=k_new, v_new=v_new)
    def plain():
        DA.write_kv_rows(k, v, ks, vs, 1, p265, k_new, v_new)
        return DA.decode_attend_int8_xla(q, k, v, ks, vs, 1, 265)
    names = ["decode_attention_kernel"]
    chosen = DA.use_streamed
    timing = {"ms": cuda_ms(kernel, reps=50),
              "device_ms": device_ms(kernel, names, reps=50),
              "plain_ms": cuda_ms(plain, reps=10)}
    DA.use_streamed = lambda pairs: False
    try:
        timing["split_body_device_ms"] = device_ms(kernel, names, reps=50)
    finally:
        DA.use_streamed = chosen
    timing.update(bound(nbytes(k[1], v[1], ks[1], vs[1], q, k_new, v_new,
                               q.float()), 4 * b * h * 266 * 64, "f32"))
    print(f"  E streamed body {label} B={b} H={h}: {n} cases (int8/int4, T "
          f"{list(caps)}, pos 0/T/2/T-1, device and host position, without "
          f"and with the slot's write, q bf16 and f32), max|err| "
          f"{worst:.3g}; half the batch bit-equal to the whole; NaN past "
          f"the cache; T=266 "
          f"pos=265 slot written: kernel {timing['ms']:.4f} ms (device "
          f"{timing['device_ms']:.4f}, split body "
          f"{timing['split_body_device_ms']:.4f}), plain "
          f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']})")
    return {"max_abs_err": worst, **timing}


def check_decode_attention(dev):
    from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as DA
    decode_attend_int8 = DA.decode_attend_int8
    decode_attend_int8_xla = DA.decode_attend_int8_xla
    g = torch.Generator(device=dev).manual_seed(3)

    def cache(b, t, bits):
        return quantised_cache(g, dev, b, t, bits)

    def at(pos):
        return torch.tensor([pos], dtype=torch.int64, device=dev)

    # the JAX package's bound for this kernel (tests/test_gpt.py:363-364);
    # at batch 1 the kernel splits the rows of a (b, h) over 1 to 4 CTAs
    # as pos grows, and every size must come up among the cases.  Every
    # case reads its position from device memory, and runs twice: over the
    # cache as it is, and with this step's key and value rows, which the
    # launch quantises into position pos before it attends (cache bytes and
    # bfloat16 scales bit-equal to the plain write, every other position
    # untouched).  The host-position entry (the eager loop's) must give the
    # device-position one's output bit for bit.
    worst, n, split_sizes = 0.0, 0, set()
    streamed = DA.decode_attend_int8.streamed
    for bits in ("int8", "int4"):
        for b in (1, 8):
            for t in VAS_CAPS:
                k, ks, v, vs = cache(b, t, bits)
                for qdt in (torch.float32, torch.bfloat16):
                    for pos in sorted({0, 1, t // 2, t - 1}):
                        case = (f"decode attention {bits} B={b} T={t} "
                                f"pos={pos} q {qdt}")
                        q, k_new, v_new = (
                            torch.randn(b, 16, 64, generator=g,
                                        device=dev).to(qdt) for _ in range(3))
                        out = decode_attend_int8(q, k, v, ks, vs, 1, at(pos))
                        ref = decode_attend_int8_xla(q, k, v, ks, vs, 1, pos)
                        err = (out - ref).abs()
                        check(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()),
                              f"{case}: max|err| {err.max().item():.3g}")
                        check(torch.equal(out, decode_attend_int8(
                            q, k, v, ks, vs, 1, pos)),
                            f"{case}: host and device position differ")
                        mine = [a.clone() for a in (k, v, ks, vs)]
                        plain = [a.clone() for a in (k, v, ks, vs)]
                        DA.write_kv_rows(*plain, 1, pos, k_new, v_new)
                        out_w = decode_attend_int8(q, *mine, 1, at(pos),
                                                   k_new=k_new, v_new=v_new)
                        ref_w = decode_attend_int8_xla(q, *plain, 1, pos)
                        err_w = (out_w - ref_w).abs()
                        check(all(torch.equal(a, c)
                                  for a, c in zip(mine, plain)),
                              f"{case}: the written slot differs from the "
                              "plain write")
                        check(bool((err_w <= 1e-4 + 1e-4 * ref_w.abs()).all()),
                              f"{case}, with the write: max|err| "
                              f"{err_w.max().item():.3g}")
                        check(torch.equal(out_w, decode_attend_int8(
                            q, *plain, 1, pos)),
                            f"{case}: attending the row just quantised "
                            "differs from reading it back")
                        worst = max(worst, err.max().item(),
                                    err_w.max().item())
                        n += 1
                        split_sizes.add(DA.choose_splits(b * 16, pos + 1))
    check(split_sizes == set(range(1, DA.MAX_SPLITS + 1)),
          f"decode attention: the cases split the rows over {split_sizes}")
    check(DA.decode_attend_int8.streamed == streamed,
          "decode attention: a launch at batch 1 or 8 took the streamed body")
    # a position past the cache: NaN out, the cache untouched
    k, ks, v, vs = cache(1, 34, "int8")
    mine = [a.clone() for a in (k, v, ks, vs)]
    q = torch.randn(1, 16, 64, generator=g, device=dev)
    out = decode_attend_int8(q, *mine, 1, at(34), k_new=q, v_new=q)
    check(bool(out.isnan().all()) and all(
        torch.equal(a, c) for a, c in zip(mine, (k, v, ks, vs))),
        "decode attention: a position outside the cache")
    print(f"  E decode attention, {n} cases (int8/int4, B 1/8, T {VAS_CAPS}, "
          f"pos 0/1/T/2/T-1 read from device memory, q f32/bf16; rows split "
          f"over {sorted(split_sizes)} CTAs), each without and with the new "
          f"slot's write (written bytes and scales bit-equal to the plain "
          f"write): max|err| {worst:.3g} (atol = rtol = 1e-4)")
    # the slice's shape: batch 8, the full cache, the last position, bf16
    # q, k, v; the launch writes the slot, as the captured step's does
    names = ["decode_attention_kernel"]
    res = {}
    for bits in ("int8", "int4"):
        k, ks, v, vs = cache(8, 266, bits)
        q, k_new, v_new = (torch.randn(8, 16, 64, generator=g,
                                       device=dev).bfloat16()
                           for _ in range(3))
        p265 = at(265)

        def kernel():
            return decode_attend_int8(q, k, v, ks, vs, 1, p265, k_new=k_new,
                                      v_new=v_new)

        def plain():
            DA.write_kv_rows(k, v, ks, vs, 1, p265, k_new, v_new)
            return decode_attend_int8_xla(q, k, v, ks, vs, 1, 265)
        o = kernel()
        r = {"ms": cuda_ms(kernel, reps=200),
             "device_ms": device_ms(kernel, names, reps=100),
             "device_ms_without_write": device_ms(
                 lambda: decode_attend_int8(q, k, v, ks, vs, 1, p265), names,
                 reps=100),
             "plain_ms": cuda_ms(plain, reps=200),
             "plain_write_ms": cuda_ms(lambda: DA.write_kv_rows(
                 k, v, ks, vs, 1, p265, k_new, v_new), reps=200),
             # layer 1's 266 rows of K and V and their scales, q and the new
             # rows in, o out; one multiply-add per cached value for the
             # scores, one for PV
             **bound(nbytes(k[1], v[1], ks[1], vs[1], q, k_new, v_new, o),
                     4 * 8 * 16 * 266 * 64, "f32")}
        print(f"  E timing {bits} B=8 H=16 T=266 pos=265, slot written: "
              f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"without the write {r['device_ms_without_write']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms (its write alone "
              f"{r['plain_write_ms']:.4f}), bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
        res[bits] = r
    # a serving mesh's rank holds a share of the heads or of the batch:
    # with the whole batch's pairs as the split rule's (``split_pairs``)
    # its rows are one card's bit for bit; without, 32 pairs split where
    # 128 do not (printed)
    k, ks, v, vs = cache(8, VAS_CAPS[-1], "int8")
    q = torch.randn(8, 16, 64, generator=g, device=dev).bfloat16()
    pos = at(VAS_CAPS[-1] - 1)
    full = decode_attend_int8(q, k, v, ks, vs, 1, pos)
    same = {}
    for name, rows, heads in (("heads 4 of 16", slice(None), slice(4, 8)),
                              ("batch 2 of 8", slice(2, 4), slice(None))):
        part = [x[:, rows, heads].contiguous() for x in (k, v, ks, vs)]
        qp = q[rows, heads].contiguous()
        mine = decode_attend_int8(qp, *part, 1, pos, split_pairs=8 * 16)
        check(torch.equal(mine, full[rows, heads]),
              f"E on a mesh rank's {name}: not one card's rows")
        same[name] = torch.equal(decode_attend_int8(qp, *part, 1, pos),
                                 full[rows, heads])
    print(f"  E on a mesh rank's share (heads 4 of 16, batch 2 of 8) with "
          f"the whole batch's split rule: one card's rows bit for bit; "
          f"with its own pairs' rule bit-equal too: {json.dumps(same)}")
    # batch 1 (speculative decoding), the shortest and the longest cache
    sweep = {}
    for t in (VAS_CAPS[0], VAS_CAPS[-1]):
        k, ks, v, vs = cache(1, t, "int8")
        q = torch.randn(1, 16, 64, generator=g, device=dev).bfloat16()
        last = at(t - 1)
        sweep[f"B=1,T={t}"] = round(device_ms(
            lambda: decode_attend_int8(q, k, v, ks, vs, 1, last, k_new=q,
                                       v_new=q), names, reps=50), 5)
    # the same launch with the split switched off: what the cluster buys
    choose = DA.choose_splits
    DA.choose_splits = lambda bh, n: 1
    try:
        sweep["B=1,T=266, one CTA a (b, h)"] = round(device_ms(
            lambda: decode_attend_int8(q, k, v, ks, vs, 1, last, k_new=q,
                                       v_new=q), names, reps=50), 5)
    finally:
        DA.choose_splits = choose
    print(f"  E device ms, int8, bf16 q, pos = T - 1, slot written: "
          f"{json.dumps(sweep)}")
    # the VAS offline batch, 512 x 16 pairs: the streamed body
    bulk = check_bulk_decode_attention(dev, 512, 16, VAS_CAPS, "VAS offline")
    return {"max_abs_err": worst, **res["int8"], "library_ms": None,
            "library_call": None, "int4": res["int4"],
            "device_ms_by_shape": sweep, "streamed_b512_h16": bulk}


def check_int8_linear(dev):
    """The int8 block product on the card against the CPU's, bit for bit:
    the plain chain (``_int8_mm``: cuBLASLt ``_int_mm``, rows padded), the
    two kernels around the same product (``quantize_rows``,
    ``rescale_bias``: ops/int8_linear.py), and the one-launch product
    (``int8_linear_splitk``) at the VAS GPT's four block shapes and the
    XL decoder's widths.  The int32 sums are exact and the quantisers round
    alike, so nothing may differ.  Returns the kernels' rows: the chain's
    two timed at the decode step's widest product (batch 8, 1024 -> 4096),
    the one-launch product at each VAS shape at batch 8 against the chain
    it replaces (``library_ms``: quantize_rows, cuBLASLt's GEMM and
    rescale_bias, device time), the weights read cold (copies over more
    than the 50 MB L2, one a call), as a decode step reads them."""
    from melspec_gpt_vqvae_tpu_torch.models.gpt import (
        _int8_mm, quantize_block_weight, quantize_block_weights)
    from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as IL
    g = torch.Generator().manual_seed(4)
    shapes = {"attn_qkv": (1024, 3072), "attn_proj": (1024, 1024),
              "mlp_up": (1024, 4096), "mlp_down": (4096, 1024)}
    xl_shapes = {"xl_qkv": (1472, 4416), "xl_proj": (1472, 1472),
                 "xl_up": (1472, 5888), "xl_down": (5888, 1472)}
    blocks = {n: {"w": 0.02 * torch.randn(1, *kn, generator=g)}
              for n, kn in {**shapes, **xl_shapes}.items()}
    w_cpu = {n: quantize_block_weight(b["w"]) for n, b in blocks.items()}
    w_dev = quantize_block_weights({n: {"w": blocks[n]["w"].to(dev)}
                                    for n in shapes})
    for name, (kk, nn) in shapes.items():
        for f in ("q", "s"):
            check(torch.equal(w_dev[name][f].cpu(), w_cpu[name][f]),
                  f"quantize_block_weights {name}.{f}: card != CPU")
        for m in (1, 8, 40):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(m, kk, generator=g).to(dtype)
                bias = torch.randn(nn, generator=g).to(dtype)
                wq_d, ws_d = w_dev[name]["q"][0], w_dev[name]["s"][0]
                ref = _int8_mm(x, w_cpu[name]["q"][0], w_cpu[name]["s"][0])
                out = _int8_mm(x.to(dev), wq_d, ws_d)
                check(torch.equal(out.cpu(), ref),
                      f"_int8_mm {name} M={m} {dtype}: card != CPU")
                xq, xs = IL.quantize_rows(x.to(dev))
                xq_ref, xs_ref = IL.quantize_rows_xla(x)
                check(xq.shape[0] == IL.pad_rows(m)
                      and torch.equal(xq[:m].cpu(), xq_ref)
                      and not bool(xq[m:].any())
                      and torch.equal(xs.cpu(), xs_ref),
                      f"quantize_rows {name} M={m} {dtype}: card != CPU")
                for fn in (IL.int8_linear, IL.int8_linear_chain):
                    lin = fn(x.to(dev), wq_d, ws_d, bias.to(dev))
                    check(torch.equal(lin.cpu(), ref.to(dtype) + bias),
                          f"{fn.__name__} {name} M={m} {dtype}: card != CPU")
                # the tensor-parallel form: the scale pass alone, then the
                # rows with given scales (a group of one reduces nothing)
                xs_d = IL.row_scales(x.to(dev))
                xq2, xs2 = IL.quantize_rows(x.to(dev), xs_d)
                lin2 = IL.int8_linear(x.to(dev), wq_d, ws_d, bias.to(dev),
                                      tp=_OneRank())
                check(torch.equal(xs_d.cpu(), xs_ref)
                      and torch.equal(xq2[:m].cpu(), xq_ref)
                      and not bool(xq2[m:].any()) and xs2 is xs_d
                      and torch.equal(lin2.cpu(), ref.to(dtype) + bias),
                      f"row_scales / quantize_rows(xs) / int8_linear(tp) "
                      f"{name} M={m} {dtype}: card != CPU")
    print("  int8 block product: 4 block shapes x M in (1, 8, 40) x "
          "(bf16, f32): _int8_mm, quantize_rows, row_scales, quantize_rows "
          "with given scales, int8_linear (by shape, and the row-cut form) "
          "and the three-kernel chain on the card bitwise equal to the CPU")
    # the one-launch product at every shape it serves, against the CPU's
    # plain chain
    n_checked = 0
    for name, (kk, nn) in {**shapes, **xl_shapes}.items():
        q, s_ = w_cpu[name]["q"][0], w_cpu[name]["s"][0]
        q_d = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                  device=dev).copy_(q)
        for m in (1, 8, 16):
            for dtype in (torch.bfloat16, torch.float32):
                x = (3.0 * torch.randn(m, kk, generator=g)).to(dtype)
                x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
                bias = torch.randn(nn, generator=g).to(dtype)
                out = IL.int8_linear_splitk(x.to(dev), q_d, s_.to(dev),
                                            bias.to(dev))
                check(torch.equal(out.cpu(),
                                  IL.int8_linear_splitk_xla(x, q, s_, bias)),
                      f"int8_linear_splitk {name} ({kk} -> {nn}) M={m} "
                      f"{dtype}: card != CPU")
                n_checked += 1
    print(f"  one-launch int8 product: {n_checked} launches (VAS and XL "
          f"shapes, M in (1, 8, 16), bf16 and f32) bitwise equal to the "
          f"CPU's plain chain")

    x = torch.randn(8, 1024, generator=g).bfloat16().to(dev)
    wq_d, ws_d = w_dev["mlp_up"]["q"][0], w_dev["mlp_up"]["s"][0]
    bias = torch.randn(4096, generator=g).bfloat16().to(dev)
    xq, xs = IL.quantize_rows(x)
    acc = torch._int_mm(xq, wq_d)
    out = IL.rescale_bias(acc, xs, ws_d, bias)
    chain = cuda_ms(lambda: _int8_mm(x, wq_d, ws_d).to(x.dtype) + bias,
                    reps=200)
    fused = cuda_ms(lambda: IL.int8_linear_chain(x, wq_d, ws_d, bias),
                    reps=200)
    print(f"  int8 product M=8 (1024 -> 4096) with bias: plain chain "
          f"{chain:.4f} ms, quantize_rows + _int_mm + rescale_bias "
          f"{fused:.4f} ms")
    rows = {}
    for name, kern, fn, plain, io, ops in (
            ("quantize_rows", "quantize_rows_kernel",
             lambda: IL.quantize_rows(x), lambda: IL.quantize_rows_xla(x),
             (x, xq, xs), 4 * x.numel()),
            ("rescale_bias", "rescale_bias_kernel",
             lambda: IL.rescale_bias(acc, xs, ws_d, bias),
             lambda: IL.rescale_bias_xla(acc, xs, ws_d, bias),
             (acc[:8], xs, ws_d, bias, out), 3 * out.numel()),
            # the row-cut products' scale pass at mlp_down's input under
            # model=4 (8 rows of 1024 of the 4096 features)
            ("row_scales", "quantize_rows_kernel",
             lambda: IL.row_scales(x), lambda: IL.row_scales_xla(x),
             (x, xs), 2 * x.numel())):
        r = {"max_abs_err": 0.0, "ms": cuda_ms(fn, reps=200),
             "device_ms": device_ms(fn, [kern], reps=100),
             "plain_ms": cuda_ms(plain, reps=200),
             **bound(nbytes(*io), ops, "f32"), "library_ms": None,
             "library_call": None}
        print(f"  {name} timing M=8: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
        rows[name] = r
    rows["int8_linear_splitk"] = time_splitk(dev, w_dev, shapes, g)
    return rows


def time_splitk(dev, w_dev, shapes, g):
    """The one-launch product at batch 8 (bf16) at each VAS block shape,
    against the three-kernel chain it replaces; the weights read from
    copies over more than the L2 cache, one a call, as the 24 layers of a
    decode step read theirs.  Returns the kernel's row: the widest shape
    (``mlp_up``) at the top level, every shape under ``shapes``."""
    from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as IL
    rows = {}
    for name, (kk, nn) in shapes.items():
        q, ws_d = w_dev[name]["q"][0], w_dev[name]["s"][0]
        copies = -(-160 * 2 ** 20 // (kk * nn))
        qs = [torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                  device=dev).copy_(q) for _ in range(copies)]
        x = torch.randn(8, kk, generator=g).bfloat16().to(dev)
        bias = torch.randn(nn, generator=g).bfloat16().to(dev)
        turn = [0]

        def rotating(fn):
            def call():
                turn[0] = (turn[0] + 1) % copies
                return fn(x, qs[turn[0]], ws_d, bias)
            return call
        kernel = rotating(IL.int8_linear_splitk)
        chain = rotating(IL.int8_linear_chain)
        plain = rotating(IL.int8_linear_splitk_xla)
        out = kernel()
        r = {"max_abs_err": 0.0, "ms": cuda_ms(kernel, reps=200),
             "device_ms": device_ms(kernel, ["int8_splitk_kernel"],
                                    reps=100),
             "plain_ms": cuda_ms(plain, reps=200),
             # bytes bound it: 16 int8 operations a weight byte take the
             # tensor cores well under a hundredth of the bytes' time
             **bound(nbytes(x, q, ws_d, bias, out), 0, "f32"),
             "library_ms": kernels_ms(chain, ["quantize_rows_kernel",
                                              "gemm", "rescale_bias_kernel"]),
             "library_call": "quantize_rows + torch._int_mm (cuBLASLt) + "
                             "rescale_bias, device time",
             "groups_a_cta": IL.splitk_plan(8, kk, nn)}
        r["roofline_pct"] = 100 * r["bound_ms"] / r["device_ms"]
        print(f"  int8_linear_splitk M=8 {name} ({kk} -> {nn}): kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.5f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"(bytes; {r['roofline_pct']:.1f}% of it), the chain "
              f"{r['library_ms']:.5f} ms device: "
              f"{r['device_ms'] / r['library_ms']:.3f} of it")
        rows[name] = r
        del qs
    return {**rows["mlp_up"], "shapes": rows}


class _OneRank:
    """A model group of one rank: the tensor-parallel form of the int8
    product without a process group (its all-reduces change nothing)."""

    def all_reduce_(self, t, axis, async_op=False, op="sum"):
        return None


def check_flash(dev):
    """Kernel F forward (O, lse) and backward (dQ, dK, dV) against the
    plain versions, at the training shape, T = 266 (one more than four
    row tiles and a column step), a small odd T and T = 1, with and
    without a keep-mask, n_unmasked 0 and T; two backward launches on the
    same inputs must agree bit for bit (no atomics).  Bounds: the JAX
    package's (tests/test_flash_attention.py:26,44): 3e-5 outputs, 5e-5
    gradients."""
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_ref_bwd,
        flash_attention_ref_fwd, make_dropout_mask)
    g = torch.Generator(device=dev).manual_seed(5)
    worst_o = worst_g = 0.0
    for t in (265, 266, 37, 1):
        for nu in (0, t):
            for rate in (0.0, 0.5):
                q, k, v, do = (torch.randn(8, 16, t, 64, generator=g,
                                           device=dev) for _ in range(4))
                keep = make_dropout_mask(g, (8, 16, t, t), rate)
                args = (nu, 1.0 - rate)
                o, lse = flash_attention_fwd(q, k, v, keep, *args)
                o_ref, lse_ref = flash_attention_ref_fwd(q, k, v, keep, *args)
                grads = flash_attention_bwd(q, k, v, keep, o, lse, do, *args)
                refs = flash_attention_ref_bwd(q, k, v, keep, lse_ref, do,
                                               *args)
                torch.cuda.synchronize()
                e_o = max(max_err(o, o_ref), max_err(lse, lse_ref))
                e_g = max(max_err(a, b) for a, b in zip(grads, refs))
                scale = max(r.abs().max().item() for r in refs)
                print(f"  F flash attention T={t:3d} n_unmasked={nu:3d} "
                      f"keep={1 - rate:.1f}: O/lse max|err| {e_o:.3g} (tol "
                      f"3e-5), dQ/dK/dV {e_g:.3g} (tol 5e-5, max|grad| "
                      f"{scale:.3g})")
                check(e_o <= 3e-5, f"flash forward T={t} nu={nu} rate={rate}")
                check(e_g <= 5e-5, f"flash backward T={t} nu={nu} "
                                   f"rate={rate}")
                again = flash_attention_bwd(q, k, v, keep, o, lse, do, *args)
                check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                      f"flash backward T={t} nu={nu} rate={rate}: two "
                      "launches on the same inputs differ")
                worst_o, worst_g = max(worst_o, e_o), max(worst_g, e_g)
    print("  F backward: two launches on the same inputs are bit-equal at "
          "every case")
    # the slice's shape: batch 8, 16 heads, T = 265, the preset's keep 0.5
    q, k, v, do = (torch.randn(8, 16, 265, 64, generator=g, device=dev)
                   for _ in range(4))
    keep = make_dropout_mask(g, (8, 16, 265, 265), 0.5)
    o, lse = flash_attention_fwd(q, k, v, keep, 0, 0.5)
    grads = flash_attention_bwd(q, k, v, keep, o, lse, do, 0, 0.5)
    fwd = (cuda_ms(lambda: flash_attention_fwd(q, k, v, keep, 0, 0.5)),
           cuda_ms(lambda: flash_attention_ref_fwd(q, k, v, keep, 0, 0.5)),
           device_ms(lambda: flash_attention_fwd(q, k, v, keep, 0, 0.5),
                     ["flash_fwd_kernel"]))
    bwd = (cuda_ms(lambda: flash_attention_bwd(q, k, v, keep, o, lse, do,
                                               0, 0.5)),
           cuda_ms(lambda: flash_attention_ref_bwd(q, k, v, keep, lse, do,
                                                   0, 0.5)),
           device_ms(lambda: flash_attention_bwd(q, k, v, keep, o, lse, do,
                                                 0, 0.5), ["flash_bwd_"]))
    # The library call exists only without a keep-mask (keep 1): one
    # float32 scaled_dot_product_attention, causal; with the preset's
    # dropout mask no single call computes the function.  Timed beside the
    # kernel at keep 1; the port never calls it.
    import torch.nn.functional as F
    fwd1 = cuda_ms(lambda: flash_attention_fwd(q, k, v, None, 0, 1.0))
    fwd1_dev = device_ms(lambda: flash_attention_fwd(q, k, v, None, 0, 1.0),
                         ["flash_fwd_kernel"])
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    # The function's products over the causal half, each counted once
    # whatever terms an implementation splits it into: 2 forward (QK^T,
    # PV), 5 backward (scores again, dP, dV, dQ, dK), 2 T (T + 1) / 2 hd
    # flops each, at the tensor cores' TF32 rate (the fastest unit that
    # takes float32 operands); against the bytes, which bind.
    half = 8 * 16 * (265 * 266 // 2) * 64 * 2
    bf = bound(nbytes(q, k, v, keep, o, lse), 2 * half, "tf32")
    bb = bound(nbytes(q, k, v, keep, o, lse, do, *grads), 5 * half, "tf32")
    print(f"  F timing f32 (8,16,265,64) keep 0.5: forward kernel "
          f"{fwd[0]:.4f} ms (device {fwd[2]:.4f}), plain {fwd[1]:.4f} ms, "
          f"bound {bf['bound_ms']:.4f} ms; backward kernel {bwd[0]:.4f} ms "
          f"(device {bwd[2]:.4f}), plain {bwd[1]:.4f} ms, bound "
          f"{bb['bound_ms']:.4f} ms; keep 1: forward kernel {fwd1:.4f} ms "
          f"(device {fwd1_dev:.4f}), scaled_dot_product_attention f32 "
          f"{lib:.4f} ms")
    return ({"max_abs_err": worst_o, "ms": fwd[0], "device_ms": fwd[2],
             "plain_ms": fwd[1], **bf, "library_ms": lib,
             "library_call": "F.scaled_dot_product_attention(q, k, v, "
                             "is_causal=True), float32, keep 1 (no single "
                             "call takes a keep-mask)", "ms_keep1": fwd1,
             "device_ms_keep1": fwd1_dev},
            {"max_abs_err": worst_g, "ms": bwd[0], "device_ms": bwd[2],
             "plain_ms": bwd[1], **bb, "library_ms": None,
             "library_call": None})


# ---------------------------------------------------------------------------
# 2. the main path, 3. float32 reference on the CPU
# ---------------------------------------------------------------------------


def check_request(out, n):
    check(out["tokens"].shape == (n, 265), f"tokens {out['tokens'].shape}")
    check(out["tokens"].min() >= 0 and out["tokens"].max() < 128,
          "tokens out of [0, 128)")
    check(out["specs"].shape == (n, 80, 848), f"specs {out['specs'].shape}")
    check(out["wavs"].shape == (n, 848 * 256), f"wavs {out['wavs'].shape}")
    check(np.isfinite(out["specs"]).all() and np.isfinite(out["wavs"]).all(),
          "non-finite output")
    check(np.abs(out["wavs"]).max() <= 1.0, "waveform outside [-1, 1]")


def reference_check(dev, exp, wav, seed):
    """PR 1's check: the float32 round trip (model-dtype cache) on the card
    against the CPU."""
    from melspec_gpt_vqvae_tpu_torch.models.gpt import gpt_apply, tree_to
    from melspec_gpt_vqvae_tpu_torch.pipeline import (GenerationPipeline,
                                                     tokenize)
    from melspec_gpt_vqvae_tpu_torch.serving import random_weights
    exp = dataclasses.replace(exp, model=exp.model.replace(
        n_layer=2, dtype="float32", cache_dtype="auto",
        decode_weight_dtype="auto"))
    gpt, vq, voc = random_weights(exp, seed)
    cpu = GenerationPipeline(exp, gpt, copy.deepcopy(vq), copy.deepcopy(voc),
                             bf16=False)
    gpu = GenerationPipeline(exp, tree_to(gpt, device=dev), vq, voc,
                             bf16=False)
    cls = [1, 6]
    toks, _ = cpu.generate_tokens(cls, None, sample=False)
    toks_gpu = gpu.generate_tokens(cls, None, sample=False)[0].cpu()
    with torch.inference_mode():
        cond = gpt["class_emb"][torch.tensor(cls)][:, None]
        l_cpu = gpt_apply(cpu.gpt_params, exp.model, toks[:, :-1], cond)
        l_gpu = gpt_apply(gpu.gpt_params, exp.model, toks[:, :-1].to(dev),
                          cond.to(dev))
    specs = cpu.decode_specs(toks)
    specs_gpu = gpu.decode_specs(toks.to(dev))
    wavs = cpu.vocode(specs)
    wavs_gpu = gpu.vocode(specs.to(dev))
    codes = tokenize(cpu.vq, wav[:4].cpu(), exp.mel)
    codes_gpu = tokenize(gpu.vq, wav[:4], exp.mel).cpu()
    # all 48 clips on the card: codes through kernel D's mel against codes
    # through the plain (rFFT) mel, the same float32 VQ-VAE
    from melspec_gpt_vqvae_tpu_torch.ops.mel import waveform_to_mel
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    k_codes, k_lat = mel_codes(gpu.vq, waveform_to_mel_fused(wav, exp.mel))
    p_codes, p_lat = mel_codes(gpu.vq, waveform_to_mel(wav, exp.mel))
    lat4 = [mel_codes(vq, waveform_to_mel_fused(w, exp.mel))
            for vq, w in ((cpu.vq, wav[:4].cpu()), (gpu.vq, wav[:4]))]
    check(torch.equal(lat4[1][0], codes_gpu),
          "mel_codes does not reproduce tokenize")
    res = {"logits": max_err(l_gpu.cpu(), l_cpu),
           "specs": max_err(specs_gpu.cpu(), specs),
           "wavs": max_err(wavs_gpu.cpu(), wavs),
           "greedy_token_agreement": (toks_gpu == toks).float().mean().item(),
           "code_agreement": (codes_gpu == codes).float().mean().item(),
           "codes_unexplained": unexplained_flips(
               codes, codes_gpu, lat4[0][1], lat4[1][1],
               cpu.vq.quantize.embedding),
           "kernel_vs_plain_mel_codes_differing":
               int((k_codes != p_codes).sum()),
           "kernel_vs_plain_mel_codes_unexplained": unexplained_flips(
               p_codes, k_codes, p_lat, k_lat, cpu.vq.quantize.embedding)}
    print(f"  reference (f32, 2-layer GPT, full-width VQ-VAE + MelGAN) card "
          f"vs CPU: {json.dumps(res)}")
    check(res["logits"] <= 1e-3, "teacher-forced logits vs CPU")
    check(res["specs"] <= 1e-3 and res["wavs"] <= 1e-3, "decode vs CPU")
    check(res["codes_unexplained"] == 0, "tokenize codes vs CPU")
    check(res["kernel_vs_plain_mel_codes_unexplained"] == 0,
          "codes of the 48 clips through kernel D vs the plain mel")


def mel_codes(vq, mel):
    """(codes (B, 265) in GPT order on the CPU, latent rows (B * 265, D) in
    the same order, float64 on the CPU) of a (B, 80, 860) mel, as
    ``tokenize`` takes it from there (the nearest index by the caller's
    kernel scope)."""
    with torch.inference_mode():
        lo = (mel.shape[-1] - vq.cfg.resolution) // 2
        x = (2.0 * mel[:, :, lo:lo + vq.cfg.resolution] - 1.0)[:, None]
        z = vq.quant_conv(vq.encoder(x.to(vq.quant_conv.weight.dtype)))
        grid = vq.quantize.nearest_index(z)
    codes = grid.transpose(1, 2).reshape(grid.shape[0], -1).cpu()
    # (B, D, h, w) -> rows in tokenize's time-major order
    return codes, z.permute(0, 3, 2, 1).reshape(-1, z.shape[1]).double().cpu()


def unexplained_flips(codes, codes_b, z, z_b, codebook):
    """Codes where one run picked a and the other b (GPT order, as tokenize
    returns them) although the difference of their latents cannot explain
    it.  With latents z and z' (rows in the codes' order), b can win in
    the second run only if the float64 gap d_z(b) - d_z(a) <=
    2 |z' - z| |e_a - e_b| (plus float32 rounding of the terms); any other
    differing code is a fault."""
    a, b = codes.reshape(-1).long(), codes_b.reshape(-1).long()
    rows = (a != b).nonzero()[:, 0]
    cb = codebook.detach().double().cpu()
    e2 = (cb * cb).sum(1)
    zr = z[rows]
    gap = (e2[b[rows]] - 2 * (zr * cb[b[rows]]).sum(1)) \
        - (e2[a[rows]] - 2 * (zr * cb[a[rows]]).sum(1))
    allowed = 2 * (z_b[rows] - zr).norm(dim=1) * (
        cb[a[rows]] - cb[b[rows]]).norm(dim=1) \
        + 2.0 ** -18 * ((zr ** 2).sum(1) + e2.max())
    return int((gap > allowed).sum())


def teacher_forced(params, cfg, cond, toks, record=None):
    """(logits (B, S, V) on the CPU, cache) of a prefill and S - 1 decode
    steps fed ``toks`` (B, S): the logits that predict each token.  With
    ``record`` (a list), every quantiser call appends its (latents, values)
    on the CPU, in order."""
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    orig = (G._quantize_kv, G._quantize_kv4)

    def recording(fn):
        def quant(x):
            q, scale = fn(x)
            record.append((x.float().cpu(), q.cpu()))
            return q, scale
        return quant
    if record is not None:
        G._quantize_kv, G._quantize_kv4 = map(recording, orig)
    try:
        with torch.inference_mode():
            b, steps = toks.shape
            cache = G.init_kv_cache(cfg, b, max_len=steps + 1,
                                    device=cond.device)
            logits, cache = G.gpt_prefill(params, cfg, cache, None, cond)
            wq = (G.quantize_block_weights(params["blocks"])
                  if cfg.decode_weight_dtype == "int8" else None)
            out = [logits]
            for i in range(steps - 1):
                logits, cache = G.gpt_decode_step(params, cfg, cache,
                                                  toks[:, i], wq)
                out.append(logits)
    finally:
        G._quantize_kv, G._quantize_kv4 = orig
    return torch.stack(out, 1).float().cpu(), cache


def cache_flips(rec_cpu, rec_gpu, bits):
    """Quantised cache values that differ between the CPU and the card.
    Each recorded quantisation is recomputed on the CPU from its latents
    (which must reproduce the values the device cached: the quantisers
    round alike); a value may differ only by 1 and only where the .5
    boundary between the two values lies between the two devices' scaled
    latents.  Returns (values, differing, unexplained, max scaled-latent
    difference)."""
    from melspec_gpt_vqvae_tpu_torch.models.gpt import _unpack4
    lim = 127.0 if bits == "int8" else 7.0
    n = flips = bad = 0
    worst = 0.0
    for (zc, qc_dev), (zg, qg_dev) in zip(rec_cpu, rec_gpu):
        ts, qs = [], []
        for z, q_dev in ((zc, qc_dev), (zg, qg_dev)):
            s = torch.clamp_min(z.abs().amax(-1) / torch.tensor(lim), 1e-8)
            t = z / s[..., None]
            q = torch.clamp(torch.round(t), -lim, lim)
            cached = _unpack4(q_dev) if bits == "int4" else q_dev
            check(torch.equal(cached.float(), q),
                  f"{bits} quantiser: cached values differ from the "
                  "rounding of their latents")
            ts.append(t)
            qs.append(q)
        diff = qs[0] != qs[1]
        mid = (qs[0] + qs[1]) / 2
        explained = ((qs[0] - qs[1]).abs() == 1) \
            & ((ts[0] - mid) * (ts[1] - mid) <= 0)
        n += diff.numel()
        flips += int(diff.sum())
        bad += int((diff & ~explained).sum())
        worst = max(worst, (ts[0] - ts[1]).abs().max().item())
    return n, flips, bad, worst


def quantised_reference_check(dev, exp, seed):
    """float32, 2 GPT layers at the VAS widths, teacher-forced (133 tokens)
    on the card against the CPU, for the int8 and the int4 cache: with
    float32 weights
    the cached values may differ only at rounding boundaries; with int8
    weights (the serving configurations) the logits must stay within the
    configuration's own quantisation error, and greedy speculative decoding
    must equal greedy plain decoding on the card.

    Why the int8-weight runs get no cache-value check: their activations
    are re-quantised at every product, so a 1-ulp difference that moves
    one activation across a rounding boundary moves every output of that
    product by one quantum, and the two devices' runs part by whole quanta
    (a CPU run with 3e-7 relative noise on the attention output reproduces
    the card's differences: ~7,500 of 2.2 million cache values, up to 5
    quanta, logits 0.033).  Each such flip is part of the quantisation
    error itself, which is therefore the bound on the logits."""
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.models.speculative import \
        gpt_speculative_generate
    base = exp.model.replace(n_layer=2, dtype="float32", cache_dtype="auto",
                             decode_weight_dtype="auto")
    params = G.init_gpt_params(base, torch.Generator().manual_seed(seed))
    draft = G.init_gpt_params(base.replace(n_layer=1),
                              torch.Generator().manual_seed(seed + 1))
    params_d, draft_d = (G.tree_to(p, device=dev) for p in (params, draft))
    cls = torch.tensor([1, 6])
    cond, cond_d = G.class_embed(params, cls), G.class_embed(params_d,
                                                             cls.to(dev))
    dcond_d = G.class_embed(draft_d, cls.to(dev))
    # teacher-forced over the first half of a greedy clip: the CPU's
    # int8-weight steps are the slow part of this check
    with torch.inference_mode():
        toks = G.gpt_generate(params, base, None, cond, steps=133,
                              sample=False)
    logits_f32, _ = teacher_forced(params, base, cond, toks)
    for bits in ("int8", "int4"):
        for weights in ("auto", "int8"):
            cfg = base.replace(cache_dtype=bits, decode_weight_dtype=weights)
            rec_c, rec_g = [], []
            l_cpu, c_cpu = teacher_forced(params, cfg, cond, toks, rec_c)
            l_gpu, c_gpu = teacher_forced(params_d, cfg, cond_d,
                                          toks.to(dev), rec_g)
            # the configuration's quantisation error on the CPU
            bound = max_err(l_cpu, logits_f32)
            res = {"teacher_forced_logits": max_err(l_gpu, l_cpu),
                   "logits_bound_quantisation_error": bound}
            if weights == "auto":
                n, flips, bad, worst = cache_flips(rec_c, rec_g, bits)
                vals = [G._unpack4(c[k].cpu()) if bits == "int4"
                        else c[k].cpu() for c in (c_cpu, c_gpu)
                        for k in ("k", "v")]
                dv = torch.cat([(a.int() - b.int()).reshape(-1)
                                for a, b in zip(vals[:2], vals[2:])])
                sc, sg = (torch.cat([c[k].float().cpu().reshape(-1)
                                     for k in ("k_scale", "v_scale")])
                          for c in (c_cpu, c_gpu))
                res.update({"cache_values": n, "cache_flips": flips,
                            "unexplained_flips": bad,
                            "cached_value_diffs": int((dv != 0).sum()),
                            "max_scaled_latent_diff": worst,
                            "scale_diffs": int((sc != sg).sum())})
                check(bad == 0 and res["cached_value_diffs"] == flips
                      and int(dv.abs().max()) <= 1,
                      f"{bits} cache values vs CPU: {json.dumps(res)}")
                check(bool(((sc - sg).abs() <= 2.0 ** -7 * sc.abs()).all()),
                      f"{bits} cache scales vs CPU: more than one bf16 ulp")
            else:
                dcfg = cfg.replace(n_layer=1)
                with torch.inference_mode():
                    plain = G.gpt_generate(params_d, cfg, None, cond_d,
                                           steps=265, sample=False,
                                           segments=8)
                    spec, stats = gpt_speculative_generate(
                        params_d, cfg, draft_d, dcfg, None, cond_d, dcond_d,
                        steps=265, gamma=4, sample=False)
                res.update({"greedy_spec_equals_plain":
                            bool(torch.equal(plain, spec)),
                            "spec_stats": stats})
                check(res["greedy_spec_equals_plain"],
                      f"{bits} greedy speculative != greedy plain on the "
                      "card")
            print(f"  {bits} cache, {weights} weights (f32, 2-layer GPT) "
                  f"card vs CPU: {json.dumps(res)}")
            check(res["teacher_forced_logits"] <= bound,
                  f"{bits} cache, {weights} weights: teacher-forced logits "
                  "vs CPU")


def profile_decode_step(pipe, cfg, dev, given=132, warm=4, steps=8,
                        graph=True):
    """Launches and device time of one decode step at batch 8 in the
    middle of a clip (positions 137-144 of a full-length cache), from a
    ``torch.profiler`` window of ``steps`` steps after ``warm`` steps:
    device launches per token, device busy ms per step, kernel E's part
    of it, and the busy share of an unprofiled step (host clock around 50
    synchronised steps).  ``graph``: the steps are replays of the captured
    program (sampling included, greedy), as the pipeline runs them; else
    eager ``gpt_decode_step`` calls at host positions."""
    from torch.profiler import DeviceType, ProfilerActivity

    from melspec_gpt_vqvae_tpu_torch.models import decode_graph
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    params = pipe.gpt_params
    with torch.inference_mode():
        cond = G.class_embed(params, torch.arange(8, device=dev))
        toks = torch.arange(8 * given, device=dev).reshape(8, given) \
            % cfg.vocab_size
        wq = (pipe.block_weights.get(params["blocks"])
              if cfg.decode_weight_dtype == "int8" else None)
        if graph:
            # a session of the clip's second half: prompt of 1 + given,
            # 266 - 1 - given steps, one capacity
            holder = decode_graph.DecodeGraphs()
            n_steps = 265 - given
            G.gpt_generate(params, cfg, None, cond, toks, steps=n_steps,
                           sample=False, wq=wq, graph=holder)
            sess = holder.last
            check(n_steps >= 50 + warm, "profile_decode_step: given")

            def rewind():
                sess.pos.fill_(1 + given)
                sess.step.zero_()

            def step():
                sess.replay(266)
        else:
            cache = G.init_kv_cache(cfg, 8, max_len=266, device=dev)
            logits, cache = G.gpt_prefill(params, cfg, cache, toks, cond)
            first = (logits, cache["len"])

            def rewind():
                nonlocal logits
                logits, cache["len"] = first

            def step():
                nonlocal logits, cache
                logits, cache = G.gpt_decode_step(params, cfg, cache,
                                                  logits.argmax(-1), wq)
        rewind()
        for _ in range(warm):
            step()
        torch.cuda.synchronize()
        wall_ms = 0.0

        def run():
            nonlocal wall_ms
            rewind()
            for _ in range(warm):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps

        def tally(avgs):
            launches = busy_us = e_us = e_calls = 0
            for ev in avgs:
                if ev.device_type != DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                launches += ev.count
                busy_us += us
                if "decode_attention_kernel" in ev.key:
                    e_us += us
                    e_calls += ev.count
            return launches, busy_us, e_us, e_calls

        # a whole trace holds kernel E once a layer a step (warm-up steps
        # of the window included), where the cache is quantised
        quantised = cfg.cache_dtype in ("int8", "int4")
        avgs, whole = profiled(
            run, lambda a: not quantised
            or tally(a)[3] >= cfg.n_layer * (steps + warm) - 1,
            [ProfilerActivity.CUDA])
        launches, busy_us, e_us, _ = tally(avgs)
        # the window holds warm + steps steps; an unprofiled step's wall
        rewind()
        _, dt = wall(lambda: [step() for _ in range(50)])
    n = steps + warm
    res = {"launches_per_token": launches / n,
           "device_busy_ms_per_step": busy_us / 1e3 / n,
           "kernel_E_ms_per_step": e_us / 1e3 / n,
           "wall_ms_per_step_profiled": wall_ms,
           "wall_ms_per_step": dt * 1e3 / 50,
           "device_busy_share": busy_us / 1e3 / n / (dt * 1e3 / 50),
           "positions": [given + warm + 1, given + warm + steps],
           "trace_whole": whole}
    print(f"  decode step, batch 8, {cfg.cache_dtype} cache, "
          f"{cfg.decode_weight_dtype} weights, "
          f"{'captured program' if graph else 'eager loop'} "
          f"(torch.profiler, {n} steps; wall from 50 unprofiled steps): "
          f"{json.dumps(res)}")
    check(launches > 0 and busy_us > 0, "profiler saw no device activity")
    return res


def splitk_vs_chain(dev, pipe, seed):
    """The one-launch int8 product against the three-kernel chain in the
    decode it serves, on the card: a captured batch-8 greedy decode of 265
    steps at the VAS widths (24 layers, bf16, int8 cache and weights) run
    twice, the second with ``SPLITK_MAX_ROWS`` 0 so that every product
    takes the chain; tokens and the caches must be equal byte for byte, and
    the logits of 16 device-position steps after a prefill bit for bit."""
    from melspec_gpt_vqvae_tpu_torch.models import decode_graph
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as IL
    cfg = pipe.gcfg
    params = G.init_gpt_params(cfg, torch.Generator().manual_seed(seed),
                               device=dev)
    wq = G.quantize_block_weights(params["blocks"])
    cond = G.class_embed(params, torch.arange(8, device=dev))

    def decode():
        holder = decode_graph.DecodeGraphs()
        toks = G.gpt_generate(params, cfg, None, cond, steps=265,
                              segments=8, sample=False, wq=wq, graph=holder)
        cache = holder.last.cache
        steps_logits = []
        step_cache = G.init_kv_cache(cfg, 8, max_len=cfg.block_size,
                                     device=dev)
        logits, step_cache = G.gpt_prefill(params, cfg, step_cache, None,
                                           cond)
        step_cache["len"] = torch.tensor([step_cache["len"]], device=dev)
        for _ in range(16):
            logits, step_cache = G.gpt_decode_step(
                params, cfg, step_cache, logits.argmax(-1), wq)
            steps_logits.append(logits.float().cpu())
        return (toks.cpu(), {k: v.clone() for k, v in cache.items()
                             if k != "len"}, torch.stack(steps_logits))

    with torch.inference_mode():
        before = IL.int8_linear_splitk.launches
        toks, cache, logits = decode()
        one = IL.int8_linear_splitk.launches - before
        limit = IL.SPLITK_MAX_ROWS
        IL.SPLITK_MAX_ROWS = 0
        try:
            before = IL.int8_linear_splitk.launches
            toks_c, cache_c, logits_c = decode()
            chained = IL.int8_linear_splitk.launches - before
        finally:
            IL.SPLITK_MAX_ROWS = limit
    same = {k: bool(torch.equal(cache[k], cache_c[k])) for k in cache}
    res = {"tokens_equal": bool(torch.equal(toks, toks_c)),
           "cache_bytes_equal": same,
           "logits_equal_16_steps": bool(torch.equal(logits, logits_c)),
           "one_launch_products": one, "chain_run_one_launch_products":
           chained}
    print(f"  one-launch product against the chain, captured batch-8 greedy "
          f"decode, 24 layers: {json.dumps(res)}")
    check(one > 0 and chained == 0, "splitk_vs_chain: the runs did not "
          "take the paths they name")
    check(res["tokens_equal"] and all(same.values())
          and res["logits_equal_16_steps"],
          "splitk_vs_chain: the one-launch product's decode differs from the "
          "chain's")


def captured_vs_eager(dev, pipe, seed):
    """The captured decode programs against the eager loop on the card,
    265 steps at batch 8 and the full VAS width: tokens must be equal, and
    after a plain decode the two caches byte for byte.  The card's default
    (int8 cache and weights, greedy and sampled), the int4 and bf16 caches
    and speculative decoding at batch 1 and 8 run on 6-layer (speculative:
    4-layer target, 1-layer draft) copies of ``pipe``'s configuration,
    since the eager loop is what costs the seconds here (the 24-layer
    default ran here until the export phases took the run past 300 s)."""
    from melspec_gpt_vqvae_tpu_torch.models import decode_graph
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.models.speculative import \
        gpt_speculative_generate

    def plain(name, params, cfg, wq, batch, sample, **skw):
        cond = G.class_embed(params, torch.arange(batch, device=dev) % 8)
        skw = {"temperature": 1.0, "top_k": None, "top_p": None, **skw}
        holder = decode_graph.DecodeGraphs()
        with torch.inference_mode():
            toks, t_c = wall(lambda: G.gpt_generate(
                params, cfg, torch.Generator(device=dev).manual_seed(seed),
                cond, steps=265, segments=8, sample=sample, wq=wq,
                graph=holder, **skw))
            (ref, cache), t_e = wall(lambda: G.gpt_generate_eager(
                params, cfg, torch.Generator(device=dev).manual_seed(seed),
                cond, None, 265, 8, sample, skw, wq))
        mine = holder.last.cache
        same = {k: bool(torch.equal(cache[k], mine[k]))
                for k in cache if k != "len"}
        res = {"tokens_equal": bool(torch.equal(toks, ref)),
               "cache_bytes_equal": same,
               "captured_s_with_capture": round(t_c, 3),
               "capture_s": round(holder.capture_seconds, 3),
               "eager_s": round(t_e, 3)}
        print(f"  {name}: {json.dumps(res)}")
        check(res["tokens_equal"], f"{name}: captured tokens != eager")
        check(all(same.values()), f"{name}: cache bytes differ")

    def cfg_of(layers, cache, weights):
        return pipe.gcfg.replace(n_layer=layers, cache_dtype=cache,
                                 decode_weight_dtype=weights)

    def weights(cfg, offset):
        params = G.init_gpt_params(
            cfg, torch.Generator().manual_seed(seed + offset), device=dev)
        wq = (G.quantize_block_weights(params["blocks"])
              if cfg.decode_weight_dtype == "int8" else None)
        return params, wq

    for cache, w, sample, skw in (("int8", "int8", False, {}),
                                  ("int4", "int8", False, {}),
                                  ("auto", "auto", False, {}),
                                  ("int8", "int8", True, {"top_k": 100})):
        cfg = cfg_of(6, cache, w)
        params, wq = weights(cfg, 1)
        plain(f"{'sampled top_k=100' if sample else 'greedy'}, 6 layers, "
              f"{cache} cache, {w} weights", params, cfg, wq, 8, sample,
              **skw)
    cfg, dcfg = cfg_of(4, "int8", "int8"), cfg_of(1, "int8", "int8")
    (params, wq), (draft, dwq) = weights(cfg, 2), weights(dcfg, 3)
    # a random draft is rejected almost always; the target as its own
    # draft is accepted always (the bonus token, the full rewind)
    for title, batch, (dp, dc, dq) in (
            ("random 1-layer draft", 1, (draft, dcfg, dwq)),
            ("random 1-layer draft", 8, (draft, dcfg, dwq)),
            ("the target as its own draft", 8, (params, cfg, wq))):
        cls = torch.arange(batch, device=dev) % 8
        out = []
        for graph in (decode_graph.DecodeGraphs(), False):
            with torch.inference_mode():
                out.append(wall(lambda: gpt_speculative_generate(
                    params, cfg, dp, dc, None, G.class_embed(params, cls),
                    G.class_embed(dp, cls), steps=265, gamma=4, sample=False,
                    wq=wq, draft_wq=dq, graph=graph)))
        ((toks, stats), t_c), ((ref, ref_stats), t_e) = out
        res = {"tokens_equal": bool(torch.equal(toks, ref)),
               "stats_equal": stats == ref_stats, "stats": stats,
               "captured_s_with_capture": round(t_c, 3),
               "eager_s": round(t_e, 3)}
        print(f"  greedy speculative, 4-layer target, {title}, gamma 4, "
              f"batch {batch}: {json.dumps(res)}")
        check(res["tokens_equal"] and res["stats_equal"],
              f"speculative batch {batch}, {title}: captured != eager")


def serve_path(exp, pipe, dev, requests):
    """Answer ``requests`` ((batch, kwargs, classes) each) through a
    GenerationService, printing each request's seconds and the seconds of
    its last batch's three stages (host clock around synchronised work).
    Returns (generate calls, summed speculative rounds)."""
    from melspec_gpt_vqvae_tpu_torch.serving import GenerationService
    stage = {}
    for name, attr in (("gpt_decode", "generate_tokens"),
                       ("vq_decode", "decode_specs"), ("vocoder", "vocode")):
        def timed(*a, _fn=getattr(pipe, attr), _name=name, **kw):
            res, stage[_name] = wall(lambda: _fn(*a, **kw))
            return res
        setattr(pipe, attr, timed)
    calls = rounds = 0
    try:
        for batch, kw, cls in requests:
            svc = GenerationService(exp, pipe, batch=batch, seed=1)
            cap0 = pipe.graphs.capture_seconds
            out, dt = wall(lambda: svc.generate(cls, **kw))
            cap = pipe.graphs.capture_seconds - cap0
            check_request(out, len(cls))
            calls += -(-len(cls) // batch)
            rounds += out.get("spec_stats", {}).get("rounds", 0)
            extra = (f", spec_stats {json.dumps(out['spec_stats'])}"
                     if "spec_stats" in out else "")
            print(f"  request batch {batch} {kw or 'sampled top_k=100'}: "
                  f"{dt:.2f} s"
                  + (f" ({cap:.2f} s of it the capture of a new shape's "
                     f"decode program, inside gpt_decode)" if cap else "")
                  + f", stage seconds "
                  f"{json.dumps({k: round(v, 4) for k, v in stage.items()})}"
                  f"{extra}")
    finally:
        # the timing wrappers hold the pipeline they hang on: with them in
        # place ``del pipe`` frees nothing until a cycle collection, and a
        # whole pipeline's weights stay on the card meanwhile
        for attr in ("generate_tokens", "decode_specs", "vocode"):
            delattr(pipe, attr)
    return calls, rounds


# ---------------------------------------------------------------------------
# 5. serving the trained checkpoint
# ---------------------------------------------------------------------------


def read_pcm(blob):
    """(samples int16, rate) of a PCM16 WAV."""
    with wave.open(io.BytesIO(blob), "rb") as w:
        return (np.frombuffer(w.readframes(w.getnframes()), "<i2"),
                w.getframerate())


def http(url, body=None):
    """The body of a GET (no ``body``) or a JSON POST; raises on an HTTP
    error."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def lockstep_on_off(params, cfg, cond, toks):
    """Teacher-forced over ``toks`` (B, S): a prefill, then S - 1 device-
    position decode steps (the captured step's arithmetic, run eagerly)
    with the kernels and, from a copy of the same cache, without them.
    The kernels' run goes on; returns (max |logits| difference of a step
    from the same state, steps whose first-layer cache slot differs, the
    kernels' logits (B, S, V) on the CPU).  The first layer's slot comes
    from the same bits either way (the int8 product's kernels equal their
    plain versions bit for bit, and so does E's write); every later value
    follows an attention output that E and its plain version round
    differently."""
    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    b, steps = toks.shape
    with torch.inference_mode():
        cache = G.init_kv_cache(cfg, b, max_len=steps + 1,
                                device=cond.device)
        logits, cache = G.gpt_prefill(params, cfg, cache, None, cond)
        cache["len"] = torch.tensor([cache["len"]], device=cond.device)
        wq = G.quantize_block_weights(params["blocks"])
        out, worst, differ = [logits], 0.0, 0
        for i in range(steps - 1):
            copy_ = {k: v.clone() for k, v in cache.items()}
            with _build.kernels(False):
                l_off, _ = G.gpt_decode_step(params, cfg, copy_, toks[:, i],
                                             wq)
            logits, cache = G.gpt_decode_step(params, cfg, cache, toks[:, i],
                                              wq)
            worst = max(worst, max_err(logits, l_off))
            differ += any(not torch.equal(cache[k][0], copy_[k][0])
                          for k in ("k", "v", "k_scale", "v_scale"))
            out.append(logits)
    return worst, differ, torch.stack(out, 1).float().cpu()


def free_running(params, cfg, cond, toks, switch):
    """Teacher-forced logits (B, S, V) on the CPU of one device-position
    run with its own cache, inside ``_build.kernels(switch)`` (None: the
    kernels)."""
    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    b, steps = toks.shape
    with torch.inference_mode(), _build.kernels(switch):
        cache = G.init_kv_cache(cfg, b, max_len=steps + 1,
                                device=cond.device)
        logits, cache = G.gpt_prefill(params, cfg, cache, None, cond)
        cache["len"] = torch.tensor([cache["len"]], device=cond.device)
        wq = (G.quantize_block_weights(params["blocks"])
              if cfg.decode_weight_dtype == "int8" else None)
        out = [logits]
        for i in range(steps - 1):
            logits, cache = G.gpt_decode_step(params, cfg, cache, toks[:, i],
                                              wq)
            out.append(logits)
    return torch.stack(out, 1).float().cpu()


def kernels_on_off_f32(dev, exp, wav, seed):
    """A float32 2-layer copy at the VAS widths with the int8 cache and
    int8 weights (kernels A, B, C, D, E and the int8 product's on the
    path), the kernels against a pipeline with ``use_kernels=False`` on
    the same weights.

    With float32 weights and the int8 cache (E on the path) the
    teacher-forced logits of the two agree within 1e-3.  With int8
    weights every product re-quantises its activations, and kernel E's
    float rounding moves some across a rounding boundary, so even one
    step from the same state parts by whole quanta (PERF.md §6, as the
    card against the CPU): there the first layer's new cache slot must be
    equal bit for bit at every step, and the logits, step for step and
    run free, stay within the configuration's own quantisation error, as
    in ``quantised_reference_check``.  That bound is the plain path's
    distance from float32 (no margin), which the kernels do not touch: a
    wrong kernel cannot widen it."""
    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    from melspec_gpt_vqvae_tpu_torch.pipeline import (GenerationPipeline,
                                                     tokenize)
    from melspec_gpt_vqvae_tpu_torch.serving import random_weights
    exp = dataclasses.replace(exp, model=exp.model.replace(
        n_layer=2, dtype="float32", cache_dtype="int8",
        decode_weight_dtype="int8"))
    gpt, vq, voc = random_weights(exp, seed)
    gpt = G.tree_to(gpt, device=dev)
    on = GenerationPipeline(exp, gpt, vq, voc, bf16=False)
    off = GenerationPipeline(exp, gpt, vq, voc, bf16=False,
                             use_kernels=False)
    cls = [1, 6]
    toks, _ = on.generate_tokens(cls, None, sample=False)
    toks_off, _ = off.generate_tokens(cls, None, sample=False)
    cond = G.class_embed(gpt, torch.tensor(cls, device=dev))
    step_err, differ, l_on = lockstep_on_off(gpt, exp.model, cond, toks)
    l_off = free_running(gpt, exp.model, cond, toks, False)
    l_f32 = free_running(gpt, exp.model.replace(
        cache_dtype="auto", decode_weight_dtype="auto"), cond, toks, None)
    f32w = exp.model.replace(decode_weight_dtype="auto")
    e_err = max_err(free_running(gpt, f32w, cond, toks, None),
                    free_running(gpt, f32w, cond, toks, False))
    specs, specs_off = on.decode_specs(toks), off.decode_specs(toks)
    wavs, wavs_off = on.vocode(specs), off.vocode(specs)
    # the codes through tokenize itself, the latents that explain a
    # differing code through mel_codes (the same arithmetic, spelled out)
    k_codes = tokenize(on.vq, wav, exp.mel).cpu()
    p_codes = off.tokenize(wav, exp.mel).cpu()
    k_lat = mel_codes(on.vq, waveform_to_mel_fused(wav, exp.mel))[1]
    with _build.kernels(False):
        p_lat = mel_codes(off.vq, waveform_to_mel_fused(wav, exp.mel))[1]
    res = {"int8_cache_f32_weights_logits": e_err,
           "stepwise_logits": step_err,
           "steps_first_layer_slot_differs": differ,
           "free_running_logits": max_err(l_on, l_off),
           "bound_quantisation_error": max_err(l_off, l_f32),
           "kernels_quantisation_error": max_err(l_on, l_f32),
           "specs": max_err(specs, specs_off),
           "wavs": max_err(wavs, wavs_off),
           "tokenize_codes_differing": int((k_codes != p_codes).sum()),
           "tokenize_unexplained_flips": unexplained_flips(
               p_codes, k_codes, p_lat, k_lat, on.vq.quantize.embedding),
           "greedy_token_agreement": (toks == toks_off).float().mean()
           .item()}
    print(f"  kernels on vs off (f32, 2-layer GPT, int8 cache and weights, "
          f"full-width VQ-VAE + MelGAN): {json.dumps(res)}")
    check(e_err <= 1e-3, "kernels vs plain, int8 cache and float32 weights: "
          "teacher-forced logits")
    check(differ == 0, "kernels vs plain, step for step: the first layer's "
          "new cache slot")
    check(max(step_err, res["free_running_logits"])
          <= res["bound_quantisation_error"],
          "kernels vs plain, int8 weights: logits beyond the quantisation "
          "error")
    check(res["specs"] <= 1e-3 and res["wavs"] <= 1e-3,
          "kernels vs plain: decode and vocoder")
    check(res["tokenize_unexplained_flips"] == 0,
          "kernels vs plain: tokenize codes")


def served_checkpoint_check(dev, wav, wrappers, zero, decode_launches,
                            smi_line):
    """Phase 5, run from the training tree: the checkpoint the training
    phase wrote served through build_pipeline, HTTP, sample.main, as its
    own draft, and with the kernels off.  Returns kernel E's launches on
    the HTTP path (24 x 265 a batch-8 call, plus the warm-up runs)."""
    from melspec_gpt_vqvae_tpu_torch import sample as sample_cli
    from melspec_gpt_vqvae_tpu_torch.pipeline import (GenerationPipeline,
                                                     wav_bytes)
    from melspec_gpt_vqvae_tpu_torch.serving import (GenerationService,
                                                    build_pipeline, serve)
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    steps = 265
    (exp, pipe), t_load = wall(lambda: build_pipeline(
        "vas", experiment="smoke", resume="last", device=dev))
    m = exp.model
    check((m.dtype, m.cache_dtype, m.decode_weight_dtype, m.n_layer)
          == ("bfloat16", "int8", "int8", 24),
          f"served checkpoint config {m.dtype}/{m.cache_dtype}/"
          f"{m.decode_weight_dtype}, {m.n_layer} layers")
    saved = CheckpointManager(os.path.join(
        "lightning_logs", "smoke-vas", "checkpoints", "version_0")).restore(
        "last", mmap=True)["state"]["params"]
    served = dict(named_leaves(pipe.gpt_params))
    same = all(torch.equal(t.to(torch.bfloat16), served[n].cpu())
               for n, t in named_leaves(saved))
    print(f"  build_pipeline(experiment='smoke', resume='last'): {t_load:.2f}"
          f" s; its bf16 params equal the checkpoint's float32 params "
          f"rounded to bf16, bit for bit: {same}")
    check(same, "served params vs the checkpoint")
    del saved

    # --- HTTP -----------------------------------------------------------
    svc = GenerationService(exp, pipe, batch=8)
    httpd = serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        zero()
        health = json.loads(http(url + "/healthz"))
        check(health["platform"] == "cuda" and health["model"]["n_layer"]
              == 24, f"/healthz {health}")
        cap0 = pipe.graphs.capture_seconds
        blob, t_get = wall(lambda: http(url + "/generate?class=3"))
        cap_get = pipe.graphs.capture_seconds - cap0
        pcm, rate = read_pcm(blob)
        check(pcm.shape == (848 * 256,) and rate == 22050,
              f"GET /generate: {pcm.shape} samples at {rate} Hz")
        cap0 = pipe.graphs.capture_seconds
        body, t_post = wall(lambda: json.loads(http(url + "/generate", {
            "classes": list(range(8)), "deterministic": True, "seed": 5,
            "format": "json"})))
        cap_post = pipe.graphs.capture_seconds - cap0
        ref, t_ref = wall(lambda: svc.generate(list(range(8)), sample=False))
        steps_off = []
        for i, clip in enumerate(body["clips"]):
            got = read_pcm(base64.b64decode(clip["wav_base64"]))[0]
            want = read_pcm(wav_bytes(ref["wavs"][i]))[0]
            steps_off.append(int(np.abs(got.astype(np.int32)
                                        - want.astype(np.int32)).max()))
        print(f"  HTTP on {url}: /healthz {json.dumps(health)}")
        print(f"  GET /generate?class=3 (batch 8, sampled top_k=100): "
              f"{t_get:.2f} s, {cap_get:.2f} s of it the capture; POST 8 "
              f"classes deterministic: {t_post:.2f} s, {cap_post:.2f} s of "
              f"it the capture; the service's own greedy request "
              f"{t_ref:.2f} s; largest PCM16 step between the POST's clips "
              f"and the service's: {max(steps_off)}")
        check([c["class"] for c in body["clips"]] == list(range(8))
              and max(steps_off) <= 1, "POST /generate vs the service")
        c = decode_launches(pipe, "HTTP", 3 * steps * m.n_layer)
        check(c["attention"] > 0 and c["vocoder_stack"] > 0,
              "the HTTP path launched kernels A and B")
        e_http = c["decode_attention"]
    finally:
        httpd.shutdown()
        httpd.server_close()

    # --- kernels off, the same weights ------------------------------------
    off = GenerationPipeline(exp, pipe.gpt_params, pipe.vq, pipe.melgan,
                             use_kernels=False)
    svc_on = GenerationService(exp, pipe, batch=8, seed=1)
    svc_off = GenerationService(exp, off, batch=8, seed=1)
    zero()
    codes_off, t_tok = wall(lambda: off.tokenize(wav))
    _, t_off_first = wall(lambda: svc_off.generate(list(range(8))))
    out_off, t_off = wall(lambda: svc_off.generate(list(range(8))))
    launched = {k: w.launches for k, w in wrappers.items()}
    captured = off.graphs.captures > 0 and all(
        p.graph is not None for p in off.graphs.last.programs)
    out_on, t_on = wall(lambda: svc_on.generate(list(range(8))))
    check_request(out_off, 8)
    check_request(out_on, 8)
    print(f"  use_kernels=False on the same weights: tokenize 48 clips "
          f"{t_tok:.3f} s; launches {json.dumps(launched)}; decode program "
          f"captured: {captured}")
    print(f"  batch-8 request (sampled top_k=100), {smi_line}: kernels on "
          f"{t_on:.3f} s, kernels off {t_off:.3f} s (first, with its "
          f"capture, {t_off_first:.3f} s)")
    check(codes_off.shape == (48, 265), "tokenize with the kernels off")
    check(not any(launched.values()), "use_kernels=False launched kernels")
    check(captured, "use_kernels=False: the decode program was not captured")
    del off, svc_off, svc_on, svc, pipe
    torch.cuda.empty_cache()

    # --- the sample CLI ---------------------------------------------------
    out_dir = Path("samples")
    summary, t_cli = wall(lambda: sample_cli.main([
        "--experiment", "smoke", "--resume", "last", "--classes", "0,3",
        "--num", "2", "--batch", "8", "--out_dir", str(out_dir),
        "--save_codes"]))
    files = sorted(p.name for p in out_dir.iterdir())
    print(f"  sample.main: {t_cli:.2f} s with its pipeline; files {files}")
    check(summary["written"] == 4 and len(files) == 8
          and all(f"class{c:02d}_{i:03d}{ext}" in files for c in (0, 3)
                  for i in (0, 1) for ext in (".wav", "_codes.npy")),
          "sample.main output")
    torch.cuda.empty_cache()

    # --- the checkpoint as its own draft ----------------------------------
    (exp_d, dpipe), t_dload = wall(lambda: build_pipeline(
        "vas", experiment="smoke", draft_experiment="smoke", resume="last",
        draft_resume="last", device=dev))
    out, t_d = wall(lambda: GenerationService(exp_d, dpipe, batch=1)
                    .generate([3], sample=False))
    stats = out["spec_stats"]
    print(f"  the checkpoint as its own draft (24 + 24 layers, gamma "
          f"{dpipe.gamma}), loaded in {t_dload:.2f} s: greedy batch-1 "
          f"request {t_d:.2f} s with its capture, spec_stats "
          f"{json.dumps(stats)}")
    check(stats["rounds"] > 0 and stats["accepted"] == stats["drafted"],
          "a self-draft must have every proposal accepted")
    del dpipe
    torch.cuda.empty_cache()
    return e_http


# ---------------------------------------------------------------------------
# 6. the export artifact and the int8 decode stage
# ---------------------------------------------------------------------------

EXPORT_DIR = Path("build") / "chip_smoke_export"
# artifact -> the flags of scripts/torch_export_serving.py beside
# --init_random --batch 8 (the script's seed is chip_smoke's)
EXPORTS = {"greedy": ["--deterministic"], "sampled": ["--top_k", "100"]}
# depth of the exported pipeline's GPT (the VAS width; cut from 24 when the
# GPT-VAE phase came: the artifact's request runs its decode scan eagerly,
# ~60 ms a token at 24 layers)
EXPORT_LAYERS = 6
EXPORT_OVERRIDE = f"n_layer={EXPORT_LAYERS}"
SNR_GATE_DB = 20.0


def start_exports():
    """Start scripts/torch_export_serving.py, one process an artifact, for
    the card's default pipeline at the VAS width and EXPORT_LAYERS layers
    (random weights of chip_smoke's seed): batch 8, greedy and sampled
    top_k 100, traced on the card.  Tracing is host work, so it runs beside the phases before
    ``export_check``.  Returns {name: (process, artifact, log)}."""
    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    script = Path(__file__).resolve().parent / "scripts" / \
        "torch_export_serving.py"
    procs = {}
    for name, flags in EXPORTS.items():
        path, log = EXPORT_DIR / f"{name}.pt2", EXPORT_DIR / f"{name}.log"
        with open(log, "w") as out:
            procs[name] = (subprocess.Popen(
                [sys.executable, str(script), "--init_random", "--batch", "8",
                 "--override", EXPORT_OVERRIDE, "--out", str(path), *flags],
                stdout=out,
                stderr=subprocess.STDOUT), path, log)
    return procs


def stop_exports(procs):
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def snr_db(ref, x):
    ref, x = np.asarray(ref, np.float64), np.asarray(x, np.float64)
    return float(10 * np.log10(np.mean(ref ** 2)
                               / max(float(np.mean((x - ref) ** 2)), 1e-20)))


def export_check(dev, procs, wrappers, zero):
    """The two artifacts the export processes wrote, loaded and served
    through ``ArtifactPipeline`` beside the live pipeline on the same
    weights: greedy tokens and sampled tokens for one seed equal to the
    live pipeline with ``use_kernels=False`` (both run the same ATen ops
    on this card: export.py's guarantee, as the JAX package's), the share
    equal to the kernels' own printed; every graph of the loaded programs
    holds only ATen / prims ops, getitem and torch's higher-order ops, and
    a request launches no kernel of the port.  Returns the live pipeline."""
    from melspec_gpt_vqvae_tpu_torch import export as X
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline
    summaries, t0 = {}, time.perf_counter()
    for name, (proc, path, log) in procs.items():
        rc = proc.wait(timeout=900)
        text = log.read_text()
        check(rc == 0, f"export {name}: exit {rc}:\n{text[-4000:]}")
        summaries[name] = json.loads(text.strip().splitlines()[-1])
    print(f"  waited {time.perf_counter() - t0:.1f} s here for the export "
          f"processes")
    exp, pipe = build_pipeline("vas", init_random=True, seed=783435,
                               device=dev, override=EXPORT_OVERRIDE)
    off = GenerationPipeline(exp, pipe.gpt_params, pipe.vq, pipe.melgan,
                             use_kernels=False)
    cls = list(range(8))
    for name, sample in (("greedy", False), ("sampled", True)):
        s = summaries[name]
        check(s["device"] == "cuda" and s["batch"] == 8
              and s["sample"] == sample, f"export {name}: sidecar {s}")
        apipe, t_load = wall(lambda: X.ArtifactPipeline.from_file(
            str(procs[name][1]), pipe))
        graphs = X.check_kernel_free(apipe.exported)
        kw = dict(temperature=1.0, top_k=100, top_p=None, sample=sample)

        def request(p):
            return wall(lambda: p.generate(
                cls, torch.Generator(device=dev).manual_seed(1234), **kw))
        zero()
        art, t_art = request(apipe)
        launched = {k: w.launches for k, w in wrappers.items()}
        request(off)                      # its capture
        ref_off, t_off = request(off)
        request(pipe)
        ref_on, t_on = request(pipe)
        check_request(art, 8)
        res = {"export_s": round(s["export_seconds"], 2),
               "artifact_bytes": s["bytes"], "graphs": graphs,
               "load_s": round(t_load, 3),
               "request_s": {"artifact": round(t_art, 3),
                             "live_kernels_off": round(t_off, 3),
                             "live_kernels_on": round(t_on, 3)},
               "launches_in_artifact_requests": launched,
               "tokens_equal_live_kernels_off": bool(np.array_equal(
                   art["tokens"], ref_off["tokens"])),
               "specs_max_err_vs_off": max_err(
                   torch.from_numpy(art["specs"]),
                   torch.from_numpy(ref_off["specs"])),
               "wavs_max_err_vs_off": max_err(
                   torch.from_numpy(art["wavs"]),
                   torch.from_numpy(ref_off["wavs"])),
               "token_share_equal_live_kernels_on": float(
                   (art["tokens"] == ref_on["tokens"]).mean())}
        print(f"  artifact {name} (batch 8{'' if sample else ', greedy'}"
              f"{', sampled top_k=100, seed 1234' if sample else ''}): "
              f"{json.dumps(res)}")
        check(res["tokens_equal_live_kernels_off"],
              f"artifact {name}: tokens differ from the live pipeline with "
              "use_kernels=False")
        check(not any(launched.values()),
              f"artifact {name}: a request launched kernels {launched}")
        # the same tokens through the same bf16 conv ops: bound at six
        # bfloat16 steps at 1.0
        check(max(res["specs_max_err_vs_off"], res["wavs_max_err_vs_off"])
              <= 0.05, f"artifact {name}: decode vs the live pipeline")
        del apipe
    del off
    torch.cuda.empty_cache()
    return pipe


def artifact_http_check():
    """``python -m melspec_gpt_vqvae_tpu_torch.serve --init_random
    --artifact sampled.pt2 --no_warmup`` on a free port: the batch and
    knobs from the sidecar, one sample mode; a request with the baked
    knobs gets 200 and a WAV, one with another top_k 400.  (The warm-up
    would be one more artifact request; that it runs the baked mode only
    is held on the CPU, tests/test_torch_port_export.py.)"""
    import urllib.error

    from melspec_gpt_vqvae_tpu_torch import serve as serve_cli
    path = str(EXPORT_DIR / "sampled.pt2")
    httpd, t_start = wall(lambda: serve_cli.start([
        "--init_random", "--artifact", path, "--port", "0",
        "--no_warmup", "--override", EXPORT_OVERRIDE]))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        svc = httpd.service
        check(svc.batch == 8 and svc.pipe.sample_modes == (True,)
              and svc.defaults["top_k"] == 100,
              f"serve --artifact: batch {svc.batch}, modes "
              f"{svc.pipe.sample_modes}, defaults {svc.defaults}")
        health = json.loads(http(url + "/healthz"))
        blob, t_get = wall(lambda: http(url + "/generate?class=3&seed=7"))
        pcm, rate = read_pcm(blob)
        try:
            http(url + "/generate?class=3&top_k=5")
            code, err = 200, ""
        except urllib.error.HTTPError as e:
            code, err = e.code, json.loads(e.read())["error"]
        print(f"  serve --artifact on {url}: start (pipeline, load) "
              f"{t_start:.2f} s; /healthz platform "
              f"{health['platform']}, batch {health['batch']}; GET "
              f"/generate?class=3 {t_get:.2f} s, {pcm.shape[0]} samples at "
              f"{rate} Hz; top_k=5: {code} ({err[:80]})")
        check(health["platform"] == "cuda" and health["batch"] == 8,
              f"/healthz {health}")
        check(pcm.shape == (848 * 256,) and rate == 22050,
              f"GET /generate from the artifact: {pcm.shape} at {rate} Hz")
        check(code == 400 and "re-export" in err,
              f"another top_k: {code} {err}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    del httpd
    torch.cuda.empty_cache()


def int8_decode_check(dev, pipe, wrappers, zero):
    """``build_pipeline(int8_decode=True)`` on the weights of ``pipe`` (the
    card's default): its calibration's seconds; a batch-8 request's tokens
    equal to ``pipe``'s for one seed (the stage runs after them, as in JAX
    tests/test_quantized.py:236-257); kernel B not launched (the int8
    stage replaces it); the stages' SNR against the bf16 / kernel-B stage
    on the same tokens at or above SNR_GATE_DB, the JAX package's gate for
    reference-scale random weights: scripts/int8_quality.py:222-227 gates
    the spectrogram at 20 dB, and JAX tests/test_quantized.py holds the
    vocoder to the same 20 dB on the float spectrogram, which is how the
    waveform is held here; the waveform of the whole int8 stage (the int8
    spectrogram through the int8 vocoder) is printed, as int8_quality.py
    prints it, not gated; and the vq_decode and vocoder stage seconds of
    both on the same tokens."""
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline
    (_, qpipe), t_build = wall(lambda: build_pipeline(
        "vas", init_random=True, seed=783435, device=dev, int8_decode=True,
        override=EXPORT_OVERRIDE))
    cls = list(range(8))

    def request(p):
        return p.generate(cls, torch.Generator(device=dev).manual_seed(99),
                          temperature=1.0, top_k=100)
    zero()
    out_q = request(qpipe)
    b_launches = wrappers["vocoder_stack"].launches
    out_f = request(pipe)
    check_request(out_q, 8)
    toks = torch.from_numpy(out_f["tokens"]).to(dev).long()
    stages, specs = {}, {}
    for name, p in (("bf16_kernel_b", pipe), ("int8", qpipe)):
        p.vocode(p.decode_specs(toks))          # cuDNN plans, first calls
        specs[name], t_dec = wall(lambda: p.decode_specs(toks))
        _, t_voc = wall(lambda: p.vocode(specs[name]))
        stages[name] = {"vq_decode_s": round(t_dec, 4),
                        "vocoder_s": round(t_voc, 4)}
    # the vocoders on the same (bf16 stage's) spectrogram
    ref = specs["bf16_kernel_b"]
    wav_f, wav_q = pipe.vocode(ref), qpipe.vocode(ref)
    res = {"build_s": round(t_build, 2),
           "calibrate_s": round(qpipe.calibrate_seconds, 2),
           "quantised_convs": len(qpipe.qstate["w8"]),
           "tokens_equal": bool(np.array_equal(out_q["tokens"],
                                               out_f["tokens"])),
           "kernel_b_launches": b_launches,
           "spec_snr_db": round(snr_db(out_f["specs"], out_q["specs"]), 2),
           "vocoder_wav_snr_db": round(snr_db(wav_f.float().cpu(),
                                              wav_q.float().cpu()), 2),
           "stage_wav_snr_db": round(snr_db(out_f["wavs"], out_q["wavs"]),
                                     2),
           "stage_seconds_batch8": stages}
    print(f"  int8 decode stage (VAS width, batch 8, sampled top_k=100, "
          f"seed 99): {json.dumps(res)} (gate: spec_snr_db and "
          f"vocoder_wav_snr_db >= {SNR_GATE_DB} dB)")
    check(res["tokens_equal"], "int8_decode: tokens differ from the float "
          "pipeline's")
    check(b_launches == 0, "int8_decode: kernel B launched")
    check(min(res["spec_snr_db"], res["vocoder_wav_snr_db"]) >= SNR_GATE_DB,
          "int8_decode: SNR against the bf16 stage below the gate")
    del qpipe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4. training
# ---------------------------------------------------------------------------

TRAIN_STEPS, VAL_BATCHES = 4, 1
TRAIN_ROOT = Path("build") / "chip_smoke_train"


def write_vas_tree(root, mels, codes):
    """A VAS tree under ``root`` as GPT_train reads it: 8 classes of six
    clips (the battery's 48 mels and their VQ codes, as (5, 53) grids),
    five per class in the train split (40 lines) and one in the valid
    split (8 lines)."""
    shutil.rmtree(root, ignore_errors=True)
    grids = codes.reshape(-1, 53, 5).transpose(1, 2).cpu().numpy()
    mels = mels.cpu().numpy()
    train, valid = [], []
    for i in range(48):
        cls, vid = f"class{i % 8}", f"clip_{i:03d}"
        feat = root / "data" / "vas" / "features" / cls
        for sub in ("melspec_10s_22050hz", "codes_10s"):
            (feat / sub).mkdir(parents=True, exist_ok=True)
        np.save(feat / "melspec_10s_22050hz" / f"{vid}_mel.npy", mels[i])
        np.save(feat / "codes_10s" / f"{vid}_mel_code.npy",
                grids[i].astype(np.int64))
        (valid if i >= 40 else train).append(f"{cls}/{vid}")
    (root / "data" / "vas_train.txt").write_text("\n".join(train) + "\n")
    (root / "data" / "vas_valid.txt").write_text("\n".join(valid) + "\n")


def run_train_cli(root, flash, train=True):
    """``train_gpt.main`` from ``root`` with the VAS preset (full width,
    batch 8, dropout 0.5).  ``train``: TRAIN_STEPS steps, VAL_BATCHES
    validation batches and the final checkpoint.  Otherwise the evaluation
    entry point, ``--train 0 --eval 1 --resume last``: that checkpoint
    restored and validated on VAL_BATCHES batches.  Returns (main's result,
    the validation losses the call computed, the (B, H, T, hd) shapes and
    dtypes the GPT blocks handed kernel A's wrapper)."""
    from melspec_gpt_vqvae_tpu_torch import train_gpt
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    from melspec_gpt_vqvae_tpu_torch.training import runner
    # media logging has a phase of its own (media_check): off here
    argv = ["--dataset", "vas", "--experiment", "smoke", "--device", "cuda",
            "--limit_val_batches", str(VAL_BATCHES), "--logging_frequency",
            "0", "--override", f"use_flash_train={flash}"]
    argv += (["--train", "1", "--epochs_override", "1", "--ckpt_every", "0",
              "--limit_train_batches", str(TRAIN_STEPS)] if train
             else ["--train", "0", "--eval", "1", "--resume", "last"])
    val_losses, a_calls = [], []
    val_loss, attend = runner._val_loss, G.attend

    def recording_val_loss(*a, **kw):
        val_losses.append(val_loss(*a, **kw))
        return val_losses[-1]

    def recording_attend(q, k, v, n_unmasked=0, **kw):
        a_calls.append((tuple(q.shape), q.dtype))
        return attend(q, k, v, n_unmasked, **kw)
    cwd = os.getcwd()
    os.chdir(root)
    runner._val_loss, G.attend = recording_val_loss, recording_attend
    try:
        return (train_gpt.main(train_gpt.init_config(argv)), val_losses,
                a_calls)
    finally:
        runner._val_loss, G.attend = val_loss, attend
        os.chdir(cwd)


def timed_steps(task, state, batch, n, lr=None):
    """``n`` train steps on one batch (dropout generators as fit_gpt draws
    them) of a ``GPTTask`` or ``VAETask``; returns (losses, ms per step
    over the last n - 2 steps, peak device bytes)."""
    from melspec_gpt_vqvae_tpu_torch.training.optim import with_lr
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator
    if lr is not None:
        with_lr(state["optimizer"], lr)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(n):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = task.train_step(state, batch,
                                      step_generator(1, 0, i, task.device))[:2]
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n - 2)
    return ([l.item() for l in losses], ms,
            torch.cuda.max_memory_allocated())


# device kernels of a train step by class: (label, substrings of the
# kernel's name, lower case); what matches none is "the rest"
TRAIN_KERNEL_CLASSES = (
    ("F forward", ("flash_fwd_kernel",)),
    ("F dQ", ("flash_bwd_dq",)),
    ("F dK,dV", ("flash_bwd_dkv",)),
    ("F delta", ("flash_bwd_delta",)),
    # cuBLAS's float32 kernels carry "gemm" in their names, its Hopper
    # bfloat16 ones "nvjet"
    ("GEMMs", ("gemm", "cutlass", "cublas", "gemv", "nvjet")),
    ("AdamW", ("multi_tensor_apply", "adam")))


def profile_train_step(task, state, batch, title, f_forward, warm=2,
                       steps=3):
    """Device milliseconds of one full-width train step (a ``GPTTask``'s
    or a ``VAETask``'s) by kernel class, from a ``torch.profiler`` window
    of ``steps`` steps after ``warm`` steps on ``batch``: kernel F's
    forward, dQ, dK/dV and delta kernels, the cuBLAS GEMMs (float32, or
    bfloat16 under mixed precision), AdamW and the rest, the device's busy
    time against the wall, and the kernels a step launches.  A window is
    whole when it holds AdamW once a step and ``f_forward`` launches of
    F's forward a step (less one at the window's edge)."""
    from torch.profiler import DeviceType, ProfilerActivity

    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator

    def step(i):
        nonlocal state
        state = task.train_step(state, batch,
                                step_generator(1, 0, i, task.device))[0]
    for i in range(warm):
        step(i)
    torch.cuda.synchronize()
    done, wall_ms = warm, 0.0

    def run():
        nonlocal done, wall_ms
        t0 = time.perf_counter()
        for i in range(steps):
            step(done + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        done += steps

    def tally(avgs):
        ms = {label: 0.0 for label, _ in TRAIN_KERNEL_CLASSES}
        ms["the rest"] = 0.0
        counts = dict.fromkeys(ms, 0)
        for ev in avgs:
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            key = ev.key.lower()
            label = next((lab for lab, names in TRAIN_KERNEL_CLASSES
                          if any(n in key for n in names)), "the rest")
            ms[label] += us / 1e3 / steps
            counts[label] += ev.count
        return ms, counts

    def whole_trace(avgs):
        # AdamW runs once a step whatever the attention; with kernel F the
        # trace also holds its forward once a layer a step
        _, counts = tally(avgs)
        return (counts["AdamW"] >= steps
                and counts["F forward"] >= f_forward * steps - 1)

    avgs, whole = profiled(run, whole_trace, [ProfilerActivity.CUDA])
    ms, counts = tally(avgs)
    busy = sum(ms.values())
    res = {"device_ms_per_step": {k: round(v, 3) for k, v in ms.items()},
           "device_busy_ms_per_step": round(busy, 3),
           "wall_ms_per_step_profiled": round(wall_ms, 3),
           "kernels_per_step": sum(counts.values()) / steps,
           "F_forward_launches_per_step": counts["F forward"] / steps,
           "trace_whole": whole}
    print(f"  train step, {title} (torch.profiler, {steps} steps after "
          f"{warm}): {json.dumps(res)}")
    check(busy > 0, "profiler saw no device activity in the train step")
    return res


def train_check(dev, mels, codes):
    """The training main path, its launch counts, the checkpoint, the
    evaluation of that checkpoint through kernel A, step times against the
    plain attention, and the learning check.  Returns F's launches
    (forward, backward) on the training path, A's on the evaluation path
    and the batch the steps were timed on."""
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    write_vas_tree(TRAIN_ROOT, mels, codes)
    torch.cuda.empty_cache()
    print(f"  device memory before training: allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    ((task, state, ckpt), flash_val, _), dt = wall(
        lambda: run_train_cli(TRAIN_ROOT, True))
    launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    n_layer = task.cfg.n_layer
    print(f"  train_gpt.main (VAS preset, use_flash_train, {TRAIN_STEPS} "
          f"steps, {VAL_BATCHES} val batch, checkpoint): {dt:.1f} s; F "
          f"launches forward {launches[0]}, backward {launches[1]}")
    check(state["step"] == TRAIN_STEPS, f"train steps {state['step']}")
    check(launches == (n_layer * (TRAIN_STEPS + VAL_BATCHES),
                       n_layer * TRAIN_STEPS),
          "kernel F: n_layer forward launches per train or val forward, "
          "n_layer backward launches per train step")

    same = trees_equal(ckpt.restore("last")["state"], task.state_tree(state))
    print(f"  checkpoint restore('last') equals the live params and AdamW "
          f"state bit for bit: {same}")
    check(same, "checkpoint round trip")

    # the evaluation entry point on that checkpoint, use_flash_train off:
    # every layer's attention is kernel A at (8, 16, 265, 64) float32.  The
    # resume restores into shapes, so its peak is one train state (params
    # and the two AdamW moments) plus the forward, not two states
    state_bytes = sum(t.numel() * t.element_size()
                      for part in ("params", "mu", "nu")
                      for _, t in named_leaves(task.state_tree(state)[part]))
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()   # the training run's live state
    torch.cuda.reset_peak_memory_stats()
    attend.launches = flash_attention_fwd.launches = 0
    (_, a_val, a_calls), dt = wall(
        lambda: run_train_cli(TRAIN_ROOT, False, train=False))
    a_launches = attend.launches
    peak = torch.cuda.max_memory_allocated() - held
    print(f"  evaluation with --resume last: peak device memory "
          f"{peak / 2 ** 30:.3f} GiB above what was held before it; one "
          f"train state is {state_bytes / 2 ** 30:.3f} GiB")
    check(peak < 1.5 * state_bytes,
          "the resume held more than one train state on the card")
    # A's float32 tile kernel and F's forward without a keep-mask run the
    # same tiles, split and order of sums on the same weights and batch, so
    # the two losses differ by rounding at most; 1e-4 is the bound asked of
    # two kernels for one function
    diff = abs(a_val[0] - flash_val[0]) if a_val and flash_val else None
    print(f"  train_gpt.main --train 0 --eval 1 --resume last "
          f"(use_flash_train off, {VAL_BATCHES} val batch): {dt:.1f} s; A "
          f"launches {a_launches}, F forward launches "
          f"{flash_attention_fwd.launches}; val/loss {a_val} against the "
          f"flash run's {flash_val}: |diff| {diff}")
    check(len(a_val) == 1 and len(flash_val) == 1,
          f"validation passes: evaluation {len(a_val)}, training "
          f"{len(flash_val)}")
    check(a_launches == n_layer * VAL_BATCHES == len(a_calls),
          "kernel A: n_layer launches per validation batch")
    check(set(a_calls) == {((8, 16, 265, 64), torch.float32)},
          f"kernel A on the evaluation path ran at {set(a_calls)}")
    check(flash_attention_fwd.launches == 0,
          "the evaluation path launched kernel F")
    check(np.isfinite(a_val[0]) and diff <= 1e-4,
          f"validation loss through kernel A {a_val[0]} against kernel F "
          f"{flash_val[0]}")

    batch = first_train_batch()
    losses, ms, mem = timed_steps(task, state, batch, 30, lr=3e-4)
    tokens = 8 * 265 / (ms / 1e3)
    print(f"  flash attention: {ms:.1f} ms per step, {tokens:.0f} tokens/s, "
          f"peak {mem / 2 ** 30:.2f} GiB; repeated batch at lr 3e-4: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in 30 steps")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "loss on a repeated batch did not fall")
    prof = profile_train_step(task, state, batch, "kernel F", n_layer)
    # a trace that came back short three times over is a fault of the
    # tracer, not of the step: the launch counters above hold F exactly
    check(not prof["trace_whole"]
          or (prof["F_forward_launches_per_step"] >= n_layer - 1
              and all(prof["device_ms_per_step"][c] > 0
                      for c in ("F forward", "F dQ", "F dK,dV"))),
          "the profiled train step did not run kernel F in every layer")
    # the same step under mixed precision (bfloat16 products, float32
    # results and residual stream), on the same state and batch
    mixed = GPTTask(load_vas_exp(use_flash_train=True, mixed_precision=True),
                    dev)
    mlosses, mms, mmem = timed_steps(mixed, state, batch, 10)
    print(f"  flash attention, mixed precision: {mms:.1f} ms per step, "
          f"{8 * 265 / (mms / 1e3):.0f} tokens/s, peak "
          f"{mmem / 2 ** 30:.2f} GiB (float32: {ms:.1f} ms)")
    check(all(np.isfinite(mlosses)), "non-finite mixed-precision loss")
    profile_train_step(mixed, state, batch, "kernel F, mixed precision",
                       n_layer)
    del task, state, ckpt, mixed
    torch.cuda.empty_cache()

    plain = GPTTask(load_vas_exp(use_flash_train=False), dev)
    pstate = plain.init_state()
    _, pms, pmem = timed_steps(plain, pstate, batch, 10)
    print(f"  plain attention (attend_xla): {pms:.1f} ms per step, "
          f"{8 * 265 / (pms / 1e3):.0f} tokens/s, peak "
          f"{pmem / 2 ** 30:.2f} GiB")
    prof = profile_train_step(plain, pstate, batch, "plain attention", 0)
    check(prof["F_forward_launches_per_step"] == 0,
          "the plain-attention step launched kernel F")
    del plain, pstate
    torch.cuda.empty_cache()
    return launches, a_launches, batch


def load_vas_exp(**override):
    from melspec_gpt_vqvae_tpu_torch.configs import load_preset
    return load_preset("GPT", "vas", **override)


def first_train_batch(root=TRAIN_ROOT, batch_size=8):
    """The first batch of a synthetic tree's shuffled train split."""
    from melspec_gpt_vqvae_tpu_torch.data import DataModule
    dm = DataModule(batch_size=batch_size, spec_dir_path=str(
        root / "data" / "vas" / "features" / "*" / "melspec_10s_22050hz"),
        data_root=str(root / "data"))
    dm.setup()
    return next(iter(dm.train_dataloader()))


def train_reference_check(dev, batch):
    """One float32 train step of a 2-layer GPT at the VAS widths, dropout
    0, kernel F, on the card against the CPU: the loss, every gradient and
    the updated parameters."""
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    exp = load_vas_exp(n_layer=2, embd_pdrop=0.0, resid_pdrop=0.0,
                       attn_pdrop=0.0, use_flash_train=True,
                       learning_rate=3e-4)
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        task = GPTTask(exp, d)
        state = task.init_state(11)
        state, loss = task.train_step(state, batch, torch.Generator(device=d))
        out[name] = (loss.item(), {n: (t.detach().cpu(), t.grad.cpu())
                                   for n, t in named_leaves(state["params"])})
    (l_cpu, cpu), (l_card, card) = out["cpu"], out["card"]
    g_rel = max(max_err(card[n][1], cpu[n][1])
                / cpu[n][1].abs().max().clamp_min(1e-30).item() for n in cpu)
    # Adam's first step is ~lr * sign(g): a parameter may differ only where
    # its gradient is within the gradient bound of 0
    p_err, p_bad = 0.0, 0
    for n in cpu:
        dp = (card[n][0] - cpu[n][0]).abs()
        p_err = max(p_err, dp.max().item())
        p_bad += int(((dp > 1e-6 + 1e-6 * cpu[n][0].abs())
                      & (cpu[n][1].abs() > 1e-4 * cpu[n][1].abs().max()))
                     .sum())
    res = {"loss_cpu": l_cpu, "loss_diff": abs(l_card - l_cpu),
           "grad_max_rel_err": g_rel, "param_max_diff": p_err,
           "params_differing_beyond_grad_noise": p_bad}
    print(f"  train step (f32, 2-layer GPT, VAS widths, dropout 0, kernel F) "
          f"card vs CPU: {json.dumps(res)} (bounds: loss 5e-5, gradients "
          f"1e-4 of each leaf's max|g|)")
    check(res["loss_diff"] <= 5e-5, "train step loss vs CPU")
    check(g_rel <= 1e-4, "train step gradients vs CPU")
    check(p_bad == 0, "updated parameters vs CPU")


# ---------------------------------------------------------------------------
# 6b. distributed training: NCCL at world size 1, the mesh paths against
#     the plain ones, the torchrun launcher
# ---------------------------------------------------------------------------


# NCCL's kernels: its collectives carry "nccl" in their names; a one-rank
# average is its oneRankReduce kernel (a product by 1 / 1)
NCCL_KERNELS = ("nccl", "onerankreduce")
DIST_EXPERIMENT, DIST_LAYERS = "dist", 2


def start_torchrun():
    """``torchrun --standalone --nproc_per_node 1 -m ...train_gpt --mesh
    data=1`` from TRAIN_ROOT: one epoch of a DIST_LAYERS-layer VAS GPT
    (use_flash_train), one validation batch, the final checkpoint; its
    output in TRAIN_ROOT / torchrun.log.  Returns (process, log file)."""
    log = open(TRAIN_ROOT / "torchrun.log", "w")
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m",
           "melspec_gpt_vqvae_tpu_torch.train_gpt", "--dataset", "vas",
           "--experiment", DIST_EXPERIMENT, "--train", "1", "--device",
           "cuda", "--mesh", "data=1", "--epochs_override", "1",
           "--ckpt_every", "0", "--logging_frequency", "0",
           "--limit_val_batches", "1", "--override",
           f"n_layer={DIST_LAYERS},use_flash_train=True"]
    return subprocess.Popen(cmd, cwd=TRAIN_ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


def wait_torchrun(proc, log):
    """Wait for the launcher's run (``start_torchrun``); it must exit 0."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (TRAIN_ROOT / "torchrun.log").read_text()
    check(rc == 0, f"the torchrun run exited {rc}:\n{text[-4000:]}")
    print(f"  the torchrun run ended {time.perf_counter() - t0:.1f} s after "
          "the checks above")
    for line in text.splitlines():
        if line.startswith(("device:", "epoch")):
            print(f"    torchrun: {line}")


def logged_scalars(log_dir, tag):
    """The values a TBLogger wrote under ``tag`` in ``log_dir``: its
    ``events.jsonl`` where tensorboardX is missing, else its event file
    (TFRecords of Event protos, read through tensorboardX's own proto)."""
    jsonl = log_dir / "events.jsonl"
    if jsonl.exists():
        recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
        return [r["value"] for r in recs if r["tag"] == tag]
    import struct

    from tensorboardX.proto.event_pb2 import Event
    out = []
    for path in sorted(log_dir.glob("events.out.tfevents.*")):
        data, pos = path.read_bytes(), 0
        while pos + 12 <= len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            out += [v.simple_value for v in ev.summary.value if v.tag == tag]
    return out


def check_torchrun(dev):
    """The launcher's checkpoint, restored in this process with no process
    group: its validation loss on the same batch within 1e-6 of the one
    the run logged."""
    from melspec_gpt_vqvae_tpu_torch.data import DataModule
    from melspec_gpt_vqvae_tpu_torch.training import runner
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    import torch.distributed as dist
    check(not dist.is_initialized(), "a process group is still joined")
    run = TRAIN_ROOT / "lightning_logs" / f"{DIST_EXPERIMENT}-vas"
    vals = logged_scalars(run / "TensorBoardLoggs" / "version_0",
                          "val/loss")
    ckpt = CheckpointManager(str(run / "checkpoints" / "version_0"))
    tree = ckpt.restore("last")
    exp = load_vas_exp(n_layer=DIST_LAYERS, use_flash_train=True)
    task = GPTTask(exp, dev)
    state = task.load_state(tree["state"])
    dm = DataModule(batch_size=8, spec_dir_path=str(
        TRAIN_ROOT / "data" / "vas" / "features" / "*"
        / "melspec_10s_22050hz"), data_root=str(TRAIN_ROOT / "data"))
    dm.setup()
    val = runner._val_loss(task, state, dm.val_dataloader(), 1)
    steps = len(dm.train_dataloader())
    print(f"  torchrun --standalone --nproc_per_node 1 -m "
          f"melspec_gpt_vqvae_tpu_torch.train_gpt --mesh data=1 (VAS preset "
          f"at {DIST_LAYERS} layers, use_flash_train, one epoch): its "
          f"checkpoint at step {tree['state']['step']} (epoch "
          f"{tree['epoch']}), val/loss logged {vals}; restored here with no "
          f"process group: {val!r} (|diff| "
          f"{abs(val - vals[-1]) if vals else None})")
    check(len(vals) == 1 and tree["state"]["step"] == steps
          and tree["epoch"] == 0, "the torchrun run's checkpoint")
    check(abs(val - vals[-1]) <= 1e-6,
          "the torchrun checkpoint's validation loss restored")


def nccl_profile(task, state, batch, steps=2):
    """NCCL's kernels in ``steps`` profiled train steps of a mesh task:
    device ms and launches a step, and their names."""
    from torch.profiler import DeviceType, ProfilerActivity

    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator

    def run():
        for i in range(steps):
            task.train_step(state, batch,
                            step_generator(1, 0, i, task.device))
        torch.cuda.synchronize()

    def nccl(avgs):
        return [ev for ev in avgs if ev.device_type == DeviceType.CUDA
                and any(n in ev.key.lower() for n in NCCL_KERNELS)]
    avgs, whole = profiled(run, lambda a: bool(nccl(a)),
                           [ProfilerActivity.CUDA])
    us = 0.0
    for ev in nccl(avgs):
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
    return {"device_ms_per_step": us / 1e3 / steps,
            "launches_per_step": sum(ev.count for ev in nccl(avgs)) / steps,
            "kernels": sorted({ev.key[:80] for ev in nccl(avgs)}),
            "trace_whole": whole}


def update_err(before, ref_after, after):
    """A step's parameter update against a reference step's from the same
    parameters ``before`` (lists of leaves with ``.grad``): over the
    elements whose reference gradient lies farther from zero than the
    leaf's largest gradient difference (there both steps' gradients have
    one sign, so Adam's update is determined), the largest over leaves of
    |update - reference update| / |reference update| (L2 norms); and the
    share of elements that covers.  A step that left the parameters as
    they were reads 1, one with the update's sign flipped 2."""
    worst, kept, total = 0.0, 0, 0
    for p0, r, m in zip(before, ref_after, after):
        g_r, g_m = r.grad.float(), m.grad.float()
        sure = g_r.abs() > (g_m - g_r).abs().max()
        d_r = (r.detach().float() - p0.float())[sure]
        d_m = (m.detach().float() - p0.float())[sure]
        kept += int(sure.sum())
        total += sure.numel()
        den = d_r.norm()
        if den > 0:
            worst = max(worst, ((d_m - d_r).norm() / den).item())
    return worst, kept / total


def interleaved_ms(runs, warm=2, rounds=2, per=5):
    """ms of each train step (synchronised before and after) of several
    paths on the card, in alternating blocks so that a drift of the clocks
    falls on every path alike: ``warm`` untimed steps each, then
    ``rounds`` blocks of ``per`` timed steps each.  ``runs``: {name:
    (task, state, batch)}; returns {name: [ms, ...]}."""
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator
    out = {k: [] for k in runs}
    for task, state, batch in runs.values():
        for i in range(warm):
            task.train_step(state, batch, step_generator(1, 0, i,
                                                         task.device))
    for r in range(rounds):
        for k, (task, state, batch) in runs.items():
            for i in range(per):
                gen = step_generator(1, 0, warm + r * per + i, task.device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                task.train_step(state, batch, gen)
                torch.cuda.synchronize()
                out[k].append((time.perf_counter() - t0) * 1e3)
    return out


def dist_check(dev, codes, batch, smi_line):
    """The port's distributed training on the card, NCCL at world size 1
    (a process group from a file store), the launcher beside it: the class
    GPT (VAS preset, full width, kernel F, mixed precision) one step under
    ``data=1`` bit for bit the plain step's, NCCL's kernels in it; the
    same step with dropout 0 under ``pipe=1`` and 4 microbatches within
    1e-5 (loss) and 1e-2 (gradients, of each leaf's largest) of the plain
    one, its parameter update within 5e-2 of the plain step's
    (``update_err``), F exactly 24 x 4 forward and backward launches, and
    A exactly 24 x 4 in its evaluation without F; the GPT-VAE
    (GPT_VAE_vas, full width, batch 24) one step under ``data=1,model=1``
    bit for bit the plain one, NCCL's kernels in it; the launcher's run
    (``wait_torchrun``, ``check_torchrun``); then each path's ms a step
    (``interleaved_ms``).  Returns the launches of F (forward, backward)
    and A on the pipe path."""
    import tempfile

    from melspec_gpt_vqvae_tpu_torch import train_gpt_vae
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from melspec_gpt_vqvae_tpu_torch.parallel import (make_mesh,
                                                      maybe_init_distributed,
                                                      shutdown_distributed)
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    from melspec_gpt_vqvae_tpu_torch.training.runner import step_generator
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask

    def params_equal(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(named_leaves(a["params"]), named_leaves(b["params"])))

    def grads_rel_err(a, b):
        # each leaf's gradient error over its largest gradient
        return max(max_err(x.grad, y.grad)
                   / x.grad.abs().max().clamp_min(1e-30).item()
                   for (_, x), (_, y) in zip(named_leaves(a["params"]),
                                             named_leaves(b["params"])))

    launcher = start_torchrun()
    store = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    maybe_init_distributed(dev, init_method=f"file://{store}/store", rank=0,
                           world_size=1)
    try:
        # the class GPT: the preset's dropout 0.5 under data=1, dropout 0
        # for the pipeline (its microbatches draw other masks)
        exp = load_vas_exp(use_flash_train=True, mixed_precision=True)
        exp0 = load_vas_exp(use_flash_train=True, mixed_precision=True,
                            embd_pdrop=0.0, attn_pdrop=0.0,
                            resid_pdrop=0.0)
        tasks = {"plain": GPTTask(exp, dev),
                 "plain again": GPTTask(exp, dev),
                 "data=1": GPTTask(exp, dev, make_mesh({"data": 1}, dev)),
                 "plain_p0": GPTTask(exp0, dev),
                 "pipe=1,M=4": GPTTask(exp0, dev,
                                       make_mesh({"pipe": 1}, dev, 4))}
        first = tasks["plain"].init_state(7)
        states = {k: t.load_state(tasks["plain"].state_tree(first))
                  for k, t in tasks.items() if k != "plain"}
        before = [t.detach().clone() for _, t in
                  named_leaves(first["params"])]
        states["plain"] = first
        losses = {}
        for k, t in tasks.items():
            if k == "pipe=1,M=4":
                flash_attention_fwd.launches = 0
                flash_attention_bwd.launches = 0
            states[k], losses[k] = t.train_step(
                states[k], batch, step_generator(1, 0, 0, dev))
        f_launches = (flash_attention_fwd.launches,
                      flash_attention_bwd.launches)
        same = (torch.equal(losses["plain"], losses["data=1"])
                and params_equal(states["plain"], states["data=1"]))
        again = (torch.equal(losses["plain"], losses["plain again"])
                 and params_equal(states["plain"], states["plain again"]))
        if not same:
            print("  parameters the data=1 step left otherwise: " + ", ".join(
                n for (n, x), (_, y) in zip(
                    named_leaves(states["plain"]["params"]),
                    named_leaves(states["data=1"]["params"]))
                if not torch.equal(x, y)) + f"; the plain step repeated "
                f"bit for bit: {again}")
        pp_loss = abs(losses["plain_p0"].item() - losses["pipe=1,M=4"].item())
        pp_upd, pp_share = update_err(
            before, [t for _, t in named_leaves(states["plain_p0"]["params"])],
            [t for _, t in named_leaves(states["pipe=1,M=4"]["params"])])
        del before
        pp_grad = grads_rel_err(states["plain_p0"], states["pipe=1,M=4"])
        n_layer = exp.model.n_layer
        print(f"  class GPT (VAS preset, full width, batch 8, kernel F, "
              f"mixed precision): data=1 step bit for bit the plain "
              f"step's (loss and every parameter): {same} (the plain step "
              f"repeated: {again}); pipe=1, 4 "
              f"microbatches, dropout 0: |loss diff| {pp_loss:.3g} (bound "
              f"1e-5), gradients within {pp_grad:.3g} of each leaf's "
              f"largest (bound 1e-2), the parameter update within "
              f"{pp_upd:.3g} of the plain step's (bound 5e-2; over "
              f"{pp_share:.4f} of the elements, the preset's lr "
              f"{exp.train.learning_rate:g}); F launches {f_launches} "
              f"(expected {n_layer} x 4 each)")
        check(same, "the data=1 step is not the plain step bit for bit")
        check(pp_loss <= 1e-5 and pp_grad <= 1e-2 and pp_upd <= 5e-2,
              "the pipe=1 step against the plain step")
        check(f_launches == (4 * n_layer, 4 * n_layer),
              "kernel F on the pipe=1, M=4 path")
        a_task = GPTTask(load_vas_exp(mixed_precision=True), dev,
                         make_mesh({"pipe": 1}, dev, 4))
        attend.launches = flash_attention_fwd.launches = 0
        ev = a_task.eval_step(states["pipe=1,M=4"], batch).item()
        a_launches = attend.launches
        print(f"  its evaluation without F (pipe=1, M=4): kernel A "
              f"{a_launches} launches (expected {4 * n_layer}), F "
              f"{flash_attention_fwd.launches}; loss {ev:.4f}")
        check(a_launches == 4 * n_layer and flash_attention_fwd.launches == 0
              and np.isfinite(ev), "kernel A on the pipe=1 evaluation")

        # the GPT-VAE under data=1,model=1
        vexp = train_gpt_vae.build_experiment(train_gpt_vae.init_config(
            ["--dataset", "vas", "--experiment", "x", "--warm_up", "1",
             "--kl_start", "0.1", "--override", "use_flash_train=True"]))
        grids = codes.reshape(-1, 53, 5).transpose(1, 2).cpu().numpy()
        vbatch = {"codes": grids[:VAE_BATCH]}
        vtasks = {"plain": VAETask(vexp, 2, dev),
                  "data=1,model=1": VAETask(vexp, 2, dev, make_mesh(
                      {"data": 1, "model": 1}, dev))}
        vfirst = vtasks["plain"].init_state(7)
        vstates = {"data=1,model=1": vtasks["data=1,model=1"].load_state(
            vtasks["plain"].state_tree(vfirst)), "plain": vfirst}
        vloss = {}
        for k, t in vtasks.items():
            vstates[k], vloss[k], _ = t.train_step(
                vstates[k], vbatch, step_generator(1, 0, 0, dev))
        vsame = (torch.equal(vloss["plain"], vloss["data=1,model=1"])
                 and params_equal(vstates["plain"],
                                  vstates["data=1,model=1"]))
        print(f"  GPT-VAE (GPT_VAE_vas, full width, batch {VAE_BATCH}, "
              f"dropout 0.3, mixed precision, remat attn, kernel F): "
              f"data=1,model=1 step bit for bit the plain step's: {vsame} "
              f"(loss {vloss['plain'].item():.4f})")
        check(vsame, "the data=1,model=1 VAE step is not the plain one")

        wait_torchrun(*launcher)
        launcher = None

        nccl = nccl_profile(tasks["data=1"], states["data=1"], batch)
        print(f"  NCCL in the data=1 step (torch.profiler, 2 steps): "
              f"{json.dumps(nccl)}")
        vnccl = nccl_profile(vtasks["data=1,model=1"],
                             vstates["data=1,model=1"], vbatch)
        print(f"  NCCL in the GPT-VAE's data=1,model=1 step (torch.profiler, "
              f"2 steps): {json.dumps(vnccl)}")
        check(nccl["launches_per_step"] > 0
              and vnccl["launches_per_step"] > 0,
              "the profiler saw no NCCL kernel in a mesh step")
        runs = {k: (tasks[k], states[k], batch)
                for k in ("plain", "data=1", "plain_p0", "pipe=1,M=4")}
        runs.update({f"vae {k}": (vtasks[k], vstates[k], vbatch)
                     for k in vtasks})
        times = interleaved_ms(runs)
        print(f"  ms a step, median [min, max] of {len(times['plain'])} "
              f"steps each ({smi_line}): " + ", ".join(
                  f"{k} {np.median(v):.1f} [{min(v):.1f}, {max(v):.1f}]"
                  for k, v in times.items())
              + f"; NCCL device ms a step: data=1 "
              f"{nccl['device_ms_per_step']:.3f}, GPT-VAE data=1,model=1 "
              f"{vnccl['device_ms_per_step']:.3f}")
        del tasks, states, vtasks, vstates, a_task, first, vfirst
    finally:
        shutdown_distributed()
        if launcher is not None:
            launcher[0].kill()
            launcher[0].wait()
            launcher[1].close()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    check_torchrun(dev)
    return f_launches, a_launches


# ---------------------------------------------------------------------------
# 4c. serving over a mesh
# ---------------------------------------------------------------------------


SERVE_MESH_LAYERS = 6   # the torchrun serve --mesh process's GPT depth
SERVE_MESH_LOG = Path("build") / "chip_smoke_serve_mesh.log"


def start_serve_torchrun():
    """``torchrun --standalone --nproc_per_node 1 -m ...serve --mesh
    model=1 --init_random`` on a free port (SERVE_MESH_LAYERS layers, the
    VAS width; no warm-up: the first request captures), its output in
    SERVE_MESH_LOG.  Returns the process."""
    SERVE_MESH_LOG.parent.mkdir(parents=True, exist_ok=True)
    log = open(SERVE_MESH_LOG, "w")
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "melspec_gpt_vqvae_tpu_torch.serve",
           "--init_random", "--mesh", "model=1", "--port", "0",
           "--no_warmup", "--device", "cuda", "--override",
           f"n_layer={SERVE_MESH_LAYERS}"]
    proc = subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc


def serve_torchrun_check(proc):
    """The launcher's server (``start_serve_torchrun``): /healthz, a WAV
    for ``GET /generate?class=3`` and a deterministic JSON batch of 8,
    then SIGINT to its rank 0, which stops it and its launcher with exit
    code 0."""
    import signal
    deadline = time.perf_counter() + 300
    line = None
    try:
        while line is None:
            check(proc.poll() is None and time.perf_counter() < deadline,
                  "torchrun serve --mesh did not come up:\n"
                  + SERVE_MESH_LOG.read_text()[-4000:])
            line = next((ln for ln in SERVE_MESH_LOG.read_text().splitlines()
                         if ln.startswith("serving on")), None)
            if line is None:
                time.sleep(0.5)
        url = line.split()[2]
        pid = int(line.rsplit("pid ", 1)[1].rstrip(")"))
        health = json.loads(http(url + "/healthz"))
        blob, t_get = wall(lambda: http(url + "/generate?class=3&seed=7"))
        pcm, rate = read_pcm(blob)
        body, t_post = wall(lambda: json.loads(http(url + "/generate", {
            "classes": list(range(8)), "deterministic": True})))
        os.kill(pid, signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = SERVE_MESH_LOG.read_text()
    print(f"  torchrun serve --mesh model=1 ({SERVE_MESH_LAYERS} layers): "
          f"{url}, /healthz batch {health['batch']} {health['platform']}; "
          f"GET /generate?class=3 {t_get:.2f} s (the capture in it), "
          f"{pcm.shape[0]} samples at {rate} Hz; POST 8 deterministic "
          f"clips {t_post:.2f} s; exit code after SIGINT {rc}")
    check(health["platform"] == "cuda" and health["batch"] == 8
          and health["model"]["n_layer"] == SERVE_MESH_LAYERS,
          f"serve --mesh /healthz {health}")
    check(pcm.shape == (848 * 256,) and rate == 22050,
          f"serve --mesh WAV {pcm.shape} at {rate} Hz")
    check(len(body["clips"]) == 8, "serve --mesh JSON batch")
    check(rc == 0 and "mesh: {'model': 1}" in text,
          f"torchrun serve --mesh exited {rc}:\n{text[-4000:]}")


def serving_mesh_check(dev, wrappers, zero, decode_launches):
    """Phase serving_mesh (the docstring's 4c), with the launcher's
    server started first and checked last.  Returns the launches of every
    counted kernel on the phase's mesh paths, summed."""
    server = start_serve_torchrun()
    try:
        total = _serving_meshes(dev, wrappers, zero, decode_launches)
    except BaseException:
        server.kill()
        server.wait()
        raise
    serve_torchrun_check(server)
    return total


def _serving_meshes(dev, wrappers, zero, decode_launches):
    """The in-process half of phase serving_mesh."""
    import tempfile

    from melspec_gpt_vqvae_tpu_torch.parallel import (make_mesh,
                                                      maybe_init_distributed,
                                                      parse_mesh,
                                                      shutdown_distributed)
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline

    store = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    maybe_init_distributed(dev, init_method=f"file://{store}/store", rank=0,
                           world_size=1)
    steps, cls = 265, list(range(8))
    total = {name: 0 for name in wrappers}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def requests(pipe, title):
        """A greedy and a sampled (top_k 100) batch of 8, then the greedy
        one again, timed (no capture in it)."""
        out = {"greedy": pipe.generate(cls, gen(5), sample=False),
               "sampled": pipe.generate(cls, gen(6), top_k=100)}
        _, secs = wall(lambda: pipe.generate(cls, gen(5), sample=False))
        print(f"  {title}: request seconds (greedy batch 8, captured) "
              f"{secs:.4f}; capture seconds "
              f"{pipe.graphs.capture_seconds:.2f}")
        return out

    def add(c):
        for name, n in c.items():
            total[name] += n

    try:
        exp, plain = build_pipeline("vas", init_random=True, seed=783435,
                                    device=dev)
        zero()
        ref = requests(plain, "no mesh")
        b_ref = wrappers["vocoder_stack"].launches
        card_wq = plain.block_weights.get(plain.gpt_params["blocks"])
        for spec in ("data=1", "model=1", "data=1,model=1"):
            if spec != "data=1":   # the entry point, from the host tree
                (_, pipe), secs = wall(lambda: build_pipeline(
                    "vas", init_random=True, seed=783435, device=dev,
                    mesh_spec=spec))
                print(f"  build_pipeline(mesh_spec={spec!r}) from the host "
                      f"tree: {secs:.2f} s")
                host_wq = pipe._mesh_wq["gpt"]
                for name, leaf in card_wq.items():
                    for f in ("q", "s"):
                        check(torch.equal(host_wq[name][f], leaf[f]),
                              f"serving {spec}: the host's int8 {name}.{f} "
                              "differs from the card's quantisation")
            else:
                pipe = GenerationPipeline(
                    exp, plain.gpt_params, plain.vq, plain.melgan,
                    segments=plain.segments, chunk=plain.chunk,
                    mesh=make_mesh(parse_mesh(spec), dev))
            check(pipe.mesh is not None and pipe.mesh.active("data")
                  == ("data" in spec), f"{spec}: the mesh {pipe.mesh}")
            zero()
            out = requests(pipe, f"mesh {spec}")
            for mode in ("greedy", "sampled"):
                for key in ("tokens", "specs", "wavs"):
                    check(np.array_equal(out[mode][key], ref[mode][key]),
                          f"serving {spec} {mode}: {key} differ from the "
                          "meshless pipeline's")
            c = decode_launches(pipe, f"serving {spec}",
                                3 * steps * exp.model.n_layer,
                                row_cut="model" in spec)
            check(c["attention"] == 3 * exp.model.n_layer
                  and c["vocoder_stack"] == b_ref,
                  f"serving {spec}: A {c['attention']} (expected "
                  f"{3 * exp.model.n_layer}), B {c['vocoder_stack']} "
                  f"(expected {b_ref}, the meshless pipeline's)")
            check("model" not in spec or c["row_scales"] > 0,
                  f"serving {spec}: the scale pass did not run")
            add(c)
            del pipe
        print("  the host's int8 block weights (VAS GPT, bf16, quantised "
              "leaf by leaf) equal the card's bit for bit")
        del plain, card_wq
        torch.cuda.empty_cache()

        # one speculative request under data=1,model=1 against none
        exp_s, spec_pipe = build_pipeline(
            "vas", init_random=True, seed=783435, device=dev,
            override=f"n_layer={SPEC_LAYERS}",
            draft_random=f"n_layer={DRAFT_LAYERS}", gamma=4)
        ref_s = spec_pipe.generate(cls, gen(9), top_k=100)
        pipe = GenerationPipeline(
            exp_s, spec_pipe.gpt_params, spec_pipe.vq, spec_pipe.melgan,
            draft_params=spec_pipe.draft_params,
            draft_cfg=spec_pipe.draft_cfg, gamma=4,
            mesh=make_mesh({"data": 1, "model": 1}, dev))
        zero()
        out, secs = wall(lambda: pipe.generate(cls, gen(9), top_k=100))
        st = out["spec_stats"]
        check(np.array_equal(out["tokens"], ref_s["tokens"])
              and st == ref_s["spec_stats"],
              f"speculative under data=1,model=1: tokens or stats differ "
              f"({st} against {ref_s['spec_stats']})")
        products = st["rounds"] * 4 * (5 * DRAFT_LAYERS + SPEC_LAYERS)
        # the draft's steps (8 rows) take the one launch in their
        # column-cut half; the target's chunk (8 x 5 rows) the chain
        c = decode_launches(pipe, "speculative data=1,model=1",
                            st["rounds"] * 5 * (DRAFT_LAYERS + SPEC_LAYERS),
                            products, row_cut=True,
                            one_launch=st["rounds"] * 5 * DRAFT_LAYERS * 2)
        print(f"  speculative under data=1,model=1 ({SPEC_LAYERS} + "
              f"{DRAFT_LAYERS} layers, gamma 4, sampled batch 8, the "
              f"capture in it): {secs:.2f} s, {json.dumps(st)}")
        add(c)
        del pipe, spec_pipe
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()
        shutil.rmtree(store, ignore_errors=True)
    return total


# ---------------------------------------------------------------------------
# 4d. the XL decoder: the VGGSound GPT-VAE's decoder, cut in depth
# ---------------------------------------------------------------------------


XL_LAYERS, XL_BATCH, XL_SEGMENTS = 4, 8, 8
# the prior's bulk batch (the benchmark's vggsound_gpt_vae_xl.prior_b256)
XL_PRIOR_BATCH = 256


def xl_config():
    """The ``GPT_VAE_vggsound`` decoder's configs (1472 wide, 23 heads of
    64, vocab 1024, block 266) at XL_LAYERS of its 40 layers, bf16 with
    the int8 cache and int8 block weights."""
    from melspec_gpt_vqvae_tpu_torch.configs import load_preset
    from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import make_vae_configs
    exp = load_preset("GPT_VAE", "vggsound")
    m = exp.model
    check((m.n_layer, m.n_head, m.n_embd, m.vocab_size)
          == (40, 23, 1472, 1024), f"the XL preset moved: {m}")
    base = m.replace(n_layer=XL_LAYERS, dtype="bfloat16", cache_dtype="int8",
                     decode_weight_dtype="int8")
    return make_vae_configs(base, exp.vae)


def check_xl_kernels(dev, cfg):
    """Kernels E and A at 23 heads against their plain versions, and the
    int8 block product at the XL widths against the CPU bit for bit:
    E over the int8 cache at each capacity of an 8-segment decode (batch
    8: 184 (b, h) pairs, one CTA each; batch 1: 23 pairs, split), with and
    without the new slot's write, at the JAX package's bound, and at batch
    256, the prior's bulk batch (5,888 pairs: the streamed body), by
    ``check_bulk_decode_attention``; A at T = 1, bf16 (the
    prefill of the latent token) at 1e-2 of max |out|; the products 1472
    -> 4416, 1472 -> 1472, 1472 -> 5888, 5888 -> 1472 at M = 8 (the
    one-launch product) and M = 256 (the prior batch's chain): ``_int8_mm``,
    ``quantize_rows`` against ``quantize_rows_xla``, ``int8_linear`` by
    shape and ``int8_linear_chain`` (``quantize_rows`` -> ``_int_mm`` ->
    ``rescale_bias``).  Returns E's and A's worst errors."""
    from melspec_gpt_vqvae_tpu_torch.models.gpt import (
        _int8_mm, _segment_plan, quantize_block_weights)
    from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as DA
    from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as IL
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend, attend_xla
    g = torch.Generator(device=dev).manual_seed(23)
    h = cfg.n_head
    caps = [c for c, _ in _segment_plan(1, 265, XL_SEGMENTS)]
    worst_e, splits = 0.0, set()
    for b in (XL_BATCH, 1):
        for t in caps:
            k, ks, v, vs = quantised_cache(g, dev, b, t, "int8", heads=h)
            for pos in sorted({0, t // 2, t - 1}):
                case = f"xl decode attention B={b} H={h} T={t} pos={pos}"
                q, k_new, v_new = (torch.randn(b, h, 64, generator=g,
                                               device=dev).bfloat16()
                                   for _ in range(3))
                at = torch.tensor([pos], dtype=torch.int64, device=dev)
                out = DA.decode_attend_int8(q, k, v, ks, vs, 1, at)
                ref = DA.decode_attend_int8_xla(q, k, v, ks, vs, 1, pos)
                mine = [a.clone() for a in (k, v, ks, vs)]
                plain = [a.clone() for a in (k, v, ks, vs)]
                DA.write_kv_rows(*plain, 1, pos, k_new, v_new)
                out_w = DA.decode_attend_int8(q, *mine, 1, at, k_new=k_new,
                                              v_new=v_new)
                ref_w = DA.decode_attend_int8_xla(q, *plain, 1, pos)
                for o, r, label in ((out, ref, ""), (out_w, ref_w,
                                                     ", with the write")):
                    err = (o.float() - r.float()).abs()
                    check(bool((err <= 1e-4 + 1e-4 * r.float().abs()).all()),
                          f"{case}{label}: max|err| {err.max().item():.3g}")
                    worst_e = max(worst_e, err.max().item())
                check(all(torch.equal(a, c) for a, c in zip(mine, plain)),
                      f"{case}: the written slot differs from the plain "
                      "write")
                splits.add(DA.choose_splits(b * h, pos + 1))
    bulk = check_bulk_decode_attention(dev, XL_PRIOR_BATCH, h, caps,
                                       "XL prior")
    worst_e = max(worst_e, bulk["max_abs_err"])
    worst_a = 0.0
    for b in (XL_BATCH, 64):
        q, k, v = (torch.randn(b, h, 1, 64, generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        ref = attend_xla(q, k, v, 0)
        err = max_err(attend(q, k, v, 0), ref)
        tol = 1e-2 * ref.float().abs().max().item()
        check(err <= tol, f"xl attention B={b} H={h} T=1: max|err| {err:.3g}"
              f" (tol {tol:.3g})")
        worst_a = max(worst_a, err)
    d = cfg.n_embd
    gc = torch.Generator().manual_seed(5)
    shapes = {"attn_qkv": (d, 3 * d), "attn_proj": (d, d),
              "mlp_up": (d, 4 * d), "mlp_down": (4 * d, d)}
    w_cpu = quantize_block_weights({n: {"w": 0.02 * torch.randn(
        1, *kn, generator=gc)} for n, kn in shapes.items()})
    for name, (kk, nn) in shapes.items():
        wq, ws = w_cpu[name]["q"][0], w_cpu[name]["s"][0]
        wq_d, ws_d = wq.to(dev), ws.to(dev)
        for m in (XL_BATCH, XL_PRIOR_BATCH):
            case = f"{name} {kk}x{nn} M={m}"
            x = torch.randn(m, kk, generator=gc).bfloat16()
            bias = torch.randn(nn, generator=gc).bfloat16()
            ref = _int8_mm(x, wq, ws)
            check(torch.equal(_int8_mm(x.to(dev), wq_d, ws_d).cpu(), ref),
                  f"xl _int8_mm {case}: card != CPU")
            xq, xs = IL.quantize_rows(x.to(dev))
            xq_ref, xs_ref = IL.quantize_rows_xla(x)
            check(xq.shape[0] == IL.pad_rows(m)
                  and torch.equal(xq[:m].cpu(), xq_ref)
                  and not bool(xq[m:].any())
                  and torch.equal(xs.cpu(), xs_ref),
                  f"xl quantize_rows {case}: card != CPU")
            for fn in (IL.int8_linear, IL.int8_linear_chain):
                lin = fn(x.to(dev), wq_d, ws_d, bias.to(dev))
                check(torch.equal(lin.cpu(), ref.to(x.dtype) + bias),
                      f"xl {fn.__name__} {case}: card != CPU")
    print(f"  E at H={h} (caps {caps}, batch {XL_BATCH}, 1 (splits "
          f"{sorted(splits)}) and {XL_PRIOR_BATCH} (streamed)): max|err| "
          f"{worst_e:.3g}; A at T=1 H={h} bf16: max|err| {worst_a:.3g}; "
          f"the int8 products at widths {d} / {3 * d} / {4 * d}, M = "
          f"{XL_BATCH} and {XL_PRIOR_BATCH} (_int8_mm, quantize_rows, "
          f"int8_linear, int8_linear_chain) bit for bit the CPU's")
    return worst_e, worst_a


def xl_decode(params, cfgs, z, switch, holder):
    """Greedy ``vae_decode`` of the prior's ``z`` (XL_SEGMENTS segments,
    the captured program kept in ``holder``) inside
    ``_build.kernels(switch)``, twice: (tokens, seconds with the
    capture, seconds again)."""
    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import vae_decode
    with _build.kernels(switch):
        toks, first = wall(lambda: vae_decode(
            params, cfgs, z, "greedy", segments=XL_SEGMENTS, graph=holder))
        again, secs = wall(lambda: vae_decode(
            params, cfgs, z, "greedy", segments=XL_SEGMENTS, graph=holder))
    check(torch.equal(toks, again), "xl: two greedy decodes differ")
    return toks, first, secs


def xl_check(dev, wrappers, zero, decode_launches):
    """Phase xl (the docstring's 4d).  Returns (the counted kernels'
    launches of the deployment configuration's decode with the kernels,
    (E's and A's worst errors), that configuration's logits with the
    kernels against without and the bound that holds them)."""
    from melspec_gpt_vqvae_tpu_torch.models.decode_graph import DecodeGraphs
    from melspec_gpt_vqvae_tpu_torch.models.gpt import (init_gpt_params,
                                                        tree_to)
    from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import sample_from_prior
    cfgs = xl_config()
    dec = cfgs.decoder
    errs = check_xl_kernels(dev, dec)
    gen = torch.Generator(device=dev)
    params = {"decoder": init_gpt_params(dec, gen.manual_seed(0), dev)}
    z = sample_from_prior(cfgs, XL_BATCH, gen.manual_seed(1))
    steps = cfgs.encoder.block_size
    cond = z[:, None, :]

    # the deployment configuration: bf16, int8 cache and int8 weights
    runs, launches = {}, None
    for name, switch in (("kernels", None), ("plain", False)):
        holder = DecodeGraphs()
        zero()
        toks, first, secs = xl_decode(params, cfgs, z, switch, holder)
        check(toks.shape == (XL_BATCH, steps) and int(toks.min()) >= 0
              and int(toks.max()) < dec.vocab_size, f"xl tokens {toks.shape}")
        print(f"  XL decoder ({XL_LAYERS} of 40 layers, batch {XL_BATCH}, "
              f"bf16, int8 cache and weights, greedy, {XL_SEGMENTS} "
              f"segments, {name}): {first:.3f} s with the capture, "
              f"{secs:.3f} s again")
        if switch is None:
            launches = decode_launches(
                SimpleNamespace(graphs=holder, gcfg=dec), "xl",
                2 * steps * XL_LAYERS)
            check(launches["attention"] == 2 * XL_LAYERS,
                  f"xl: A launched {launches['attention']} times, expected "
                  f"{2 * XL_LAYERS} (the prefill, a layer and call)")
        else:
            c = {k: w.launches for k, w in wrappers.items()}
            check(not any(c.values()), f"xl, kernels off: launches {c}")
        runs[name] = toks
    # with int8 weights every product re-quantises its activations, and
    # E's float rounding moves some across a rounding boundary: the
    # greedy runs part (their share printed); from the same state the
    # first layer's new slot is the same bits at every step (the int8
    # product's kernels and E's write equal their plain versions bit
    # for bit), and the logits, step for step and run free, stay within
    # the configuration's own quantisation error (below), as in
    # ``kernels_on_off_f32``
    step_err, differ, l_on8 = lockstep_on_off(params["decoder"], dec, cond,
                                              runs["kernels"])
    l_off8 = free_running(params["decoder"], dec, cond, runs["kernels"],
                          False)
    share = (runs["kernels"] == runs["plain"]).float().mean().item()
    print(f"  bf16 / int8 weights, kernels against plain: greedy tokens "
          f"{share:.4f} equal; from the same state, logits within "
          f"{step_err:.3g} and the first layer's slot differing at "
          f"{differ} steps")
    check(differ == 0, "xl: the first layer's new cache slot differs "
          "between the kernels and the plain versions")

    # float32 weights over the int8 cache: E and A the only kernels, the
    # products the same cuBLAS calls either way
    dec32 = dec.replace(dtype="float32", decode_weight_dtype="auto")
    cfgs32 = cfgs._replace(decoder=dec32)
    params32 = {"decoder": tree_to(params["decoder"], dtype=torch.float32)}
    toks32 = {name: xl_decode(params32, cfgs32, z, switch,
                              DecodeGraphs())[0]
              for name, switch in (("kernels", None), ("plain", False))}
    l_on = free_running(params32["decoder"], dec32, cond,
                        toks32["kernels"], None)
    l_off = free_running(params32["decoder"], dec32, cond,
                         toks32["kernels"], False)
    err32 = max_err(l_on, l_off)
    equal32 = torch.equal(toks32["kernels"], toks32["plain"])
    print(f"  float32 weights, int8 cache: greedy tokens with the kernels "
          f"equal to those without: {equal32}; teacher-forced logits "
          f"within {err32:.3g}")
    check(equal32, "xl: greedy tokens with the kernels differ from those "
          "without (float32 weights, int8 cache)")
    check(err32 <= 1e-3, "xl: teacher-forced logits, kernels against "
          "plain (float32 weights, int8 cache)")

    # the deployment configuration's quantisation error: its plain run's
    # distance from float32 weights and a float32 cache (no margin),
    # which the kernels do not touch
    l_f32 = free_running(params32["decoder"], dec32.replace(
        cache_dtype="auto"), cond, runs["kernels"], None)
    int8 = {"stepwise_logits": step_err,
            "free_running_logits": max_err(l_on8, l_off8),
            "bound_quantisation_error": max_err(l_off8, l_f32),
            "greedy_token_agreement": share}
    print(f"  bf16 / int8 weights, kernels against plain: {json.dumps(int8)}")
    check(max(step_err, int8["free_running_logits"])
          <= int8["bound_quantisation_error"],
          "xl, bf16 / int8 weights: kernels against plain beyond the "
          "quantisation error")
    del params, params32
    torch.cuda.empty_cache()
    return launches, errs, int8


# ---------------------------------------------------------------------------
# 7. the GPT-VAE: kernels at its shapes, training, evaluation, step times
# ---------------------------------------------------------------------------


VAE_ROOT = Path("build") / "chip_smoke_vae"
VAE_BATCH, VAE_EPOCHS = 24, 2          # two train batches an epoch: 4 steps
# the two stacks' attention: the encoder unmasked over T = 265, the decoder
# causal over the latent token and 265 codes
VAE_SHAPES = (("encoder_t265_nu265", 265, 265), ("decoder_t266_causal", 266,
                                                   0))


def visible_pairs(t, nu):
    """(query, key) pairs the minGPT window lets attend at length ``t``."""
    nu = min(nu, t)
    return t * (t + 1) // 2 + nu * (nu - 1) // 2


def check_vae_kernels(dev):
    """Kernel F (forward O, lse; backward dQ, dK, dV) and kernel A (float32)
    against their plain versions at the GPT-VAE's shapes, (24, 16, 265, 64)
    with n_unmasked 265 and (24, 16, 266, 64) causal, F at the preset's keep
    0.7 (16-bit uniforms, scale 1 / 0.7) and at keep 1; the bounds of
    ``check_flash`` and ``check_attention``.  Timed at keep 0.7 (F) and in
    float32 (A), each with its bound.  Returns the rows' new entries (F
    forward, F backward, A)."""
    import torch.nn.functional as F

    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend, attend_xla
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_ref_bwd,
        flash_attention_ref_fwd, make_dropout_mask)
    g = torch.Generator(device=dev).manual_seed(21)
    rows = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0},
            "attention": {}}
    for name, t, nu in VAE_SHAPES:
        q, k, v, do = (torch.randn(VAE_BATCH, 16, t, 64, generator=g,
                                   device=dev) for _ in range(4))
        for keep_prob in (0.7, 1.0):
            keep = make_dropout_mask(g, (VAE_BATCH, 16, t, t), 1 - keep_prob)
            args = (nu, keep_prob)
            o, lse = flash_attention_fwd(q, k, v, keep, *args)
            o_ref, lse_ref = flash_attention_ref_fwd(q, k, v, keep, *args)
            grads = flash_attention_bwd(q, k, v, keep, o, lse, do, *args)
            refs = flash_attention_ref_bwd(q, k, v, keep, lse_ref, do, *args)
            torch.cuda.synchronize()
            e_o = max(max_err(o, o_ref), max_err(lse, lse_ref))
            e_g = max(max_err(a, b) for a, b in zip(grads, refs))
            print(f"  F flash attention ({VAE_BATCH},16,{t},64) n_unmasked="
                  f"{nu:3d} keep={keep_prob:.1f}: O/lse max|err| {e_o:.3g} "
                  f"(tol 3e-5), dQ/dK/dV {e_g:.3g} (tol 5e-5)")
            check(e_o <= 3e-5, f"flash forward {name} keep {keep_prob}")
            check(e_g <= 5e-5, f"flash backward {name} keep {keep_prob}")
            again = flash_attention_bwd(q, k, v, keep, o, lse, do, *args)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"flash backward {name} keep {keep_prob}: two launches "
                  "differ")
            for row, e in (("fwd", e_o), ("bwd", e_g)):
                rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], e)
        # timing at the preset's keep 0.7; the function's products over the
        # visible pairs, at the TF32 rate, against its bytes
        keep = make_dropout_mask(g, (VAE_BATCH, 16, t, t), 0.3)
        o, lse = flash_attention_fwd(q, k, v, keep, nu, 0.7)
        grads = flash_attention_bwd(q, k, v, keep, o, lse, do, nu, 0.7)
        flops = VAE_BATCH * 16 * visible_pairs(t, nu) * 64 * 2
        # device_ms is held against the CUDA-event time of the same calls
        # (windows have read this shape at 0.46 / 0.67 of it); both go into
        # the row
        f_dev = device_ms(lambda: flash_attention_fwd(q, k, v, keep, nu, 0.7),
                          ["flash_fwd_kernel"])
        f_ev = device_ms.events_ms
        b_dev = device_ms(lambda: flash_attention_bwd(
            q, k, v, keep, o, lse, do, nu, 0.7), ["flash_bwd_"])
        b_ev = device_ms.events_ms
        rows["fwd"][name + "_keep07"] = {
            "ms": cuda_ms(lambda: flash_attention_fwd(q, k, v, keep, nu,
                                                      0.7)),
            "device_ms": f_dev, "events_ms": f_ev,
            "plain_ms": cuda_ms(lambda: flash_attention_ref_fwd(
                q, k, v, keep, nu, 0.7), reps=5),
            "library_ms": None,
            **bound(nbytes(q, k, v, keep, o, lse), 2 * flops, "tf32")}
        rows["bwd"][name + "_keep07"] = {
            "ms": cuda_ms(lambda: flash_attention_bwd(q, k, v, keep, o, lse,
                                                      do, nu, 0.7)),
            "device_ms": b_dev, "events_ms": b_ev,
            "plain_ms": cuda_ms(lambda: flash_attention_ref_bwd(
                q, k, v, keep, lse, do, nu, 0.7), reps=5),
            "library_ms": None,
            **bound(nbytes(q, k, v, keep, o, lse, do, *grads), 5 * flops,
                    "tf32")}
        print(f"  F device time against CUDA events ({VAE_BATCH},16,{t},64) "
              f"n_unmasked={nu}: forward {f_dev:.4f} / {f_ev:.4f} ms, "
              f"backward {b_dev:.4f} / {b_ev:.4f} ms")
        check(abs(f_dev - f_ev) <= 0.2 * f_ev and abs(b_dev - b_ev)
              <= 0.2 * b_ev, f"F {name}: device time more than 20% from the "
              "CUDA-event time of the same calls")
        # kernel A in float32 (the evaluation forward's residual stream
        # stays float32 under mixed precision); the library call is one
        # float32 scaled_dot_product_attention with the same mask (causal,
        # or none over the whole unmasked block)
        err = max_err(attend(q, k, v, nu), attend_xla(q, k, v, nu))
        print(f"  A attention float32 ({VAE_BATCH},16,{t},64) n_unmasked="
              f"{nu}: max|err| {err:.3g} (tol 2e-05)")
        check(err <= 2e-5, f"attention {name}")
        causal = nu == 0
        rows["attention"][name + "_f32"] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: attend(q, k, v, nu)),
            "device_ms": device_ms(lambda: attend(q, k, v, nu), A_KERNELS),
            "plain_ms": cuda_ms(lambda: attend_xla(q, k, v, nu), reps=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            **bound(4 * nbytes(q), 2 * flops, "tf32")}
        r = (rows["fwd"][name + "_keep07"], rows["bwd"][name + "_keep07"],
             rows["attention"][name + "_f32"])
        print(f"  timing ({VAE_BATCH},16,{t},64) n_unmasked={nu}: F forward "
              f"keep 0.7 {r[0]['ms']:.4f} ms (device {r[0]['device_ms']:.4f},"
              f" plain {r[0]['plain_ms']:.4f}, bound {r[0]['bound_ms']:.4f});"
              f" F backward {r[1]['ms']:.4f} ms (device "
              f"{r[1]['device_ms']:.4f}, plain {r[1]['plain_ms']:.4f}, bound "
              f"{r[1]['bound_ms']:.4f}); A float32 {r[2]['ms']:.4f} ms "
              f"(device {r[2]['device_ms']:.4f}, plain {r[2]['plain_ms']:.4f},"
              f" scaled_dot_product_attention {r[2]['library_ms']:.4f}, "
              f"bound {r[2]['bound_ms']:.4f})")
        del q, k, v, do, keep, o, lse, grads
    torch.cuda.empty_cache()
    return rows


def write_vae_tree(root, mels, codes):
    """The battery's 48 clips and codes as a VAS tree for the GPT-VAE
    (batch 24, drop_last): all 48 in the train split (two batches), the
    last 24 again in the valid split (one batch)."""
    write_vas_tree(root, mels, codes)
    names = [f"class{i % 8}/clip_{i:03d}" for i in range(48)]
    (root / "data" / "vas_train.txt").write_text("\n".join(names) + "\n")
    (root / "data" / "vas_valid.txt").write_text("\n".join(names[24:])
                                                 + "\n")


def run_vae_cli(flags, override=""):
    """``train_gpt_vae.main`` from VAE_ROOT with the GPT_VAE_vas preset (full
    width, batch 24, dropout 0.3, mixed precision, remat attn), one
    validation batch; returns main's result and, for each of
    ``runner.evaluate_vae`` and ``vae_tools.reconstruct`` it ran, the
    seconds and the launches of kernels A, E and F inside it."""
    from melspec_gpt_vqvae_tpu_torch import train_gpt_vae
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.decode_attention import \
        decode_attend_int8
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from melspec_gpt_vqvae_tpu_torch.training import runner
    from melspec_gpt_vqvae_tpu_torch.utils import vae_tools
    counters = {"A": attend, "E": decode_attend_int8,
                "F forward": flash_attention_fwd}
    inside = []

    def recorded(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            before = {k: w.launches for k, w in counters.items()}
            out, dt = wall(lambda: fn(*a, **kw))
            inside.append((name, dt, {k: w.launches - before[k]
                                      for k, w in counters.items()}))
            return out
        return fn, wrapper
    argv = ["--dataset", "vas", "--experiment", "vsmoke", "--device", "cuda",
            "--limit_val_batches", "1", "--override", override, *flags]
    cwd = os.getcwd()
    saved = [(runner, "evaluate_vae"), (vae_tools, "reconstruct")]
    originals = []
    os.chdir(VAE_ROOT)
    try:
        for module, name in saved:
            fn, wrapper = recorded(module, name)
            originals.append(fn)
            setattr(module, name, wrapper)
        return train_gpt_vae.main(train_gpt_vae.init_config(argv)), inside
    finally:
        for (module, name), fn in zip(saved, originals):
            setattr(module, name, fn)
        os.chdir(cwd)


def vae_check(dev, mels, codes):
    """The GPT-VAE on the card: ``train_gpt_vae.main`` trains the full-width
    preset with kernel F (launches counted exactly, remat's recompute
    included), its checkpoint restored bit for bit; the evaluation entry
    point with kernel A (exactly 48 launches a validation batch in the
    ELBO pass, 24 more in the MI / AU pass), the test entry point with
    the IW-NLL and the greedy reconstructions through the captured decode
    program; the loss on a repeated batch falls; step times with mixed
    precision and remat on and off; a 2-layer float32 copy's train step
    against the CPU.  Returns the launches of F (forward, backward) and A
    on these paths."""
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    write_vae_tree(VAE_ROOT, mels, codes)
    torch.cuda.empty_cache()
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    ((task, state, ckpt, _), _), dt = wall(lambda: run_vae_cli(
        ["--train", "1", "--epochs_override", str(VAE_EPOCHS),
         "--ckpt_every", "0", "--logging_frequency", "0", "--warm_up", "1",
         "--kl_start", "0.1"], "use_flash_train=True"))
    f_launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    cfg, n_layer = task.cfgs.encoder, task.cfgs.encoder.n_layer
    steps = state["step"]
    n_params = sum(t.numel() for _, t in named_leaves(state["params"]))
    # a train step: each stack's forward (2 x n_layer), remat's recompute
    # of every attention region (2 x n_layer); a validation batch: both
    # stacks; the epoch-end MI / AU pass: the encoder
    want = (steps * 4 * n_layer + VAE_EPOCHS * 3 * n_layer,
            steps * 2 * n_layer)
    print(f"  train_gpt_vae.main (GPT_VAE_vas: 2 x {n_layer} layers, "
          f"{cfg.n_head} heads, {cfg.n_embd} wide, {n_params / 1e6:.1f}M "
          f"parameters, batch {VAE_BATCH}, dropout {task.cfgs.decoder.attn_pdrop}"
          f", mixed_precision {cfg.mixed_precision}, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}, use_flash_train; "
          f"{steps} steps, {VAE_EPOCHS} validation batches, a checkpoint): "
          f"{dt:.1f} s; F launches forward {f_launches[0]}, backward "
          f"{f_launches[1]} (expected {want}); remat adds "
          f"{2 * n_layer} forward launches a step ({steps * 2 * n_layer} in "
          f"this run); kl_weight {state['kl_weight'].item()}")
    check(steps == 2 * VAE_EPOCHS, f"VAE train steps {steps}")
    check(cfg.mixed_precision and cfg.remat and cfg.remat_policy == "attn"
          and cfg.use_flash_train and cfg.n_embd == 1024 and n_layer == 24,
          "the VAE run's configuration")
    check(f_launches == want, "kernel F launches on the VAE training path")
    ckpt_bytes = os.path.getsize(ckpt._resolve("last"))
    (restored, rdt) = wall(lambda: ckpt.restore("last"))
    same = trees_equal(restored["state"], task.state_tree(state))
    print(f"  checkpoint {ckpt_bytes / 2 ** 30:.2f} GiB; restore('last') "
          f"{rdt:.1f} s, equals the live params, AdamW moments, step and "
          f"kl_weight bit for bit: {same}; extras {restored['extras']}")
    check(same and "kl_weight" in restored["state"], "VAE checkpoint round "
          "trip")
    del restored

    # evaluation, use_flash_train off: kernel A in both stacks
    attend.launches = flash_attention_fwd.launches = 0
    ((_, _, _, metrics), inside), dt = wall(lambda: run_vae_cli(
        ["--train", "0", "--eval", "1", "--resume", "last"]))
    ev = inside[0]
    print(f"  train_gpt_vae.main --eval 1 --resume last (use_flash_train "
          f"off, 1 val batch): {dt:.1f} s (evaluate_vae {ev[1]:.1f} s); "
          f"launches {ev[2]}; {json.dumps(metrics['eval'])}")
    check(ev[2] == {"A": 3 * n_layer, "E": 0, "F forward": 0},
          "evaluation: kernel A 2 x n_layer launches a validation batch "
          "(both stacks) and n_layer in the MI / AU pass, no F")
    check(all(np.isfinite(v) for v in metrics["eval"].values())
          and {"mutual_info", "active_units", "nll", "ppl"}
          <= set(metrics["eval"]), "evaluation metrics")

    # the test entry point with the IW-NLL, and greedy reconstructions
    ((_, _, _, metrics), inside), dt = wall(lambda: run_vae_cli(
        ["--train", "0", "--test", "1", "--iw_nsamples", "20", "--resume",
         "last", "--reconstruct_from", "last", "--reconstruct_to",
         "decoding.txt"]))
    (_, t_iw, k_iw), (_, t_rec, k_rec) = inside
    rows = (VAE_ROOT / "decoding.txt").read_text().splitlines()
    print(f"  train_gpt_vae.main --test 1 --iw_nsamples 20 "
          f"--reconstruct_from last: {dt:.1f} s; evaluate_vae with IW-NLL "
          f"{t_iw:.1f} s, launches {k_iw}; {json.dumps(metrics['test'])}; "
          f"greedy reconstructions of {len(rows)} clips {t_rec:.1f} s "
          f"(captured decode program), launches {k_rec}")
    check(np.isfinite(metrics["test"]["iw_nll"]), "IW-NLL")
    # the ELBO and MI / AU passes, then the IW-NLL: the encoder once and
    # the decoder for each of the 20 samples
    check(k_iw == {"A": (3 + 1 + 20) * n_layer, "E": 0, "F forward": 0},
          "IW-NLL launches")
    check(len(rows) == VAE_BATCH and all(len(r.split()) == 265
                                         for r in rows), "reconstructions")
    # the encoder and the decoder's prefill (T = 1); the decode steps
    # attend over a float32 cache in plain torch, no E
    check(k_rec == {"A": 2 * n_layer, "E": 0, "F forward": 0},
          "reconstruction launches")

    # learning: the loss on one repeated batch falls
    batch = first_train_batch(VAE_ROOT, VAE_BATCH)
    losses, ms, mem = timed_steps(task, state, batch, 10, lr=3e-4)
    print(f"  repeated batch at lr 3e-4: loss {losses[0]:.2f} -> "
          f"{losses[-1]:.2f} in 10 steps")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the VAE's loss on a repeated batch did not fall")

    # step times: mixed precision and remat on and off, kernel F, on the
    # same parameters (each with a fresh optimizer)
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
    params, kl = state["params"], state["kl_weight"]
    del state, ckpt
    torch.cuda.empty_cache()
    steps_ms = {}
    for mixed in (True, False):
        for remat in ("attn", None):
            exp = copy.deepcopy(task.exp)
            exp.model = exp.model.replace(mixed_precision=mixed,
                                          remat=remat is not None,
                                          remat_policy=remat or "attn")
            t2 = VAETask(exp, 2, dev)
            st = {"params": params, "optimizer": t2._optimizer(params),
                  "step": 0, "kl_weight": kl}
            torch.cuda.empty_cache()
            _, ms, mem = timed_steps(t2, st, batch, 5)
            key = f"mixed_{'on' if mixed else 'off'}_remat_{remat or 'off'}"
            steps_ms[key] = {"ms": ms, "tokens_per_s": VAE_BATCH * 265
                             / (ms / 1e3), "peak_gib": mem / 2 ** 30}
            print(f"  VAE step, {key}: {ms:.1f} ms, "
                  f"{steps_ms[key]['tokens_per_s']:.0f} tokens/s, peak "
                  f"{mem / 2 ** 30:.2f} GiB")
            if remat == "attn":
                profile_train_step(t2, st, batch, f"GPT-VAE, {key}",
                                   4 * n_layer)
            del st, t2
    del params
    torch.cuda.empty_cache()
    vae_reference_check(dev, batch)
    # VAE_ROOT stays for phase media, which removes it
    return f_launches, ev[2]["A"] + k_iw["A"] + k_rec["A"]


def vae_reference_check(dev, batch):
    """One train step of a 2-layer GPT-VAE at the preset's widths, float32
    parameters, dropout 0, kernel F, remat attn, with mixed precision off
    and on, on the card against the CPU from the same weights and latent
    noise, on 8 of the batch's clips.  Bounds: float32, loss 1e-5 of its
    value and gradients 1e-4 of each leaf's max|g| (the class GPT's
    check); mixed precision, loss 1e-4 and gradients 2e-2: the card's
    backward rounds the incoming gradient to bfloat16 before its product
    (cuBLAS takes no float32 x bfloat16 product), the CPU's does not, and
    a bfloat16 value carries 2^-9 of relative rounding."""
    from melspec_gpt_vqvae_tpu_torch.configs import load_preset
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
    small = {"codes": np.asarray(batch["codes"])[:8]}
    eps = torch.randn(8, 1, 1024, generator=torch.Generator().manual_seed(3))
    for mixed in (False, True):
        exp = load_preset("GPT_VAE", "vas", n_layer=2, embd_pdrop=0.0,
                          resid_pdrop=0.0, attn_pdrop=0.0,
                          use_flash_train=True, mixed_precision=mixed,
                          learning_rate=3e-4)
        out = {}
        for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
            task = VAETask(exp, 2, d)
            state = task.init_state(11)
            state, loss, _ = task.train_step(state, small,
                                             torch.Generator(device=d),
                                             eps=eps.to(d))
            out[name] = (loss.item(), {
                n: (t.detach().cpu(), t.grad.cpu())
                for n, t in named_leaves(state["params"])})
        (l_cpu, cpu), (l_card, card) = out["cpu"], out["card"]
        g_rel = max(max_err(card[n][1], cpu[n][1])
                    / cpu[n][1].abs().max().clamp_min(1e-30).item()
                    for n in cpu)
        g_tol, l_tol = (2e-2, 1e-4) if mixed else (1e-4, 1e-5)
        p_bad = sum(int((((card[n][0] - cpu[n][0]).abs()
                          > 1e-6 + 1e-6 * cpu[n][0].abs())
                         & (cpu[n][1].abs() > g_tol * cpu[n][1].abs().max()))
                        .sum()) for n in cpu)
        res = {"mixed_precision": mixed, "loss_cpu": l_cpu,
               "loss_rel_diff": abs(l_card - l_cpu) / abs(l_cpu),
               "grad_max_rel_err": g_rel,
               "params_differing_beyond_grad_noise": p_bad}
        print(f"  VAE train step (2-layer copy, VAS widths, 8 clips, dropout "
              f"0, kernel F, remat attn) card vs CPU: {json.dumps(res)} "
              f"(bounds: loss {l_tol:g}, gradients {g_tol:g} of each leaf's "
              f"max|g|)")
        check(res["loss_rel_diff"] <= l_tol, f"VAE step loss vs CPU, mixed "
              f"{mixed}")
        check(g_rel <= g_tol, f"VAE step gradients vs CPU, mixed {mixed}")
        check(p_bad == 0, f"VAE step parameters vs CPU, mixed {mixed}")


# ---------------------------------------------------------------------------
# 7b. the offline tokenizer: wavs -> mel files -> code grids, parity_check,
#     the mel inverse chain
# ---------------------------------------------------------------------------


FEATURES_ROOT = Path("build") / "chip_smoke_features"
# the 48 battery clips through extract_mel_spectrogram at -b 16 (3 launches
# of D) and extract_codes at -b 8 (6 of C); parity_check's variants on the
# first 8 clips; Griffin-Lim on 8 of the mel files
MEL_BATCH, CODE_BATCH, PARITY_CLIPS, ROUND_TRIP_CLIPS = 16, 8, 8, 8
SHORT_CLIP = 3 * 22050     # the last wav, shorter than a clip


def write_battery_wavs(folder, wavs):
    """The battery as wav files: the even clips int16, the odd ones
    float32, the last cut to SHORT_CLIP samples (the CLI pads it back with
    zeros)."""
    from scipy.io import wavfile
    folder.mkdir(parents=True)
    for i, w in enumerate(wavs):
        if i == len(wavs) - 1:
            w = w[:SHORT_CLIP]
        wavfile.write(folder / f"clip{i:02d}.wav", 22050,
                      (w * 32767).astype(np.int16) if i % 2 == 0 else w)


def write_reference_vq(path, cfg, seed):
    """A VQ-VAE of seeded random weights as the reference stores one: its
    ``LitVQVAE`` names in a Lightning checkpoint's ``state_dict``."""
    from melspec_gpt_vqvae_tpu_torch import bridge
    from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel
    from melspec_gpt_vqvae_tpu_torch.utils.convert import _vq_reference_name
    vq = bridge.init_conv_net_(VQModel(cfg),
                               torch.Generator().manual_seed(seed))
    torch.save({"state_dict": {_vq_reference_name(k): v for k, v in
                               vq.state_dict().items()}}, path)


def read_stack(folder, names, suffix):
    return np.stack([np.load(folder / f"{n}{suffix}.npy") for n in names])


def features_check(dev, battery):
    """The offline tokenizer through its entry points, on the battery's
    48 clips written as wavs (int16 and float32, one short): the mel CLI
    (D exactly once a batch of 16), each mel file held against the plain
    rFFT mel on the card within check_mel's 2e-3; the code CLI on a
    reference-format file of the ``VQVAEConfig`` preset (C exactly once a
    batch of 8), called with TF32 on: it must encode with TF32 off and
    give the caller's flags back; its codes against the plain argmin on the
    same latents (no unexplained flip); a second run writes nothing;
    ``--int8`` (its agreement with the float32 codes printed);
    ``parity_check`` on PARITY_CLIPS clips (D and C counted); the inverse
    chain on ROUND_TRIP_CLIPS mel files, Griffin-Lim 32 iterations: the
    mel of the waveform within tests/test_mel.py:111-123's criterion, mean
    |mel - mel2| < 0.05 over the active frames.  Returns the record and
    the launches of C and D by path."""
    from melspec_gpt_vqvae_tpu_torch import parity_check
    from melspec_gpt_vqvae_tpu_torch.configs import MelConfig, VQVAEConfig
    from melspec_gpt_vqvae_tpu_torch.feature_extraction import (
        extract_codes, extract_mel_spectrogram)
    from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel
    from melspec_gpt_vqvae_tpu_torch.ops.mel import (mel_to_waveform,
                                                    pad_or_trim,
                                                    waveform_to_mel)
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    from melspec_gpt_vqvae_tpu_torch.ops.vq import (vq_nearest_index,
                                                   vq_nearest_index_xla)
    from melspec_gpt_vqvae_tpu_torch.utils.convert import load_vqvae_params
    shutil.rmtree(FEATURES_ROOT, ignore_errors=True)
    features = FEATURES_ROOT / "features"
    cls = features / "battery"
    audio, mel_dir = cls / "audio_10s_22050hz", cls / "melspec_10s_22050hz"
    write_battery_wavs(audio, battery)
    n, mcfg, cfg = len(battery), MelConfig(), VQVAEConfig()
    names = [f"clip{i:02d}" for i in range(n)]
    rec, by_path = {}, {}

    def counted(title, fn, d, c):
        waveform_to_mel_fused.launches = vq_nearest_index.launches = 0
        out, dt = wall(fn)
        got = {"D": waveform_to_mel_fused.launches,
               "C": vq_nearest_index.launches}
        print(f"  {title}: {dt:.3f} s, launches {json.dumps(got)}")
        check(got == {"D": d, "C": c}, f"{title}: launches {got}, expected "
              f"D {d}, C {c}")
        by_path[title] = got
        rec[title] = {"seconds": round(dt, 4)}
        return out, dt

    # wavs -> mel files
    written, dt = counted("extract_mel_spectrogram", lambda:
                          extract_mel_spectrogram.main(
                              ["-i", str(audio), "-o", str(mel_dir), "-b",
                               str(MEL_BATCH)]), -(-n // MEL_BATCH), 0)
    check(written == n, f"extract_mel_spectrogram wrote {written} of {n}")
    rec["extract_mel_spectrogram"]["clips_per_s"] = round(n / dt, 2)
    wavs = torch.stack([pad_or_trim(torch.from_numpy(
        extract_mel_spectrogram.read_wav(audio / f"{nm}.wav")),
        mcfg.clip_samples) for nm in names]).to(dev)
    check(bool((wavs[-1, SHORT_CLIP:] == 0).all()), "short wav not padded")
    mels = torch.from_numpy(read_stack(mel_dir, names, "_mel")).to(dev)
    with torch.inference_mode():
        err = max_err(mels, waveform_to_mel(wavs, mcfg))
    print(f"  mel files {tuple(mels.shape)} vs the plain rFFT mel of the "
          f"wavs as read: max|err| {err:.3g} (tol 2e-3)")
    check(mels.shape == (n, 80, 860) and err <= 2e-3, "mel files vs plain")
    rec["extract_mel_spectrogram"]["max_abs_err_vs_plain"] = err

    # mel files -> code grids, with TF32 on in the caller
    vq_path = FEATURES_ROOT / "vqvae.ckpt"
    write_reference_vq(vq_path, cfg, seed=5)
    argv = ["-i", str(features), "-m", str(vq_path), "-b", str(CODE_BATCH)]
    flags, encode = [], VQModel.encode_to_indices

    def tf32():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def recording(self, x):
        flags.append(tf32())
        return encode(self, x)
    VQModel.encode_to_indices = recording
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        written, dt = counted("extract_codes", lambda: extract_codes.main(
            argv), 0, -(-n // CODE_BATCH))
        after = tf32()
    finally:
        VQModel.encode_to_indices = encode
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  TF32 (cuDNN, matmul) in the caller (True, True); in each of "
          f"the CLI's {len(flags)} encodes {sorted(set(flags))}; after it "
          f"{after}")
    check(set(flags) == {(False, False)}, "extract_codes encoded with TF32")
    check(after == (True, True), "extract_codes did not restore TF32")
    check(written == n, f"extract_codes wrote {written} of {n}")
    rec["extract_codes"]["clips_per_s"] = round(n / dt, 2)
    rec["extract_mel_spectrogram+extract_codes_clips_per_s"] = round(
        n / (rec["extract_mel_spectrogram"]["seconds"] + dt), 2)
    codes = read_stack(cls / "codes_10s", names, "_mel_code")
    vq = load_vqvae_params(str(vq_path), cfg).to(dev)
    x = 2.0 * mels[:, :, 6:854] - 1.0
    with torch.inference_mode():
        z = torch.cat([vq.quant_conv(vq.encoder(x[i:i + CODE_BATCH, None]))
                       for i in range(0, n, CODE_BATCH)])
        rows = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])
        plain = vq_nearest_index_xla(rows, vq.quantize.embedding).cpu()
    z64 = rows.double().cpu()
    flips = unexplained_flips(torch.from_numpy(codes), plain, z64, z64,
                              vq.quantize.embedding)
    differ = int((torch.from_numpy(codes).reshape(-1) != plain).sum())
    print(f"  codes {codes.shape} {codes.dtype} vs the plain argmin on the "
          f"same latents: {differ} differ, {flips} unexplained")
    check(codes.shape == (n, 5, 53) and codes.dtype == np.int32
          and flips == 0, "extract_codes codes vs the plain argmin")
    stamps = {p: p.stat().st_mtime_ns for p in (cls / "codes_10s").iterdir()}
    written, _ = counted("extract_codes_again", lambda: extract_codes.main(
        argv), 0, 0)
    check(written == 0 and stamps == {p: p.stat().st_mtime_ns for p in
                                      (cls / "codes_10s").iterdir()},
          "a second extract_codes run wrote files")

    # --int8 on the same mel files
    cls8 = FEATURES_ROOT / "features_int8" / "battery"
    cls8.mkdir(parents=True)
    (cls8 / "melspec_10s_22050hz").symlink_to(mel_dir.resolve())
    written, dt = counted("extract_codes_int8", lambda: extract_codes.main(
        ["-i", str(cls8.parent), "-m", str(vq_path), "-b", str(CODE_BATCH),
         "--int8"]), 0, -(-n // CODE_BATCH))
    agree = float((read_stack(cls8 / "codes_10s", names, "_mel_code")
                   == codes).mean())
    rec["extract_codes_int8"].update(clips_per_s=round(n / dt, 2),
                                     code_agreement_vs_f32=agree)
    print(f"  --int8: {written} grids, agreement with the float32 codes "
          f"{agree:.4f}")
    check(written == n, "extract_codes --int8 wrote too few grids")

    # parity_check's variants on the first clips
    batches = -(-PARITY_CLIPS // parity_check.BATCH)
    parity, _ = counted("parity_check", lambda: parity_check.main(
        ["--clips", str(PARITY_CLIPS), "--out",
         str(FEATURES_ROOT / "parity.json")]), 3 * batches, 4 * batches)
    check(list(parity["variants"]) == list(parity_check.VARIANTS),
          "parity_check variants")
    rec["parity_check"]["variants"] = {
        k: v["match_rate"] for k, v in parity["variants"].items()}
    print(f"  parity_check ({PARITY_CLIPS} clips) match rates vs the CPU: "
          f"{json.dumps(rec['parity_check']['variants'])}")

    # the inverse chain: mel files -> waveforms -> mels
    pick = torch.arange(0, n, n // ROUND_TRIP_CLIPS)[:ROUND_TRIP_CLIPS]
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        back, dt = wall(lambda: mel_to_waveform(mels[pick], g, mcfg))
        mel2 = waveform_to_mel(pad_or_trim(back, mcfg.clip_samples), mcfg)
    active = mels[pick].amax(dim=1) > 0.1          # (clips, frames)
    errs = [(mel2[i] - mels[pick][i])[:, active[i]].abs().mean().item()
            for i in range(len(pick))]
    rec["mel_to_waveform"] = {"seconds": round(dt, 4), "clips": len(pick),
                              "mean_abs_mel_err": [round(e, 5)
                                                   for e in errs]}
    print(f"  mel_to_waveform {len(pick)} mels (NNLS 200, Griffin-Lim 32): "
          f"{dt:.3f} s, {tuple(back.shape)}; mean |mel - mel2| over the "
          f"active frames {max(errs):.4f} at worst (bound 0.05)")
    check(back.shape == (len(pick), 859 * 256) and max(errs) < 0.05,
          "mel_to_waveform round trip")
    print(f"  features: {json.dumps(rec)}")
    shutil.rmtree(FEATURES_ROOT)
    return rec, by_path


# ---------------------------------------------------------------------------
# 8. the VQ-GAN first stage: training, evaluation, kernel C inside training
# ---------------------------------------------------------------------------


VQGAN_ROOT = Path("build") / "chip_smoke_vqgan"
# batch 2 (the CLI's default) of 80 x 848 mels: 2 x 5 x 53 = 530 latents
VQGAN_STEPS, VQGAN_VAL, VQGAN_DISC_START, VQGAN_BATCH = 4, 1, 2, 2
# a VQ-GAN step's device time by class: the kernels of the PyTorch ops
# that launch them (their self device time in the profiler; cuDNN picks
# direct, implicit-GEMM and FFT algorithms, all inside these ops), and the
# port's kernel C and Adam's foreach kernels by name; what is in none is
# "the rest"
VQGAN_OP_CLASSES = (
    ("convs", ("aten::cudnn_convolution", "aten::convolution_backward")),
    ("GroupNorm", ("aten::native_group_norm",
                   "aten::native_group_norm_backward")),
    ("attention (bmm, softmax)", ("aten::bmm", "aten::_softmax",
                                  "aten::_softmax_backward_data")))
VQGAN_KERNEL_CLASSES = (("C", ("vq_nearest_kernel",)),
                        ("Adam", ("multi_tensor_apply",)))


def run_vqvae_cli(flags):
    """``train_vqvae.main`` from VQGAN_ROOT at the ``VQVAEConfig`` preset
    (the vas codebook of 128), on the card; returns main's result and the
    logs of every train step it took."""
    from melspec_gpt_vqvae_tpu_torch import train_vqvae
    from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import VQVAETask
    argv = ["--dataset", "vas", "--experiment", "vqsmoke", "--device",
            "cuda", "--limit_val_batches", str(VQGAN_VAL), *flags]
    logs, step = [], VQVAETask.train_step

    def recording(self, state, batch):
        state, log = step(self, state, batch)
        logs.append(log)
        return state, log
    cwd = os.getcwd()
    os.chdir(VQGAN_ROOT)
    VQVAETask.train_step = recording
    try:
        return train_vqvae.main(train_vqvae.init_config(argv)), logs
    finally:
        VQVAETask.train_step = step
        os.chdir(cwd)


def check_vq_in_training(task, state, batch):
    """One train step with kernel C's two launches recorded (the generator
    phase's forward, then the discriminator phase's on the updated
    autoencoder): each held against ``vq_nearest_index_xla`` on the same
    latents and codebook (unexplained flips must be 0), then C timed at
    that shape.  Returns (state, C's row at the training shape)."""
    from melspec_gpt_vqvae_tpu_torch.models import vqvae as VM
    from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index_xla
    calls, kernel = [], VM.vq_nearest_index

    def recording(x, cb):
        out = kernel(x, cb)
        calls.append((x.clone(), cb.clone(), out.clone()))
        return out
    VM.vq_nearest_index = recording
    try:
        state, _ = task.train_step(state, batch)
    finally:
        VM.vq_nearest_index = kernel
    check(len(calls) == 2, f"a train step launched kernel C {len(calls)} "
          "times")
    flips = differing = 0
    for x, cb, out in calls:
        ref = vq_nearest_index_xla(x, cb)
        differing += int((out != ref).sum())
        flips += unexplained_flips(ref.cpu(), out.cpu(), x.double().cpu(),
                                   x.double().cpu(), cb)
    x, cb, out = calls[0]
    n, d = x.shape
    k = cb.shape[0]
    e2 = torch.sum(cb * cb, dim=1)
    row = {"N": n, "K": k, "D": d, "indices_differing": differing,
           "unexplained_flips": flips,
           "ms": cuda_ms(lambda: kernel(x, cb), reps=100),
           "device_ms": device_ms(lambda: kernel(x, cb),
                                  ["vq_nearest_kernel"]),
           "events_ms": device_ms.events_ms,
           "plain_ms": cuda_ms(lambda: vq_nearest_index_xla(x, cb), reps=100),
           # the library form: one cuBLAS product with the codebook norms as
           # its bias, and an argmin (|x|^2 is the same for every code)
           "library_ms": cuda_ms(lambda: torch.argmin(
               torch.addmm(e2, x, cb.T, alpha=-2.0), 1), reps=100),
           **bound(nbytes(x, cb, out), 2 * n * k * d, "f32")}
    print(f"  C inside a train step (2 launches, latents {n} x {d}, K {k}, "
          f"TF32 off): {differing} indices differ from vq_nearest_index_xla, "
          f"{flips} unexplained; kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f}, CUDA events {row['events_ms']:.4f}), "
          f"plain {row['plain_ms']:.4f} ms, cuBLAS addmm + argmin "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']})")
    check(flips == 0, "kernel C in the training forward: indices the "
          "latents cannot explain")
    return state, row


def vqgan_steps(task, state, batch, n):
    """``n`` train steps on one batch; (logs, ms a step over the last
    n - 2, peak device bytes, the bytes allocated before them: the train
    state and what earlier phases of the process still hold)."""
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logs = []
    for i in range(n):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, log = task.train_step(state, batch)
        logs.append(log)
    torch.cuda.synchronize()
    return (logs, (time.perf_counter() - t0) * 1e3 / (n - 2),
            torch.cuda.max_memory_allocated(), held)


def profile_vqgan_step(task, state, batch, warm=1, steps=3):
    """Device ms of a VQ-GAN train step by class (VQGAN_OP_CLASSES,
    VQGAN_KERNEL_CLASSES) from a ``torch.profiler`` window of ``steps``
    steps, the busy time against the wall, and the ten kernels that took
    the most.  A window is whole when it holds kernel C twice a step (less
    one at its edge) and the two Adams' launches."""
    from torch.profiler import DeviceType
    for _ in range(warm):
        state = task.train_step(state, batch)[0]
    torch.cuda.synchronize()
    wall_ms = 0.0

    def run():
        nonlocal state, wall_ms
        t0 = time.perf_counter()
        for _ in range(steps):
            state = task.train_step(state, batch)[0]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def tally(avgs):
        labels = [lab for lab, _ in VQGAN_OP_CLASSES + VQGAN_KERNEL_CLASSES]
        ms = dict.fromkeys(labels, 0.0)
        counts = dict.fromkeys(labels, 0)
        busy, top = 0.0, []
        for ev in avgs:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if ev.device_type == DeviceType.CUDA:
                busy += us / 1e3 / steps
                top.append((us / 1e3 / steps, ev.count / steps, ev.key[:90]))
                label = next((lab for lab, names in VQGAN_KERNEL_CLASSES
                              if any(n in ev.key.lower() for n in names)),
                             None)
            else:
                label = next((lab for lab, names in VQGAN_OP_CLASSES
                              if ev.key in names), None)
            if label is not None:
                ms[label] += us / 1e3 / steps
                counts[label] += ev.count
        ms["the rest"] = busy - sum(ms.values())
        return ms, counts, busy, sorted(top, reverse=True)[:10]

    def whole(avgs):
        _, counts, _, _ = tally(avgs)
        return counts["C"] >= 2 * steps - 1 and counts["Adam"] >= 2 * steps

    avgs, ok = profiled(run, whole)
    ms, counts, busy, top = tally(avgs)
    res = {"device_ms_per_step": {k: round(v, 3) for k, v in ms.items()},
           "device_busy_ms_per_step": round(busy, 3),
           "wall_ms_per_step_profiled": round(wall_ms, 3),
           "C_launches_per_step": counts["C"] / steps, "trace_whole": ok}
    print(f"  VQ-GAN step (torch.profiler, {steps} steps after {warm}): "
          f"{json.dumps(res)}")
    for t, c, key in top:
        print(f"    {t:8.3f} ms {c:6.1f} a step  {key}")
    check(busy > 0, "profiler saw no device activity in the VQ-GAN step")
    return res


def vqgan_check(dev, mels, codes):
    """The VQ-GAN first stage on the card: ``train_vqvae.main`` trains the
    ``VQVAEConfig`` preset at full width (batch 2 of 80 x 848 mels, the
    adversarial phase from step VQGAN_DISC_START), kernel C exactly twice an
    iteration and once a validation batch; the checkpoint restored bit for
    bit and evaluated through ``--train 0 --eval 1 --resume last``; C
    inside a train step against its plain version and timed there; the
    reconstruction loss on a repeated batch falling; step ms, peak memory
    and a profiled window; a narrow float32 copy's step card vs CPU.
    Returns (C's row at the training shape, C's launches on the training
    and the evaluation path)."""
    from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index
    write_vas_tree(VQGAN_ROOT, mels, codes)
    torch.cuda.empty_cache()
    # cuDNN's deterministic algorithms from the first step to the check of
    # the repeated batch: the adversarial phase amplifies the last-bit
    # differences of the default (nondeterministic) convolution backward
    # passes, and that check's rec_loss went either way between two runs of
    # one tree.  The step is timed after it with torch's default algorithms.
    torch.backends.cudnn.deterministic = True
    vq_nearest_index.launches = 0
    ((task, state, ckpt, val), logs), dt = wall(lambda: run_vqvae_cli(
        ["--train", "1", "--epochs", "1", "--limit_train_batches",
         str(VQGAN_STEPS), "--disc_start", str(VQGAN_DISC_START)]))
    c_train = vq_nearest_index.launches
    cfg = task.cfg
    n_ae = sum(p.numel() for p in state["model"].parameters())
    n_disc = sum(p.numel() for p in state["disc"].parameters())
    print(f"  train_vqvae.main (VQVAEConfig preset: ch {cfg.ch}, mult "
          f"{cfg.ch_mult}, attention at {cfg.attn_resolutions}, z "
          f"{cfg.z_channels}, K {cfg.num_embeddings}, ndf {cfg.disc_ndf}; "
          f"{n_ae / 1e6:.2f}M + {n_disc / 1e6:.2f}M parameters; batch "
          f"{VQGAN_BATCH}, {VQGAN_STEPS} steps, disc_start "
          f"{VQGAN_DISC_START}, {VQGAN_VAL} validation batch, a checkpoint): "
          f"{dt:.1f} s; C launches {c_train}; validation {json.dumps(val)}")
    for i, log in enumerate(logs):
        print(f"    step {i}: {json.dumps(log)}")
    check(state["step"] == VQGAN_STEPS == len(logs),
          f"VQ-GAN train steps {state['step']}")
    check((cfg.ch, cfg.ch_mult, cfg.attn_resolutions, cfg.z_channels,
           cfg.embedding_dim, cfg.num_embeddings, cfg.disc_ndf)
          == (128, (1, 1, 2, 2, 4), (53,), 256, 256, 128, 64),
          "the VQ-GAN run's configuration is not the preset")
    check(c_train == 2 * VQGAN_STEPS + VQGAN_VAL,
          "kernel C: two launches an iteration and one a validation batch")
    lo, hi = cfg.min_adapt_weight, cfg.max_adapt_weight * cfg.disc_weight
    for i, log in enumerate(logs):
        live = i >= VQGAN_DISC_START
        check(all(np.isfinite(v) for v in log.values()),
              f"VQ-GAN step {i}: a non-finite log value")
        check(lo <= log["train/d_weight"] <= hi,
              f"VQ-GAN step {i}: d_weight {log['train/d_weight']} outside "
              f"[{lo}, {hi}]")
        check(log["train/disc_factor"] == (cfg.disc_factor if live else 0.0)
              and (log["train/disc_loss"] > 0) == live,
              f"VQ-GAN step {i}: the GAN terms are {'off' if live else 'on'}")
    check(np.isfinite(val["val/aeloss"]), "VQ-GAN validation loss")

    ckpt_bytes = os.path.getsize(ckpt._resolve("last"))
    restored, rdt = wall(lambda: ckpt.restore("last"))
    same = trees_equal(restored["state"], task.state_tree(state))
    print(f"  checkpoint {ckpt_bytes / 2 ** 20:.1f} MiB; restore('last') "
          f"{rdt:.2f} s, equals the live params, both Adams, the "
          f"discriminator's statistics and the step bit for bit: {same}")
    check(same, "VQ-GAN checkpoint round trip")
    del restored

    vq_nearest_index.launches = 0
    ((_, _, _, ev), _), edt = wall(lambda: run_vqvae_cli(
        ["--train", "0", "--eval", "1", "--resume", "last"]))
    c_eval = vq_nearest_index.launches
    print(f"  train_vqvae.main --train 0 --eval 1 --resume last: {edt:.1f} "
          f"s; C launches {c_eval}; {json.dumps(ev)}")
    check(c_eval == VQGAN_VAL, "kernel C: one launch a validation batch")
    check(all(np.isfinite(v) for v in ev.values()), "VQ-GAN evaluation")

    batch = first_train_batch(VQGAN_ROOT, VQGAN_BATCH)
    state, c_row = check_vq_in_training(task, state, batch)

    # learning on a repeated batch, then the step's time and memory
    steps = vqgan_steps(task, state, batch, 20)[0]
    rec = [s["train/rec_loss"] for s in steps]
    print(f"  repeated batch (deterministic cuDNN): rec_loss {rec[0]:.4f} -> "
          f"{rec[-1]:.4f} in 20 steps, d_weight "
          f"{steps[-1]['train/d_weight']:.4g}")
    check(all(np.isfinite(v) for s in steps for v in s.values()),
          "non-finite VQ-GAN logs on the repeated batch")
    check(rec[-1] < rec[0], "the VQ-GAN's rec_loss on a repeated batch did "
          "not fall")
    torch.backends.cudnn.deterministic = False
    _, ms, mem, held = vqgan_steps(task, state, batch, 8)
    print(f"  VQ-GAN step, preset, batch {VQGAN_BATCH}, float32, TF32 off: "
          f"{ms:.1f} ms, peak {mem / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} "
          f"GiB held before the steps)")
    profile_vqgan_step(task, state, batch)
    torch.backends.cudnn.allow_tf32 = True
    try:
        ms32 = vqgan_steps(task, state, batch, 8)[1]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"  the same step with cuDNN's TF32 on (torch's default for "
          f"convs): {ms32:.1f} ms")
    del task, state, ckpt
    torch.cuda.empty_cache()
    vqgan_reference_check(dev, batch)
    # VQGAN_ROOT stays for phase media (its --reconstruct_spec), which
    # removes it
    return c_row, (c_train, c_eval)


# the log values of a VQ-GAN step computed before it updates anything, which
# d_weight does not reach
VQGAN_PRE_UPDATE = ("train/rec_loss", "train/quant_loss", "train/g_loss",
                    "train/perplexity", "train/logits_real")


def vqgan_reference_check(dev, batch):
    """One train step of a narrow copy (ch 16, the preset's other widths)
    from the same random weights on the card in float32 and on the CPU in
    float64, with the GAN terms off (``disc_start`` beyond the step) and on.
    The reference is float64 because the CPU's float32 GroupNorm takes its
    variance as E[x^2] - E[x]^2, which on the battery's mels (channels whose
    mean is 10-25 times their spread) is off by ~2e-3 after the first block
    (the card's Welford statistics are not).  The CPU's first quantiser call
    takes the card's codes: where its own argmin differs, the pick must be
    a near-tie the two devices' latents explain (``unexplained_flips``),
    and a flipped code would otherwise move every value after it.  Bounds:
    the values the step computes before it updates anything
    (VQGAN_PRE_UPDATE, and ``aeloss`` with the GAN terms off, where
    ``d_weight`` reaches it times 0) 1e-4 relative (of at least 1e-3).  With
    the GAN terms off also each leaf's gradient 1e-4 of its max |g|, and
    the updated parameters 1e-4 relative wherever an element's gradient
    agrees to 1e-4 of itself: Adam's first step is ~lr sign(g) / (1 +
    eps / |g|), so a gradient near 0 or near eps moves its parameter by up
    to 2 lr on one device against the other, which is the bound elsewhere;
    leaves
    whose gradient is 0 in exact arithmetic (a conv bias before a GroupNorm
    of one channel a group, an attention key bias) aside; the
    discriminator unchanged.  ``d_weight`` and the values after the update
    are printed, not bounded: d_weight's denominator is the gradient of the
    mean logit, which train-mode BatchNorm makes all but independent of the
    input (a normalised channel's batch mean is its bias), a sum that
    cancels to parts in 10^3 of its terms."""
    from melspec_gpt_vqvae_tpu_torch.configs import VQVAEConfig
    from melspec_gpt_vqvae_tpu_torch.models import vqvae as VM
    from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import VQVAETask
    kernel = VM.vq_nearest_index
    for live in (False, True):
        cfg = VQVAEConfig(ch=16, disc_start=0 if live else 10)
        card_calls, flips = [], {}

        def recording(x, cb):
            out = kernel(x, cb)
            card_calls.append((x.double().cpu(), out.cpu()))
            return out

        def replaying(x, cb):
            own = kernel(x, cb)
            if flips:            # the discriminator phase's call: its own
                return own
            z_card, theirs = card_calls[0]
            flips.update(differing=int((own != theirs).sum()),
                         unexplained=unexplained_flips(
                             own, theirs, x.double(), z_card, cb))
            return theirs
        out = {}
        for name, d, fn in (("card", dev, recording),
                            ("cpu", torch.device("cpu"), replaying)):
            task = VQVAETask(cfg, d)
            state = task.init_state(11)
            x = task.batch_images(batch)
            if d.type == "cpu":
                for net in ("model", "disc"):
                    state[net].double()
                x = x.double()
            task.batch_images = lambda _: x
            VM.vq_nearest_index = fn
            try:
                state, logs = task.train_step(state, batch)
            finally:
                VM.vq_nearest_index = kernel
            out[name] = (logs, {
                f"{net}.{n}": (p.detach().cpu().double(),
                               p.grad.cpu().double())
                for net in ("model", "disc")
                for n, p in state[net].named_parameters()})
        (l_card, card), (l_cpu, cpu) = out["card"], out["cpu"]
        keys = VQGAN_PRE_UPDATE + (() if live else ("train/aeloss",))
        rel = {k: abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-3)
               for k in l_cpu}
        res = {"gan_terms": "on" if live else "off", "logs_cpu_f64": l_cpu,
               "log_rel_err": rel, "codes": flips}
        if not live:
            ae = {n: v for n, v in cpu.items() if n.startswith("model.")}
            scale = max(g.abs().max().item() for _, g in ae.values())
            g_rel, p_bad, p_far, settled, total = 0.0, 0, 0.0, 0, 0
            for n, (p, g) in ae.items():
                dp = (card[n][0] - p).abs()
                p_far = max(p_far, dp.max().item())
                total += p.numel()
                gmax = g.abs().max().item()
                if gmax <= 1e-6 * scale:      # zero in exact arithmetic
                    continue
                dg = (card[n][1] - g).abs()
                g_rel = max(g_rel, dg.max().item() / gmax)
                # elements whose own gradient agrees to 1e-4: Adam moves
                # them alike
                agree = dg <= 1e-4 * g.abs()
                settled += int(agree.sum())
                p_bad += int(((dp > 1e-4 * p.abs() + 1e-7) & agree).sum())
            res.update(grad_max_rel_err=g_rel,
                       params_with_gradients_agreeing=f"{settled}/{total}",
                       params_beyond_1e_4_of_those=p_bad,
                       param_max_abs_diff=p_far,
                       disc_unchanged=all(
                           torch.equal(card[n][0], v[0])
                           for n, v in cpu.items() if n.startswith("disc.")))
        print(f"  VQ-GAN train step (ch-16 copy, GAN terms "
              f"{res['gan_terms']}) card float32 vs CPU float64: "
              f"{json.dumps(res)} (bounds: {', '.join(keys)} 1e-4 relative"
              f"{'' if live else '; gradients 1e-4 of each leaf max; parameters 1e-4 relative where the element gradients agree to 1e-4, 2 lr elsewhere'})")
        check(flips["unexplained"] == 0, "VQ-GAN step: codes the latents "
              "cannot explain, card vs CPU")
        check(all(rel[k] <= 1e-4 for k in keys),
              f"VQ-GAN step logs vs CPU, GAN terms {res['gan_terms']}")
        if not live:
            check(g_rel <= 1e-4, "VQ-GAN step gradients vs CPU")
            check(p_bad == 0 and p_far <= 2 * cfg.learning_rate + 1e-6,
                  "VQ-GAN step parameters vs CPU")
            check(res["disc_unchanged"],
                  "the discriminator moved with the GAN terms off")


# ---------------------------------------------------------------------------
# 9. media logging through frozen decoders: the class GPT and the GPT-VAE
# ---------------------------------------------------------------------------


MEDIA_ROOT = Path("build") / "chip_smoke_media"
MEDIA_STEPS, MEDIA_VAL = 2, 1
MEDIA_CLIP = 848 * 256          # samples of a vocoded (80, 848) spectrogram
# the tags of one GPTImageLogger call (training/callbacks.py, letter for
# letter the JAX package's)
GPT_MEDIA_TAGS = (
    ("conditioning", "text"), ("codes", "text"), ("codes_half", "text"),
    ("codes_nopix", "text"), ("codes_det", "text"), ("att_nopix", "image"),
    ("inputs", "image"), ("inputs_audio", "audio"),
    ("reconstructions", "image"), ("reconstructions_audio", "audio"),
    ("samples_half", "image"), ("samples_half_audio", "audio"),
    ("samples_nopix", "image"), ("samples_nopix_audio", "audio"),
    ("samples_det", "image"), ("samples_det_audio", "audio"))


def write_melgan_dir(path, seed):
    """A reference-format MelGAN folder of the VAS vocoder from seeded
    random weights: ``best_netG.pt`` in the reference Sequential's layout,
    each conv weight-normed with g = |v| (folded back to v), and
    ``args.yml``."""
    from melspec_gpt_vqvae_tpu_torch.bridge import init_conv_net_
    from melspec_gpt_vqvae_tpu_torch.configs import VocoderConfig
    from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANGenerator
    from melspec_gpt_vqvae_tpu_torch.utils import convert
    cfg = VocoderConfig()
    params = dict(init_conv_net_(MelGANGenerator(cfg), torch.Generator()
                                 .manual_seed(seed)).named_parameters())
    sd = {}
    for port, ref in convert._melgan_reference_names(cfg).items():
        w = params[f"{port}.weight"].detach()
        sd[f"{ref}.weight_v"] = w
        sd[f"{ref}.weight_g"] = w.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        sd[f"{ref}.bias"] = params[f"{port}.bias"].detach()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path / "best_netG.pt")
    (path / "args.yml").write_text(
        "!!python/object:argparse.Namespace\n"
        f"n_mel_channels: {cfg.n_mel_channels}\nngf: {cfg.ngf}\n"
        f"n_residual_layers: {cfg.n_residual_layers}\n")


def media_counters():
    """The wrappers of the kernels a media or LSTM path could launch."""
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.decode_attention import \
        decode_attend_int8
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack import \
        fused_resblock_stack
    from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index
    return {"A": attend, "B": fused_resblock_stack, "C": vq_nearest_index,
            "E": decode_attend_int8, "F forward": flash_attention_fwd,
            "F backward": flash_attention_bwd}


def recording(cls, name, log, extra=None):
    """Replace ``cls.name`` by a wrapper that appends (seconds on the card,
    launches of each media counter inside, ``extra(self)`` before and
    after) of every call to ``log``; returns the original."""
    fn, counters = getattr(cls, name), media_counters()

    def wrapper(self, *a, **kw):
        before = {k: w.launches for k, w in counters.items()}
        x0 = extra(self) if extra else None
        out, dt = wall(lambda: fn(self, *a, **kw))
        log.append((dt, {k: w.launches - before[k]
                         for k, w in counters.items()},
                    (x0, extra(self)) if extra else None))
        return out
    setattr(cls, name, wrapper)
    return fn


def media_records(log_dir):
    """The JSON lines of a run's logger, every WAV they name checked (mono
    16-bit, 22050 Hz, MEDIA_CLIP samples)."""
    recs = [json.loads(line) for line in
            (log_dir / "events.jsonl").read_text().splitlines()]
    for r in recs:
        if "audio" in r:
            with wave.open(str(log_dir / r["audio"]), "rb") as w:
                got = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                       w.getnframes())
            check(got == (1, 2, 22050, MEDIA_CLIP),
                  f"{r['tag']}: WAV {got}")
    return recs


def media_check(dev, mels, codes, smi_line):
    """Media logging on the card through the port's CLIs: ``train_gpt.main``
    at the full VAS preset with ``--reconstruct_spec`` (phase vqgan's run
    directory) and ``--vocoder`` (a reference-format folder of seeded
    weights), every batch logged (``--logging_frequency 1``): each
    GPTImageLogger call's tags and files, its launches of A (three
    prefills), E (every decode step over the int8 cache, plus the warm-up
    runs of its captures), B (4 a vocoded clip), no C or F; then one
    VAETextLogger call with the same decoders on phase vae's checkpoint.
    Returns {kernel: (launches on the GPT path, on the GPT-VAE call)}."""
    from melspec_gpt_vqvae_tpu_torch import train_gpt, train_gpt_vae
    from melspec_gpt_vqvae_tpu_torch.training import callbacks as CB
    from melspec_gpt_vqvae_tpu_torch.training import runner
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
    write_vas_tree(MEDIA_ROOT, mels, codes)
    write_melgan_dir(MEDIA_ROOT / "melgan", seed=5)
    vq_run = (VQGAN_ROOT / "lightning_logs" / "vqsmoke-vas").resolve()
    decoder_flags = ["--reconstruct_spec", str(vq_run),
                     "--vocoder", str((MEDIA_ROOT / "melgan").resolve())]
    counters = media_counters()
    calls, steps = [], []
    saved = [(CB.GPTImageLogger, "__call__",
              recording(CB.GPTImageLogger, "__call__", calls,
                        lambda cb: dict(cb.task.graphs.warmup_launches))),
             (GPTTask, "train_step",
              recording(GPTTask, "train_step", steps))]
    argv = ["--dataset", "vas", "--experiment", "msmoke", "--device", "cuda",
            "--train", "1", "--epochs_override", "1", "--ckpt_every", "-1",
            "--limit_train_batches", str(MEDIA_STEPS),
            "--limit_val_batches", str(MEDIA_VAL), "--logging_frequency",
            "1", *decoder_flags,
            "--override", "use_flash_train=True,cache_dtype=int8"]
    for w in counters.values():
        w.launches = 0
    cwd = os.getcwd()
    os.chdir(MEDIA_ROOT)
    try:
        (task, state, _), dt = wall(lambda: train_gpt.main(
            train_gpt.init_config(argv)))
    finally:
        os.chdir(cwd)
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    gpt_launches = {k: w.launches for k, w in counters.items()}
    n_layer, t = task.cfg.n_layer, 265
    decode_steps = (t - t // 2) + t + t      # half, nopix, det
    print(f"  train_gpt.main (VAS preset, use_flash_train, int8 KV cache, "
          f"{MEDIA_STEPS} steps, {MEDIA_VAL} val batch, --logging_frequency "
          f"1, --reconstruct_spec the vqgan run, --vocoder a reference "
          f"folder): {dt:.1f} s; launches {json.dumps(gpt_launches)}")
    check(state["step"] == MEDIA_STEPS and len(steps) == MEDIA_STEPS
          and len(calls) == MEDIA_STEPS + MEDIA_VAL,
          f"media run: {state['step']} steps, {len(calls)} callbacks")
    check(task.cfg.n_embd == 1024 and n_layer == 24
          and task.cfg.cache_dtype == "int8", "the media run's config")
    for i, (sec, k, (w0, w1)) in enumerate(calls):
        e_warm = w1.get("decode_attention", 0) - w0.get("decode_attention", 0)
        want = {"A": 3 * n_layer, "B": 4 * 5, "C": 0,
                "E": decode_steps * n_layer + e_warm, "F forward": 0,
                "F backward": 0}
        print(f"    callback {i}: {sec:.2f} s, launches {json.dumps(k)} "
              f"(E: {decode_steps} decode steps x {n_layer} layers + "
              f"{e_warm} in the warm-up runs of its captures)")
        check(k == want, f"media callback {i}: launches {k}, expected "
              f"{want}")
    check(gpt_launches["F forward"] == n_layer * (MEDIA_STEPS + MEDIA_VAL)
          and gpt_launches["F backward"] == n_layer * MEDIA_STEPS,
          "kernel F on the media run's steps")
    logs = MEDIA_ROOT / "lightning_logs" / "msmoke-vas" / \
        "TensorBoardLoggs" / "version_0"
    recs = media_records(logs)
    got = {(r["tag"], next(k for k in ("text", "image", "audio") if k in r))
           for r in recs if "value" not in r and "histogram" not in r}
    want_tags = {(f"{s}/{n}", kind) for s in ("train", "val")
                 for n, kind in GPT_MEDIA_TAGS}
    check(got == want_tags, f"media tags: missing "
          f"{sorted(want_tags - got)}, extra {sorted(got - want_tags)}")
    for r in recs:
        if "image" in r:
            shape = np.load(logs / r["image"]).shape
            want = ((266, 266, 1) if r["tag"].endswith("att_nopix")
                    else (80, 848, 1))
            check(shape == want, f"{r['tag']}: image {shape}")
    step_s = [s for s, _, _ in steps]
    cb_s = [s for s, _, _ in calls]
    print(f"  one media callback {cb_s[-1]:.2f} s (the first, with its "
          f"three decode captures: {cb_s[0]:.2f} s) against the run's train "
          f"steps {', '.join(f'{x:.3f}' for x in step_s)} s (phase training "
          f"times the step steady), on {smi_line}")
    del task, state
    torch.cuda.empty_cache()

    # the GPT-VAE's logger with the same decoders, on phase vae's checkpoint
    vae_args = train_gpt_vae.init_config(
        ["--dataset", "vas", "--experiment", "vsmoke", *decoder_flags])
    exp = train_gpt_vae.build_experiment(vae_args)
    vtask = VAETask(exp, 2, dev)
    ckpt = CheckpointManager(str(VAE_ROOT / "lightning_logs" / "vsmoke-vas"
                                 / "checkpoints" / "version_0"))
    vstate, _ = runner._restore(vtask, ckpt, "last")
    decoders = train_gpt.load_decoders(vae_args, exp, dev)
    vlog = TBLogger(str(MEDIA_ROOT / "vae_logs"))
    cb = CB.VAETextLogger(vtask, vlog, decoders,
                          sample_rate=exp.data.sample_rate)
    batch = first_train_batch(MEDIA_ROOT, VAE_BATCH)
    for w in counters.values():
        w.launches = 0
    _, vdt = wall(lambda: cb(vstate, batch, int(vstate["step"]), "val"))
    vae_launches = {k: w.launches for k, w in counters.items()}
    vn, n_interp = vtask.cfgs.encoder.n_layer, cb.interpolation_steps
    # greedy and beam: the encoder and the decoder's prefill each; the
    # interpolation: two encoder forwards and a prefill a point (the decode
    # steps attend over a float32 cache in plain torch); B: the original
    # (no raw clip in the tree) and every decoded row
    want = {"A": (2 * 2 + 2 + n_interp) * vn, "B": 4 * (4 + n_interp),
            "C": 0, "E": 0, "F forward": 0, "F backward": 0}
    print(f"  VAETextLogger call (phase vae's checkpoint, both decoders): "
          f"{vdt:.2f} s, launches {json.dumps(vae_launches)}")
    check(vae_launches == want, f"VAE media launches, expected {want}")
    vlog.close()
    vtags = {r["tag"] for r in media_records(Path(vlog.log_dir))}
    want_tags = {"val/original_spec", "val/original_audio"} | {
        f"val/{row}{sfx}" for row in
        ["original_codes", "greedy_reconstruction", "beam_reconstruction"]
        + [f"interpolation_{i}" for i in range(n_interp)]
        for sfx in ("", "_spec", "_audio")}
    check(vtags == want_tags, f"VAE media tags {sorted(vtags ^ want_tags)}")
    del vtask, vstate, decoders, cb
    torch.cuda.empty_cache()
    for root in (MEDIA_ROOT, VAE_ROOT, VQGAN_ROOT):
        shutil.rmtree(root)
    return {k: (gpt_launches[k], vae_launches[k]) for k in counters}


# ---------------------------------------------------------------------------
# 10. the LSTM-VAE: training, evaluation, decoding
# ---------------------------------------------------------------------------


LSTM_ROOT = Path("build") / "chip_smoke_lstm"
LSTM_STEPS, LSTM_BATCH = 4, 8


def run_lstm_cli(flags):
    """``train_gpt_vae.main --model lstm`` from LSTM_ROOT at the VAE_vas
    preset (full width, batch 8), one validation batch."""
    from melspec_gpt_vqvae_tpu_torch import train_gpt_vae
    argv = ["--dataset", "vas", "--experiment", "lsmoke", "--model", "lstm",
            "--device", "cuda", "--limit_val_batches", "1", *flags]
    cwd = os.getcwd()
    os.chdir(LSTM_ROOT)
    try:
        return train_gpt_vae.main(train_gpt_vae.init_config(argv))
    finally:
        os.chdir(cwd)


def lstm_check(dev, mels, codes, smi_line):
    """The LSTM-VAE on the card through ``train_gpt_vae.main --model
    lstm``: the VAE_vas preset at full width (ni 512, encoder and decoder
    nh 1024, nz 32, 130 symbols, sentences of 52; batch 8 grids = 40
    sentences; SGD lr 1, clip 5) for LSTM_STEPS steps with the text logger,
    no kernel launched; its checkpoint restored bit for bit; ``--eval 1``
    (MI, AU); greedy and beam reconstructions and a sample from the prior,
    each timed; the loss on a repeated batch falling; one float32 train
    step (dropout 0) on the card against the CPU with TF32 off, within
    phase vae's bounds.  Returns the step's ms and the evaluation's
    seconds."""
    from melspec_gpt_vqvae_tpu_torch.configs import load_lstm_preset
    from melspec_gpt_vqvae_tpu_torch.training.lstm_task import LSTMVAETask
    from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves
    write_vas_tree(LSTM_ROOT, mels, codes)
    counters = media_counters()
    for w in counters.values():
        w.launches = 0
    (task, state, ckpt, _), dt = wall(lambda: run_lstm_cli(
        ["--train", "1", "--epochs_override", "1", "--limit_train_batches",
         str(LSTM_STEPS), "--logging_frequency", "2", "--warm_up", "1",
         "--kl_start", "0.1"]))
    cfg = task.cfg
    launched = {k: w.launches for k, w in counters.items()}
    n_params = sum(t.numel() for _, t in named_leaves(state["params"]))
    print(f"  train_gpt_vae.main --model lstm (VAE_vas: ni {cfg.ni}, nh "
          f"{cfg.enc_nh}/{cfg.dec_nh}, nz {cfg.nz}, vocab {cfg.vocab_size}, "
          f"max_len {cfg.max_len}, {n_params / 1e6:.2f}M parameters, batch "
          f"{task.exp.train.batch_size} grids = {5 * LSTM_BATCH} sentences; "
          f"{LSTM_STEPS} steps, 1 validation batch, a checkpoint): "
          f"{dt:.1f} s; kernel launches {json.dumps(launched)}")
    check((cfg.ni, cfg.enc_nh, cfg.dec_nh, cfg.nz, cfg.vocab_size,
           cfg.max_len, task.exp.train.batch_size)
          == (512, 1024, 1024, 32, 130, 52, LSTM_BATCH),
          "the LSTM run's configuration is not the preset")
    check(state["step"] == LSTM_STEPS, f"LSTM train steps {state['step']}")
    check(not any(launched.values()), "the LSTM path launched a kernel")
    tags = {json.loads(line)["tag"] for line in (
        LSTM_ROOT / "lightning_logs" / "lsmoke-vas" / "TensorBoardLoggs"
        / "version_0" / "events.jsonl").read_text().splitlines()}
    check({"train/original", "train/greedy_reconstruction",
           "train/beam_reconstruction", "train/sampled_from_prior",
           "metrics/mutual_info"} <= tags, f"LSTM log tags {sorted(tags)}")
    restored, rdt = wall(lambda: ckpt.restore("last"))
    same = trees_equal(restored["state"], task.state_tree(state))
    print(f"  checkpoint restore('last') {rdt:.2f} s, equals the live "
          f"params, SGD state, step and kl_weight bit for bit: {same}")
    check(same, "LSTM checkpoint round trip")
    (_, _, _, metrics), edt = wall(lambda: run_lstm_cli(
        ["--train", "0", "--eval", "1", "--resume", "last"]))
    print(f"  --eval 1 --resume last: {edt:.1f} s; "
          f"{json.dumps(metrics['eval'])}")
    check({"mutual_info", "active_units", "nll", "ppl"}
          <= set(metrics["eval"])
          and all(np.isfinite(v) for v in metrics["eval"].values()),
          "LSTM evaluation metrics")
    batch = first_train_batch(LSTM_ROOT, LSTM_BATCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    for what, fn in (
            ("greedy", lambda: task.reconstruct(state, batch, "greedy", gen)),
            ("beam 5", lambda: task.reconstruct(state, batch, "beam", gen)),
            ("prior sample", lambda: task.sample_from_prior(
                state, 5 * LSTM_BATCH, generator=gen))):
        toks, sec = wall(fn)
        print(f"  {what}: {5 * LSTM_BATCH} sentences of {cfg.max_len} in "
              f"{sec:.3f} s")
        check(toks.shape == (5 * LSTM_BATCH, cfg.max_len)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"LSTM {what} tokens")
    # learning: the batch's ELBO at z = the posterior mean (no dropout)
    # before and after 10 steps on it; the steps' own losses are noisy
    # (dropout 0.5, one z draw, SGD at lr 1)
    mean_z = torch.zeros(5 * LSTM_BATCH, 1, cfg.nz, device=dev)
    before = task.eval_step(state, batch, eps=mean_z)["loss"]
    losses, ms, mem = timed_steps(task, state, batch, 10)
    after = task.eval_step(state, batch, eps=mean_z)["loss"]
    print(f"  LSTM step: {ms:.1f} ms, {5 * LSTM_BATCH / (ms / 1e3):.0f} "
          f"sentences/s, peak {mem / 2 ** 30:.2f} GiB, on {smi_line}; "
          f"repeated batch: ELBO a sentence {before / (5 * LSTM_BATCH):.2f} "
          f"-> {after / (5 * LSTM_BATCH):.2f} after 10 steps (step losses "
          f"{losses[0]:.2f} ... {losses[-1]:.2f})")
    check(all(np.isfinite(losses)) and after < before,
          "the LSTM's loss on a repeated batch did not fall")
    del task, state, ckpt
    torch.cuda.empty_cache()

    # one float32 step, dropout 0, the same weights and latent noise
    exp, lcfg = load_lstm_preset("vas", dec_dropout_in=0.0,
                                 dec_dropout_out=0.0)
    eps = torch.randn(5 * LSTM_BATCH, 1, lcfg.nz,
                      generator=torch.Generator().manual_seed(3))
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        t = LSTMVAETask(exp, lcfg, 5, d)
        st = t.init_state(11)
        st, loss, _ = t.train_step(st, batch, torch.Generator(device=d),
                                   eps=eps.to(d))
        out[name] = (loss.item(), {n: (p.detach().cpu(), p.grad.cpu())
                                   for n, p in named_leaves(st["params"])})
    (l_cpu, cpu), (l_card, card) = out["cpu"], out["card"]
    g_rel = max(max_err(card[n][1], cpu[n][1])
                / cpu[n][1].abs().max().clamp_min(1e-30).item() for n in cpu)
    p_rel = max(max_err(card[n][0], cpu[n][0])
                / cpu[n][0].abs().max().clamp_min(1e-30).item() for n in cpu)
    res = {"loss_cpu": l_cpu,
           "loss_rel_diff": abs(l_card - l_cpu) / abs(l_cpu),
           "grad_max_rel_err": g_rel, "param_max_rel_err": p_rel}
    print(f"  LSTM train step (preset widths, 40 sentences, dropout 0, "
          f"float32, TF32 off) card vs CPU: {json.dumps(res)} (bounds: "
          f"loss 1e-5, gradients and parameters 1e-4 of each leaf's max)")
    check(res["loss_rel_diff"] <= 1e-5, "LSTM step loss vs CPU")
    check(g_rel <= 1e-4 and p_rel <= 1e-4, "LSTM step gradients and "
          "parameters vs CPU")
    shutil.rmtree(LSTM_ROOT)
    return {"step_ms": ms, "eval_s": edt}


def check_bounds(kernels):
    """No row's bound may exceed a time measured for the same function: the
    kernel's, its plain version's or the library call's.  A bound above one
    of them counts operations or bytes the function does not need."""
    for row in kernels:
        for label, r in [("", row)] + [(f" {k}", v) for k, v in row.items()
                                        if isinstance(v, dict)
                                        and "bound_ms" in v] \
                + [(f" stage {i}", st)
                   for i, st in enumerate(row.get("stages", []))]:
            for key in ("ms", "device_ms", "plain_ms", "library_ms"):
                t = r.get(key)
                check(t is None or r["bound_ms"] <= t,
                      f"{row['name']}{label}: bound_ms {r['bound_ms']:.5f} "
                      f"above the measured {key} {t}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "an NVIDIA card")
    procs = start_exports()
    try:
        run(procs)
    finally:
        stop_exports(procs)


def run(procs):
    """The phases, with the export processes running from the start."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from melspec_gpt_vqvae_tpu_torch.utils.battery import make_battery

    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.decode_attention import \
        decode_attend_int8
    from melspec_gpt_vqvae_tpu_torch.ops.int8_linear import (
        int8_linear_splitk, quantize_rows, rescale_bias, row_scales)
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    from melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack import \
        fused_resblock_stack
    from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index
    from melspec_gpt_vqvae_tpu_torch.pipeline import tokenize
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    # nvcc runs beside the first pipeline's weight set-up on the host; a
    # failed build raises from the second load()
    nvcc_thread = threading.Thread(target=_build.load)
    nvcc_thread.start()
    exp, pipe = build_pipeline("vas", init_random=True, seed=783435,
                               device=dev)
    nvcc_thread.join()
    _build.load()
    print(f"build, beside the first build_pipeline: done at "
          f"{time.perf_counter() - T_START:.1f} s, nvcc "
          f"{_build.build_seconds} s (None: library reused)")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"card: {smi_line}")

    # the card's default configuration, as the JAX package's on its chip
    m = exp.model
    check((m.dtype, m.cache_dtype, m.decode_weight_dtype)
          == ("bfloat16", "int8", "int8"),
          f"card default {m.dtype}/{m.cache_dtype}/{m.decode_weight_dtype}")
    wav = torch.from_numpy(make_battery(exp.mel.clip_samples)).to(dev)
    check(wav.shape[0] == 48, "battery size")

    phase("kernels", "kernels vs plain PyTorch on the card:")
    results = {"attention": check_attention(dev),
               "vocoder_stack": check_vocoder_stack(dev, pipe.melgan),
               "vq_nearest": check_vq(dev),
               "mel": check_mel(dev, wav, exp.mel),
               "decode_attention": check_decode_attention(dev)}
    results["flash_attention_fwd"], results["flash_attention_bwd"] = \
        check_flash(dev)
    results.update(check_int8_linear(dev))

    wrappers = {"attention": attend, "vocoder_stack": fused_resblock_stack,
                "vq_nearest": vq_nearest_index, "mel": waveform_to_mel_fused,
                "decode_attention": decode_attend_int8,
                "quantize_rows": quantize_rows, "rescale_bias": rescale_bias,
                "row_scales": row_scales,
                "int8_linear_splitk": int8_linear_splitk}
    steps, n_layer = 265, m.n_layer

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def counts(title):
        c = {k: w.launches for k, w in wrappers.items()}
        print(f"  launches ({title}): {json.dumps(c)}")
        return c

    def decode_launches(pipe, title, e_launches, products=None,
                        row_cut=False, one_launch=None):
        """Check the decode kernels' counts of a path in their exact form:
        ``e_launches`` of kernel E and ``products`` int8 block products
        (None: four for each launch of E, as in a plain decode step; none
        where the weights are not int8), plus what the warm-up runs before
        each capture launched, which the holder reports.  A product is one
        launch of ``int8_linear_splitk`` (at most SPLITK_MAX_ROWS rows) or
        one of ``quantize_rows`` and one of ``rescale_bias`` (more rows, or
        the row-cut half, ``attn_proj`` and ``mlp_down``, of a
        tensor-parallel path (``row_cut``), which launches the scale pass
        ``row_scales`` too).  ``one_launch``: how many took the one launch
        (None: every product that is not row-cut, as at the served batches;
        "any": a path of several batch sizes, only the sum checked).
        Returns the counts."""
        c = counts(title)
        warm = pipe.graphs.warmup_launches
        print(f"  of these the warm-up runs before {pipe.graphs.captures} "
              f"captures ({pipe.graphs.capture_seconds:.2f} s): "
              f"{json.dumps(warm)}")
        if products is None:
            products = 4 * e_launches
        if pipe.gcfg.decode_weight_dtype != "int8":
            products = 0
        ran = {name: c[name] - warm.get(name, 0) for name in c}
        if one_launch == "any":
            one_launch = ran["int8_linear_splitk"]
        elif one_launch is None:
            one_launch = products - (products // 2 if row_cut else 0)
        for name, each in (("decode_attention", e_launches),
                           ("quantize_rows", products - one_launch),
                           ("rescale_bias", products - one_launch),
                           ("int8_linear_splitk", one_launch),
                           ("row_scales", products // 2 if row_cut else 0)):
            check(ran[name] == each,
                  f"{title}: {name} launched {c[name]} times, expected "
                  f"{each} + {warm.get(name, 0)} in warm-up runs")
        return c

    phase("main_path",
          "main path (VAS width, bf16, int8 KV cache, int8 weights, "
          "random weights, captured decode program):")
    tokenize(pipe.vq, wav, exp.mel)        # first call: cuDNN set-up
    zero()
    codes, t_tok = wall(lambda: tokenize(pipe.vq, wav, exp.mel))
    print(f"  tokenize 48 clips: {t_tok:.4f} s")
    check(codes.shape == (48, 265) and int(codes.min()) >= 0
          and int(codes.max()) < 128, f"tokenize codes {codes.shape}")
    # the third request has the first's shape: no capture in its seconds
    calls, _ = serve_path(exp, pipe, dev, [
        (8, {}, list(range(8))), (8, {"sample": False}, [3] * 8),
        (8, {}, list(range(8)))])
    launches = decode_launches(pipe, "main path", calls * steps * n_layer)
    check(pipe.melgan.packs == len(exp.vocoder.ratios),
          f"the vocoder packed its stages' weights {pipe.melgan.packs} "
          "times: once a stage is all the main path needs")
    check(pipe.block_weights.passes == 1 and pipe.graphs.captures == 2,
          f"the main path quantised the block weights "
          f"{pipe.block_weights.passes} times and captured "
          f"{pipe.graphs.captures} shapes: once, and two")
    for name, n in launches.items():
        # the scale pass alone runs on the tensor-parallel path only
        # (phase serving_mesh); at batch 8 every int8 product is one launch
        # of int8_linear_splitk, the chain's two kernels run at more rows
        check(n > 0 or name in ("row_scales", "quantize_rows",
                                "rescale_bias"),
              f"kernel {name} was not launched by the main path")
    prof = {"captured": profile_decode_step(pipe, m, dev),
            "eager": profile_decode_step(pipe, m, dev, graph=False)}

    phase("captured_vs_eager",
          "captured decode programs against the eager loop on the card:")
    captured_vs_eager(dev, pipe, seed=11)
    splitk_vs_chain(dev, pipe, seed=12)
    del pipe

    phase("bf16_cache",
          "bf16 KV cache and bf16 weights (the first serving path):")
    exp_b, pipe = build_pipeline("vas", init_random=True, seed=783435,
                                 device=dev, kv_cache="auto", int8_weights=0)
    zero()
    serve_path(exp_b, pipe, dev, [(8, {}, list(range(8)))] * 2)
    c = decode_launches(pipe, "bf16 cache", 0)
    check(c["attention"] > 0 and c["vocoder_stack"] > 0, "bf16 path kernels")
    prof["bf16"] = profile_decode_step(pipe, exp_b.model, dev)
    del pipe

    phase("int4_cache", "int4 KV cache, int8 weights:")
    exp_4, pipe = build_pipeline("vas", init_random=True, seed=783435,
                                 device=dev, kv_cache="int4")
    zero()
    calls, _ = serve_path(exp_4, pipe, dev, [
        (8, {"seed": 1234, "top_p": 0.9}, list(range(8)))] * 2)
    c = decode_launches(pipe, "int4 cache", calls * steps * n_layer)
    check(c["attention"] > 0 and c["vocoder_stack"] > 0, "int4 path kernels")
    del pipe

    phase("speculative",
          f"speculative decoding, {SPEC_LAYERS}-layer target, random "
          f"{DRAFT_LAYERS}-layer draft, gamma 4 (int8 cache and weights):")
    exp_s, pipe = build_pipeline("vas", init_random=True, seed=783435,
                                 device=dev, override=f"n_layer={SPEC_LAYERS}",
                                 draft_random=f"n_layer={DRAFT_LAYERS}",
                                 gamma=4)
    check(exp_s.model.n_layer == SPEC_LAYERS
          and pipe.draft_cfg.n_layer == DRAFT_LAYERS,
          "speculative path: target and draft depth")
    zero()
    _, rounds = serve_path(exp_s, pipe, dev, [
        (1, {}, [3]), (8, {}, list(range(8)))] * 2)
    # per round: gamma + 1 draft steps and a target chunk of gamma + 1
    # positions; E runs once a layer and position, the chunk's int8
    # products once a layer for all its positions
    c = decode_launches(pipe, "speculative",
                        rounds * 5 * (DRAFT_LAYERS + SPEC_LAYERS),
                        rounds * 4 * (5 * DRAFT_LAYERS + SPEC_LAYERS),
                        one_launch="any")
    check(c["attention"] > 0 and c["vocoder_stack"] > 0,
          "speculative path kernels")
    del pipe
    torch.cuda.empty_cache()

    phase("export", f"torch.export artifacts (VAS width, {EXPORT_LAYERS} "
          "layers, batch 8, int8 KV cache and weights) against the live "
          "pipeline:")
    pipe = export_check(dev, procs, wrappers, zero)
    phase("artifact_http", "serve --artifact over HTTP:")
    artifact_http_check()
    phase("int8_decode", f"the int8 decode stage (VAS width, "
          f"{EXPORT_LAYERS}-layer GPT, batch 8):")
    int8_decode_check(dev, pipe, wrappers, zero)
    del pipe
    torch.cuda.empty_cache()

    phase("f32_vs_cpu", "float32 reference on the CPU:")
    reference_check(dev, exp, wav, seed=7)
    phase("quantised_vs_cpu", "quantised paths, float32, card vs CPU:")
    quantised_reference_check(dev, exp, seed=7)

    phase("training",
          "training (VAS GPT preset, full width, float32, random weights):")
    with torch.inference_mode():
        mels = waveform_to_mel_fused(wav, exp.mel)
    f_launches, a_eval_launches, batch = train_check(dev, mels, codes)
    launches["flash_attention_fwd"], launches["flash_attention_bwd"] = \
        f_launches
    # kernel A is on two driven paths: the serving prefill (T = 1) and the
    # evaluation forward (T = 265), each counted from 0
    results["attention"]["launches_by_path"] = {
        "serving_prefill_t1": launches["attention"],
        "evaluation_t265_f32": a_eval_launches}
    launches["attention"] += a_eval_launches
    train_reference_check(dev, batch)

    phase("dist", "distributed training, NCCL at world size 1 (VAS GPT and "
          "GPT_VAE_vas presets, full width), and the torchrun launcher:")
    dist_f, dist_a = dist_check(dev, codes, batch, smi_line)
    results["attention"]["launches_by_path"]["dist_pipe1_m4_eval"] = dist_a
    launches["attention"] += dist_a

    phase("serving_mesh", "serving over a mesh, NCCL at world size 1 (VAS "
          "width, int8 KV cache and weights, captured decode, batch 8), "
          "and torchrun serve --mesh:")
    mesh_launches = serving_mesh_check(dev, wrappers, zero, decode_launches)
    for name, n in mesh_launches.items():
        if not n:
            continue
        by_path = results[name].setdefault("launches_by_path",
                                           {"serving": launches[name]})
        by_path["serving_mesh"] = n
        launches[name] += n

    phase("xl", f"the XL decoder (GPT_VAE_vggsound: 1472 wide, 23 heads, "
          f"vocab 1024; {XL_LAYERS} of 40 layers, batch {XL_BATCH}, bf16, "
          "int8 KV cache and weights, random weights):")
    xl_launches, (xl_e, xl_a), xl_int8 = xl_check(dev, wrappers, zero,
                                                  decode_launches)
    results["decode_attention"]["xl_int8_weights_on_off"] = xl_int8
    for name, err in (("decode_attention", xl_e), ("attention", xl_a)):
        results[name]["max_abs_err_xl_h23"] = err
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           err)
    for name, n in xl_launches.items():
        if not n:
            continue
        by_path = results[name].setdefault("launches_by_path",
                                           {"serving": launches[name]})
        by_path["xl"] = n
        launches[name] += n

    phase("served_checkpoint",
          "serving the trained checkpoint (HTTP, sample CLI, self-draft, "
          "kernels on against off):")
    cwd = os.getcwd()
    os.chdir(TRAIN_ROOT)
    try:
        served_checkpoint_check(dev, wav, wrappers, zero, decode_launches,
                                smi_line)
    finally:
        os.chdir(cwd)
    kernels_on_off_f32(dev, exp, wav, seed=7)
    shutil.rmtree(TRAIN_ROOT)

    phase("vae", "the GPT-VAE (GPT_VAE_vas preset, full width, batch 24, "
          "mixed precision, remat attn, random weights):")
    vae_rows = check_vae_kernels(dev)
    (vf_fwd, vf_bwd), va = vae_check(dev, mels, codes)
    # the VAE's shapes join each row as entries of their own; F's worst
    # error covers them
    for row, new in (("flash_attention_fwd", vae_rows["fwd"]),
                     ("flash_attention_bwd", vae_rows["bwd"]),
                     ("attention", vae_rows["attention"])):
        if "max_abs_err" in new:
            err = new.pop("max_abs_err")
            results[row]["max_abs_err_vae_shapes"] = err
            results[row]["max_abs_err"] = max(results[row]["max_abs_err"],
                                              err)
        results[row].update(new)
    for name, gpt_n, vae_n, dist_n in (
            ("flash_attention_fwd", f_launches[0], vf_fwd, dist_f[0]),
            ("flash_attention_bwd", f_launches[1], vf_bwd, dist_f[1])):
        results[name]["launches_by_path"] = {"gpt_training": gpt_n,
                                             "vae_training": vae_n,
                                             "dist_pipe1_m4": dist_n}
        launches[name] = gpt_n + vae_n + dist_n
    results["attention"]["launches_by_path"]["vae_evaluation"] = va
    launches["attention"] += va

    phase("features", "the offline tokenizer (extract_mel_spectrogram, "
          "extract_codes, parity_check at the VQVAEConfig preset, seeded "
          "weights; the mel inverse chain):")
    feat, feat_launches = features_check(
        dev, make_battery(exp.mel.clip_samples))
    # C and D in the tokenizer's CLIs and parity_check, beside the main
    # path's tokenize; the record keeps them by entry point
    for name, key in (("vq_nearest", "C"), ("mel", "D")):
        n = sum(c[key] for c in feat_launches.values())
        results[name]["launches_by_path"] = {"tokenize": launches[name],
                                             "features": n}
        launches[name] += n
    results["mel"]["features"] = {**feat, "launches": feat_launches}

    phase("vqgan", "the VQ-GAN first stage (VQVAEConfig preset, full width, "
          "batch 2, float32, random weights):")
    c_row, (c_train, c_eval) = vqgan_check(dev, mels, codes)
    results["vq_nearest"]["training_n530_k128"] = c_row
    results["vq_nearest"]["launches_by_path"].update(
        vqgan_training=c_train, vqgan_evaluation=c_eval)
    launches["vq_nearest"] += c_train + c_eval

    phase("media", "media logging through frozen decoders (VAS GPT preset, "
          "full width, int8 KV cache; phase vae's GPT-VAE checkpoint):")
    media = media_check(dev, mels, codes, smi_line)
    for name, key in (("attention", "A"), ("vocoder_stack", "B"),
                      ("decode_attention", "E"),
                      ("flash_attention_fwd", "F forward"),
                      ("flash_attention_bwd", "F backward")):
        by_path = results[name].setdefault("launches_by_path",
                                           {"serving": launches[name]})
        by_path["media_gpt"], by_path["media_vae"] = media[key]
        launches[name] += sum(media[key])

    phase("lstm", "the LSTM-VAE (VAE_vas preset, full width, batch 8, "
          "float32, random weights):")
    lstm_check(dev, mels, codes, smi_line)

    meta = {"attention": ("attention.cu", "attention.py:114"),
            "vocoder_stack": ("vocoder_stack.cu", "vocoder_pallas.py:143"),
            "vq_nearest": ("vq.cu", "vq.py:37"),
            "mel": ("mel.cu", "mel_pallas.py:54"),
            "decode_attention": ("decode_attention.cu",
                                 "decode_attention.py:64"),
            "flash_attention_fwd": ("flash_attention.cu",
                                    "flash_attention.py:51"),
            "flash_attention_bwd": ("flash_attention.cu",
                                    "flash_attention.py:70"),
            # no TPU kernel: the lines XLA fuses around the JAX package's
            # int8 dot
            "quantize_rows": ("int8_linear.cu", "../models/gpt.py:444"),
            "rescale_bias": ("int8_linear.cu", "../models/gpt.py:450"),
            "row_scales": ("int8_linear.cu", "../models/gpt.py:444"),
            "int8_linear_splitk": ("int8_linear.cu",
                                   "../models/gpt.py:441")}
    results["decode_attention"]["decode_step_profiles"] = prof
    kernels = [{"name": name, "route": "cuda",
                "source": "melspec_gpt_vqvae_tpu_torch/csrc/" + src,
                "replaces": os.path.normpath(
                    "melspec_gpt_vqvae_tpu/ops/" + rep),
                "launches": launches[name],
                **results[name]} for name, (src, rep) in meta.items()]
    check_bounds(kernels)
    print(f"total: {time.perf_counter() - T_START:.1f} s; phase seconds "
          f"(build and first pipeline before them): "
          f"{json.dumps(phase_seconds())}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
