#!/usr/bin/env python
"""XL serving datapoint on the card: the VGGSound GPT-VAE's decoder (40
layers, 23 heads, 1472 wide, vocab 1024, block 266; the
``GPT_VAE_vggsound`` preset, reference config_GPT_VAE_vggsound.py:56-68)
sampling from the prior.  The port of scripts/xl_decode_bench.py, without
its ``--project_tp`` (an XLA memory analysis of an abstract compile
against a 16 GB budget, which has no counterpart in PyTorch).

The decoder alone (prior sampling never runs the encoder), seeded random
weights drawn on the card and cast to bfloat16, an int8 KV cache and int8
streamed block weights: ``sample_from_prior`` with a ``torch.Generator``,
then ``vae_decode(strategy="beam", top_k=100, temperature=1.0,
segments=XL_SEGMENTS)`` through the captured decode program (kernel A at
the prefill, kernel E and the int8 product's kernels every step).  The
first call builds the kernels, quantises the block weights, warms up and
captures (``compile_seconds``); three timed calls follow on the kept
program and int8 weights, each ended by ``torch.cuda.synchronize``.
``peak_gib`` is ``torch.cuda.max_memory_allocated`` from after the
weights were made to the end of the timed calls.

Prints the card (``nvidia-smi --query-gpu=name,power.limit``) and then
one JSON line with the JAX script's keys plus ``peak_gib``.  Knobs:
``XL_BATCH`` (default 64) and ``XL_SEGMENTS`` (default 8).

Usage, on a machine with the card: python3 scripts/torch_xl_decode_bench.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from melspec_gpt_vqvae_tpu_torch.configs import load_preset  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.decode_graph import \
    DecodeGraphs  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.gpt import (  # noqa: E402
    init_gpt_params, quantize_block_weights)
from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import (  # noqa: E402
    make_vae_configs, sample_from_prior, vae_decode)

B = int(os.environ.get("XL_BATCH", "64"))
SEGMENTS = int(os.environ.get("XL_SEGMENTS", "8"))
ITERS = 3


def count(tree):
    """Elements of a nested dict's leaves."""
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    return tree.numel()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None):
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_xl_decode_bench: no CUDA device; the XL "
                             "decoder is measured on the card")
        device = torch.device("cuda", 0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    device = torch.device(device)
    exp = load_preset("GPT_VAE", "vggsound")
    base = exp.model.replace(dtype="bfloat16", cache_dtype="int8",
                             decode_weight_dtype="int8")
    cfgs = make_vae_configs(base, exp.vae)
    dec = cfgs.decoder
    gen = torch.Generator(device=device)
    params = {"decoder": init_gpt_params(dec, gen.manual_seed(0), device)}
    n = count(params)
    # vae_decode runs cfgs.encoder.block_size steps
    steps = cfgs.encoder.block_size
    z = sample_from_prior(cfgs, B, gen.manual_seed(0))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    graphs = DecodeGraphs() if device.type == "cuda" else None

    def run(seed, wq):
        return vae_decode(params, cfgs, z, strategy="beam", top_k=100,
                          temperature=1.0, generator=gen.manual_seed(seed),
                          segments=SEGMENTS, graph=graphs, wq=wq)

    t0 = time.perf_counter()
    wq = quantize_block_weights(params["decoder"]["blocks"])
    toks = run(0, wq)
    sync(device)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(ITERS):
        toks = run(i + 1, wq)
    sync(device)
    dt = (time.perf_counter() - t0) / ITERS
    assert toks.shape == (B, steps), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < dec.vocab_size
    out = {
        "model": "GPT_VAE vggsound XL decoder",
        "params_b": round(n / 1e9, 3),
        "batch": B, "steps": steps, "segments": SEGMENTS,
        "decode_seconds": round(dt, 3),
        "tokens_per_sec": round(B * steps / dt, 1),
        "clips_per_sec": round(B / dt, 2),
        "compile_seconds": round(compile_s, 1),
        "peak_gib": (round(torch.cuda.max_memory_allocated(device)
                           / 2 ** 30, 2) if device.type == "cuda" else None),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
