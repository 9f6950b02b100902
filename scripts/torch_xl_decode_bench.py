#!/usr/bin/env python
"""XL serving datapoint on the card: the VGGSound GPT-VAE's decoder (40
layers, 23 heads, 1472 wide, vocab 1024, block 266; the
``GPT_VAE_vggsound`` preset, reference config_GPT_VAE_vggsound.py:56-68)
sampling from the prior, on one card or cut over a ``model`` axis.  The
port of scripts/xl_decode_bench.py, without its ``--project_tp`` (an XLA
memory analysis of an abstract compile against a 16 GB budget, which has
no counterpart in PyTorch).

The decoder alone (prior sampling never runs the encoder), seeded random
weights drawn on the card, cast to bfloat16 and kept on the host; an int8
KV cache and int8 streamed block weights, each block matrix quantised
whole on the host and then cut (``parallel/mesh.py::shard_block_weight``;
the whole matrix on one card), the float leaves cut by
``shard_gpt_for_serving``, so that only this rank's parts reach its card:
``sample_from_prior`` with a ``torch.Generator``, then
``vae_decode(strategy="beam", top_k=100, temperature=1.0,
segments=XL_SEGMENTS)`` through the captured decode program (kernel A at
the prefill, kernel E and the int8 product's kernels every step).  The
first call quantises, warms up and captures (``compile_seconds``); three
timed calls follow on the kept program and int8 weights, each ended by
``torch.cuda.synchronize``.  ``peak_gib`` is
``torch.cuda.max_memory_allocated`` from before the weights reach the
card to the end of the timed calls.

``--mesh model=N`` (under ``torchrun --nproc_per_node N``) cuts the
decoder over N cards: 23 heads, which no N > 1 divides, go 12, 11 over 2
and 6, 6, 6, 5 over 4 (``head_range``), the KV cache with them; every
rank decodes the whole batch, its row-cut products summed over the model
group.  Rank 0 prints the card (``nvidia-smi
--query-gpu=name,power.limit``) and one JSON line with the JAX script's
keys plus ``peak_gib`` (rank 0's), and under a mesh ``mesh``,
``heads_by_rank``, ``peak_gib_by_rank`` and rank 0's
``launches_a_decode`` (kernel A, kernel E and the int8 product's kernels,
a timed call's).  Knobs:
``XL_BATCH`` (default 64) and ``XL_SEGMENTS`` (default 8).

Usage, on a machine with the card:
python3 scripts/torch_xl_decode_bench.py
torchrun --standalone --nproc_per_node 4 scripts/torch_xl_decode_bench.py \\
    --mesh model=4
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from melspec_gpt_vqvae_tpu_torch.configs import (  # noqa: E402
    load_preset, parse_overrides)
from melspec_gpt_vqvae_tpu_torch.models.decode_graph import \
    DecodeGraphs  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.gpt import (  # noqa: E402
    BLOCK_MATRICES, init_gpt_params, quantize_block_weight, tree_to)
from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import (  # noqa: E402
    make_vae_configs, sample_from_prior, vae_decode)
from melspec_gpt_vqvae_tpu_torch.ops import int8_linear  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops.attention import attend  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops.decode_attention import \
    decode_attend_int8  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.parallel import mesh as pm  # noqa: E402

# the kernels a decode launches (each wrapper counts its own launches,
# the captured program's replays included)
KERNELS = {"A": attend, "E": decode_attend_int8,
           "quantize_rows": int8_linear.quantize_rows,
           "rescale_bias": int8_linear.rescale_bias,
           "row_scales": int8_linear.row_scales,
           "int8_linear_splitk": int8_linear.int8_linear_splitk}
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


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def xl_decoder(device, override=""):
    """(the VAE configs, the decoder's full tree on the host in bfloat16):
    drawn on ``device`` from seed 0, as every rank draws it.  ``override``:
    preset overrides (a narrow rehearsal on the CPU)."""
    exp = load_preset("GPT_VAE", "vggsound", **parse_overrides(override))
    base = exp.model.replace(dtype="bfloat16", cache_dtype="int8",
                             decode_weight_dtype="int8")
    cfgs = make_vae_configs(base, exp.vae)
    gen = torch.Generator(device=device).manual_seed(0)
    tree = tree_to(init_gpt_params(cfgs.decoder, gen, device),
                   device="cpu")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cfgs, tree


def decode_bench(cfgs, host, device, mesh=None, batch=None):
    """(the JSON row of rank 0, None elsewhere; the tokens of the last
    timed call, on every rank): the decoder cut over ``mesh`` (None: the
    whole of it on this card) decodes ``batch`` prior samples (default
    ``XL_BATCH``) in ``XL_SEGMENTS`` segments."""
    batch = B if batch is None else batch
    dec = cfgs.decoder
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    wq = {name: pm.shard_block_weight(
        mesh, name, quantize_block_weight(host["blocks"][name]["w"]),
        dec.n_head, device) for name in BLOCK_MATRICES}
    params = {"decoder": pm.shard_gpt_for_serving(mesh, host, dec.n_head,
                                                  device)}
    gen = torch.Generator(device=device)
    # vae_decode runs cfgs.encoder.block_size steps
    steps = cfgs.encoder.block_size
    z = sample_from_prior(cfgs, batch, gen.manual_seed(0))
    graphs = DecodeGraphs() if device.type == "cuda" else None

    def run(seed):
        return vae_decode(params, cfgs, z, strategy="beam", top_k=100,
                          temperature=1.0, generator=gen.manual_seed(seed),
                          segments=SEGMENTS, graph=graphs, wq=wq, mesh=mesh)

    toks = run(0)
    sync(device)
    compile_s = time.perf_counter() - t0

    for w in KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    for i in range(ITERS):
        toks = run(i + 1)
    sync(device)
    dt = (time.perf_counter() - t0) / ITERS
    launches = {k: w.launches // ITERS for k, w in KERNELS.items()}
    assert toks.shape == (batch, steps), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < dec.vocab_size
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    peaks = [peak]
    if mesh is not None and mesh.active(pm.MODEL_AXIS):
        import torch.distributed as dist
        peaks = [None] * mesh.size(pm.MODEL_AXIS)
        dist.all_gather_object(peaks, peak, group=mesh.group(pm.MODEL_AXIS))
    del graphs, params, wq, run
    if device.type == "cuda":
        gc.collect()   # the captured programs hold their buffers in a cycle
        torch.cuda.empty_cache()
    if not pm.is_primary():
        return None, toks
    out = {
        "model": "GPT_VAE vggsound XL decoder",
        "params_b": round(count(host) / 1e9, 3),
        "batch": batch, "steps": steps, "segments": SEGMENTS,
        "decode_seconds": round(dt, 3),
        "tokens_per_sec": round(batch * steps / dt, 1),
        "clips_per_sec": round(batch / dt, 2),
        "compile_seconds": round(compile_s, 1),
        "peak_gib": None if peak is None else round(peak, 2),
    }
    if mesh is not None:
        out.update(mesh=mesh.shape, launches_a_decode=launches,
                   heads_by_rank=pm.head_counts(
            dec.n_head, mesh.size(pm.MODEL_AXIS)),
            peak_gib_by_rank=[None if p is None else round(p, 2)
                              for p in peaks])
    return out, toks


def main(device=None, mesh_spec=""):
    """One run (see the docstring); ``mesh_spec`` "model=N" under a
    launcher of N processes."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_xl_decode_bench: no CUDA device; the XL "
                             "decoder is measured on the card")
        device = pm.maybe_init_distributed("cuda")
        if pm.is_primary():
            print(card(), flush=True)
    device = torch.device(device)
    mesh = None
    if mesh_spec:
        shape = pm.parse_mesh(mesh_spec)
        if set(shape) != {pm.MODEL_AXIS}:
            raise SystemExit("--mesh: a model axis alone (model=N)")
        mesh = pm.make_mesh(shape, device)
    try:
        cfgs, host = xl_decoder(device)
        out, _ = decode_bench(cfgs, host, device, mesh)
        if out is not None:
            print(json.dumps(out), flush=True)
    finally:
        pm.shutdown_distributed()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="",
                    help="model=N under torchrun --nproc_per_node N "
                         "(default: one card)")
    main(mesh_spec=ap.parse_args().mesh)
