"""Batch generation CLI of the PyTorch port: class-conditional 10-second
clips from a GPT run checkpoint, or clips sampled from a GPT-VAE's prior,
written as WAV files.

    python -m melspec_gpt_vqvae_tpu_torch.sample --dataset vas \\
        --experiment myrun --resume best --classes all --num 4 \\
        --out_dir samples [--vqvae_ckpt vqvae.ckpt] \\
        [--vocoder_ckpt vocoder/logs/vggsound]
    python -m melspec_gpt_vqvae_tpu_torch.sample --init_random --num 1 \\
        --classes 0,3 --out_dir /tmp/smoke      # random weights
    python -m melspec_gpt_vqvae_tpu_torch.sample --model GPT_VAE \\
        --dataset vggsound --init_random --num 256 --batch 256 \\
        --out_dir /tmp/prior    # the XL GPT-VAE's prior, random weights

``--model GPT_VAE`` (``--dataset vas`` or ``vggsound``) samples ``--num``
clips from the prior of a ``train_gpt_vae`` run's decoder (or random
weights): each batch draws its latents z ~ N(0, I) and decodes from them
(``--classes`` does not apply); the clips are ``prior_MMM.wav``.

The counterpart of the repository's ``sample.py``, with its flags minus
the JAX-only ``--platform`` and plus ``--device`` (the card unless
``--device cpu``).  ``--mesh data=2,model=2`` samples over one process a
GPU under ``torchrun --nproc_per_node 4 -m
melspec_gpt_vqvae_tpu_torch.sample ...`` (gloo with ``--device cpu``):
a tail batch is padded to the data axis and only its real clips are
written, by rank 0 alone.  The GPT checkpoint is the port's own
(``train_gpt``'s ``lightning_logs/{experiment}-{dataset}``; an orbax run
of the JAX package converts with ``scripts/torch_convert_orbax.py``).
Each batch of clips is sampled from a ``torch.Generator`` seeded by one
draw from a generator seeded with ``--seed``: JAX's key stream cannot be
reproduced.  Writes ``classNN_MMM.wav`` (and ``_codes.npy`` /
``_mel.npy`` with ``--save_codes`` / ``--save_spec``); the last line of
the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, default="GPT",
                   choices=["GPT", "GPT_VAE"],
                   help="GPT: class-conditional; GPT_VAE: clips from a "
                        "GPT-VAE's prior")
    p.add_argument("--dataset", type=str, default="vas",
                   choices=["vas", "vggsound"],
                   help="the class-conditional GPT has a VAS preset only; "
                        "the GPT-VAE both")
    p.add_argument("--experiment", type=str, default=None,
                   help="run name: the checkpoint is read from "
                        "lightning_logs/{experiment}-{dataset}/checkpoints")
    p.add_argument("--resume", type=str, default="best",
                   help="'best', 'last', or a checkpoint file")
    p.add_argument("--init_random", action="store_true",
                   help="random GPT weights (no checkpoint; smoke/demo)")
    p.add_argument("--vqvae_ckpt", type=str, default=None,
                   help="reference torch VQ-VAE checkpoint (frozen "
                        "decoder); random init if omitted")
    p.add_argument("--vocoder_ckpt", type=str, default=None,
                   help="MelGAN log dir (best_netG.pt + args.yml); random "
                        "init if omitted")
    p.add_argument("--classes", type=str, default="all",
                   help="'all' or comma-separated class indices")
    p.add_argument("--num", type=int, default=4,
                   help="clips per class (GPT_VAE: clips in all)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling threshold in (0,1]; 0/1 disable "
                        "(applies after --top_k)")
    p.add_argument("--deterministic", action="store_true",
                   help="greedy decode (reference sample(sample=False))")
    p.add_argument("--segments", type=int, default=8)
    p.add_argument("--chunk", type=int, default=128,
                   help="conv-stage chunk size (bounds activation memory)")
    p.add_argument("--seed", type=int, default=783435)
    p.add_argument("--out_dir", type=str, default="samples")
    p.add_argument("--save_codes", action="store_true")
    p.add_argument("--save_spec", action="store_true")
    p.add_argument("--kv_cache", type=str, default=None,
                   choices=["auto", "int8"],
                   help="default: int8 on the card, auto on the CPU")
    p.add_argument("--int8_weights", type=int, default=None,
                   help="stream int8 decode weights (default: 1 on the "
                        "card)")
    p.add_argument("--int8_decode", action="store_true",
                   help="calibrated int8 VQ-decoder + vocoder convs (an "
                        "experiment, as in the JAX package; replaces "
                        "kernel B)")
    p.add_argument("--mesh", type=str, default="",
                   help="sample over one process a GPU under torchrun, "
                        "e.g. 'data=4' (batch sharded) or 'data=2,model=2' "
                        "(Megatron-TP GPT weights + head-sharded KV "
                        "cache); default: one device")
    p.add_argument("--override", type=str, default="",
                   help="comma k=v preset overrides, e.g. "
                        "'n_layer=2,n_embd=32'; repeat the run's own")
    p.add_argument("--draft_experiment", type=str, default=None,
                   help="speculative decoding: run name of a smaller GPT "
                        "to use as the draft (exact target distribution)")
    p.add_argument("--draft_resume", type=str, default="best")
    p.add_argument("--draft_override", type=str, default="",
                   help="draft preset overrides, e.g. 'n_layer=4'")
    p.add_argument("--draft_random", type=str, default="",
                   help="random-init draft config (mechanics smoke), "
                        "e.g. 'n_layer=2'")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    return p.parse_args(argv)


def pipeline_from_args(args):
    """``build_pipeline`` with the flags the serve and sample CLIs share;
    ``--device cuda`` without a card raises there."""
    from .serving import build_pipeline
    if args.model == "GPT" and args.dataset != "vas":
        raise SystemExit(f"--model GPT has no {args.dataset} preset (the "
                         "class-conditional GPT is VAS only)")
    return build_pipeline(
        args.dataset, model=args.model, experiment=args.experiment,
        resume=args.resume,
        init_random=args.init_random, vqvae_ckpt=args.vqvae_ckpt,
        vocoder_ckpt=args.vocoder_ckpt, override=args.override,
        seed=args.seed, segments=args.segments, chunk=args.chunk,
        kv_cache=args.kv_cache, int8_weights=args.int8_weights,
        device=args.device, mesh_spec=args.mesh,
        draft_experiment=args.draft_experiment,
        draft_resume=args.draft_resume, draft_override=args.draft_override,
        draft_random=args.draft_random, gamma=args.gamma,
        int8_decode=args.int8_decode)


def main(argv=None):
    """Run the CLI; returns the summary it prints last (None off rank 0 of
    a mesh).  A process group that ``--mesh`` joined is left at the end;
    one the caller had joined is kept."""
    import torch.distributed as dist

    from .parallel.mesh import shutdown_distributed
    joined = dist.is_initialized()
    try:
        return _sample(parse_args(argv))
    finally:
        if not joined:
            shutdown_distributed()


def _sample(args):
    import numpy as np
    import torch

    from .parallel.mesh import data_size, is_primary
    from .pipeline import write_wav

    exp, pipe = pipeline_from_args(args)
    dp = data_size(pipe.mesh)
    primary = is_primary()
    prior = pipe.prompt == "latent"
    if prior:   # the pipeline draws each clip's latent
        names = [f"prior_{i:03d}" for i in range(args.num)]
    else:
        if args.classes == "all":
            classes = list(range(exp.model.class_size))
        else:
            classes = [int(c) for c in args.classes.split(",")]
        requests = np.repeat(np.asarray(classes, np.int32), args.num)
        counters, names = {}, []
        for c in requests:
            i = counters.get(int(c), 0)
            counters[int(c)] = i + 1
            names.append(f"class{int(c):02d}_{i:03d}")
    if primary:
        os.makedirs(args.out_dir, exist_ok=True)
    seeds = torch.Generator().manual_seed(args.seed)
    t0 = time.time()
    written = 0
    spec_agg = {"rounds": 0, "drafted": 0, "accepted": 0}
    for start in range(0, len(names), args.batch):
        batch_names = names[start:start + args.batch]
        n_real = len(batch_names)
        pad = -n_real % dp   # pad the tail to the data axis; not written
        if prior:
            prompt = n_real + pad
        else:
            prompt = requests[start:start + n_real]
            prompt = np.concatenate([prompt, np.repeat(prompt[-1:], pad)])
        s = int(torch.randint(2 ** 62, (1,), generator=seeds))
        gen = torch.Generator(device=pipe.device).manual_seed(s)
        out = pipe.generate(prompt, gen, temperature=args.temperature,
                            top_k=args.top_k or None,   # 0 disables
                            top_p=(args.top_p
                                   if 0.0 < args.top_p < 1.0 else None),
                            sample=not args.deterministic)
        if out is None:   # another rank of the mesh: rank 0 writes
            continue
        for f in spec_agg:   # run-level stats, not the last batch's
            spec_agg[f] += out.get("spec_stats", {}).get(f, 0)
        for j, name in enumerate(batch_names):
            stem = os.path.join(args.out_dir, name)
            write_wav(stem + ".wav", out["wavs"][j], exp.data.sample_rate)
            if args.save_codes:
                np.save(stem + "_codes.npy", out["tokens"][j])
            if args.save_spec:
                np.save(stem + "_mel.npy", out["specs"][j])
            written += 1
    if not primary:
        return None
    dt = time.time() - t0
    summary = {"written": written, "out_dir": args.out_dir,
               "seconds": round(dt, 2),
               "clips_per_sec": round(written / dt, 2)}
    if spec_agg["drafted"]:
        spec_agg["accept_rate"] = round(
            spec_agg["accepted"] / spec_agg["drafted"], 4)
        summary["speculative"] = spec_agg
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
