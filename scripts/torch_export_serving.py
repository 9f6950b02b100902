#!/usr/bin/env python
"""Export the PyTorch port's serving pipeline as a ``torch.export`` artifact.

The counterpart of scripts/export_serving.py for
melspec_gpt_vqvae_tpu_torch: builds the same pipeline as the port's
``sample`` / ``serve`` entry points (``serving.build_pipeline``), traces
it at a fixed serving batch with the given sampling knobs, kernel-free,
and writes the artifact and its ``.json`` sidecar
(melspec_gpt_vqvae_tpu_torch/export.py documents the contract).  The same
flags as the JAX script minus ``--platforms`` / ``--platform``, plus
``--device``: the artifact is traced on the card unless ``--device cpu``,
and serves on that device type only.

Usage:
  python scripts/torch_export_serving.py --dataset vas --experiment my_gpt \\
      --resume best --vqvae_ckpt vq.ckpt --vocoder_ckpt vocoder/logs/x \\
      --batch 8 --temperature 1.0 --top_k 100 --out pipe_b8.pt2
  # smoke: --init_random skips checkpoints
  python -m melspec_gpt_vqvae_tpu_torch.serve --init_random \\
      --artifact pipe_b8.pt2          # serve it (batch and knobs from it)

The last line of the output is a JSON summary (export seconds, bytes).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="vas")
    p.add_argument("--experiment", default=None)
    p.add_argument("--resume", default="best")
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--vqvae_ckpt", default=None)
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("--override", default="")
    p.add_argument("--seed", type=int, default=783435,
                   help="random weights' seed (--init_random)")
    p.add_argument("--kv_cache", default=None, choices=["auto", "int8"])
    p.add_argument("--int8_weights", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--deterministic", action="store_true",
                   help="bake greedy decode instead of sampling")
    p.add_argument("--segments", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to trace on and serve from, e.g. "
                        "'cuda' or 'cpu'")
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from melspec_gpt_vqvae_tpu_torch import export as aot
    from melspec_gpt_vqvae_tpu_torch.serving import build_pipeline

    # the default pipeline: the export traces its kernel-free program
    _, pipe = build_pipeline(
        args.dataset, experiment=args.experiment, resume=args.resume,
        init_random=args.init_random, vqvae_ckpt=args.vqvae_ckpt,
        vocoder_ckpt=args.vocoder_ckpt, override=args.override,
        seed=args.seed, segments=args.segments, kv_cache=args.kv_cache,
        int8_weights=args.int8_weights, device=args.device)
    knobs = dict(temperature=args.temperature, top_k=args.top_k or None,
                 top_p=args.top_p, sample=not args.deterministic)
    t0 = time.perf_counter()
    ep = aot.export_serving(pipe, args.batch, **knobs)
    seconds = time.perf_counter() - t0
    meta = aot.artifact_meta(pipe, args.batch, dataset=args.dataset, **knobs)
    n = aot.save_exported(ep, args.out, meta)
    print(f"wrote {args.out}: {n / 1e6:.2f} MB, batch={args.batch}, "
          f"device={pipe.device.type}, temperature={args.temperature} "
          f"top_k={args.top_k} top_p={args.top_p} "
          f"sample={not args.deterministic}; traced in {seconds:.1f} s")
    print("serve with: python -m melspec_gpt_vqvae_tpu_torch.serve "
          f"--artifact {args.out} (and the flags that built these weights)")
    summary = {"out": args.out, "bytes": n, "export_seconds": seconds,
               "graphs": aot.check_kernel_free(ep), **meta}
    del summary["weight_dtypes"]
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
