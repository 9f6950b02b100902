"""Online serving CLI of the PyTorch port: an HTTP endpoint for
class-conditional clip generation, or for clips from a GPT-VAE's prior.

    python -m melspec_gpt_vqvae_tpu_torch.serve --dataset vas \\
        --experiment myrun --resume best --batch 8 --port 8000 \\
        [--vqvae_ckpt vqvae.ckpt] [--vocoder_ckpt vocoder/logs/vggsound]
    curl -o clip.wav 'localhost:8000/generate?class=3&top_p=0.9'
    python -m melspec_gpt_vqvae_tpu_torch.serve --model GPT_VAE \\
        --dataset vggsound --init_random --batch 8 --port 8000
    curl -o clip.wav 'localhost:8000/generate'      # one prior clip

API (the JAX package's, serving.py there; JSON in, WAV or JSON out):
  GET  /healthz                 -> {"status": "ok", platform, model, ...}
  GET  /generate?class=3        -> audio/wav (one 10-second clip)
  POST /generate {"classes": [0, 1], "num": 2, "temperature": 1.0,
                  "top_k": 100, "top_p": 0.9, "deterministic": false,
                  "seed": 7, "format": "json"}
       -> {"clips": [{"class": 0, "wav_base64": ...}, ...], ...}
  With --model GPT_VAE a request is ``num`` clips from the prior (its
  latents drawn from the request's seed; "class" and "classes" do not
  apply) and each clip of the JSON body has ``wav_base64`` alone.

The counterpart of the repository's ``serve.py``, with its flags minus
``--platform`` and plus ``--device`` (the card unless ``--device cpu``).
``--mesh data=2,model=2`` serves over one process a GPU, launched by
``torchrun --nproc_per_node 4 -m melspec_gpt_vqvae_tpu_torch.serve ...``
(gloo with ``--device cpu``): rank 0 binds the HTTP server and leads, the
other ranks follow it (serving.py); an interrupt of rank 0 (SIGINT) stops
them all.  Requests are padded to the fixed ``--batch``; the
first request of a sampling shape captures its decode program, which the
start-up warm-up does for the default knobs.  ``--artifact`` serves a
``torch.export`` artifact of scripts/torch_export_serving.py instead: its
sidecar fixes the batch and the sampling knobs (a request with others gets
400), the weights come from the pipeline these flags build, and the
warm-up runs the one baked mode.
"""

from __future__ import annotations

import argparse
import os

from .parallel.mesh import is_primary, shutdown_distributed
from .sample import pipeline_from_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, default="GPT",
                   choices=["GPT", "GPT_VAE"],
                   help="GPT: class-conditional; GPT_VAE: clips from a "
                        "GPT-VAE's prior")
    p.add_argument("--dataset", type=str, default="vas",
                   choices=["vas", "vggsound"])
    p.add_argument("--experiment", type=str, default=None)
    p.add_argument("--resume", type=str, default="best")
    p.add_argument("--init_random", action="store_true",
                   help="random GPT weights (no checkpoint; smoke/demo)")
    p.add_argument("--vqvae_ckpt", type=str, default=None)
    p.add_argument("--vocoder_ckpt", type=str, default=None)
    p.add_argument("--batch", type=int, default=8,
                   help="fixed serving batch (one captured decode program "
                        "a sampling shape)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--segments", type=int, default=8)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--seed", type=int, default=783435)
    p.add_argument("--kv_cache", type=str, default=None,
                   choices=["auto", "int8"])
    p.add_argument("--int8_weights", type=int, default=None)
    p.add_argument("--int8_decode", action="store_true",
                   help="calibrated int8 VQ-decoder + vocoder convs (an "
                        "experiment, as in the JAX package; replaces "
                        "kernel B)")
    p.add_argument("--mesh", type=str, default="",
                   help="serve over one process a GPU under torchrun, e.g. "
                        "'data=4' (batch sharded) or 'data=2,model=2' "
                        "(Megatron-TP GPT weights + head-sharded KV cache); "
                        "default: one device")
    p.add_argument("--override", type=str, default="")
    p.add_argument("--draft_experiment", type=str, default=None,
                   help="speculative decoding: run name of a smaller GPT "
                        "draft (exact target distribution, lower latency)")
    p.add_argument("--draft_resume", type=str, default="best")
    p.add_argument("--draft_override", type=str, default="")
    p.add_argument("--draft_random", type=str, default="",
                   help="random-init draft config (mechanics smoke)")
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--artifact", type=str, default="",
                   help="serve from a torch.export artifact "
                        "(scripts/torch_export_serving.py): no capture; "
                        "the batch and sampling knobs come from its "
                        "sidecar and differing requests get a 400")
    p.add_argument("--max_queue", type=int, default=16,
                   help="bounded request queue: requests beyond this many "
                        "in flight get 503 + Retry-After (load shedding)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 takes a free port (printed)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the start-up warm-up (the first request "
                        "pays for the capture)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    return p.parse_args(argv)


def start(argv=None):
    """Build the pipeline and the service, warm up and bind the server;
    returns the ``ThreadingHTTPServer`` (``main`` serves it until
    interrupted).  Over a mesh only rank 0 binds one: every other rank
    follows rank 0's batches here until it stops them, and then gets
    None."""
    from .serving import GenerationService, serve

    args = parse_args(argv)
    if args.artifact and (args.mesh or args.draft_experiment
                          or args.draft_random or args.int8_decode):
        # refused before build_pipeline: these would build (a mesh, a
        # draft, the int8 calibration) what the artifact then leaves
        # unused
        raise SystemExit("--artifact is single-device, no draft, no "
                         "--int8_decode (export.py contract)")
    exp, pipe = pipeline_from_args(args)
    if args.artifact:
        # the artifact's sidecar fixes batch and knobs; the weights are the
        # pipeline's, cast to the dtypes the artifact was traced with
        from .export import ArtifactPipeline
        pipe = ArtifactPipeline.from_file(args.artifact, pipe)
        m = pipe.meta
        svc = GenerationService(
            exp, pipe, batch=pipe.batch, seed=args.seed,
            temperature=m["temperature"], top_k=m["top_k"],
            top_p=m["top_p"], max_queue=args.max_queue)
        print(f"artifact: {args.artifact} (batch {pipe.batch}, "
              f"temperature {m['temperature']}, top_k {m['top_k']}, "
              f"top_p {m['top_p']}, sample {m['sample']})")
    else:
        svc = GenerationService(
            exp, pipe, batch=args.batch, seed=args.seed,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p if 0.0 < args.top_p < 1.0 else None,
            max_queue=args.max_queue)
    if svc.mesh is not None and not is_primary():
        print(f"rank {svc.mesh.rank}: following rank 0", flush=True)
        svc.follow()
        return None
    if not args.no_warmup:
        svc.warmup()
    httpd = serve(svc, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} (batch {svc.batch}, "
          f"{pipe.device}, pid {os.getpid()})", flush=True)
    return httpd


def main(argv=None):
    import torch.distributed as dist
    joined = dist.is_initialized()
    try:
        httpd = start(argv)
        if httpd is None:   # a follower, stopped by rank 0
            return
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
            httpd.service.stop_followers()
            graphs = getattr(httpd.service.pipe, "graphs", None)
            if graphs is not None:   # before the group they recorded goes
                graphs.clear()
    finally:
        if not joined:   # the group --mesh joined, not the caller's
            shutdown_distributed()


if __name__ == "__main__":
    main()
