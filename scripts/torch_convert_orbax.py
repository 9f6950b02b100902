#!/usr/bin/env python
"""Convert the JAX package's orbax checkpoints into files the PyTorch port
reads.  Runs on a host with JAX and orbax; the port itself reads no orbax.

    # a GPT run of GPT_train.py (lightning_logs/{experiment}-{dataset}/
    # checkpoints/version_*/{last,best}) -> lightning_logs/{out}-{dataset}/
    # checkpoints/version_0/{last,best}.pt + meta.json, the whole train
    # state (params, AdamW moments and count, live lr, step), which the
    # port's build_pipeline(experiment=...), sample/serve --experiment and
    # train_gpt --resume read; repeat the run's --override
    python scripts/torch_convert_orbax.py gpt --dataset vas \
        --experiment myrun [--out_experiment myrun_torch] [--override ...]
    # a native VQ-VAE params dir -> a torch file for --vqvae_ckpt
    python scripts/torch_convert_orbax.py vqvae VQ_DIR vqvae.pt
    # a native MelGAN params dir -> a dir (best_netG.pt + args.yml) for
    # --vocoder_ckpt
    python scripts/torch_convert_orbax.py vocoder VOC_DIR vocoder_torch

Run from the directory that holds ``lightning_logs``, as the CLIs are.
The GPT run is read as the JAX package's serving loader reads it
(melspec_gpt_vqvae_tpu/serving.py::_restore_gpt_params: the newest
version dir, a ``GPTTask`` template, the legacy-layout fallback) and
carried across by ``bridge.train_state_from_jax``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _versions(root):
    """``version_*`` dirs under ``root``, newest first."""
    return sorted((d for d in os.listdir(root) if d.startswith("version_")),
                  key=lambda d: int(d.split("_")[-1]), reverse=True)


def convert_gpt_run(dataset: str, experiment: str, out_experiment: str,
                    override: str = "", seed: int = 783435):
    """Write the run's ``last`` and ``best`` checkpoints (whichever exist)
    in the port's layout; returns the files written."""
    import jax
    import numpy as np
    import torch

    from melspec_gpt_vqvae_tpu.configs import load_preset, parse_overrides
    from melspec_gpt_vqvae_tpu.training.checkpoint import (CheckpointManager,
                                                           shape_template)
    from melspec_gpt_vqvae_tpu.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch import bridge

    root = os.path.join("lightning_logs", f"{experiment}-{dataset}",
                        "checkpoints")
    if not os.path.isdir(root) or not _versions(root):
        raise SystemExit(f"no checkpoints under {root}")
    exp = load_preset("GPT", dataset, **parse_overrides(override))
    state0 = GPTTask(exp).init_state(seed)
    template = {"state": shape_template(state0), "epoch": 0}
    ckpt = CheckpointManager(os.path.join(root, _versions(root)[0]))
    out_dir = os.path.join("lightning_logs", f"{out_experiment}-{dataset}",
                           "checkpoints", "version_0")
    os.makedirs(out_dir, exist_ok=True)
    meta, written = {}, []
    for which in ("last", "best"):
        found = [os.path.abspath(os.path.join(root, v, which))
                 for v in _versions(root)
                 if os.path.exists(os.path.join(root, v, which))]
        if not found:
            continue
        restored = ckpt.restore(found[0], template=template,
                                defaults={"state": state0, "epoch": 0})
        st = restored["state"]
        tree = bridge.train_state_from_jax(
            jax.tree_util.tree_map(np.asarray, st["params"]),
            st["opt_state"], st["step"])
        path = os.path.join(out_dir, f"{which}.pt")
        torch.save({"state": tree, "epoch": int(restored["epoch"])}, path)
        written.append(path)
        mp = os.path.join(os.path.dirname(found[0]), "meta.json")
        if os.path.exists(mp):
            with open(mp) as f:
                src = json.load(f)
            keys = (("best_metric", "best_step") if which == "best"
                    else ("last_step", "last_batch_idx"))
            meta.update({k: src[k] for k in keys if k in src})
    if not written:
        raise SystemExit(f"no 'last' or 'best' checkpoint under {root}")
    meta = {"best_metric": None, "best_step": None, "last_step": None,
            **meta}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return written


def convert_conv_net(kind: str, src: str, out: str):
    """A native VQ-VAE (``kind`` "vqvae") or MelGAN ("vocoder") params dir
    -> the port's state dict: a file for the VQ-VAE, a ``best_netG.pt`` +
    ``args.yml`` dir for the MelGAN."""
    import torch

    from melspec_gpt_vqvae_tpu.configs import VQVAEConfig
    from melspec_gpt_vqvae_tpu.utils import convert as jconvert
    from melspec_gpt_vqvae_tpu_torch import bridge

    if kind == "vqvae":
        tree = jconvert.load_vqvae_params(src, VQVAEConfig())
        torch.save(bridge.conv_state_dict(tree), out)
        return [out]
    tree, cfg = jconvert.load_vocoder_params(src)
    os.makedirs(out, exist_ok=True)
    torch.save(bridge.conv_state_dict(tree),
               os.path.join(out, "best_netG.pt"))
    with open(os.path.join(out, "args.yml"), "w") as f:
        f.write(f"n_mel_channels: {cfg.n_mel_channels}\nngf: {cfg.ngf}\n"
                f"n_residual_layers: {cfg.n_residual_layers}\n")
    return [out]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="kind", required=True)
    g = sub.add_parser("gpt", help="a GPT run checkpoint")
    g.add_argument("--dataset", type=str, default="vas")
    g.add_argument("--experiment", type=str, required=True)
    g.add_argument("--out_experiment", type=str, default=None,
                   help="the port's run name (default: {experiment}_torch; "
                        "a run dir of its own, so the JAX run's meta.json "
                        "is never overwritten)")
    g.add_argument("--override", type=str, default="")
    g.add_argument("--seed", type=int, default=783435)
    for kind in ("vqvae", "vocoder"):
        c = sub.add_parser(kind, help=f"a native {kind} params dir")
        c.add_argument("src")
        c.add_argument("out")
    args = p.parse_args(argv)
    if args.kind == "gpt":
        written = convert_gpt_run(args.dataset, args.experiment,
                                  args.out_experiment
                                  or f"{args.experiment}_torch",
                                  args.override, args.seed)
    else:
        written = convert_conv_net(args.kind, args.src, args.out)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
