#!/usr/bin/env python3
"""Training measurements of the PyTorch port on one card, apart from the
whole smoke run.

    python3 scripts/torch_train_probe.py [--skip_vae]
    python3 scripts/torch_train_probe.py --dataset vggsound

From the repository root on a machine with an NVIDIA card.  TF32 off, as
in chip_smoke.py.  ``--dataset vggsound`` measures the XL GPT-VAE's train
step alone (``GPT_VAE_vggsound``: 40 layers, 23 heads, 1472 wide, 2.09B
parameters, AdamW, the preset's mixed precision and remat ``attn``, its
batch of 1, kernel F): ms a step (steps 3-6 of 6), tokens/s, peak GiB and
the launches of kernel F a step.  The VAS presets (default) print:

1. one (24 x 265) x 1,024 x 4,096 product in float32, in bfloat16 with a
   float32 result (``torch.mm(..., out_dtype=torch.float32)``, the mixed-
   precision product of ``models/gpt.py::_dot``) and in bfloat16, ms and
   TFLOP/s (CUDA events), and whether autograd has a derivative for the
   float32-result product;
2. kernels F and A against their plain versions at the GPT-VAE's shapes,
   timed (``chip_smoke.check_vae_kernels``);
3. the class GPT's full-width flash step at batch 8, float32 and mixed
   precision (``chip_smoke.timed_steps``), and the mixed step's device ms
   by kernel class (``chip_smoke.profile_train_step``);
4. unless ``--skip_vae``: chip_smoke's GPT-VAE phase (``vae_check``) on
   random stand-ins for the battery's mels and codes.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def gemm_probe(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(24 * 265, 1024, generator=g, device=dev)
    w = torch.randn(1024, 4096, generator=g, device=dev)
    ab, wb = a.bfloat16(), w.bfloat16()
    flops = 2 * a.shape[0] * 1024 * 4096
    for name, fn in (("float32", lambda: a @ w),
                     ("bf16 -> float32", lambda: torch.mm(
                         ab, wb, out_dtype=torch.float32)),
                     ("bf16", lambda: ab @ wb)):
        ms = cs.cuda_ms(fn)
        print(f"  product {tuple(a.shape)} x {tuple(w.shape)} {name}: "
              f"{ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
    err = (torch.mm(ab, wb, out_dtype=torch.float32)
           - ab.float() @ wb.float()).abs().max().item()
    try:
        x = ab.clone().requires_grad_(True)
        torch.mm(x, wb, out_dtype=torch.float32).sum().backward()
        grad = "has a derivative"
    except RuntimeError as e:
        grad = f"no derivative ({str(e)[:60]})"
    print(f"  mm(out_dtype=float32) against the float32 product of the "
          f"rounded operands: max|err| {err:.3g}; autograd: {grad}")


def gpt_steps(dev):
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    rng = np.random.default_rng(0)
    batch = {"codes": rng.integers(0, 128, (8, 5, 53)),
             "target": rng.integers(0, 8, (8,))}
    task = GPTTask(cs.load_vas_exp(use_flash_train=True), dev)
    state = task.init_state()
    for mixed in (False, True):
        t = GPTTask(cs.load_vas_exp(use_flash_train=True,
                                    mixed_precision=mixed), dev)
        _, ms, mem = cs.timed_steps(t, state, batch, 10)
        print(f"  class GPT flash step, batch 8, mixed_precision {mixed}: "
              f"{ms:.1f} ms, {8 * 265 / (ms / 1e3):.0f} tokens/s, peak "
              f"{mem / 2 ** 30:.2f} GiB")
    cs.profile_train_step(t, state, batch, "class GPT, mixed precision",
                          t.cfg.n_layer)


XL_STEPS = 6


def xl_vae_task(dev, mesh=None, override=""):
    """``VAETask`` of the ``GPT_VAE_vggsound`` preset with kernel F, over
    ``mesh`` (None: one card), and a seeded batch of the preset's size.
    ``override``: preset overrides (a narrow rehearsal on the CPU)."""
    from melspec_gpt_vqvae_tpu_torch.configs import (load_preset,
                                                     parse_overrides)
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
    exp = load_preset("GPT_VAE", "vggsound", **{
        "use_flash_train": True, **parse_overrides(override)})
    rng = np.random.default_rng(0)
    batch = {"codes": rng.integers(0, exp.model.vocab_size, (
        exp.train.batch_size, 5, 53)).astype(np.int64)}
    return VAETask(exp, 1, dev, mesh), batch


def xl_steps(dev):
    """The XL GPT-VAE's train step on one card (see the docstring)."""
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    task, batch = xl_vae_task(dev)
    cfg = task.cfgs.encoder
    state = task.init_state(7)
    n = sum(t.numel() for t in _leaves(state["params"]))
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    losses, ms, mem = cs.timed_steps(task, state, batch, XL_STEPS)
    b = len(batch["codes"])
    print(f"  XL GPT-VAE step ({cfg.n_layer} L / {cfg.n_head} H / "
          f"{cfg.n_embd} d, {n / 1e9:.3f}B parameters, batch {b}, mixed "
          f"precision {cfg.mixed_precision}, remat {cfg.remat_policy}): "
          f"{ms:.1f} ms, {b * 265 / (ms / 1e3):.0f} tokens/s, peak "
          f"{mem / 2 ** 30:.2f} GiB; F launches a step "
          f"{flash_attention_fwd.launches // XL_STEPS} / "
          f"{flash_attention_bwd.launches // XL_STEPS}; losses "
          f"{[round(x, 4) for x in losses]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--skip_vae", action="store_true")
    p.add_argument("--dataset", default="vas", choices=["vas", "vggsound"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_probe: no CUDA device")
    from melspec_gpt_vqvae_tpu_torch import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    _build.load()
    if args.dataset == "vggsound":
        xl_steps(dev)
        return
    gemm_probe(dev)
    cs.check_vae_kernels(dev)
    gpt_steps(dev)
    torch.cuda.empty_cache()
    if not args.skip_vae:
        rng = np.random.default_rng(0)
        mels = torch.from_numpy(rng.uniform(0, 1, (48, 80, 848))
                                .astype(np.float32))
        codes = torch.from_numpy(rng.integers(0, 128, (48, 265)))
        t0 = time.perf_counter()
        cs.vae_check(dev, mels, codes)
        print(f"  vae_check: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
