#!/usr/bin/env python
"""Reference-scale VQ-GAN proof of the PyTorch port on the card: the port
of scripts/quality_vqgan_fullscale.py.

QUALITY_TORCH.json's adversarial phase runs at reduced geometry (ch 32, 1
res block, no attention, ndf 16).  Here the ``VQVAEConfig`` preset itself
-- ch 128, ch_mult (1, 1, 2, 2, 4), 2 res blocks, attention at 53, z 256,
the NLayerDiscriminator at ndf 64 with 3 layers (reference
big_model_attn_gan.py:521-602) -- goes through both phases on the card:
reconstruction and VQ (kernel C twice an iteration), then the adversarial
phase (hinge discriminator, the adaptive generator weight from the two
gradient norms).  The geometry is untouched; only the schedule moves, as
in the JAX script: ``disc_start`` at ``RECON_STEPS`` so the adversarial
phase is reached, 200 + 200 steps at batch 4 on the tone battery's mels.
cuDNN runs its deterministic algorithms throughout: the adversarial phase
amplifies the last-bit differences of the default convolution backward
passes, which made a learning check go either way between two runs
(ROADMAP C8).

Gates (quality_vqgan_fullscale.py:115-130, unchanged): the reconstruction
learns (below half its first step's); the discriminator factor live; the
discriminator learns (hinge loss down from its first step, the real-fake
logit margin open); d_weight strictly inside its clip range; the
reconstruction not collapsed under adversarial pressure, judged on a FIXED
evaluation forward of the first 16 mels (at most 2x the pre-GAN value);
everything finite.

Writes QUALITY_VQGAN_TORCH.json (QUALITY_VQGAN.json's keys, plus the card,
the TF32 switches as the run left them -- torch's defaults, as the port's
training CLIs leave them -- and kernel C's launches), then exits non-zero
if a gate failed.  ``--seed`` draws both nets' initial weights from
another seed (the batch order stays); ``--tf32 off`` turns cuDNN's TF32
convolutions off for the run (``torch.backends.cudnn.allow_tf32``) and
restores the switch after it.  Every run is appended to the record's
``runs`` (its UTC time, seed, switches, gates, eval and train
reconstruction, d_weight, minutes); the top-level keys stay the latest
default run's (seed 0, TF32 as torch leaves it).  QUALITY_VQGAN.json is the TPU's record and is not
touched.

Usage, on a machine with the card:
python3 scripts/torch_quality_vqgan_fullscale.py [--seed N] [--tf32 off]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_quality_fullscale import record_run, tf32_state  # noqa: E402
from torch_quality_proof import card_info  # noqa: E402

from melspec_gpt_vqvae_tpu_torch.configs import (MelConfig,  # noqa: E402
                                                 VQVAEConfig)
from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index  # noqa
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    make_tone_battery, wavs_to_training_mels)

RECON_STEPS = 200
GAN_STEPS = 200
BS = 4
N_EVAL = 16
OUT = os.path.join(ROOT, "QUALITY_VQGAN_TORCH.json")
DEFAULT_SEED = 0


def vqgan_gates(vcfg, rec_first, rec_pre_gan, disc_factor_last, d_first,
                d_last5, margin_last5, dw, eval_pre, eval_post, scalars):
    """quality_vqgan_fullscale.py's gates.  The collapse gate reads the
    fixed evaluation forward: under adversarial pressure at reference
    scale the generator trades L1 for realism (the reference's dynamics),
    so "not collapsed" is at most 2x the pre-GAN evaluation loss."""
    dw = np.asarray(dw)
    return {
        "recon_learns": bool(rec_pre_gan < 0.5 * rec_first),
        "disc_factor_live": bool(float(disc_factor_last) == 1.0),
        "disc_learns": bool(d_last5 < d_first and margin_last5 > 0.0),
        "d_weight_in_range": bool(
            np.all(dw > vcfg.min_adapt_weight)
            and np.all(dw < vcfg.max_adapt_weight * vcfg.disc_weight)),
        "recon_not_collapsed": bool(
            eval_post <= max(2.0 * eval_pre, eval_pre + 0.05)),
        "all_finite": bool(np.all(np.isfinite(scalars))),
    }


def main(device=None, seed=DEFAULT_SEED, tf32=True):
    """``seed``: both nets' initial draw; ``tf32`` False runs the
    convolutions without cuDNN's TF32 (the caller's switch restored)."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_quality_vqgan_fullscale: no CUDA device; "
                             "the full-scale proof runs on the card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    deterministic = torch.backends.cudnn.deterministic
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic = True
    if not tf32:
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(device, seed, seed == DEFAULT_SEED and tf32)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.allow_tf32 = allow_tf32


def _run(device, seed, default):
    t_start = time.time()
    mcfg = MelConfig()
    wavs, _, _ = make_tone_battery(mcfg)
    n = len(wavs)
    _, x_all = wavs_to_training_mels(wavs, mcfg, device)
    # the fixed evaluation batch: per-batch rec at batch 4 swings ~2x on
    # this battery, so the reconstruction is judged on this forward
    x_eval = x_all[:N_EVAL]

    # the preset's geometry; only the schedule replaced
    vcfg = VQVAEConfig(disc_start=RECON_STEPS)
    assert (vcfg.ch, vcfg.ch_mult, vcfg.num_res_blocks, vcfg.z_channels,
            vcfg.disc_ndf, vcfg.disc_num_layers) \
        == (128, (1, 1, 2, 2, 4), 2, 256, 64, 3), \
        "preset drifted from reference scale"
    task = VQVAETask(vcfg, device)
    state = task.init_state(seed)
    n_params = sum(p.numel() for p in state["model"].parameters())
    print(f"VQ-GAN preset: {n_params / 1e6:.1f}M AE params, bs {BS}, "
          f"lr {vcfg.learning_rate}", flush=True)

    def eval_rec():
        return float(task.eval_step(state, x_eval)[0]["val/rec_loss"])

    vq_nearest_index.launches = 0
    rng = np.random.default_rng(0)
    rec_first = log = None
    for step in range(RECON_STEPS):
        idxs = rng.integers(0, n, BS)
        state, log = task.train_step(state, x_all[idxs])
        if step == 0:
            rec_first = float(log["train/rec_loss"])
        if step % 50 == 0:
            print(f"recon step {step}: rec {log['train/rec_loss']:.4f} "
                  f"perp {log['train/perplexity']:.1f}", flush=True)
    rec_pre_gan = float(log["train/rec_loss"])
    eval_pre = eval_rec()
    print(f"recon phase: rec {rec_first:.4f} -> {rec_pre_gan:.4f} "
          f"(eval {eval_pre:.4f})", flush=True)

    gan_logs = []
    for step in range(GAN_STEPS):
        idxs = rng.integers(0, n, BS)
        state, log = task.train_step(state, x_all[idxs])
        gan_logs.append(log)
        if step % 25 == 0:
            print(f"gan step {step}: rec {log['train/rec_loss']:.4f} "
                  f"disc {log['train/disc_loss']:.4f} "
                  f"d_weight {log['train/d_weight']:.3g} "
                  f"lr/lf {log['train/logits_real']:.3f}/"
                  f"{log['train/logits_fake']:.3f}", flush=True)
    eval_post = eval_rec()
    c_launches = vq_nearest_index.launches

    rec_final = float(np.mean([g["train/rec_loss"] for g in gan_logs[-5:]]))
    d_first = float(gan_logs[0]["train/disc_loss"])
    d_last5 = float(np.mean([g["train/disc_loss"] for g in gan_logs[-5:]]))
    dw = np.asarray([float(g["train/d_weight"]) for g in gan_logs])
    margin_last5 = float(np.mean(
        [g["train/logits_real"] - g["train/logits_fake"]
         for g in gan_logs[-5:]]))
    scalars = [float(g[k]) for g in gan_logs for k in
               ("train/rec_loss", "train/disc_loss", "train/d_weight",
                "train/g_loss")]
    gates = vqgan_gates(vcfg, rec_first, rec_pre_gan,
                        gan_logs[-1]["train/disc_factor"], d_first, d_last5,
                        margin_last5, dw, eval_pre, eval_post, scalars)
    minutes = round((time.time() - t_start) / 60, 1)
    out = {
        "geometry": "ch128 mult(1,1,2,2,4) res2 attn(53,) z256 ndf64 "
                    "(VQVAEConfig preset, reference "
                    "big_model_attn_gan.py:521-602)",
        "ae_params_m": round(n_params / 1e6, 1),
        "batch_size": BS, "lr": vcfg.learning_rate,
        "recon_steps": RECON_STEPS, "gan_steps": GAN_STEPS,
        "rec_loss": {"first": round(rec_first, 4),
                     "pre_gan": round(rec_pre_gan, 4),
                     "final_last5": round(rec_final, 4)},
        "eval_rec_loss": {"pre_gan": round(eval_pre, 4),
                          "post_gan": round(eval_post, 4)},
        "disc_loss": {"first": round(d_first, 4),
                      "last5_mean": round(d_last5, 4)},
        "logit_margin_last5": round(margin_last5, 4),
        "d_weight": {"min": round(float(dw.min()), 5),
                     "max": round(float(dw.max()), 5),
                     "final": round(float(dw[-1]), 5)},
        "gates": gates,
        "minutes": minutes,
        "passed": all(gates.values()),
        "tf32": tf32_state(),
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "kernel_launches": {"vq_nearest": c_launches},
        "device": (card_info(device) if device.type == "cuda"
                   else {"platform": device.type}),
    }
    run = {"seed": seed, "tf32": tf32_state(),
           "cudnn_deterministic": torch.backends.cudnn.deterministic,
           "gates": gates,
           "passed": all(gates.values()), "rec_loss": out["rec_loss"],
           "eval_rec_loss": out["eval_rec_loss"], "d_weight": out["d_weight"],
           "minutes": minutes}
    record_run(OUT, out, run, default)
    print(json.dumps(out if default else run))
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"torch_quality_vqgan_fullscale: gates failed: "
                         f"{failed}")
    print("QUALITY_VQGAN_TORCH: all gates passed")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED,
                    help="both nets' initial draw (default 0, the committed "
                         "record's run)")
    ap.add_argument("--tf32", choices=("on", "off"), default="on",
                    help="off: cuDNN's TF32 convolutions off for the run")
    args = ap.parse_args()
    main(seed=args.seed, tf32=args.tf32 == "on")
