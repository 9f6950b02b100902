#!/usr/bin/env python
"""End-to-end LEARNING proof of the PyTorch port on the card: the full loop
learns, not merely runs.  The port of scripts/quality_proof.py:

  1. the deterministic tone battery (4 classes = 4 frequency bands, 16
     base tones x 4 jittered variants = 64 clips) -> mels through kernel D;
  2. a small-but-real VQ-VAE: the reconstruction phase, then the FULL
     adversarial phase (``disc_start`` reached on the card: hinge
     discriminator, adaptive generator weight from the two gradient norms,
     reference big_model_attn_gan.py:643-844), kernel C picking the codes
     twice an iteration; gated on the discriminator learning, d_weight
     inside its clip range and the reconstruction not collapsing;
  3. the battery tokenized with the TRAINED codec (kernel C) -> (5, 53)
     code grids;
  4. a small class-conditional GPT overfit on the codes through the port's
     ``GPTTask`` (reference loop: Lit_minGPT, transformer/minGPT.py);
  5. class-conditional sampling (kernel A at the prefill; the decode steps
     attend over the float32 cache in plain torch), the samples decoded by
     the trained VQ decoder, and the dominant mel bin of each generated
     spectrogram checked to lie in the conditioning class's band.

Writes QUALITY_TORCH.json {accuracy, per_class, gan_phase, gates, device,
...} (QUALITY.json is the TPU's record and is not touched), then exits
non-zero if a gate failed: band accuracy >= 0.7 (chance 0.25) and the four
GAN-phase gates.  The ``QP_*`` environment knobs are the JAX script's.

Usage, on a machine with the card: python3 scripts/torch_quality_proof.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from melspec_gpt_vqvae_tpu_torch.configs import (  # noqa: E402
    DataConfig, ExperimentConfig, GPTConfig, MelConfig, TrainConfig,
    VQVAEConfig)
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask  # noqa
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    N_CLASSES, make_tone_battery, wavs_to_training_mels)

VQ_STEPS = int(os.environ.get("QP_VQ_STEPS", "300"))
GAN_STEPS = int(os.environ.get("QP_GAN_STEPS", "150"))
GPT_STEPS = int(os.environ.get("QP_GPT_STEPS", "400"))
SAMPLES_PER_CLASS = int(os.environ.get("QP_SAMPLES", "8"))
OUT = os.path.join(ROOT, "QUALITY_TORCH.json")
ACCURACY_GATE = 0.7


def small_codec_cfg(disc_start):
    """The reduced-geometry proof codec (ch 32, 1 res block, 64-d z, 128
    codes), as the JAX script's."""
    return VQVAEConfig(ch=32, num_res_blocks=1, z_channels=64,
                       embedding_dim=64, num_embeddings=128,
                       disc_start=disc_start, learning_rate=3e-4,
                       disc_ndf=16)


def train_codec(task, state, x_all, steps, rng, bs=8, tag="vqvae",
                every=50):
    """``steps`` iterations on batches of ``bs`` clips drawn by ``rng``
    (one draw a step).  Returns (state, the logs of every step)."""
    logs = []
    for step in range(steps):
        idxs = rng.integers(0, len(x_all), bs)
        state, log = task.train_step(state, x_all[idxs])
        logs.append(log)
        if step % every == 0:
            print(f"{tag} step {step}: rec {log['train/rec_loss']:.4f} "
                  f"perp {log['train/perplexity']:.1f} disc "
                  f"{log['train/disc_loss']:.4f} d_weight "
                  f"{log['train/d_weight']:.3g}", flush=True)
    return state, logs


@torch.no_grad()
def encode_grids(model, x_all, device):
    """Tokenize prepared mels with a trained codec -> (N, 5, 53) int32."""
    return np.concatenate([
        model.encode_to_indices(torch.as_tensor(x_all[i:i + 16]).to(device))
        .cpu().numpy() for i in range(0, len(x_all), 16)]).astype(np.int32)


def class_bands(mels, labels):
    """Each class's dominant mel bins of the INPUT mels (argmax of the
    time-averaged spectrum): {class: sorted bins}."""
    dom = mels.mean(axis=2).argmax(axis=1)
    return {c: sorted(set(int(d) for d, l in zip(dom, labels) if l == c))
            for c in range(N_CLASSES)}


def band_hit(d, c, bands):
    """A generated dominant bin ``d`` hits class ``c``: within 3 bins of its
    band and no nearer another class's band."""
    dist = min(abs(int(d) - b) for b in bands[c])
    other = min(abs(int(d) - b) for cc, bins in bands.items() if cc != c
                for b in bins)
    return dist <= 3 and dist <= other


def gan_phase_summary(gan_logs, rec_pre_gan, vcfg):
    """The adversarial phase's figures and its four gates: the
    discriminator factor live, the discriminator learning (hinge loss down
    from its first step, the real-fake logit margin open), d_weight strictly
    inside its clip range, the reconstruction not collapsed."""
    rec_final = float(gan_logs[-1]["train/rec_loss"])
    d_first = float(gan_logs[0]["train/disc_loss"])
    d_last5 = float(np.mean([g["train/disc_loss"] for g in gan_logs[-5:]]))
    dw = np.asarray([g["train/d_weight"] for g in gan_logs])
    margin = float(np.mean([g["train/logits_real"] - g["train/logits_fake"]
                            for g in gan_logs[-5:]]))
    gates = {
        "disc_factor_live": float(gan_logs[-1]["train/disc_factor"]) == 1.0,
        "disc_learns": d_last5 < d_first and margin > 0.0,
        "d_weight_in_range": bool(
            np.all(dw > vcfg.min_adapt_weight)
            and np.all(dw < vcfg.max_adapt_weight * vcfg.disc_weight)),
        "recon_not_collapsed": rec_final <= max(1.5 * rec_pre_gan,
                                                rec_pre_gan + 0.05),
    }
    return {"disc_loss": {"first": round(d_first, 4),
                          "last5_mean": round(d_last5, 4)},
            "logit_margin_last5": round(margin, 4),
            "d_weight": {"min": round(float(dw.min()), 5),
                         "max": round(float(dw.max()), 5),
                         "final": round(float(dw[-1]), 5)},
            "rec_loss": {"pre_gan": round(rec_pre_gan, 4),
                         "final": round(rec_final, 4)},
            "steps": len(gan_logs), "gates": gates}


def class_gpt_task(device):
    gcfg = GPTConfig(vocab_size=128, block_size=266, n_layer=4, n_head=4,
                     n_embd=128, class_size=N_CLASSES, embd_pdrop=0.1,
                     resid_pdrop=0.1, attn_pdrop=0.1)
    exp = ExperimentConfig(model=gcfg,
                           train=TrainConfig(learning_rate=3e-4, epochs=1,
                                             batch_size=16),
                           data=DataConfig(batch_size=16))
    return GPTTask(exp, device)


def train_class_gpt(task, grids, labels, steps, rng, every=100):
    """Overfit the class GPT on the code grids; returns (state, first
    loss, last loss)."""
    gstate = task.init_state(0)
    gen = torch.Generator(device=task.device).manual_seed(1)
    l0 = loss = float("nan")
    for step in range(steps):
        idxs = rng.integers(0, len(grids), 16)
        gstate, loss = task.train_step(
            gstate, {"codes": grids[idxs], "target": labels[idxs]}, gen)
        if step % every == 0:
            if step == 0:
                l0 = float(loss)
            print(f"gpt step {step}: loss {float(loss):.4f}", flush=True)
    return gstate, l0, float(loss)


@torch.no_grad()
def sample_and_score(task, gstate, model, bands, samples, seed=1):
    """Class-conditional samples decoded by the codec; the dominant bin of
    each spectrogram scored against its class's band.  Returns (accuracy,
    per-class accuracy, detail)."""
    gen = torch.Generator(device=task.device).manual_seed(seed)
    per_class, detail, correct = {}, [], 0
    for c in range(N_CLASSES):
        toks = task.sample(gstate["params"], gen,
                           torch.full((samples,), c, dtype=torch.long),
                           steps=265, temperature=0.9, top_k=16)
        grid = toks[:, -265:].reshape(-1, 53, 5).transpose(1, 2)
        spec = model.decode_code(grid.to(task.device))[..., 0].cpu().numpy()
        dom = np.clip((spec + 1.0) / 2.0, 0.0, 1.0).mean(axis=2).argmax(1)
        hits = sum(band_hit(d, c, bands) for d in dom)
        per_class[c] = hits / samples
        correct += hits
        detail.append({"class": c, "dom_bins": [int(d) for d in dom],
                       "band": bands[c], "acc": per_class[c]})
        print(f"class {c}: dom bins {sorted(int(d) for d in dom)} band "
              f"{bands[c]} acc {per_class[c]:.2f}", flush=True)
    return correct / (N_CLASSES * samples), per_class, detail


def result(acc, per_class, gan_out, rec_final, gpt_loss, clips, minutes,
           detail, device_info):
    """QUALITY_TORCH.json's object: QUALITY.json's keys, the gates and the
    card."""
    gates = {"accuracy": acc >= ACCURACY_GATE, **gan_out["gates"]}
    return {
        "accuracy": round(acc, 3), "chance": round(1.0 / N_CLASSES, 3),
        "per_class": {str(k): round(v, 3) for k, v in per_class.items()},
        "vq_rec_loss_final": round(float(rec_final), 4),
        "gan_phase": gan_out,
        "gpt_loss": {"start": round(gpt_loss[0], 3),
                     "final": round(gpt_loss[1], 3)},
        "vq_steps": VQ_STEPS, "gan_steps": GAN_STEPS, "gpt_steps": GPT_STEPS,
        "clips": clips, "samples_per_class": SAMPLES_PER_CLASS,
        "minutes": round(minutes, 2), "gates": gates,
        "passed": all(gates.values()), "device": device_info,
        "detail": detail}


def card_info(device):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 else None}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_quality_proof: no CUDA device; the learning "
                         "proof runs on the card")
    device = torch.device("cuda", 0)
    t_start = time.time()
    mcfg = MelConfig()
    wavs, labels, _ = make_tone_battery(mcfg)
    mels, x_all = wavs_to_training_mels(wavs, mcfg, device)
    bands = class_bands(mels, labels)
    print(f"class dominant-bin bands: {bands}", flush=True)

    # the reconstruction phase, then the adversarial phase: disc_factor
    # turns to 1 at step == VQ_STEPS (reference threshold semantics:
    # big_model_attn_gan.py:596)
    vcfg = small_codec_cfg(disc_start=VQ_STEPS)
    rng = np.random.default_rng(0)
    vq_task = VQVAETask(vcfg, device)
    state = vq_task.init_state(0)
    state, logs = train_codec(vq_task, state, x_all, VQ_STEPS, rng)
    rec_pre_gan = float(logs[-1]["train/rec_loss"])
    print(f"vqvae recon-phase final rec {rec_pre_gan:.4f}", flush=True)
    state, gan_logs = train_codec(vq_task, state, x_all, GAN_STEPS, rng,
                                  tag="gan", every=25)
    gan_out = gan_phase_summary(gan_logs, rec_pre_gan, vcfg)
    print(f"vqvae GAN phase: {json.dumps(gan_out)}", flush=True)

    model = state["model"]
    grids = encode_grids(model, x_all, device)               # (N, 5, 53)
    gpt = class_gpt_task(device)
    gstate, l0, l_final = train_class_gpt(gpt, grids, labels, GPT_STEPS, rng)
    print(f"gpt loss {l0:.3f} -> {l_final:.3f}", flush=True)
    acc, per_class, detail = sample_and_score(gpt, gstate, model, bands,
                                              SAMPLES_PER_CLASS)
    out = result(acc, per_class, gan_out, gan_out["rec_loss"]["final"],
                 (l0, l_final), len(wavs), (time.time() - t_start) / 60,
                 detail, card_info(device))
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "detail"}))
    failed = [k for k, ok in out["gates"].items() if not ok]
    if failed:
        raise SystemExit(f"torch_quality_proof: gates failed: {failed}")


if __name__ == "__main__":
    main()
