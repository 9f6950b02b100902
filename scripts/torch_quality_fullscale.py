#!/usr/bin/env python
"""Reference-scale learning proof of the PyTorch port on the card: the
port of scripts/quality_fullscale.py.

The smaller proofs (QUALITY_TORCH.json, QUALITY_VAE_TORCH.json) train at
reduced geometry.  Here the VAS GPT preset itself -- 24 layers, 16 heads,
1024 wide, block 266, class-conditional, batch 8
(reference config_GPT_vas.py:4-6) -- trains on the card for 300 steps,
and the held-out loss is read every 50: the configuration where numerics
that only the full width shows (float32 products summed across 24 layers
at 1024, the full-length attention) would surface.

Recipe, as the JAX script's: the tone battery (utils/battery.py) ->
mels through kernel D -> the ch-32 tone codec of
scripts/torch_quality_proof.py (reconstruction phase only) -> (5, 53)
code grids -> the preset GPT through ``GPTTask`` at lr 1e-4 (``QF_LR``)
on 56 training clips, 8 held-out clips (2 a class) evaluated every
``EVAL_EVERY`` (50) steps (kernel A in every layer of an evaluation
forward).  The lr is the one knob; the geometry and step counts are not.

Gates (quality_fullscale.py:137-146, unchanged): the last milestone is
the best; every milestone beats the random-init loss; none is more than
10% above the running best; the final is below 0.9x the initial; the
train loss falls (last 20 steps' mean below the first 20's); everything
finite.

Writes QUALITY_FULLSCALE_TORCH.json (QUALITY_FULLSCALE.json's keys, plus
the card, the TF32 switches as the run left them -- torch's defaults, as
the port's training CLIs leave them -- and the launches of kernels A and
F), then exits non-zero if a gate failed.  cuDNN runs its deterministic
algorithms throughout, so the codec, and with it the code grids the GPT
learns (their SHA-1 is recorded), are the same in every run; the default
convolution backward passes gave another codec, and another step-0
loss, run to run.  ``--seed`` draws the GPT's initial weights from
another seed (the codec, batch order and dropout stream stay).  Every
run is appended to the record's ``runs`` (its UTC time, seed, switches,
code SHA-1, gates, milestones, minutes), and the top-level keys stay the
latest default-seed run's.  QUALITY_FULLSCALE.json is the TPU's record
and is not touched.

Usage, on a machine with the card:
python3 scripts/torch_quality_fullscale.py [--seed N]
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_quality_proof import (card_info, encode_grids,  # noqa: E402
                                 small_codec_cfg, train_codec)

from melspec_gpt_vqvae_tpu_torch.configs import (MelConfig,  # noqa: E402
                                                 load_preset)
from melspec_gpt_vqvae_tpu_torch.ops.attention import attend  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import \
    GPTTask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    N_CLASSES, make_tone_battery, wavs_to_training_mels)

VQ_STEPS = 300
STEPS = 300
EVAL_EVERY = 50
# the preset lr (1e-6) moves the loss by ~1e-2 in 300 steps; 1e-4 is the
# JAX script's choice, kept
LR = float(os.environ.get("QF_LR", "1e-4"))
N_VAL = 8
OUT = os.path.join(ROOT, "QUALITY_FULLSCALE_TORCH.json")
KERNELS = {"attention": attend, "flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd": flash_attention_bwd}


def tf32_state():
    """The TF32 switches as this run leaves them."""
    return {"cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}


def record_run(path, out, run, default: bool):
    """Write the record at ``path``: ``run`` (this run's seed, switches,
    gates and figures), stamped with its UTC time, is appended to the
    record's ``runs``, which keeps every earlier run; the top-level keys
    are ``out`` for the default run and stay the file's own for any other.
    Returns the record."""
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    run = {"at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()), **run}
    top = out if default else {k: v for k, v in old.items() if k != "runs"}
    rec = {**top, "runs": old.get("runs", []) + [run]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def fullscale_gates(vals, tl):
    """quality_fullscale.py's gates on the validation milestones ``vals``
    (the first at step 0) and the train losses ``tl``.  The val set is 8
    clips, so one milestone a few percent up is eval noise: the trend is
    gated (the last milestone the best, every one below the random-init
    loss, none more than 10% above the running best)."""
    running_best = np.minimum.accumulate(vals)
    return {
        "val_final_is_best": bool(vals[-1] == min(vals)),
        "val_all_below_init": bool(all(v < vals[0] for v in vals[1:])),
        "val_no_regression": bool(np.all(
            np.asarray(vals[1:]) <= 1.10 * running_best[:-1])),
        "val_material": bool(vals[-1] < 0.9 * vals[0]),
        "train_decreased": bool(np.mean(tl[-20:]) < np.mean(tl[:20])),
        "all_finite": bool(np.all(np.isfinite(tl))
                           and np.all(np.isfinite(vals))),
    }


def main(device=None, seed=None):
    """``seed``: the GPT's initial draw (None: the preset's ``train.seed``,
    the committed record's); the codec, the batch order and the dropout
    stream stay as they are (cuDNN deterministic for the run, the
    caller's switch restored)."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_quality_fullscale: no CUDA device; the "
                             "full-scale proof runs on the card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _run(device, seed)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _run(device, seed):
    t_start = time.time()
    mcfg = MelConfig()
    wavs, labels, _ = make_tone_battery(mcfg)
    n = len(wavs)
    _, x_all = wavs_to_training_mels(wavs, mcfg, device)

    # --- the tone codec (QUALITY_TORCH.json's recipe, GAN off) ------------
    vcfg = small_codec_cfg(disc_start=10 ** 9)
    rng = np.random.default_rng(0)
    vq_task = VQVAETask(vcfg, device)
    vstate, _ = train_codec(vq_task, vq_task.init_state(0), x_all, VQ_STEPS,
                            rng, every=100)
    grids = encode_grids(vstate["model"], x_all, device)
    codes_sha1 = hashlib.sha1(np.ascontiguousarray(grids)).hexdigest()
    del vq_task, vstate

    # --- held-out split: 2 clips a class -----------------------------------
    val_idx = np.concatenate([np.where(labels == c)[0][-2:]
                              for c in range(N_CLASSES)])
    tr_idx = np.setdiff1d(np.arange(n), val_idx)

    # --- the VAS preset, its geometry untouched ----------------------------
    exp = load_preset("GPT", "vas")
    assert (exp.model.n_layer, exp.model.n_head, exp.model.n_embd) \
        == (24, 16, 1024), "preset drifted from reference scale"
    exp = dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, learning_rate=LR))
    bs = exp.train.batch_size                      # 8, the reference's
    task = GPTTask(exp, device)
    default = seed is None or seed == exp.train.seed
    seed = exp.train.seed if seed is None else seed
    state = task.init_state(seed)
    n_params = sum(p.numel() for p in _leaves(state["params"]))
    print(f"VAS preset GPT: {n_params / 1e6:.1f}M params, bs {bs}, lr {LR}",
          flush=True)

    val_batches = [{"codes": grids[val_idx[i:i + bs]],
                    "target": labels[val_idx[i:i + bs]]}
                   for i in range(0, N_VAL, bs)]

    def val_loss(st):
        return float(np.mean([float(task.eval_step(st, b))
                              for b in val_batches]))

    for w in KERNELS.values():
        w.launches = 0
    milestones = [(0, val_loss(state))]
    print(f"step 0: val {milestones[0][1]:.4f}", flush=True)

    gen = torch.Generator(device=device).manual_seed(1)
    train_losses = []          # device scalars, read once at the end
    t_train, t_steps = 0.0, 0
    for step in range(1, STEPS + 1):
        idxs = rng.choice(tr_idx, bs, replace=True)
        batch = {"codes": grids[idxs], "target": labels[idxs]}
        _sync(device)
        t0 = time.perf_counter()
        state, loss = task.train_step(state, batch, gen)
        _sync(device)
        train_losses.append(loss)
        if step > 5:           # the first steps set up cuBLAS and caches
            t_train += time.perf_counter() - t0
            t_steps += 1
        if step % EVAL_EVERY == 0:
            vl = val_loss(state)
            milestones.append((step, vl))
            print(f"step {step}: train {float(loss):.4f} val {vl:.4f}",
                  flush=True)

    tl = torch.stack(train_losses).float().cpu().numpy().tolist()
    vals = [v for _, v in milestones]
    gates = fullscale_gates(vals, tl)
    minutes = round((time.time() - t_start) / 60, 1)
    out = {
        "geometry": "24L/16H/1024d block 266 (VAS preset, "
                    "reference config_GPT_vas.py:4-6)",
        "params_m": round(n_params / 1e6, 1),
        "batch_size": bs, "lr": LR, "steps": STEPS,
        "val_loss_milestones": [[s, round(v, 4)] for s, v in milestones],
        "train_loss": {"first20_mean": round(float(np.mean(tl[:20])), 4),
                       "last20_mean": round(float(np.mean(tl[-20:])), 4)},
        # each step's wall clock between two synchronizes, host included
        "wall_s_per_step_upper_bound": round(t_train / max(t_steps, 1), 4),
        "gates": gates,
        "minutes": minutes,
        "passed": all(gates.values()),
        "dtype": exp.model.dtype,
        "use_flash_train": exp.model.use_flash_train,
        "tf32": tf32_state(),
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "codes_sha1": codes_sha1,
        "kernel_launches": {k: w.launches for k, w in KERNELS.items()},
        "device": (card_info(device) if device.type == "cuda"
                   else {"platform": device.type}),
    }
    run = {"seed": seed, "tf32": tf32_state(),
           "cudnn_deterministic": torch.backends.cudnn.deterministic,
           "codes_sha1": codes_sha1, "gates": gates,
           "passed": all(gates.values()),
           "val_loss_milestones": out["val_loss_milestones"],
           "minutes": minutes}
    record_run(OUT, out, run, default)
    print(json.dumps(out if default else run))
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"torch_quality_fullscale: gates failed: {failed}")
    print("QUALITY_FULLSCALE_TORCH: all gates passed")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="the GPT's initial draw (default: the preset's "
                         "train.seed, the committed record's run)")
    main(seed=ap.parse_args().seed)
