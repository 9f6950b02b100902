#!/usr/bin/env python
"""The GPT-VAE's LEARNING proof on the card: the port of
scripts/quality_vae.py.

The tone battery (utils/battery.py: 4 frequency-band classes, 64 clips)
through kernel D, a ch-32 tone codec trained by the recipe of
scripts/torch_quality_proof.py (``small_codec_cfg``, ``train_codec``,
``encode_grids``: the reconstruction phase only), its code grids, then a
4-layer, 128-wide GPT-VAE (encoder and decoder, nz 128) trained THROUGH
``training/runner.py::fit_vae`` -- KL annealing from 0.1 over ``QV_WARM_UP``
epochs, per-dimension free bits (``QV_FB`` = 2, target KL 8 nats) -- on 56
clips, 8 held out (2 a class).  Gates, as the JAX script's:

  (a) the validation ELBO and reconstruction loss (KL weight 1) under half
      of the random init's;
  (b) greedy reconstructions of the HELD-OUT clips land in their source
      clip's frequency band (>= 0.7), decoded by the trained codec;
  (c) corpus mutual information > 0 and active units > 0 (with free bits
      2 every dimension keeps KL >= target / nz, so AU == nz is the healthy
      outcome; without free bits 0 < AU < nz);
  (d) the endpoints of a latent interpolation between two held-out clips
      of classes 0 and 3 reconstruct their sources' bands (accuracy 1).

Writes QUALITY_VAE_TORCH.json with QUALITY_VAE.json's keys (the TPU's
record, not touched) plus each gate's pass or fail, ``passed`` and the
card; exits non-zero when a gate failed.  The ``QV_*`` environment knobs
are the JAX script's.  Scratch (the run's logs and its last checkpoint)
goes to build/torch_quality_vae/ of the checkout.

Usage, on a machine with the card: python3 scripts/torch_quality_vae.py
"""

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_quality_proof import (band_hit, card_info, class_bands,  # noqa
                                 encode_grids, small_codec_cfg, train_codec)

from melspec_gpt_vqvae_tpu_torch.configs import (  # noqa: E402
    DataConfig, ExperimentConfig, GPTConfig, MelConfig, TrainConfig,
    VAEConfig)
from melspec_gpt_vqvae_tpu_torch.training import runner  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
    CheckpointManager  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import \
    tokens_from_batch  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.logging import \
    TBLogger  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.vae_task import \
    VAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    N_CLASSES, make_tone_battery, wavs_to_training_mels)

VQ_STEPS = int(os.environ.get("QV_VQ_STEPS", "300"))
EPOCHS = int(os.environ.get("QV_EPOCHS", "800"))
WARM_UP = int(os.environ.get("QV_WARM_UP", "100"))
EMBD = int(os.environ.get("QV_EMBD", "128"))
LAYERS = int(os.environ.get("QV_LAYERS", "4"))
# free bits, the reference's per-dimension mode (Lit_GPT_VAE.py:270-292):
# without them the JAX battery's first run collapsed the posterior
FB = int(os.environ.get("QV_FB", "2"))
TARGET_KL = float(os.environ.get("QV_TARGET_KL", "8.0"))
BS = 16
OUT = os.path.join(ROOT, "QUALITY_VAE_TORCH.json")
SCRATCH = os.path.join(ROOT, "build", "torch_quality_vae")
ACCURACY_GATE = 0.7


class GridLoader:
    """A shuffled-per-epoch loader over (N, 5, 53) grids: the surface
    ``fit_vae`` drives (``set_epoch``, ``start_batch``)."""

    def __init__(self, grids, labels, bs, shuffle):
        self.grids, self.labels = grids, labels
        self.bs, self.shuffle = bs, shuffle
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def set_start_batch(self, i):
        self.start_batch = i

    def __len__(self):
        return max(1, len(self.grids) // self.bs)

    def __iter__(self):
        idx = np.arange(len(self.grids))
        if self.shuffle:
            idx = np.random.default_rng(1234 + self.epoch).permutation(idx)
        for i in range(0, len(self) * self.bs, self.bs):
            sl = idx[i:i + self.bs]
            if len(sl) < self.bs and self.shuffle:
                break
            yield {"codes": self.grids[sl], "target": self.labels[sl]}


class GridDM:
    def __init__(self, tr_g, tr_l, va_g, va_l, bs):
        self._tr = GridLoader(tr_g, tr_l, bs, True)
        self._va = GridLoader(va_g, va_l, min(bs, len(va_g)), False)

    def train_dataloader(self):
        return self._tr

    def val_dataloader(self):
        return self._va


def band_accuracy(specs, classes, bands):
    """The share of decoded spectrograms whose dominant mel bin hits the
    class's band (``band_hit``)."""
    mel01 = np.clip((specs + 1.0) / 2.0, 0.0, 1.0)
    dom = mel01.mean(axis=2).argmax(axis=1)
    return float(np.mean([band_hit(d, int(c), bands)
                          for d, c in zip(dom, classes)]))


@torch.no_grad()
def decode_tokens(model, toks, device):
    """GPT-order tokens (B, 265) -> spectrograms (B, 80, 848) by the
    codec's decoder."""
    grid = torch.as_tensor(np.asarray(toks)).reshape(-1, 53, 5)
    grid = grid.transpose(1, 2).to(device)
    return model.decode_code(grid)[..., 0].float().cpu().numpy()


def vae_experiment():
    gcfg = GPTConfig(vocab_size=128, block_size=265, n_layer=LAYERS,
                     n_head=4, n_embd=EMBD, class_size=None,
                     embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1)
    return ExperimentConfig(
        model=gcfg,
        vae=VAEConfig(nz=EMBD, warm_up=WARM_UP, kl_start=0.1, fb=FB,
                      target_kl=TARGET_KL),
        train=TrainConfig(learning_rate=3e-4, epochs=EPOCHS, batch_size=BS),
        data=DataConfig(batch_size=BS))


def val_metrics(task, state, batches, seed=99):
    """The ELBO at KL weight 1 and its parts over the held-out batches,
    each drawn from a generator of its own."""
    outs = [task.eval_step(state, b, torch.Generator(
        device=task.device).manual_seed(seed + i))
        for i, b in enumerate(batches)]
    return task.metrics_from_sums(task.sum_outputs(outs))


def gates_of(m0, m1, rec_acc, mi, au, end_acc):
    """Gates (a)-(d) of the module's docstring, each True or False."""
    au_ok = au > 0 if FB == 2 else 0 < au < EMBD
    return {"a_elbo_and_rec_decrease": bool(m1["loss"] < 0.5 * m0["loss"]
                                            and m1["rec"] < 0.5 * m0["rec"]),
            "b_heldout_band_accuracy": bool(rec_acc >= ACCURACY_GATE),
            "c_mutual_info_and_active_units": bool(mi > 0.0 and au_ok),
            "d_interpolation_endpoints": bool(end_acc == 1.0)}


def result(m0, m1, kl_w, rec_acc, mi, au, end_acc, steps, clips, minutes,
           device_info):
    """QUALITY_VAE_TORCH.json's object: QUALITY_VAE.json's keys, the gates
    and the card."""
    gates = gates_of(m0, m1, rec_acc, mi, au, end_acc)
    return {
        "val_loss": {"random_init": round(m0["loss"], 2),
                     "trained": round(m1["loss"], 2)},
        "val_rec": {"random_init": round(m0["rec"], 2),
                    "trained": round(m1["rec"], 2)},
        "val_kl_trained": round(m1["kl"], 2),
        "ppl_trained": round(m1["ppl"], 4),
        "kl_weight_final": round(kl_w, 3),
        "heldout_reconstruction_band_accuracy": round(rec_acc, 3),
        "mutual_info": round(float(mi), 3),
        "active_units": int(au),
        "nz": EMBD,
        "interpolation_endpoint_accuracy": round(end_acc, 3),
        "geometry": f"{LAYERS}L/{EMBD}d enc+dec, nz={EMBD}",
        "fb": FB, "target_kl": TARGET_KL,
        "epochs": EPOCHS, "warm_up": WARM_UP, "steps": steps,
        "clips": clips, "minutes": round(minutes, 1),
        "gates": gates, "passed": all(gates.values()),
        "device": device_info}


def main(device=None):
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_quality_vae: no CUDA device; the "
                             "learning proof runs on the card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    t_start = time.time()
    mcfg = MelConfig()
    wavs, labels, _ = make_tone_battery(mcfg)
    mels, x_all = wavs_to_training_mels(wavs, mcfg, device)
    bands = class_bands(mels, labels)
    print(f"class dominant-bin bands: {bands}", flush=True)

    # the trained codec, the reconstruction phase alone (the JAX script's
    # disc_start=10**9)
    vcfg = small_codec_cfg(disc_start=10 ** 9)
    rng = np.random.default_rng(0)
    vq_task = VQVAETask(vcfg, device)
    vstate, _ = train_codec(vq_task, vq_task.init_state(0), x_all, VQ_STEPS,
                            rng, every=100)
    model = vstate["model"]
    grids = encode_grids(model, x_all, device)               # (N, 5, 53)

    # held out: the last 2 clips of each class
    n = len(wavs)
    val_idx = np.concatenate([np.where(labels == c)[0][-2:]
                              for c in range(N_CLASSES)])
    tr_mask = np.ones(n, bool)
    tr_mask[val_idx] = False
    dm = GridDM(grids[tr_mask], labels[tr_mask], grids[val_idx],
                labels[val_idx], BS)

    exp = vae_experiment()
    steps_per_epoch = len(dm.train_dataloader())
    task = VAETask(exp, steps_per_epoch, device)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    log = TBLogger(os.path.join(SCRATCH, "logs"))
    ckpt = CheckpointManager(os.path.join(SCRATCH, "ckpt", "version_0"))
    val_batches = list(dm.val_dataloader())
    m0 = val_metrics(task, task.init_state(783435), val_batches)
    print(f"random init: val loss {m0['loss']:.2f} rec {m0['rec']:.2f}",
          flush=True)

    state = runner.fit_vae(task, dm, epochs=EPOCHS, log=log, ckpt=ckpt,
                           logging_frequency=0, ckpt_every=0)
    ckpt.wait()
    m1 = val_metrics(task, state, val_batches)
    kl_w = float(state["kl_weight"])
    print(f"trained: val loss {m1['loss']:.2f} rec {m1['rec']:.2f} kl "
          f"{m1['kl']:.2f} ppl {m1['ppl']:.3f} kl_weight {kl_w:.3f}",
          flush=True)

    # (b) greedy reconstructions of the held-out clips
    gen = torch.Generator(device=device).manual_seed(7)
    rec_toks = torch.cat([task.reconstruct(state, b, "greedy", gen).cpu()
                          for b in val_batches])
    rec_acc = band_accuracy(decode_tokens(model, rec_toks, device),
                            labels[val_idx], bands)
    print(f"held-out greedy reconstruction band accuracy: {rec_acc:.3f}",
          flush=True)

    # (c) MI and AU over the whole corpus
    all_batches = [{"codes": grids[i:i + BS]} for i in range(0, n, BS)]
    mi, au, _ = task.calc_mi_au(
        state, all_batches, torch.Generator(device=device).manual_seed(11))
    print(f"mutual_info {mi:.3f} active_units {au}/{EMBD}", flush=True)

    # (d) the endpoints of an interpolation between classes 0 and 3
    a_idx, b_idx = int(val_idx[0]), int(val_idx[-1])
    toks = tokens_from_batch(grids[[a_idx, b_idx]])
    outs = task.interpolate(state, toks[:1], toks[1:2], steps=5,
                            generator=torch.Generator(
                                device=device).manual_seed(31))
    ends = torch.cat([outs[0].cpu(), outs[-1].cpu()])
    end_acc = band_accuracy(decode_tokens(model, ends, device),
                            [labels[a_idx], labels[b_idx]], bands)
    print(f"interpolation endpoints band accuracy: {end_acc:.3f}",
          flush=True)

    out = result(m0, m1, kl_w, rec_acc, mi, au, end_acc,
                 EPOCHS * steps_per_epoch,
                 {"train": int(tr_mask.sum()), "heldout": len(val_idx)},
                 (time.time() - t_start) / 60,
                 card_info(device) if device.type == "cuda" else
                 {"platform": device.type})
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    failed = [k for k, ok in out["gates"].items() if not ok]
    if failed:
        raise SystemExit(f"torch_quality_vae: gates failed: {failed}")
    return out


if __name__ == "__main__":
    main()
