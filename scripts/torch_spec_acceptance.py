#!/usr/bin/env python
"""Speculative decoding's acceptance with a TRAINED pair, on the card: the
port of scripts/spec_acceptance.py.

The tone battery (utils/battery.py) through kernel D, the ch-32 tone codec
of scripts/torch_quality_proof.py (reconstruction phase, its recipe), its
code grids, then two class-conditional GPTs trained on the same codes
through ``GPTTask``: a 4-layer target and a 1-layer draft (128 wide, 4
heads).  For gamma 2, 4 and 8, ``gpt_speculative_generate`` (the captured
decode programs, float32 cache; temperature 0.9, top_k 16, as the JAX
script) measures:

  * the acceptance at batch 1, the per-lane figure that sets the latency
    regime's speed-up (2 requests a class, one generator each);
  * the acceptance at batch 8, where the batch advances by the minimum
    over its lanes (``accept_rate_b8_min``);
  * the batch-8 samples' class accuracy: each decoded by the codec, its
    dominant mel bin in the conditioning class's band (distribution kept
    on a trained pair).

Writes SPEC_ACCEPTANCE_TORCH.json with SPEC_ACCEPTANCE.json's keys (the
TPU's record, not touched), plus the card; ``measured_e2e`` and
``measured_e2e_hard`` are scripts/torch_spec_measured.py's and are kept
as the file holds them.  Tones are easy data: the acceptance is an
optimistic indication, not a VAS number.
The ``SA_*`` environment knobs are the JAX script's.

Usage, on a machine with the card: python3 scripts/torch_spec_acceptance.py
"""

import json
import os
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
    DataConfig, ExperimentConfig, GPTConfig, MelConfig, TrainConfig)
from melspec_gpt_vqvae_tpu_torch.models.decode_graph import \
    DecodeGraphs  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.gpt import class_embed  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.speculative import \
    gpt_speculative_generate  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import \
    GPTTask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    N_CLASSES, make_tone_battery, wavs_to_training_mels)

VQ_STEPS = int(os.environ.get("SA_VQ_STEPS", "300"))
GPT_STEPS = int(os.environ.get("SA_GPT_STEPS", "400"))
SAMPLES = int(os.environ.get("SA_SAMPLES", "8"))
GAMMAS = (2, 4, 8)
STEPS = 265
SAMPLING = {"temperature": 0.9, "top_k": 16}
OUT = os.path.join(ROOT, "SPEC_ACCEPTANCE_TORCH.json")
MEASURED = ("measured_e2e", "measured_e2e_hard")
CAVEAT = ("tone battery = easy data; acceptance is an optimistic "
          "indication, not a VAS deployment number")


def gpt_experiment(layers):
    g = GPTConfig(vocab_size=128, block_size=266, n_layer=layers, n_head=4,
                  n_embd=128, class_size=N_CLASSES, embd_pdrop=0.1,
                  resid_pdrop=0.1, attn_pdrop=0.1)
    return ExperimentConfig(model=g,
                            train=TrainConfig(learning_rate=3e-4, epochs=1,
                                              batch_size=16),
                            data=DataConfig(batch_size=16))


def train_gpt(exp, grids, labels, rng, steps, seed, device):
    """``steps`` GPTTask steps on batches of 16 drawn by ``rng``; returns
    (params, the last loss)."""
    task = GPTTask(exp, device)
    state = task.init_state(seed)
    gen = torch.Generator(device=task.device).manual_seed(seed + 100)
    loss = float("nan")
    for step in range(steps):
        idxs = rng.integers(0, len(grids), exp.train.batch_size)
        state, loss = task.train_step(
            state, {"codes": grids[idxs], "target": labels[idxs]}, gen)
        if step % 100 == 0:
            print(f"  step {step}: loss {float(loss):.4f}", flush=True)
    print(f"  final loss {float(loss):.4f}", flush=True)
    return state["params"], float(loss)


class Pair:
    """The trained target and draft, and the captured programs their
    speculative decodes keep."""

    def __init__(self, t_params, t_cfg, d_params, d_cfg, device):
        self.t, self.t_cfg = t_params, t_cfg
        self.d, self.d_cfg = d_params, d_cfg
        self.device = device
        self.graphs = DecodeGraphs()

    @torch.no_grad()
    def generate(self, c, batch, gamma, seed):
        cls = torch.full((batch,), c, dtype=torch.long, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return gpt_speculative_generate(
            self.t, self.t_cfg, self.d, self.d_cfg, gen,
            class_embed(self.t, cls), class_embed(self.d, cls), steps=STEPS,
            gamma=gamma, graph=self.graphs if self.device.type == "cuda"
            else None, **SAMPLING)


def acceptance_b1(pair, gamma):
    """Accepted over drafted of 2 single-lane requests a class."""
    acc = drafted = 0
    for c in range(N_CLASSES):
        for s in range(2):
            _, st = pair.generate(c, 1, gamma, 6000 + c * 100 + s * 10
                                  + gamma)
            acc += st["accepted"]
            drafted += st["drafted"]
    return acc / max(1, drafted)


@torch.no_grad()
def batch_acceptance_and_accuracy(pair, model, bands, gamma):
    """(accepted over drafted, class accuracy) of SAMPLES-lane requests,
    one a class, the samples decoded by the codec."""
    acc = drafted = correct = 0
    for c in range(N_CLASSES):
        toks, st = pair.generate(c, SAMPLES, gamma, 5000 + c * 10 + gamma)
        acc += st["accepted"]
        drafted += st["drafted"]
        grid = toks.reshape(-1, 53, 5).transpose(1, 2)
        spec = model.decode_code(grid.to(pair.device))[..., 0]
        mel01 = np.clip((spec.float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)
        correct += sum(band_hit(d, c, bands)
                       for d in mel01.mean(axis=2).argmax(axis=1))
    return acc / max(1, drafted), correct / (N_CLASSES * SAMPLES)


def main(device=None):
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_spec_acceptance: no CUDA device; the "
                             "acceptance is measured on the card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    t_start = time.time()
    mcfg = MelConfig()
    wavs, labels, _ = make_tone_battery(mcfg)
    mels, x_all = wavs_to_training_mels(wavs, mcfg, device)
    bands = class_bands(mels, labels)

    vcfg = small_codec_cfg(disc_start=10 ** 9)
    rng = np.random.default_rng(0)
    vq_task = VQVAETask(vcfg, device)
    vstate, _ = train_codec(vq_task, vq_task.init_state(0), x_all, VQ_STEPS,
                            rng, every=100)
    model = vstate["model"]
    grids = encode_grids(model, x_all, device)

    print("training the target GPT (4 layers):", flush=True)
    t_exp = gpt_experiment(4)
    t_params, t_loss = train_gpt(t_exp, grids, labels, rng, GPT_STEPS, 0,
                                 device)
    print("training the draft GPT (1 layer):", flush=True)
    d_exp = gpt_experiment(1)
    d_params, d_loss = train_gpt(d_exp, grids, labels, rng, GPT_STEPS, 1,
                                 device)
    pair = Pair(t_params, t_exp.model, d_params, d_exp.model, device)

    out = {"gammas": {}, "target_loss": round(t_loss, 3),
           "draft_loss": round(d_loss, 3)}
    for gamma in GAMMAS:
        rate, quality = batch_acceptance_and_accuracy(pair, model, bands,
                                                      gamma)
        rate_b1 = acceptance_b1(pair, gamma)
        out["gammas"][str(gamma)] = {
            "accept_rate_b1": round(rate_b1, 3),
            "accept_rate_b8_min": round(rate, 3),
            "class_accuracy": round(quality, 3)}
        print(f"gamma={gamma}: acceptance B=1 {rate_b1:.3f} (B={SAMPLES} "
              f"batched-min {rate:.3f}) class accuracy {quality:.3f}",
              flush=True)
    out["minutes"] = round((time.time() - t_start) / 60, 1)
    out["caveat"] = CAVEAT
    out["sampling"] = dict(SAMPLING)
    out["device"] = (card_info(device) if device.type == "cuda"
                     else {"platform": device.type})
    if os.path.isfile(OUT):   # the wall-clock runs' keys stay
        with open(OUT) as f:
            kept = json.load(f)
        out.update({k: kept[k] for k in MEASURED if k in kept})
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
