#!/usr/bin/env python
"""Speculative decoding timed end to end on a TRAINED pair, on the card:
the port of scripts/spec_measured.py.

The recipe of scripts/torch_spec_acceptance.py at the VAS geometry: the
ch-32 tone codec of scripts/torch_quality_proof.py (reconstruction phase)
tokenizes the battery, then a target GPT at the VAS width (24 layers, 16
heads, 1024 wide, vocab 128, block 266; reference config_GPT_vas.py) and
a 2-layer draft of the same width train on the same codes through
``GPTTask`` -- lr 3e-4, batch 8, dropout 0.1, remat ``attn``, mixed
precision, 400 steps each, as the JAX script trains them.  Then, in the
deployment dtypes (bfloat16 parameters, int8 KV cache, int8 streamed
block weights), at batch 1 with top_k 16 and temperature 0.9:

  * the plain ``gpt_generate`` (8 cache segments), the latency regime
    speculative decoding exists for;
  * ``gpt_speculative_generate`` for gamma 2, 4 and 8, with the pair's
    realised acceptance;
  * the speed-up plain_ms / spec_ms, measured, not modelled.

Each is one warm-up call (the kernels' build, the int8 weights, the
decode programs' capture), then ``ITERS`` timed calls on the kept
programs, each ended by ``torch.cuda.synchronize``.

``SM_CORPUS=hard`` swaps the tone battery for the mixture corpus
(utils/battery.py::make_hard_battery: noise bands, chirps, AM tones,
chords, per-clip random parameters) and writes ``measured_e2e_hard``.
Writes ``measured_e2e`` (or ``measured_e2e_hard``) into
SPEC_ACCEPTANCE_TORCH.json with SPEC_ACCEPTANCE.json's keys plus the
card, and leaves every other key of the file as it is.  ``SM_CORPUS``
is the one knob, the JAX script's; the geometry and counts are not.

Usage, on a machine with the card: python3 scripts/torch_spec_measured.py
(and SM_CORPUS=hard python3 scripts/torch_spec_measured.py)
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

from torch_quality_proof import (card_info, encode_grids,  # noqa: E402
                                 small_codec_cfg, train_codec)
from torch_spec_acceptance import train_gpt  # noqa: E402

from melspec_gpt_vqvae_tpu_torch.configs import (  # noqa: E402
    DataConfig, ExperimentConfig, GPTConfig, MelConfig, TrainConfig)
from melspec_gpt_vqvae_tpu_torch.models.decode_graph import \
    DecodeGraphs  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.gpt import (  # noqa: E402
    DTYPES, class_embed, gpt_generate, quantize_block_weights)
from melspec_gpt_vqvae_tpu_torch.models.speculative import \
    gpt_speculative_generate  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    N_CLASSES, make_hard_battery, make_tone_battery, wavs_to_training_mels)

VQ_STEPS = 300
GPT_STEPS = 400
ITERS = 8
BATCH = 1
TARGET_LAYERS = 24
DRAFT_LAYERS = 2
EMBD = 1024
HEADS = 16
CORPUS = os.environ.get("SM_CORPUS", "tones")
GAMMAS = (2, 4, 8)
STEPS, TOP_K, TEMPERATURE = 265, 16, 0.9
OUT = os.path.join(ROOT, "SPEC_ACCEPTANCE_TORCH.json")


def exp_for(layers):
    """The VAS geometry at ``layers`` with a recipe that trains on tones
    (the JAX script's): remat ``attn`` and mixed precision, as the VAS VAE
    preset carries them."""
    g = GPTConfig(vocab_size=128, block_size=266, n_layer=layers,
                  n_head=HEADS, n_embd=EMBD, class_size=N_CLASSES,
                  embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1,
                  remat=True, remat_policy="attn", mixed_precision=True)
    return ExperimentConfig(model=g,
                            train=TrainConfig(learning_rate=3e-4, epochs=1,
                                              batch_size=8),
                            data=DataConfig(batch_size=8))


def deployment(params, cfg, on_card):
    """(params, config) in the deployment dtypes: bfloat16 parameters, int8
    cache and int8 block weights on the card (float32 and no quantisation
    on the CPU, as the JAX script off its chip)."""
    cfg = cfg.replace(dtype="bfloat16" if on_card else "float32",
                      cache_dtype="int8" if on_card else "auto",
                      decode_weight_dtype="int8" if on_card else "auto")
    return _cast(params, DTYPES[cfg.dtype]), cfg


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.detach().to(dtype)


def timed(fn, device):
    """(seconds a call over ``ITERS`` calls after one warm-up call, the
    last call's output); each call is ended by a synchronize."""
    def call(seed):
        out = fn(torch.Generator(device=device).manual_seed(seed))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out
    call(99)
    out, total = None, 0.0
    for i in range(ITERS):
        t0 = time.perf_counter()
        out = call(i)
        total += time.perf_counter() - t0
    return total / ITERS, out


def merge(key, measured):
    """``measured`` under ``key`` in the record at ``OUT``, every other key
    left as it is."""
    out = {}
    if os.path.isfile(OUT):
        with open(OUT) as f:
            out = json.load(f)
    out[key] = measured
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)


def main(device=None):
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_spec_measured: no CUDA device; the wall "
                             "clock is measured on the card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    t_start = time.time()
    mcfg = MelConfig()
    battery = make_hard_battery if CORPUS == "hard" else make_tone_battery
    wavs, labels, _ = battery(mcfg)
    _, x_all = wavs_to_training_mels(wavs, mcfg, device)

    vcfg = small_codec_cfg(disc_start=10 ** 9)
    rng = np.random.default_rng(0)
    vq_task = VQVAETask(vcfg, device)
    vstate, _ = train_codec(vq_task, vq_task.init_state(0), x_all, VQ_STEPS,
                            rng, every=100)
    grids = encode_grids(vstate["model"], x_all, device)
    del vq_task, vstate

    print(f"training the target GPT ({TARGET_LAYERS}L/{EMBD}d):", flush=True)
    t_exp = exp_for(TARGET_LAYERS)
    t_params, t_loss = train_gpt(t_exp, grids, labels, rng, GPT_STEPS, 0,
                                 device)
    print(f"training the draft GPT ({DRAFT_LAYERS}L/{EMBD}d):", flush=True)
    d_exp = exp_for(DRAFT_LAYERS)
    d_params, d_loss = train_gpt(d_exp, grids, labels, rng, GPT_STEPS, 1,
                                 device)

    with torch.no_grad():
        t_params, tcfg = deployment(t_params, t_exp.model, on_card)
        d_params, dcfg = deployment(d_params, d_exp.model, on_card)
        cls = torch.zeros((BATCH,), dtype=torch.long, device=device)
        cond = class_embed(t_params, cls)
        d_cond = class_embed(d_params, cls)
        # what a server keeps across requests: the int8 block weights and
        # the captured programs (a holder a mode, so none is evicted)
        wq = (quantize_block_weights(t_params["blocks"])
              if tcfg.decode_weight_dtype == "int8" else None)
        d_wq = (quantize_block_weights(d_params["blocks"])
                if dcfg.decode_weight_dtype == "int8" else None)

        def holder():
            return DecodeGraphs() if on_card else None
        graphs = holder()
        plain_s, _ = timed(lambda g: gpt_generate(
            t_params, tcfg, g, cond, steps=STEPS, top_k=TOP_K,
            temperature=TEMPERATURE, segments=8, wq=wq, graph=graphs),
            device)
        print(json.dumps({"mode": "plain", "ms": round(plain_s * 1e3, 1)}),
              flush=True)
        gammas = {}
        for gamma in GAMMAS:
            graphs = holder()
            s, (_, stats) = timed(lambda g: gpt_speculative_generate(
                t_params, tcfg, d_params, dcfg, g, cond, d_cond,
                steps=STEPS, gamma=gamma, temperature=TEMPERATURE,
                top_k=TOP_K, wq=wq, draft_wq=d_wq, graph=graphs), device)
            row = {"spec_ms": round(s * 1e3, 1),
                   "measured_speedup": round(plain_s / s, 2),
                   "realized_acceptance": round(
                       float(stats["accepted"])
                       / max(1.0, float(stats["drafted"])), 3),
                   "rounds": int(stats["rounds"])}
            gammas[str(gamma)] = row
            print(json.dumps({"gamma": gamma, **row}), flush=True)

    best = max(gammas.values(), key=lambda r: r["measured_speedup"])
    measured = {
        "platform": "gpu" if on_card else device.type,
        "batch": BATCH,
        "target": f"{TARGET_LAYERS}L/{EMBD}d, loss {t_loss:.3f}",
        "draft": f"{DRAFT_LAYERS}L/{EMBD}d, loss {d_loss:.3f}",
        "plain_ms": round(plain_s * 1e3, 1),
        "spec_ms": best["spec_ms"],
        "measured_speedup": best["measured_speedup"],
        "realized_acceptance": best["realized_acceptance"],
        "per_gamma": gammas,
        "sampling": {"temperature": TEMPERATURE, "top_k": TOP_K},
        "minutes": round((time.time() - t_start) / 60, 1),
        "corpus": CORPUS,
        "caveat": (
            "trained on the tone battery (easy data) -> the acceptance, "
            "and so the speed-up, is a MEASURED optimistic ceiling at "
            "deployment geometry (measured_e2e_hard quantifies the gap)"
            if CORPUS != "hard" else
            "mixture corpus (noise bands/chirps/AM/chords, per-clip "
            "random parameters): real conditional entropy in the token "
            "stream -- the realistic-acceptance companion to the tone "
            "ceiling in measured_e2e"),
        "dtypes": {"params": tcfg.dtype, "cache": tcfg.cache_dtype,
                   "decode_weights": tcfg.decode_weight_dtype},
        "device": card_info(device) if on_card else {"platform": "cpu"},
    }
    merge("measured_e2e_hard" if CORPUS == "hard" else "measured_e2e",
          measured)
    print(json.dumps(measured))
    return measured


if __name__ == "__main__":
    main()
