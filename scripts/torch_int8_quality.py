#!/usr/bin/env python
"""Quality gate of the PyTorch port's int8 decode stage
(models/quantized.py) on a TRAINED decoder.  The port of
scripts/int8_quality.py, on the card.

The int8 VQ-decoder + vocoder stage runs int8 ACTIVATIONS through a GAN
decoder, so it is held against the bfloat16 stage the pipeline serves
(the VQ-VAE's ``decode_code`` through cuDNN, the MelGAN through kernel B)
on the same code grids:

  1. trained decoder: the tone-battery codec of
     scripts/torch_quality_proof.py (``small_codec_cfg`` with the
     adversarial phase off, ``train_codec``, ``IQ_VQ_STEPS`` steps) is
     trained, the battery tokenized by it (kernel C), the grids decoded by
     both stages: spectrogram SNR, every clip's dominant mel bin (the class
     signal QUALITY_TORCH.json scores), waveform SNR and the mel distance
     of the two vocoded waveforms (the vocoder's weights are random);
  1b. the int8 ENCODER (``extract_codes --int8``): its codes' agreement
     with the bfloat16 encoder's (the JAX record's figure) and with the
     float32 encoder's, calibrated on the first batch of 8 as the CLI
     does;
  2. reference scale: the ``VQVAEConfig`` / ``VocoderConfig`` shapes with
     seeded random weights, bfloat16 against int8 on 32 random grids.

The gates are the JAX script's: trained spectrogram SNR >= 25 dB,
dominant-bin match >= 0.95, reference-scale spectrogram SNR >= 20 dB.
Writes INT8_DECODE_TORCH.json (INT8_DECODE.json is the TPU's record) with
``pass``, the minutes and the card, then exits non-zero if a gate failed.
With ``IQ_SWEEP=1`` it runs only the reference-scale sweep over the
calibration percentile and the int8 transposes (``sweep``).

Usage, on a machine with the card: python3 scripts/torch_int8_quality.py
"""

import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from melspec_gpt_vqvae_tpu_torch import bridge  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.configs import (  # noqa: E402
    MelConfig, VocoderConfig, VQVAEConfig)
from melspec_gpt_vqvae_tpu_torch.feature_extraction import \
    tf32_flags  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models import quantized as qz  # noqa
from melspec_gpt_vqvae_tpu_torch.models.vocoder import \
    MelGANGenerator  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.models.vqvae import VQModel  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
    waveform_to_mel_fused  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import \
    VQVAETask  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import (  # noqa: E402
    make_tone_battery, wavs_to_training_mels)
from torch_quality_proof import (card_info, encode_grids,  # noqa: E402
                                 small_codec_cfg, train_codec)

VQ_STEPS = int(os.environ.get("IQ_VQ_STEPS", "300"))
OUT = os.path.join(ROOT, "INT8_DECODE_TORCH.json")
GATES = {"trained_spec_snr_db_min": 25.0,
         "trained_dominant_bin_match_min": 0.95,
         "ref_scale_spec_snr_db_min": 20.0}


def snr_db(ref, x):
    ref = np.asarray(ref, np.float32)
    err = np.asarray(x, np.float32) - ref
    return float(10 * np.log10(np.mean(ref ** 2) /
                               max(float(np.mean(err ** 2)), 1e-20)))


def seeded(model, seed, device):
    """``model`` with seeded random weights (bridge.init_conv_net_, drawn
    on the CPU), in bfloat16 on ``device``."""
    bridge.init_conv_net_(model, torch.Generator().manual_seed(seed))
    return model.to(device, torch.bfloat16).eval()


@torch.inference_mode()
def decode_pair(vq, melgan, vcfg, vocfg, grids, batch=16, **qkw):
    """(float spec, float wav, int8 spec, int8 wav) as float32 numpy for
    the same (N, code_h, code_w) grids: the bfloat16 stage of the pipeline
    (``decode_code``, the MelGAN through kernel B) and the int8 stage
    calibrated by ``build_qstate(**qkw)``."""
    qstate = qz.build_qstate(vq, melgan, vcfg, vocfg, **qkw)
    ex = qz.Int8Convs(qstate)
    outs = {"f": ([], []), "q": ([], [])}
    for i in range(0, grids.shape[0], batch):
        g = grids[i:i + batch]
        for name in ("f", "q"):
            spec = (vq.decode_code(g) if name == "f"
                    else qz.decode_code_apply(vq, vcfg, g, ex))[..., 0]
            mel = torch.clamp((spec.float() + 1) / 2, 0, 1).to(
                spec.dtype).transpose(1, 2)
            wav = (melgan(mel) if name == "f"
                   else qz.melgan_apply(melgan, vocfg, mel, ex))
            outs[name][0].append(spec.float().cpu().numpy())
            outs[name][1].append(wav.float().cpu().numpy())
    return tuple(np.concatenate(x) for x in outs["f"] + outs["q"])


def reference_scale(voc, device, **qkw):
    """The ``VQVAEConfig`` shapes with seeded random weights against the
    int8 stage on 32 seeded random grids (numpy's generator, as the JAX
    script's)."""
    vcfg = VQVAEConfig()
    vq = seeded(VQModel(vcfg), 1, device)
    grids = torch.as_tensor(np.random.default_rng(1).integers(
        0, vcfg.num_embeddings, (32, vcfg.code_h, vcfg.code_w)),
        device=device)
    return decode_pair(vq, voc, vcfg, VocoderConfig(), grids, **qkw)


def sweep(device):
    """Reference scale only, over the calibration percentile and the
    int8 transposes (``build_qstate``'s knobs)."""
    voc = seeded(MelGANGenerator(VocoderConfig()), 3, device)
    rows = []
    for pct in (1.0, 0.9999, 0.999):
        for tr in (True, False):
            spec_f, wav_f, spec_q, wav_q = reference_scale(
                voc, device, percentile=pct, int8_transpose=tr)
            row = {"percentile": pct, "int8_transpose": tr,
                   "spec_snr_db": round(snr_db(spec_f, spec_q), 2),
                   "wav_snr_db": round(snr_db(wav_f, wav_q), 2)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"sweep": rows, "device": card_info(device)}))


@torch.inference_mode()
def encoder_agreement(model, vcfg, x_all, device):
    """The int8 encoder's codes against the bfloat16 encoder's (calibrated
    on the first 32 clips, as the JAX script) and against the float32
    encoder's with TF32 off (calibrated on the first batch of 8, as
    ``extract_codes --int8``, and run, as there, under the caller's TF32
    flags)."""
    def agree(m, n_calib, batch):
        x = torch.as_tensor(x_all, device=device).to(
            m.quant_conv.weight.dtype)
        ex = qz.Int8Convs(qz.build_encode_qstate(m, vcfg, x[:n_calib]))
        out = []
        for i in range(0, len(x), batch):
            with tf32_flags():
                a = qz.encode_to_indices_apply(m, vcfg, x[i:i + batch],
                                               qz.FloatConvs())
            b = qz.encode_to_indices_apply(m, vcfg, x[i:i + batch], ex)
            out.append((a == b).float().mean().item())
        return round(float(np.mean(out)), 4)

    bf16 = agree(copy.deepcopy(model).to(torch.bfloat16), 32, 16)
    f32 = agree(model, 8, 8)
    return {"code_agreement_vs_bf16": bf16, "code_agreement_vs_f32": f32,
            "note": "extract_codes --int8 only; the parity path stays "
                    "float32 with TF32 off"}


def trained_check(device):
    """Train the battery codec, tokenize the battery with it and hold the
    int8 stage against the bfloat16 stage on its grids.  Returns (the
    ``trained`` record, the codec, the training mels, the vocoder)."""
    mcfg = MelConfig()
    wavs, _, _ = make_tone_battery(mcfg)
    n = len(wavs)
    _, x_all = wavs_to_training_mels(wavs, mcfg, device)
    vcfg = small_codec_cfg(disc_start=10 ** 9)
    task = VQVAETask(vcfg, device)
    state, logs = train_codec(task, task.init_state(0), x_all, VQ_STEPS,
                              np.random.default_rng(0), every=100)
    rec = float(logs[-1]["train/rec_loss"])
    print(f"vqvae final rec {rec:.4f}", flush=True)
    model = state["model"].eval()
    grids = torch.as_tensor(encode_grids(model, x_all, device),
                            device=device)

    voc = seeded(MelGANGenerator(VocoderConfig()), 3, device)
    vq_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    spec_f, wav_f, spec_q, wav_q = decode_pair(vq_bf16, voc, vcfg,
                                               VocoderConfig(), grids)
    # the dominant mel bin of each clip: the class signal of the proof
    dom_f = ((spec_f + 1) / 2).mean(axis=2).argmax(axis=1)
    dom_q = ((spec_q + 1) / 2).mean(axis=2).argmax(axis=1)

    def mels_of(w):
        with torch.inference_mode():
            return np.concatenate([waveform_to_mel_fused(torch.as_tensor(
                w[i:i + 16, :mcfg.clip_samples], device=device), mcfg)
                .cpu().numpy() for i in range(0, n, 16)])
    mw_f, mw_q = mels_of(wav_f), mels_of(wav_q)
    trained = {
        "spec_snr_db": round(snr_db(spec_f, spec_q), 2),
        "dominant_bin_match": float((dom_f == dom_q).mean()),
        "wav_snr_db": round(snr_db(wav_f, wav_q), 2),
        "wav_mel_l1": round(float(np.abs(mw_f - mw_q).mean()), 5),
        "wav_mel_l1_ref_scale": round(float(np.abs(mw_f).mean()), 5),
        "vq_rec_loss": round(rec, 4),
        "clips": int(n),
    }
    return trained, model, x_all, voc


def main(device=None):
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_int8_quality: no CUDA device; the gate runs "
                         "on the card")
    t0 = time.time()
    result = {}
    result["trained"], model, x_all, voc = trained_check(device)
    print(json.dumps(result["trained"]), flush=True)
    result["encoder"] = encoder_agreement(model, model.cfg, x_all, device)
    print(json.dumps(result["encoder"]), flush=True)
    spec_f, wav_f, spec_q, wav_q = reference_scale(voc, device)
    result["reference_scale_random"] = {
        "spec_snr_db": round(snr_db(spec_f, spec_q), 2),
        "wav_snr_db": round(snr_db(wav_f, wav_q), 2), "batch": 32}
    print(json.dumps(result["reference_scale_random"]), flush=True)
    result["minutes"] = round((time.time() - t0) / 60, 2)
    result["gates"] = dict(GATES)
    checks = {
        "trained_spec_snr_db_min": result["trained"]["spec_snr_db"],
        "trained_dominant_bin_match_min":
            result["trained"]["dominant_bin_match"],
        "ref_scale_spec_snr_db_min":
            result["reference_scale_random"]["spec_snr_db"]}
    failed = [k for k, v in checks.items() if v < GATES[k]]
    result["pass"] = not failed
    result["failed_gates"] = failed
    result["vq_steps"] = VQ_STEPS
    result["device"] = card_info(device) if device.type == "cuda" \
        else {"platform": "cpu"}
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if failed:
        raise SystemExit(f"torch_int8_quality: gates failed: {failed}")
    return result


if __name__ == "__main__":
    if os.environ.get("IQ_SWEEP") == "1":
        sweep(torch.device("cuda"))
    else:
        main()
