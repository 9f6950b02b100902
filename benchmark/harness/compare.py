"""The comparisons that decide ``correct``: what the timed path produced
against the plain float32 reference, run once the window has closed and
the program's state is freed.

Each number compared has its limit in benchmark/checks/<workload>.json;
``correct`` holds when every number is at or under its limit (a NaN is
not).  PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from reference import detok as ref_detok
from reference import gpt as ref_gpt
from reference import gpt_vae as ref_vae

from . import program

Check = Dict[str, float]


def judged(name: str, value: float, limit: float) -> Check:
    return {"name": name, "value": float(value), "limit": float(limit)}


def passed(checks: List[Check]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks)


def _max_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest elementwise distance over the reference's largest
    magnitude."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _below_best(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(N, T): how far each token's reference logit lies below the
    reference's best at its position."""
    served = logits.gather(-1, tokens[..., None])[..., 0]
    return logits.max(-1).values - served


def decode_readings(params, model: Dict, greedy, sampled, top_k: int,
                    device, int4_ref: bool = False) -> Dict[str, float]:
    """The served tokens against the reference, teacher-forced on the
    prompt and the served tokens before each position.  Greedy rows: the
    widest gap by which a served token's reference logit lies below the
    reference's best (``logit_gap``).  Sampled rows: the widest distance
    by which a served token's reference logit lies below the reference's
    ``top_k``-th largest (``topk_gap``; the program samples only among its
    own ``top_k`` best).  ``int4_ref``: the control's ``logit_gap``, that
    of the token a reference with int4 products and K/V puts first
    (``logit_gap_int4``)."""
    cls, toks = (t.to(device) for t in greedy[:2])
    toks = toks.long()
    logits = ref_gpt.class_logits(params, model, cls, toks)
    gap = _below_best(logits, toks)
    out = {"logit_gap": float(gap.max())}
    if int4_ref:
        low = ref_gpt.class_logits(params, model, cls, toks,
                                   matmul=ref_gpt.int4_matmul,
                                   kv=ref_gpt.int4_kv)
        out["logit_gap_int4"] = float(_below_best(logits,
                                                  low.argmax(-1)).max())
        del low
    del logits
    s_cls, s_toks = (t.to(device) for t in sampled)
    s_toks = s_toks.long()
    logits = ref_gpt.class_logits(params, model, s_cls, s_toks)
    kth = logits.topk(top_k, dim=-1).values[..., -1]
    below = kth - logits.gather(-1, s_toks[..., None])[..., 0]
    out["topk_gap"] = float(below.max())
    return out


def served_readings(cfg: Dict, seed: int, device, greedy, sampled,
                    top_k: int, int4_ref: bool = False) -> Dict[str, float]:
    """A class-GPT round trip's served rows against the reference:
    ``greedy`` (classes, tokens, spectrograms, waveforms) and ``sampled``
    (classes, tokens) rows.  The decode's gaps (``decode_readings``); the
    largest elementwise error of the waveform against the reference's
    decode of the served greedy tokens, and of MelGAN alone (the
    reference vocoding the served spectrograms), each over the
    reference's largest sample; the spectrogram's beside them, not
    compared."""
    model = cfg["model"]
    params = program.gpt_weights(model, seed, device,
                                 program.DTYPES[cfg["dtypes"]["dtype"]])
    out = decode_readings(params, model, greedy, sampled, top_k, device,
                          int4_ref)
    del params
    _, tokens, specs, wavs = greedy
    vq_w, mg_w = program.detok_weights(
        cfg, seed, device, program.DTYPES[cfg["serving"]["conv_dtype"]])
    vq, mg = program.reference_detok(cfg, vq_w, mg_w, device)
    spec_ref, wav_ref = [], []
    v = cfg["vqvae"]
    with ref_gpt.fp32_scope():
        for i in range(0, tokens.shape[0], 4):
            s, w = ref_detok.detok(vq, mg, tokens[i:i + 4].to(device),
                                   v["code_h"], v["code_w"])
            spec_ref.append(s)
            wav_ref.append(w)
    spec_ref, wav_ref = torch.cat(spec_ref), torch.cat(wav_ref)
    specs, wavs = specs.to(device), wavs.to(device)
    # the vocoder alone: the reference's MelGAN on the served spectrograms
    stage = []
    with torch.no_grad(), ref_gpt.fp32_scope():
        for i in range(0, specs.shape[0], 4):
            stage.append(mg(ref_detok.spec_to_mel01(specs[i:i + 4].float())))
    stage = torch.cat(stage)
    return {**out,
            "spec_max_err": _max_err(specs, spec_ref),
            "wav_max_err": _max_err(wavs, wav_ref),
            "vocoder_max_err": _max_err(wavs, stage)}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    names = sorted(leaves if leaves is not None else ref)
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """A training cell's first steps against the reference's: each step's
    loss (the worst step's relative gap), the first gradient's norm by
    leaf, and the norm of each leaf's change over the steps.  The change
    leaves out the leaves whose reference gradient is under a thousandth
    of the median leaf's (a key's bias under softmax: moved by round-off
    alone under Adam)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"]))
    g = ref["first_grad"]
    med = statistics.median(g.values())
    moved = [n for n in g if g[n] >= 1e-3 * med]
    return {"loss_rel_gap": loss,
            "grad_norm_gap": leaf_gap(prog["first_grad"], g),
            "change_norm_gap": leaf_gap(prog["change"], ref["change"],
                                        moved),
            "change_leaves_left_out": float(len(g) - len(moved))}


def reference_train(cfg: Dict, seed: int, device, steps, matmul=None):
    """The reference's first steps from the benchmark's weights."""
    flat = program.vae_weights(cfg["model"], seed, device)
    out = ref_vae.train_steps(flat, cfg["model"], cfg["train"], steps,
                              **({} if matmul is None else
                                 {"matmul": matmul}))
    del flat
    return out


def checks_of(readings: Dict[str, float], limits: Dict) -> List[Check]:
    return [judged(n, readings.get(n, math.nan), limits[n])
            for n in limits]
