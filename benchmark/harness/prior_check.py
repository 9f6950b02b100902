"""The comparison that decides ``correct`` in a cell that samples a GPT-VAE
from its prior: what the timed path produced against the plain float32
reference (reference/prior.py for the decoder, reference/detok.py for the
detok), run once the window has closed and the program's state is freed.

The numbers are those of the class cells (harness/compare.py), read at the
same positions.  The latents are the traffic's, not the program's: the
harness draws each kept row's latent again from its batch's seed, as the
mix defines it (the batch's N(0, I) draw, the first of its generator),
holds the latents the program returned to that draw, and teacher-forces
the decoder's reference on its own draw and the program's tokens.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import detok as ref_detok
from reference import gpt as ref_gpt
from reference import prior as ref_prior

from . import program, weights
from .compare import _below_best, _max_err


def decoder_weights(cfg: Dict, seed: int, device, dtype) -> Dict:
    """The GPT-VAE decoder's parameter tree in the served type, drawn from
    the seed (the program and the reference draw the same leaves)."""
    flat = weights.draw(weights.gpt_specs(ref_prior.param_shapes(
        cfg["model"])), seed, "prior_decoder", device, dtype)
    return ref_gpt.nest(flat)


def detok_readings(cfg: Dict, seed: int, device, tokens, specs,
                   wavs) -> Dict[str, float]:
    """The largest elementwise error of the served waveforms against the
    reference's decode of the served tokens, and of MelGAN alone (the
    reference vocoding the served spectrograms), each over the reference's
    largest sample; the spectrogram's beside them, not compared."""
    vq_w, mg_w = program.detok_weights(
        cfg, seed, device, program.DTYPES[cfg["serving"]["conv_dtype"]])
    vq, mg = program.reference_detok(cfg, vq_w, mg_w, device)
    spec_ref, wav_ref, stage = [], [], []
    v = cfg["vqvae"]
    specs, wavs = specs.to(device), wavs.to(device)
    with torch.no_grad(), ref_gpt.fp32_scope():
        for i in range(0, tokens.shape[0], 4):
            s, w = ref_detok.detok(vq, mg, tokens[i:i + 4].to(device),
                                   v["code_h"], v["code_w"])
            spec_ref.append(s)
            wav_ref.append(w)
            stage.append(mg(ref_detok.spec_to_mel01(specs[i:i + 4].float())))
    return {"spec_max_err": _max_err(specs, torch.cat(spec_ref)),
            "wav_max_err": _max_err(wavs, torch.cat(wav_ref)),
            "vocoder_max_err": _max_err(wavs, torch.cat(stage))}


def traffic_latents(seeds, rows, batch: int, nz: int,
                    device) -> torch.Tensor:
    """The latents (len(rows), nz) float32 the mix gives the kept rows:
    row ``rows[i]`` of the (batch, nz) N(0, I) draw of a generator on
    ``device`` seeded with ``seeds[i]``."""
    out = []
    for s, r in zip(seeds.tolist(), rows.tolist()):
        g = torch.Generator(device=device).manual_seed(int(s))
        out.append(torch.randn((batch, nz), generator=g, device=device)[r])
    return torch.stack(out)


def prior_readings(cfg: Dict, seed: int, device, greedy, sampled,
                   top_k: int, batch: int,
                   int4_ref: bool = False) -> Dict[str, float]:
    """``greedy`` (batch seeds, rows, latents, tokens, spectrograms,
    waveforms) and ``sampled`` (batch seeds, rows, latents, tokens) rows
    against the reference teacher-forced on each row's latent of the mix
    (``traffic_latents``) and served tokens.  ``latent_max_err``: the
    largest distance of a latent the program returned from the mix's,
    over the mix's largest; ``logit_gap``: the widest gap by which a greedy
    token's reference logit lies below the reference's best; ``topk_gap``:
    the widest distance by which a sampled token's lies below the
    reference's ``top_k``-th largest; ``int4_ref``: the control's
    ``logit_gap_int4``, that of the token a reference with int4 products
    and K/V puts first; then the detok's readings (``detok_readings``)."""
    model = cfg["model"]
    nz = cfg["vae"]["nz"]
    z, s_z = (traffic_latents(r[0], r[1], batch, nz, device)
              for r in (greedy, sampled))
    served = torch.cat([greedy[2], sampled[2]]).to(device)
    out = {"latent_max_err": _max_err(served, torch.cat([z, s_z]))}
    params = decoder_weights(cfg, seed, device,
                             program.DTYPES[cfg["dtypes"]["dtype"]])
    toks = greedy[3].to(device).long()
    logits = ref_prior.prior_logits(params, model, z, toks)
    out["logit_gap"] = float(_below_best(logits, toks).max())
    if int4_ref:
        low = ref_prior.prior_logits(params, model, z, toks,
                                     matmul=ref_gpt.int4_matmul,
                                     kv=ref_gpt.int4_kv)
        out["logit_gap_int4"] = float(_below_best(logits,
                                                  low.argmax(-1)).max())
        del low
    del logits
    s_toks = sampled[3].to(device).long()
    logits = ref_prior.prior_logits(params, model, s_z, s_toks)
    kth = logits.topk(top_k, dim=-1).values[..., -1]
    below = kth - logits.gather(-1, s_toks[..., None])[..., 0]
    out["topk_gap"] = float(below.max())
    del params, logits
    return {**out, **detok_readings(cfg, seed, device, *greedy[3:])}
