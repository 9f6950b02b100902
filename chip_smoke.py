#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the repository root

1. Builds the port's kernels from melspec_gpt_vqvae_tpu_torch/csrc (nvcc,
   sm_90a) and holds each against its plain PyTorch version on the card,
   at the shapes the generation round trip gives it, with TF32 off:
   A attention, B MelGAN resblock stack, C VQ nearest index, D mel.
2. Drives the round trip at the full VAS width (24-layer GPT, VQ-VAE,
   MelGAN) with seeded random weights, bf16 on the card: tokenize 48 clips
   of the parity battery, then a batch-8 GenerationService answering three
   requests.  Every kernel's launch count over this run must be > 0.
3. Holds a float32 copy of the round trip (2 GPT layers, same widths) on
   the card against the same weights on the CPU (plain PyTorch versions).

Exits non-zero, printing no result, when there is no CUDA card or any check
fails.  The last three lines of stdout are: a JSON object of the kernels,
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import copy
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, host seconds) of ``fn`` on the card, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention(dev):
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend, attend_xla
    g = torch.Generator(device=dev).manual_seed(0)
    # f32: the JAX package's own bound (tests/test_ops.py); bf16: outputs
    # are rounded to bf16 (2^-8 relative), so 1e-2 of max |out|
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for t in (1, 265, 266):
            for nu in (0, 266):
                q, k, v = (torch.randn(8, 16, t, 64, generator=g, device=dev)
                           .to(dtype) for _ in range(3))
                ref = attend_xla(q, k, v, nu)
                err = max_err(attend(q, k, v, nu), ref)
                tol = 2e-5 if dtype == torch.float32 else \
                    1e-2 * ref.float().abs().max().item()
                print(f"  A attention {str(dtype)[6:]:8s} T={t:3d} "
                      f"n_unmasked={nu:3d}: max|err| {err:.3g} "
                      f"(tol {tol:.3g})")
                check(err <= tol, f"attention {dtype} T={t} nu={nu}")
                errs[dtype] = max(errs.get(dtype, 0.0), err)
    # the slice's prefill: class prompt only, T = 1, batch 8, bf16
    q = torch.randn(8, 16, 1, 64, generator=g, device=dev).bfloat16()
    ms = cuda_ms(lambda: attend(q, q, q, 0), reps=200)
    plain = cuda_ms(lambda: attend_xla(q, q, q, 0), reps=200)
    q = torch.randn(8, 16, 266, 64, generator=g, device=dev).bfloat16()
    ms266 = cuda_ms(lambda: attend(q, q, q, 0))
    plain266 = cuda_ms(lambda: attend_xla(q, q, q, 0))
    print(f"  A timing bf16 (8,16,T,64): T=1 kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms; T=266 kernel {ms266:.4f} ms, plain "
          f"{plain266:.4f} ms")
    return {"max_abs_err": errs[torch.bfloat16], "ms": ms, "plain_ms": plain}


SPEC_FRAMES = 848   # vocoder input frames of one clip


def vocoder_stages(melgan):
    """(C, T) of each upsample stage's resblock stack for one clip: VAS is
    (256, 6784), (128, 54272), (64, 108544), (32, 217088)."""
    stages, t = [], SPEC_FRAMES
    for i, r in enumerate(melgan.cfg.ratios):
        t *= r
        stages.append((melgan.stage_blocks(i)[0].block_conv1.in_channels, t))
    return stages


def check_vocoder_stack(dev, melgan):
    from melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack import (
        fused_resblock_stack, resblock_stack)
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    # f32: 1e-4 absolute; bf16: every intermediate is rounded to bf16 as in
    # the plain version, so differences are a few bf16 ulps: 2e-2 of max|out|
    for dtype in (torch.float32, torch.bfloat16):
        model = copy.deepcopy(melgan).to(device=dev, dtype=dtype)
        for i, (c, t) in enumerate(vocoder_stages(melgan)):
            blocks = model.stage_blocks(i)
            x = torch.randn(2, c, t, generator=g, device=dev).to(dtype)
            with torch.no_grad():
                out = fused_resblock_stack(x, blocks)
                ref = resblock_stack(x, blocks)
            err = max_err(out, ref)
            edge = max(max_err(out[..., :13], ref[..., :13]),
                       max_err(out[..., -13:], ref[..., -13:]))
            tol = 1e-4 if dtype == torch.float32 else \
                2e-2 * ref.float().abs().max().item()
            print(f"  B resblock stack {str(dtype)[6:]:8s} C={c:3d} T={t:6d}: "
                  f"max|err| {err:.3g}, first/last 13 samples {edge:.3g} "
                  f"(tol {tol:.3g})")
            check(err <= tol and edge <= tol, f"resblock stack {dtype} C={c}")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
    # the slice's shapes: one batch-8 request, bf16, all four stages
    model = copy.deepcopy(melgan).to(device=dev, dtype=torch.bfloat16)
    xs = [torch.randn(8, c, t, generator=g, device=dev).bfloat16()
          for c, t in vocoder_stages(melgan)]
    ms, plain = 0.0, 0.0
    with torch.no_grad():
        for i, x in enumerate(xs):
            blocks = model.stage_blocks(i)
            k_ms = cuda_ms(lambda: fused_resblock_stack(x, blocks), reps=5)
            p_ms = cuda_ms(lambda: resblock_stack(x, blocks), reps=5)
            print(f"  B timing bf16 B=8 C={x.shape[1]}: kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")
            ms, plain = ms + k_ms, plain + p_ms
    return {"max_abs_err": errs[torch.bfloat16], "ms": ms, "plain_ms": plain}


def check_vq(dev):
    from melspec_gpt_vqvae_tpu_torch.ops.vq import (vq_nearest_index,
                                                   vq_nearest_index_xla)
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for k in (128, 1024):
        x = torch.randn(64 * 265, 256, generator=g, device=dev)
        cb = torch.randn(k, 256, generator=g, device=dev)
        out = vq_nearest_index(x, cb)
        ref = vq_nearest_index_xla(x, cb)
        rows = (out != ref).nonzero()[:, 0].cpu().numpy()
        # a row may differ only where its two candidates' float64 distances
        # lie within float32 rounding of the distance's terms
        x64, cb64 = x.double().cpu().numpy(), cb.double().cpu().numpy()
        e2 = (cb64 ** 2).sum(1)
        oi, ri = out.cpu().numpy(), ref.cpu().numpy()
        d_out = e2[oi] - 2 * (x64 * cb64[oi]).sum(1)
        d_ref = e2[ri] - 2 * (x64 * cb64[ri]).sum(1)
        gap = np.abs(d_out - d_ref)
        scale = (x64 ** 2).sum(1) + np.maximum(e2[oi], e2[ri]) + 2 * (
            np.abs(x64) * (np.abs(cb64[oi]) + np.abs(cb64[ri]))).sum(1)
        bad = rows[gap[rows] > 2.0 ** -18 * scale[rows]]
        print(f"  C vq nearest K={k:4d} N={x.shape[0]}: {len(rows)} rows "
              f"differ, all near-ties (float64 gap <= 2^-18 of the terms): "
              f"{len(bad) == 0}")
        check(len(bad) == 0, f"vq K={k}: {len(bad)} rows differ beyond "
                             "rounding")
        worst = max(worst, float(gap.max()))
    # the slice's shape: tokenize of 48 clips, K = 128
    x = torch.randn(48 * 265, 256, generator=g, device=dev)
    cb = torch.randn(128, 256, generator=g, device=dev)
    ms = cuda_ms(lambda: vq_nearest_index(x, cb))
    plain = cuda_ms(lambda: vq_nearest_index_xla(x, cb))
    print(f"  C timing N=12720 K=128: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain}


def check_mel(dev, wav, mel_cfg):
    from melspec_gpt_vqvae_tpu_torch.ops.mel import waveform_to_mel
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    out = waveform_to_mel_fused(wav, mel_cfg)
    ref = waveform_to_mel(wav, mel_cfg)
    err = max_err(out, ref)
    # the JAX package's bound for its Pallas mel (tests/test_mel.py:137)
    print(f"  D mel 48 battery clips {tuple(out.shape)}: max|err| {err:.3g} "
          "(tol 2e-3)")
    check(out.shape == (48, 80, 860) and err <= 2e-3, "mel kernel")
    ms = cuda_ms(lambda: waveform_to_mel_fused(wav, mel_cfg), reps=10)
    plain = cuda_ms(lambda: waveform_to_mel(wav, mel_cfg), reps=10)
    print(f"  D timing B=48: kernel {ms:.3f} ms, plain {plain:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain}


# ---------------------------------------------------------------------------
# 2. the main path, 3. float32 reference on the CPU
# ---------------------------------------------------------------------------


def check_request(out, n):
    check(out["tokens"].shape == (n, 265), f"tokens {out['tokens'].shape}")
    check(out["tokens"].min() >= 0 and out["tokens"].max() < 128,
          "tokens out of [0, 128)")
    check(out["specs"].shape == (n, 80, 848), f"specs {out['specs'].shape}")
    check(out["wavs"].shape == (n, 848 * 256), f"wavs {out['wavs'].shape}")
    check(np.isfinite(out["specs"]).all() and np.isfinite(out["wavs"]).all(),
          "non-finite output")
    check(np.abs(out["wavs"]).max() <= 1.0, "waveform outside [-1, 1]")


def reference_check(dev, exp, wav, seed):
    from melspec_gpt_vqvae_tpu_torch.models.gpt import gpt_apply, tree_to
    from melspec_gpt_vqvae_tpu_torch.pipeline import (GenerationPipeline,
                                                     tokenize)
    from melspec_gpt_vqvae_tpu_torch.serving import random_weights
    exp = dataclasses.replace(exp, model=exp.model.replace(
        n_layer=2, dtype="float32"))
    gpt, vq, voc = random_weights(exp, seed)
    cpu = GenerationPipeline(exp, gpt, copy.deepcopy(vq), copy.deepcopy(voc),
                             bf16=False)
    gpu = GenerationPipeline(exp, tree_to(gpt, device=dev), vq, voc,
                             bf16=False)
    cls = [1, 6]
    toks = cpu.generate_tokens(cls, None, sample=False)
    toks_gpu = gpu.generate_tokens(cls, None, sample=False).cpu()
    with torch.inference_mode():
        cond = gpt["class_emb"][torch.tensor(cls)][:, None]
        l_cpu = gpt_apply(cpu.gpt_params, exp.model, toks[:, :-1], cond)
        l_gpu = gpt_apply(gpu.gpt_params, exp.model, toks[:, :-1].to(dev),
                          cond.to(dev))
    specs = cpu.decode_specs(toks)
    specs_gpu = gpu.decode_specs(toks.to(dev))
    wavs = cpu.vocode(specs)
    wavs_gpu = gpu.vocode(specs.to(dev))
    codes = tokenize(cpu.vq, wav[:4].cpu(), exp.mel)
    codes_gpu = tokenize(gpu.vq, wav[:4], exp.mel).cpu()
    res = {"logits": max_err(l_gpu.cpu(), l_cpu),
           "specs": max_err(specs_gpu.cpu(), specs),
           "wavs": max_err(wavs_gpu.cpu(), wavs),
           "greedy_token_agreement": (toks_gpu == toks).float().mean().item(),
           "code_agreement": (codes_gpu == codes).float().mean().item(),
           "codes_unexplained": unexplained_flips(codes, codes_gpu, cpu.vq,
                                                  gpu.vq, wav[:4], exp.mel)}
    print(f"  reference (f32, 2-layer GPT, full-width VQ-VAE + MelGAN) card "
          f"vs CPU: {json.dumps(res)}")
    check(res["logits"] <= 1e-3, "teacher-forced logits vs CPU")
    check(res["specs"] <= 1e-3 and res["wavs"] <= 1e-3, "decode vs CPU")
    check(res["codes_unexplained"] == 0, "tokenize codes vs CPU")


def unexplained_flips(codes, codes_gpu, vq_cpu, vq_gpu, wav, mel_cfg):
    """Codes where the card picked b and the CPU a (GPT order, as tokenize
    returns them) although the difference of their latents cannot explain
    it.  With latents z (CPU) and z' (card), b can win on the card only if
    the float64 gap d_z(b) - d_z(a) <= 2 |z' - z| |e_a - e_b| (plus float32
    rounding of the terms); any other differing code is a fault."""
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    lat = []
    with torch.inference_mode():
        for vq, w in ((vq_cpu, wav.cpu()), (vq_gpu, wav)):
            mel = waveform_to_mel_fused(w, mel_cfg)[:, :, 6:854]
            z = vq.quant_conv(vq.encoder((2.0 * mel - 1.0)[:, None]))
            # (B, D, h, w) -> rows in tokenize's time-major order
            lat.append(z.permute(0, 3, 2, 1).reshape(-1, z.shape[1])
                       .double().cpu())
    z, z_gpu = lat
    a, b = codes.reshape(-1).long(), codes_gpu.reshape(-1).long()
    rows = (a != b).nonzero()[:, 0]
    cb = vq_cpu.quantize.embedding.detach().double()
    e2 = (cb * cb).sum(1)
    zr = z[rows]
    gap = (e2[b[rows]] - 2 * (zr * cb[b[rows]]).sum(1)) \
        - (e2[a[rows]] - 2 * (zr * cb[a[rows]]).sum(1))
    allowed = 2 * (z_gpu[rows] - zr).norm(dim=1) * (
        cb[a[rows]] - cb[b[rows]]).norm(dim=1) \
        + 2.0 ** -18 * ((zr ** 2).sum(1) + e2.max())
    return int((gap > allowed).sum())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from parity_check import make_battery

    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    from melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack import \
        fused_resblock_stack
    from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index
    from melspec_gpt_vqvae_tpu_torch.pipeline import tokenize
    from melspec_gpt_vqvae_tpu_torch.serving import (GenerationService,
                                                     build_pipeline)

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s, nvcc "
          f"{_build.build_seconds} s (None: library reused)")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"card: {smi_line}")

    exp, pipe = build_pipeline("vas", init_random=True, seed=783435,
                               device=dev)
    wav = torch.from_numpy(make_battery(exp.mel.clip_samples)).to(dev)
    check(wav.shape[0] == 48, "battery size")

    print("kernels vs plain PyTorch on the card:")
    results = {"attention": check_attention(dev),
               "vocoder_stack": check_vocoder_stack(dev, pipe.melgan),
               "vq_nearest": check_vq(dev),
               "mel": check_mel(dev, wav, exp.mel)}

    wrappers = {"attention": attend, "vocoder_stack": fused_resblock_stack,
                "vq_nearest": vq_nearest_index, "mel": waveform_to_mel_fused}
    for w in wrappers.values():
        w.launches = 0
    print("main path (VAS width, bf16, random weights):")
    tokenize(pipe.vq, wav, exp.mel)        # first call: cuDNN set-up
    codes, t_tok = wall(lambda: tokenize(pipe.vq, wav, exp.mel))
    stage = {"tokenize": t_tok}
    check(codes.shape == (48, 265) and int(codes.min()) >= 0
          and int(codes.max()) < 128, f"tokenize codes {codes.shape}")
    svc = GenerationService(exp, pipe, batch=8, seed=1)
    requests = [({}, list(range(8))), ({"sample": False}, [3] * 8),
                ({"seed": 1234, "top_p": 0.9}, [0, 1, 2, 3, 4, 5, 6, 7])]
    for kw, cls in requests:
        t0 = time.perf_counter()
        out = svc.generate(cls, **kw)
        check_request(out, 8)
        print(f"  request {kw or 'sampled top_k=100'}: "
              f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(5)
    toks, stage["gpt_decode"] = wall(
        lambda: pipe.generate_tokens(list(range(8)), gen))
    specs, stage["vq_decode"] = wall(lambda: pipe.decode_specs(toks))
    _, stage["vocoder"] = wall(lambda: pipe.vocode(specs))
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  stage seconds (batch 8; tokenize 48 clips): "
          f"{json.dumps({k: round(v, 4) for k, v in stage.items()})}")
    print(f"  launches: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")

    print("float32 reference on the CPU:")
    reference_check(dev, exp, wav, seed=7)

    meta = {"attention": ("attention.cu", "attention.py:114"),
            "vocoder_stack": ("vocoder_stack.cu", "vocoder_pallas.py:143"),
            "vq_nearest": ("vq.cu", "vq.py:37"),
            "mel": ("mel.cu", "mel_pallas.py:54")}
    kernels = [{"name": name, "route": "cuda",
                "source": "melspec_gpt_vqvae_tpu_torch/csrc/" + src,
                "replaces": "melspec_gpt_vqvae_tpu/ops/" + rep,
                "launches": launches[name],
                **results[name]} for name, (src, rep) in meta.items()]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
