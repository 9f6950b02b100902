#!/usr/bin/env python3
"""Device time of the PyTorch port's kernels A, C, D, E, B and F in two
checkouts, on one card, in one run.

    python3 scripts/torch_kernel_compare.py --parent DIR [--out FILE]
                                            [--kernels A,C,D,E,B,F]

``DIR`` holds another commit of this repository (for instance
``git archive <commit> | tar -x -C build/parent``).  The script measures
parent, this tree, this tree, parent -- each in a process of its own that
imports the port from that checkout and builds its kernels there -- and
prints one JSON object with the four readings and the card's name and
power limit.  Per reading: kernel A (``attend``, (8, 16, T, 64)) at
T = 1 and 266 in bfloat16 and T = 265 in float32, causal and with the full
window; kernel C (``vq_nearest_index``, D = 256) at the tokenize shape
(N = 12,720, K = 128) and at the widest codebook (N = 16,960, K = 1024);
kernel D (``waveform_to_mel_fused``) on the 48 battery clips;
kernel E (``decode_attend_int8``, int8 and int4
cache, bfloat16 q, pos = T - 1) at batch 8 and 1 for every cache length of
a VAS decode in 8 segments, at a host position without a write and, in a
checkout whose wrapper takes them, with the position in device memory and
the new slot's write in the launch; and kernel B (``fused_resblock_stack``,
bfloat16) on the four MelGAN stages of a batch-8 request, and kernel F
(``flash_attention_fwd`` / ``flash_attention_bwd``, float32, (8, 16, T, 64))
forward and backward (delta, dQ and dK/dV kernels together) at T = 265
with keep 0.5 and keep 1, n_unmasked 0 and T, and at T = 266.  A time is the
kernel's own device time in milliseconds per call, taken by this checkout's
``chip_smoke.device_ms`` (a ``torch.profiler`` window; the wrapper's host
work is not in it) at chip_smoke.py's shapes.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


F_CASES = ((265, 0.5, 0), (265, 1.0, 0), (265, 0.5, 265), (265, 1.0, 265),
           (266, 0.5, 0))   # (T, keep_prob, n_unmasked)


def measure(root, kernels):
    """One reading: the port imported from the checkout at ``root``, timed
    with this checkout's chip_smoke.py (its ``device_ms``, cache lengths,
    cache maker and stage shapes), so both trees are read one way."""
    import importlib.util
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    print(json.dumps({name: READERS[name](smoke, dev, g)
                      for name in READERS if name in kernels}))


def measure_a(smoke, dev, g):
    import torch
    from melspec_gpt_vqvae_tpu_torch.ops.attention import attend
    out = {}
    for t, dtype in ((1, torch.bfloat16), (266, torch.bfloat16),
                     (265, torch.float32)):
        q, k, v = (torch.randn(8, 16, t, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        for nu in (0, t):
            out[f"{str(dtype)[6:]},T={t},n_unmasked={nu}"] = smoke.device_ms(
                lambda: attend(q, k, v, nu), smoke.A_KERNELS,
                200 if t == 1 else 20)
    return out


def measure_c(smoke, dev, g):
    import torch
    from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index
    out = {}
    for n, k in ((48 * 265, 128), (64 * 265, 1024)):
        x = torch.randn(n, 256, generator=g, device=dev)
        cb = torch.randn(k, 256, generator=g, device=dev)
        out[f"N={n},K={k}"] = smoke.device_ms(
            lambda: vq_nearest_index(x, cb), ["vq_nearest_kernel"])
    return out


def measure_d(smoke, dev, g):
    import torch
    from melspec_gpt_vqvae_tpu_torch.configs import MelConfig
    from melspec_gpt_vqvae_tpu_torch.ops.mel_kernel import \
        waveform_to_mel_fused
    from melspec_gpt_vqvae_tpu_torch.utils.battery import make_battery
    cfg = MelConfig()
    wav = torch.from_numpy(make_battery(cfg.clip_samples)).to(dev)
    return {"48 clips": smoke.device_ms(
        lambda: waveform_to_mel_fused(wav, cfg), ["mel_kernel"], 10)}


def measure_e(smoke, dev, g):
    import torch
    from melspec_gpt_vqvae_tpu_torch.ops.decode_attention import \
        decode_attend_int8
    import inspect
    writes = "k_new" in inspect.signature(decode_attend_int8).parameters
    out = {}
    for bits in ("int8", "int4"):
        for b in (8, 1):
            for t in smoke.VAS_CAPS:
                k, ks, v, vs = smoke.quantised_cache(g, dev, b, t, bits)
                q = torch.randn(b, 16, 64, generator=g,
                                device=dev).bfloat16()
                out[f"{bits},B={b},T={t}"] = smoke.device_ms(
                    lambda: decode_attend_int8(q, k, v, ks, vs, 1, t - 1),
                    ["decode_attention_kernel"], 50)
                if writes:
                    pos = torch.tensor([t - 1], device=dev)
                    out[f"{bits},B={b},T={t},device pos,write"] = \
                        smoke.device_ms(lambda: decode_attend_int8(
                            q, k, v, ks, vs, 1, pos, k_new=q, v_new=q),
                            ["decode_attention_kernel"], 50)
    return out


def measure_b(smoke, dev, g):
    import torch
    from melspec_gpt_vqvae_tpu_torch import bridge
    from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANGenerator
    from melspec_gpt_vqvae_tpu_torch.ops.vocoder_stack import \
        fused_resblock_stack
    out = {}
    melgan = bridge.init_conv_net_(
        MelGANGenerator(), torch.Generator().manual_seed(1)).to(
        device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        for i, (c, t) in enumerate(smoke.vocoder_stages(melgan)):
            blocks = melgan.stage_blocks(i)
            x = torch.randn(8, c, t, generator=g, device=dev).bfloat16()
            out[f"C={c},T={t}"] = smoke.device_ms(
                lambda: fused_resblock_stack(x, blocks),
                ["resblock_stack"], 5)
    out["sum"] = sum(out.values())
    return out


def measure_f(smoke, dev, g):
    import torch
    from melspec_gpt_vqvae_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, make_dropout_mask)
    out = {}
    for t, keep_prob, nu in F_CASES:
        q, k, v, do = (torch.randn(8, 16, t, 64, generator=g, device=dev)
                       for _ in range(4))
        keep = make_dropout_mask(g, (8, 16, t, t), 1.0 - keep_prob)
        o, lse = flash_attention_fwd(q, k, v, keep, nu, keep_prob)
        name = f"T={t},keep={keep_prob},n_unmasked={nu}"
        out[f"fwd,{name}"] = smoke.device_ms(
            lambda: flash_attention_fwd(q, k, v, keep, nu, keep_prob),
            ["flash_fwd_kernel"])
        out[f"bwd,{name}"] = smoke.device_ms(
            lambda: flash_attention_bwd(q, k, v, keep, o, lse, do, nu,
                                        keep_prob), ["flash_bwd_"])
    return out


READERS = {"A": measure_a, "C": measure_c, "D": measure_d, "E": measure_e,
           "B": measure_b, "F": measure_f}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--kernels", default="A,C,D,E,B,F",
                    help="which kernels to time (default: all six)")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= set(READERS):
        ap.error(f"--kernels takes {', '.join(READERS)}, got {args.kernels}")
    if args.measure:
        return measure(Path(args.measure).resolve(), kernels)
    if not args.parent:
        ap.error("--parent is required")
    parent = Path(args.parent).resolve()
    readings = []
    for name, root in (("parent", parent), ("change", HERE),
                       ("change", HERE), ("parent", parent)):
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             str(root), "--kernels", args.kernels], cwd=root,
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(root)})
        if run.returncode:
            raise SystemExit(f"{name} ({root}) failed:\n{run.stdout}"
                             f"{run.stderr}")
        readings.append({"tree": name,
                         **json.loads(run.stdout.strip().splitlines()[-1])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = json.dumps({"card": smi, "unit": "device ms per call",
                      "readings": readings})
    print(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(res + "\n")


if __name__ == "__main__":
    main()
