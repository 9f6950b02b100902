#!/usr/bin/env python3
"""Kernel E at the bulk decodes' shapes, beside its bytes bound, on one card.

    python3 scripts/torch_e_bulk_probe.py [--root DIR] [--out FILE]
                                          [--pairs] [--variants FILE]

Times ``decode_attend_int8`` (int8 cache of 266 positions, as the captured
decode allocates it; bfloat16 q; the new slot quantised and written in the
launch; the position in device memory) at the two bulk shapes: 256 x 23
(b, h) pairs (the VGGSound XL prior, 40 layers) and 512 x 16 (the VAS
offline batch, 24 layers), at the last position of each capacity of an
8-segment decode (and at positions 0 and 31), and at every position
1..265, which summed over the layers is kernel E's time a batch.  Every
launch reads another of four layers of the cache in turn, so no launch finds the last one's rows in
the 50 MB L2, as the decode's launches find none.  ``--pairs`` adds a sweep
over (b, 16) pairs at a middle and the last position, for the choice of
body.  Where the wrapper has more than one body (``use_streamed``), each
shape is timed with each body forced, then as the wrapper chooses.  Each
reading at a capacity gives its largest distance from the attention
computed in float64.

``--root`` imports the port from another checkout (an earlier commit,
unpacked with ``git archive``), timed by this checkout's
``chip_smoke.device_ms`` (``torch.profiler``).  ``--variants`` names a JSON
file that maps a variant's name to a list of ``[old, new]`` string
replacements in a copy of csrc/decode_attention.cu (an empty list is the
source as it stands); each variant is built on its own (nvcc, all at once,
under the git-ignored build/e_variants/), put in the place of the port's
library and timed with the streamed body forced.  One JSON line a reading
on standard output and in ``--out``.
"""

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPES = {"prior": (256, 23, 40), "offline": (512, 16, 24)}
HD, T_CAP, LAYERS = 64, 266, 4
CAPS = (34, 67, 100, 133, 167, 200, 233, 266)   # _segment_plan(1, 265, 8)


def bound_ms(b, h, rows, hbm=3.35e12, f32=67e12):
    """The least milliseconds of one launch: its cached rows and scales, q
    and the new rows in, the float32 output out, or its multiply-adds."""
    n_bytes = (2 * rows * b * h * HD + 2 * rows * b * h * 2
               + 3 * b * h * HD * 2 + b * h * HD * 4)
    return 1e3 * max(n_bytes / hbm, 4.0 * b * h * rows * HD / f32)


def build_variants(path, build):
    """Start one nvcc per variant of decode_attention.cu; returns {name:
    (process, library path)}."""
    root = HERE / "build" / "e_variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, edits in json.loads(Path(path).read_text()).items():
        d = root / name
        d.mkdir(parents=True)
        for f in build.CSRC.glob("*.cu*"):
            shutil.copy(f, d / f.name)
        text = (d / "decode_attention.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source")
            text = text.replace(old, new)
        (d / "decode_attention.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "e.so"), str(d / "decode_attention.cu"),
             str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d / "e.so")
    return procs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="the prior shape alone at positions 0, 31, 63, "
                         "132 and 265, without the sweep over positions")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from melspec_gpt_vqvae_tpu_torch import _build
    from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as DA
    procs = build_variants(args.variants, _build) if args.variants else {}
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    out = open(args.out, "a") if args.out else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

    def emit(rec):
        rec = {"root": args.root, "card": card, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def cache(b, h):
        k, v = (torch.randint(-127, 128, (LAYERS, b, h, T_CAP, HD),
                              generator=g, device=dev, dtype=torch.int32)
                .to(torch.int8) for _ in range(2))
        ks, vs = ((0.005 + 0.02 * torch.rand(LAYERS, b, h, T_CAP,
                                             generator=g, device=dev))
                  .bfloat16() for _ in range(2))
        return k, v, ks, vs

    bodies = {"as chosen": None}
    if hasattr(DA, "use_streamed"):
        bodies = {"split": False, "streamed": True, "as chosen": None}
    chosen = getattr(DA, "use_streamed", None)

    def force(which):
        if which is None:
            DA.use_streamed = chosen
        else:
            DA.use_streamed = lambda pairs: which

    def caller(q, k, v, ks, vs, kn, vn, pos):
        at = torch.tensor([pos], dtype=torch.int64, device=dev)
        turn = [0]

        def call():
            turn[0] = (turn[0] + 1) % LAYERS
            return DA.decode_attend_int8(q, k, v, ks, vs, turn[0], at,
                                         k_new=kn, v_new=vn)
        return call

    names = ["decode_attention_kernel"]

    def exact(q, k, v, ks, vs, pos):
        """Layer 1's attention at ``pos`` in float64."""
        n = pos + 1
        sc = torch.einsum("bhd,bhtd->bht", q.double(),
                          k[1, :, :, :n].double()) * ks[1, :, :, :n].double()
        p = torch.softmax(sc / HD ** 0.5, dim=-1) * vs[1, :, :, :n].double()
        return torch.einsum("bht,bhtd->bhd", p, v[1, :, :, :n].double())

    def shapes(bodies, **tag):
        for shape, (b, h, n_layer) in SHAPES.items():
            if args.quick and shape != "prior":
                continue
            k, v, ks, vs = cache(b, h)
            q, kn, vn = (torch.randn(b, h, HD, generator=g, device=dev)
                         .bfloat16() for _ in range(3))
            for body, which in bodies.items():
                force(which)
                rows = []
                # positions 0 and 31 (one chunk of the streamed body) show
                # a launch's fixed cost
                for cap, pos in ([(None, p) for p in (0, 31, 63, 132, 265)]
                                 if args.quick else [(None, 0), (None, 31)]
                                 + [(c, c - 1) for c in CAPS]):
                    call = caller(q, k, v, ks, vs, kn, vn, pos)
                    got = call()
                    ref = exact(q, k, v, ks, vs, pos)
                    err = (got.double() - ref).abs().max().item()
                    ms = smoke.device_ms(call, names, reps=40)
                    bd = bound_ms(b, h, pos + 1)
                    rows.append({"cap": cap, "pos": pos, "device_ms": ms,
                                 "bound_ms": bd,
                                 "roofline_pct": 100 * bd / ms,
                                 "max_abs_err": err})
                # every position of the decode, by CUDA events around
                # launches queued while the card is held: E a batch
                total_ms, total_bound = 0.0, 0.0
                for pos in range(1, 1 if args.quick else T_CAP):
                    total_ms += smoke.queued_ms(caller(q, k, v, ks, vs, kn,
                                                       vn, pos), reps=8)
                    total_bound += bound_ms(b, h, pos + 1)
                emit({**tag, "shape": shape, "pairs": b * h, "body": body,
                      "streamed": getattr(DA.decode_attend_int8, "streamed",
                                          None),
                      "by_cap": rows,
                      "batch_s": n_layer * total_ms / 1e3,
                      "batch_bound_s": n_layer * total_bound / 1e3,
                      "batch_roofline_pct": 100 * total_bound / max(
                          total_ms, 1e-9)})
            force(None)
            del k, v, ks, vs
            torch.cuda.empty_cache()

    shapes(bodies)
    if args.pairs:
        for b in (8, 16, 32, 64, 128, 256, 512):
            k, v, ks, vs = cache(b, 16)
            q, kn, vn = (torch.randn(b, 16, HD, generator=g, device=dev)
                         .bfloat16() for _ in range(3))
            for body, which in bodies.items():
                if which is None and len(bodies) > 1:
                    continue
                force(which)
                emit({"sweep": "pairs", "pairs": b * 16, "body": body,
                      **{f"pos{pos}_device_ms": smoke.device_ms(
                          caller(q, k, v, ks, vs, kn, vn, pos), names,
                          reps=40) for pos in (132, 265)},
                      **{f"pos{pos}_bound_ms": bound_ms(b, 16, pos + 1)
                         for pos in (132, 265)}})
            force(None)
            del k, v, ks, vs
            torch.cuda.empty_cache()

    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "nvcc failed:", log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        lib.msgv_decode_attention.argtypes = \
            _build.SIGNATURES["msgv_decode_attention"]
        lib.msgv_decode_attention.restype = ctypes.c_int
        lib.msgv_error_string.argtypes = [ctypes.c_int]
        lib.msgv_error_string.restype = ctypes.c_char_p
        _build._lib = lib
        regs = [ln.split("Used ")[1].split(",")[0] for ln in
                log.splitlines() if "Used" in ln]
        shapes({"streamed": True}, variant=name, registers=regs)


if __name__ == "__main__":
    main()
