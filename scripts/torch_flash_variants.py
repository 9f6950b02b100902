#!/usr/bin/env python3
"""Time source variants of kernel F (csrc/flash_attention.cu and the tile
header csrc/attn_tiles.cuh) on one card, in one run.

    python3 scripts/torch_flash_variants.py VARIANTS.json

``VARIANTS.json`` maps a variant's name to a list of ``[old, new]`` string
replacements applied to a copy of ``flash_attention.cu`` or, where the text
is found there, ``attn_tiles.cuh`` (an empty list is the source as it
stands), for instance::

    {"base": [],
     "dkv_4_ctas": [["__launch_bounds__(kThreads, 3)\\n    flash_bwd_dkv",
                     "__launch_bounds__(kThreads, 4)\\n    flash_bwd_dkv"]],
     "columns_64": [["constexpr int kBc = 32;", "constexpr int kBc = 64;"]]}

Every variant is compiled on its own (``nvcc -shared`` of the edited copy
and ``errors.cu`` under the git-ignored ``build/flash_variants/``, all at
once), called through ctypes at the training shape (8, 16, 265, 64)
float32 with keep 0.5, held against the plain versions, and timed with
chip_smoke.py's ``device_ms`` (``torch.profiler``): forward (keep 0.5 and
keep 1), dQ, dK/dV and delta kernels apart.  One JSON line per variant:
registers per kernel and spills from ``ptxas``, max |error| of O/lse and of
the gradients, device milliseconds.  A variant may be wrong on purpose (a
part compiled out to see what it costs); its errors say so.
"""

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from melspec_gpt_vqvae_tpu_torch import _build  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops import flash_attention as TF  # noqa: E402

ROOT = HERE / "build" / "flash_variants"
BH, T, HD, KEEP_PROB = 128, 265, 64, 0.5


def compile_variants(variants):
    """Start one nvcc per variant; returns {name: (process, library path)}."""
    shutil.rmtree(ROOT, ignore_errors=True)
    procs = {}
    for name, edits in variants.items():
        d = ROOT / name
        d.mkdir(parents=True)
        for f in _build.CSRC.glob("*.cu*"):
            shutil.copy(f, d / f.name)
        # the kernel's own file and the tile header it shares with kernel A
        srcs = {f: (d / f).read_text()
                for f in ("flash_attention.cu", "attn_tiles.cuh")}
        for old, new in edits:
            hit = [f for f, text in srcs.items() if old in text]
            if not hit:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source")
            srcs[hit[0]] = srcs[hit[0]].replace(old, new)
        for f, text in srcs.items():
            (d / f).write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "f.so"), str(d / "flash_attention.cu"),
             str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d / "f.so")
    return procs


def main():
    variants = json.loads(Path(sys.argv[1]).read_text())
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    procs = compile_variants(variants)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(8, 16, T, HD, generator=g, device=dev)
                   for _ in range(4))
    keep = TF.make_dropout_mask(g, (8, 16, T, T), 1.0 - KEEP_PROB)
    o_ref, lse_ref = TF.flash_attention_ref_fwd(q, k, v, keep, 0, KEEP_PROB)
    g_ref = TF.flash_attention_ref_bwd(q, k, v, keep, lse_ref, do, 0,
                                       KEEP_PROB)
    o, lse = torch.empty_like(q), torch.empty(8, 16, T, device=dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(name, "nvcc failed:", out[-2000:], flush=True)
            continue
        lines = out.splitlines()
        lib = ctypes.CDLL(str(so))
        for fn in ("msgv_flash_attention_fwd", "msgv_flash_attention_bwd"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]

        def fwd(mask=keep, keep_prob=KEEP_PROB):
            err = lib.msgv_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), o.data_ptr(),
                lse.data_ptr(), BH, T, HD, 0, keep_prob, stream)
            assert err == 0, err

        def bwd():
            err = lib.msgv_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(),
                o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), BH, T, HD, 0,
                KEEP_PROB, stream)
            assert err == 0, err
        fwd()
        bwd()
        torch.cuda.synchronize()
        res = {
            "registers": [ln.split("Used ")[1].split(",")[0]
                          for ln in lines if "Used" in ln],
            "spills": [ln.strip() for ln in lines if "spill" in ln
                       and "0 bytes spill stores" not in ln],
            "err_o_lse": max(smoke.max_err(o, o_ref),
                             smoke.max_err(lse, lse_ref)),
            "err_grads": max(smoke.max_err(a, b)
                             for a, b in zip((dq, dk, dv), g_ref)),
            "fwd": smoke.device_ms(fwd, ["flash_fwd_kernel"], 30),
            "fwd_keep1": smoke.device_ms(lambda: fwd(None, 1.0),
                                         ["flash_fwd_kernel"], 30),
            "dq": smoke.device_ms(bwd, ["flash_bwd_dq"], 30),
            "dkv": smoke.device_ms(bwd, ["flash_bwd_dkv"], 30),
            "delta": smoke.device_ms(bwd, ["flash_bwd_delta"], 30)}
        res["bwd"] = res["dq"] + res["dkv"] + res["delta"]
        print(name, json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi)


if __name__ == "__main__":
    main()
