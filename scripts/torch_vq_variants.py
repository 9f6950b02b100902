#!/usr/bin/env python3
"""Time source variants of kernel C (csrc/vq.cu) on one card, in one run.

    python3 scripts/torch_vq_variants.py VARIANTS.json

``VARIANTS.json`` maps a variant's name to a list of ``[old, new]`` string
replacements applied to a copy of ``vq.cu`` (an empty list is the source as
it stands), or to ``{"source": "path/to/other.cu", "edits": [...]}`` for
another source file altogether (an earlier commit's kernel, a different
design), for instance::

    {"base": [],
     "unroll_4": [["#pragma unroll 2", "#pragma unroll 4"]],
     "parent": {"source": "build/parent/melspec_gpt_vqvae_tpu_torch/csrc/vq.cu"}}

Every variant is compiled on its own (``nvcc -shared`` of the edited copy
and ``errors.cu`` under the git-ignored ``build/vq_variants/``, all at
once), called through ctypes at the tokenize shape (N = 12,720, K = 128)
and at the widest codebook (N = 16,960, K = 1024), D = 256, held against
the plain version, and timed with chip_smoke.py's ``device_ms``
(``torch.profiler``).  One JSON line per variant: registers and spills from
``ptxas``, rows that differ from the plain version and from the first
variant at each shape, device milliseconds.  An entry point that takes the
size of a persistent grid (``int ctas``) gets the card's SM count.
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
from melspec_gpt_vqvae_tpu_torch.ops.vq import vq_nearest_index_xla  # noqa: E402

ROOT = HERE / "build" / "vq_variants"
SHAPES = {"n12720_k128": (48 * 265, 128), "n16960_k1024": (64 * 265, 1024)}
D = 256


def compile_variants(variants):
    """Start one nvcc per variant; returns {name: (process, library path,
    whether the entry point takes ``ctas``)}."""
    shutil.rmtree(ROOT, ignore_errors=True)
    procs = {}
    for name, spec in variants.items():
        d = ROOT / name
        d.mkdir(parents=True)
        for f in _build.CSRC.glob("*.cu*"):
            shutil.copy(f, d / f.name)
        edits = spec
        if isinstance(spec, dict):
            shutil.copy(HERE / spec["source"], d / "vq.cu")
            edits = spec.get("edits", [])
        text = (d / "vq.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source")
            text = text.replace(old, new)
        (d / "vq.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "c.so"), str(d / "vq.cu"), str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d / "c.so", "int ctas" in text)
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(2)
    data = {}
    for shape, (n, k) in SHAPES.items():
        x = torch.randn(n, D, generator=g, device=dev)
        cb = torch.randn(k, D, generator=g, device=dev)
        data[shape] = (x, cb, torch.sum(cb * cb, dim=1),
                       vq_nearest_index_xla(x, cb))
    stream = torch.cuda.current_stream().cuda_stream
    first = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (proc, so, takes_ctas) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "nvcc failed:", log[-2000:], flush=True)
            continue
        lines = log.splitlines()
        lib = ctypes.CDLL(str(so))
        lib.msgv_vq_nearest.argtypes = [P] * 4 + [I] * (4 if takes_ctas
                                                      else 3) + [P]
        res = {"registers": [ln.split("Used ")[1].split(",")[0]
                             for ln in lines if "Used" in ln],
               "spills": [ln.strip() for ln in lines if "spill" in ln
                          and "0 bytes spill stores" not in ln]}
        for shape, (x, cb, e2, ref) in data.items():
            out = torch.full((x.shape[0],), -1, dtype=torch.int32, device=dev)

            def run():
                tail = (sms, stream) if takes_ctas else (stream,)
                err = lib.msgv_vq_nearest(
                    x.data_ptr(), cb.data_ptr(), e2.data_ptr(),
                    out.data_ptr(), x.shape[0], cb.shape[0], D, *tail)
                assert err == 0, err
            run()
            torch.cuda.synchronize()
            first.setdefault(shape, out.clone())
            res[shape] = {
                "rows_differ_from_plain": int((out != ref).sum()),
                "rows_differ_from_first": int((out != first[shape]).sum()),
                "device_ms": smoke.device_ms(run, ["vq_nearest_kernel"], 30)}
        print(name, json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi)


if __name__ == "__main__":
    main()
