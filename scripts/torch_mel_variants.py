#!/usr/bin/env python3
"""Time source variants of kernel D (csrc/mel.cu) on one card, in one run.

    python3 scripts/torch_mel_variants.py VARIANTS.json

``VARIANTS.json`` maps a variant's name to a list of ``[old, new]`` string
replacements applied to a copy of ``mel.cu`` (an empty list is the source
as it stands), for instance::

    {"base": [],
     "warp_an_fft": [["constexpr int kGroup = 64;", "constexpr int kGroup = 32;"],
                     ["constexpr int kGroups = 4;", "constexpr int kGroups = 8;"]]}

Every variant is compiled on its own (``nvcc -shared`` of the edited copy
and ``errors.cu`` under the git-ignored ``build/mel_variants/``, all at
once), called through ctypes on the 48 battery clips with the wrapper's own
tables, held against the plain ``waveform_to_mel`` and timed with
chip_smoke.py's ``device_ms`` (``torch.profiler``).  One JSON line per
variant: registers and spills from ``ptxas``, max |error|, device
milliseconds; then the card's name and power limit.
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
from melspec_gpt_vqvae_tpu_torch.configs import MelConfig  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops import mel_kernel as MK  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.ops.mel import waveform_to_mel  # noqa: E402
from melspec_gpt_vqvae_tpu_torch.utils.battery import \
    make_battery  # noqa: E402

ROOT = HERE / "build" / "mel_variants"


def compile_variants(variants):
    """Start one nvcc per variant; returns {name: (process, library path)}."""
    shutil.rmtree(ROOT, ignore_errors=True)
    procs = {}
    for name, edits in variants.items():
        d = ROOT / name
        d.mkdir(parents=True)
        for f in _build.CSRC.glob("*.cu*"):
            shutil.copy(f, d / f.name)
        src = (d / "mel.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source")
            src = src.replace(old, new)
        (d / "mel.cu").write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "d.so"), str(d / "mel.cu"), str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d / "d.so")
    return procs


def main():
    variants = json.loads(Path(sys.argv[1]).read_text())
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    procs = compile_variants(variants)
    dev = torch.device("cuda", 0)
    cfg = MelConfig()
    wav = torch.from_numpy(make_battery(cfg.clip_samples)).to(dev)
    ref = waveform_to_mel(wav, cfg)
    tables = MK._device_tables(cfg, dev)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "nvcc failed:", log[-2000:], flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        lib.msgv_mel.argtypes = _build.SIGNATURES["msgv_mel"]

        def run():
            return lib.msgv_mel(
                wav.data_ptr(), *(t.data_ptr() for t in tables),
                out.data_ptr(), wav.shape[0], cfg.clip_samples, cfg.n_fft,
                cfg.hop_length, cfg.trim_len, cfg.n_mels, tables[-1].numel(),
                cfg.spec_power, cfg.lower_thresh, cfg.multiply, cfg.subtract,
                cfg.add, cfg.divide, cfg.clip_min, cfg.clip_max, stream)
        res = {"variant": name,
               "ptxas": [ln.split(":", 1)[-1].strip() for ln in
                         log.splitlines() if "registers" in ln
                         or "spill" in ln]}
        out.zero_()
        err = run()
        torch.cuda.synchronize()
        if err:
            res["launch_error"] = err
        else:
            res["max_abs_err"] = smoke.max_err(out, ref)
            res["device_ms"] = smoke.device_ms(run, ["mel_kernel"], 20)
        print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
