"""Card <-> CPU code-index parity record of the PyTorch port.

    python -m melspec_gpt_vqvae_tpu_torch.parity_check [--device cuda] \\
        [--clips 48] [--out PARITY_CODES_TORCH.json]
    python -m melspec_gpt_vqvae_tpu_torch.parity_check --worker out.npz \\
        [--clips 48]        (the CPU reference, run as a subprocess)

Counterpart of the repository's parity_check.py.  The reference tokenizes
offline in float32 (extract_codes.py:48-50).  The deterministic battery
(utils/battery.py::make_battery: tones, chirps, harmonic stacks, AM tones,
noise mixes) goes wav -> mel -> VQ encode on the card in one variant for
each way the port's code can run:

  f32_plain_mel    float32 convs, TF32 off, the rFFT mel, kernel C
  f32_kernel_mel   the same with kernel D's mel (extract_codes' path)
  tf32_kernel_mel  torch's default flags (cuDNN convs in TF32)
  bf16_kernel_mel  bfloat16 weights and input, as the serving pipeline

then the float32 plain path runs on the CPU in a subprocess on the same
seeded weights (the ``VQVAEConfig`` of the VAS preset), and each variant's
match rate against it goes to the record, with the JAX record's keys
(PARITY_CODES.json is the TPU's; this writes PARITY_CODES_TORCH.json).
On the CPU only ``f32_plain_mel`` runs, against itself.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import bridge
from .configs import MelConfig, load_preset
from .feature_extraction import tf32_flags, torch_device
from .models.vqvae import VQModel
from .ops.mel import waveform_to_mel
from .ops.mel_kernel import waveform_to_mel_fused
from .utils.battery import make_battery

# variant -> (bfloat16 weights, kernel D's mel, cuDNN TF32, matmul TF32)
VARIANTS = {
    "f32_plain_mel": (False, False, False, False),
    "f32_kernel_mel": (False, True, False, False),
    "tf32_kernel_mel": (False, True, True, False),
    "bf16_kernel_mel": (True, True, True, False),
}
REFERENCE = "CPU float32 plain path of the port (rFFT mel, argmin)"
BATCH = 8
MODULE = "melspec_gpt_vqvae_tpu_torch.parity_check"


def seeded_vq(device: torch.device, bf16: bool = False) -> VQModel:
    """The VAS preset's VQ-VAE with weights from seed 0, drawn on the CPU:
    the same on every device."""
    vq = bridge.init_conv_net_(VQModel(load_preset("GPT", "vas").vqvae),
                               torch.Generator().manual_seed(0))
    return vq.to(device, torch.bfloat16 if bf16 else torch.float32).eval()


@torch.inference_mode()
def encode_battery(wavs: np.ndarray, vq: VQModel, kernel_mel: bool
                   ) -> np.ndarray:
    """wavs (B, samples) -> (B, code_h, code_w) int32 codes on ``vq``'s
    device, ``BATCH`` clips a call: mel (kernel D or the rFFT version),
    frames centre-cropped to the VQ-VAE's width, [-1, 1] in its dtype,
    ``encode_to_indices`` (kernel C on the card)."""
    mcfg = MelConfig()
    device = vq.quant_conv.weight.device
    mel_fn = waveform_to_mel_fused if kernel_mel else waveform_to_mel
    out = []
    for i in range(0, len(wavs), BATCH):
        mel = mel_fn(torch.from_numpy(wavs[i:i + BATCH]).to(device), mcfg)
        lo = (mel.shape[-1] - vq.cfg.resolution) // 2
        x = 2.0 * mel[:, :, lo:lo + vq.cfg.resolution] - 1.0
        out.append(vq.encode_to_indices(
            x[..., None].to(vq.quant_conv.weight.dtype)).cpu().numpy())
    return np.concatenate(out)


def run_variant(wavs, device, bf16, kernel_mel, cudnn_tf32, matmul_tf32):
    with tf32_flags(cudnn_tf32, matmul_tf32):
        return encode_battery(wavs, seeded_vq(device, bf16), kernel_mel)


def run_worker(out_path: str, clips: int) -> None:
    """The CPU float32 reference: writes ``idx`` (clips, code_h, code_w)
    to an .npz."""
    wavs = make_battery(MelConfig().clip_samples)[:clips]
    idx = run_variant(wavs, torch.device("cpu"), *VARIANTS["f32_plain_mel"])
    np.savez(out_path, idx=idx)
    print(f"cpu reference -> {out_path} {idx.shape}")


def card_info(device: torch.device) -> dict:
    """The device the record was taken on; on the card its name and
    ``nvidia-smi``'s name and power limit."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 else None}


def cpu_reference(clips: int) -> np.ndarray:
    """``run_worker`` in a subprocess of its own."""
    root = str(Path(__file__).resolve().parent.parent)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "cpu_ref.npz")
        subprocess.run([sys.executable, "-m", MODULE, "--worker", path,
                        "--clips", str(clips)], check=True, cwd=root)
        return np.load(path)["idx"]


def compare(idx: np.ndarray, ref: np.ndarray) -> dict:
    """The JAX record's figures of one variant against the reference."""
    same = idx == ref
    per_clip = same.reshape(idx.shape[0], -1).mean(axis=1)
    return {"match_rate": round(float(same.mean()), 6),
            "worst_clip_match": round(float(per_clip.min()), 6),
            "mismatched_codes": int((~same).sum())}


def init_config(argv=None):
    parser = argparse.ArgumentParser(
        description="card vs CPU code parity (PyTorch port)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--clips", type=int, default=48,
                        help="the first N clips of the 48-clip battery")
    parser.add_argument("--out", type=str, default="PARITY_CODES_TORCH.json")
    parser.add_argument("--worker", type=str, default="",
                        help="internal: write the CPU reference to this .npz")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the check; returns the record it wrote to ``--out``."""
    args = init_config(argv)
    if args.worker:
        run_worker(args.worker, args.clips)
        return {}
    device = torch_device(args.device)
    wavs = make_battery(MelConfig().clip_samples)[:args.clips]
    names = list(VARIANTS) if device.type == "cuda" else ["f32_plain_mel"]
    got = {}
    for name in names:
        got[name] = run_variant(wavs, device, *VARIANTS[name])
        print(f"{name}: encoded {got[name].shape}")
    ref = cpu_reference(args.clips)
    info = card_info(device)
    result = {"platform": info["platform"],
              "battery_clips": int(wavs.shape[0]),
              "codes_per_clip": int(ref[0].size),
              "reference_path": REFERENCE, "variants": {}}
    for name, idx in got.items():
        bf16, kernel_mel, cudnn_tf32, matmul_tf32 = VARIANTS[name]
        result["variants"][name] = {
            **compare(idx, ref), "bf16": bf16, "kernel_mel": kernel_mel,
            "cudnn_allow_tf32": cudnn_tf32,
            "matmul_allow_tf32": matmul_tf32}
        print(f"{name}: {json.dumps(result['variants'][name])}")
    result["device"] = info
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
