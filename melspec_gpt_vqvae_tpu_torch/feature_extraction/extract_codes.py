"""Offline tokenizer CLI of the PyTorch port: mel spectrograms -> VQ code
grids.

    python -m melspec_gpt_vqvae_tpu_torch.feature_extraction.extract_codes \\
        -i data/vas/features -m vqvae.ckpt [-b 8] [--int8] [--device cuda]

Counterpart of the repository's feature_extraction/extract_codes.py
(reference extract_codes.py:63-120): the same flags (-i/--input_dir,
-m/--model_dir, -emb_dim, -n_e, -crop, -b, --int8) plus ``--device``.
The mel folders are ``<input>/<class>/melspec_10s_22050hz`` (VAS) or
``<input>/melspec_10s_22050hz`` (a path naming vggsound); each mel is
centre-cropped to ``-crop`` frames and scaled to [-1, 1], a batch is
encoded by ``VQModel.encode_to_indices`` -- the nearest codebook index is
one launch of kernel C a batch on the card -- and each grid is written to
the sibling ``codes_10s/<name>_code.npy`` (int32).  A grid already there is
skipped, and so is a mel file that does not load.

The weights (``-m``) are a reference-format VQ-VAE ``.pt`` / ``.ckpt`` or a
port VQ-GAN run (``train_vqvae``), read by ``utils/convert.py::
load_vqvae_params``; an orbax directory of the JAX package is refused.
Without ``--int8`` the encoder runs in full float32, TF32 off for its
scope (``tf32_flags``), the parity-grade path.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
import torch

from ..configs import VQVAEConfig
from ..data.transforms import center_crop
from ..models import quantized as qz
from ..utils.convert import load_vqvae_params
from . import tf32_flags, torch_device


def iter_mel_dirs(input_dir: str):
    """The mel folders under ``input_dir``: the one of VGGSound, or each
    class's of VAS, in name order."""
    if "vggsound" in input_dir:
        mel_dir = os.path.join(input_dir, "melspec_10s_22050hz")
        if os.path.isdir(mel_dir):
            yield mel_dir
    else:  # VAS: features/<cls>/melspec_10s_22050hz
        for folder in sorted(os.listdir(input_dir)):
            mel_dir = os.path.join(input_dir, folder, "melspec_10s_22050hz")
            if os.path.isdir(mel_dir):
                yield mel_dir


def float32_encoder(model):
    """mels (B, H, W, 1) -> code grids (B, h, w), in full float32."""
    def encode(x):
        with tf32_flags():
            return model.encode_to_indices(x)
    return encode


def int8_encoder(model, cfg: VQVAEConfig):
    """mels -> code grids through the calibrated int8 encoder convs
    (models/quantized.py), calibrated on the first batch it is given."""
    qstate = {}

    def encode(x):
        if not qstate:
            qstate.update(qz.build_encode_qstate(model, cfg, x,
                                                 batch=x.shape[0]))
            print("\nint8: encoder calibrated on the first batch")
        return qz.encode_to_indices_apply(model, cfg, x,
                                          qz.Int8Convs(qstate))
    return encode


def init_config(argv=None):
    parser = argparse.ArgumentParser(
        description="mel spectrograms -> VQ code grids (PyTorch port)")
    parser.add_argument("-i", "--input_dir", default="data/vas/features")
    parser.add_argument("-m", "--model_dir", required=True,
                        help="VQ-VAE weights: a reference .pt / .ckpt or a "
                             "port VQ-GAN run directory")
    parser.add_argument("-emb_dim", "--embedding_dim", type=int, default=256)
    parser.add_argument("-n_e", "--num_embeddings", type=int, default=128)
    parser.add_argument("-crop", "--spec_crop_len", type=int, default=848)
    parser.add_argument("-b", "--batch_size", type=int, default=8)
    parser.add_argument("--int8", action="store_true",
                        help="int8 encoder convs: code indices flip "
                             "against the float32 parity path (0.976 "
                             "agreement on a trained codec on the H100, "
                             "INT8_DECODE_TORCH.json) -- NOT for "
                             "parity-checked corpora")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    return parser.parse_args(argv)


@torch.inference_mode()
def main(argv=None) -> int:
    """Run the CLI; returns the number of code files written."""
    args = init_config(argv)
    device = torch_device(args.device)
    cfg = VQVAEConfig(num_embeddings=args.num_embeddings,
                      embedding_dim=args.embedding_dim,
                      resolution=args.spec_crop_len)
    model = load_vqvae_params(args.model_dir, cfg).to(device)
    encode = int8_encoder(model, cfg) if args.int8 else float32_encoder(model)
    written = 0
    for mel_dir in iter_mel_dirs(args.input_dir):
        save_dir = os.path.join(os.path.dirname(mel_dir), "codes_10s")
        os.makedirs(save_dir, exist_ok=True)
        pending, names = [], []

        def flush():
            nonlocal written
            if not pending:
                return
            batch = torch.from_numpy(np.stack(pending))[..., None]
            codes = encode(batch.to(device)).cpu().numpy()
            for name, grid in zip(names, codes):
                np.save(os.path.join(save_dir, name + "_code.npy"), grid)
            written += len(names)
            pending.clear()
            names.clear()

        for mel_path in sorted(glob(os.path.join(mel_dir, "*.npy"))):
            audio_name = os.path.basename(mel_path).split(".")[0]
            out_path = os.path.join(save_dir, audio_name + "_code.npy")
            if os.path.isfile(out_path):
                print(f"\rfile exists: {mel_path}", end="", flush=True)
                continue
            try:
                mel = np.load(mel_path).astype(np.float32)
                mel = center_crop(mel, mel.shape[0], args.spec_crop_len)
            except (OSError, ValueError, EOFError):
                print(f"\n{mel_path} is damaged")
                continue
            pending.append(2.0 * mel - 1.0)
            names.append(audio_name)
            if len(pending) == args.batch_size:
                print(f"\rworking on {mel_path}", end="", flush=True)
                flush()
        flush()
    print()
    return written


if __name__ == "__main__":
    main()
