"""Offline mel-spectrogram extraction CLI of the PyTorch port.

    python -m melspec_gpt_vqvae_tpu_torch.feature_extraction.extract_mel_spectrogram \\
        -i data/features/dog/audio_10s_22050hz \\
        -o data/features/dog/melspec_10s_22050hz [-b 16] [--device cuda]

Counterpart of the repository's feature_extraction/extract_mel_spectrogram.py
(reference extract_mel_spectrogram.py:193-211): the same flags
(-i/--input_dir, -o/--output_dir, -l/--length, -n/--num_worker, accepted
and unused, -b/--batch_size) plus ``--device``; each wav (scipy's reader:
int16 / int32 / uint8 scaled to [-1, 1], stereo averaged) is cut or
zero-padded to ``--length`` samples, and the wavs of a batch go through
``ops/mel_kernel.py::waveform_to_mel_fused`` together -- one launch of
kernel D a batch on the card, the plain rFFT version on the CPU -- to
``<name>_mel.npy`` files of (80, frames) float32 in [0, 1].  Only the
reference's output folder name ``melspec_10s_22050hz`` is accepted.
"""

from __future__ import annotations

import argparse
import os
import os.path as P
from glob import glob
from pathlib import Path

import numpy as np
import torch

from ..configs import MelConfig
from ..ops.mel import mel_to_waveform
from ..ops.mel_kernel import waveform_to_mel_fused
from . import torch_device

FOLDER = "melspec_10s_22050hz"


def mel_config(length: int) -> MelConfig:
    """The mel configuration of ``length``-sample clips.  A clip shorter
    than 10 s has fewer frames than the 860 kept: the frames it has are
    kept (the JAX CLI's slice to 860 keeps them all), and kernel D is told
    so."""
    cfg = MelConfig(clip_samples=length)
    frames = 1 + length // cfg.hop_length
    return MelConfig(clip_samples=length, trim_len=min(cfg.trim_len, frames))


@torch.inference_mode()
def wavs_to_mels(wavs: np.ndarray, cfg: MelConfig,
                 device: torch.device) -> np.ndarray:
    """(B, samples) float32 -> (B, 80, frames) float32 on the host: one
    call of kernel D on the card."""
    return waveform_to_mel_fused(torch.from_numpy(wavs).to(device),
                                 cfg).cpu().numpy()


def read_wav(path: str) -> np.ndarray:
    """A wav at its own rate as float32 mono (librosa.load(sr=None) for PCM
    and float wavs; scipy reads the container): int16 / int32 / uint8
    samples scaled to [-1, 1], then the channels averaged.  (The JAX CLI's
    reader averages first, which turns integer samples into float64 that
    it then leaves unscaled: a stereo PCM file reaches its mel 32768 times
    too loud.  Mono files and float files read the same in both.)"""
    from scipy.io import wavfile
    _, wav = wavfile.read(path)
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    elif wav.dtype == np.uint8:
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    return wav


def _fit(wav: np.ndarray, length: int, out: np.ndarray) -> None:
    n = min(len(wav), length)
    out[:n] = wav[:n]


def get_spectrogram(audio_path, save_dir, length, folder_name=FOLDER,
                    save_results=True, device="cuda"):
    """One file, as the reference's ``get_spectrogram``
    (extract_mel_spectrogram.py:166-190): writes ``<name>_mel.npy`` into
    ``save_dir``, or returns (the wav cut or padded to ``length``, its
    mel) with ``save_results=False``."""
    if folder_name != FOLDER:
        raise NotImplementedError(folder_name)
    y = np.zeros(length, np.float32)
    _fit(read_wav(audio_path), length, y)
    mel = wavs_to_mels(y[None], mel_config(length), torch_device(device))[0]
    if save_results:
        os.makedirs(save_dir, exist_ok=True)
        name = os.path.basename(audio_path).split(".")[0]
        np.save(P.join(save_dir, name + "_mel.npy"), mel)
        return None
    return y, mel


def inv_transforms(x, folder_name=FOLDER, generator=None, gl_iters=32,
                   device="cuda"):
    """The reference's inverse chain (extract_mel_spectrogram.py:154-163):
    normalised mel (..., 80, T) -> waveform (..., (T - 1) 256) as numpy,
    by NNLS and Griffin-Lim on ``device``; Griffin-Lim's initial phases
    from ``generator`` (seed 0 on ``device`` if None)."""
    if folder_name != FOLDER:
        raise NotImplementedError(folder_name)
    dev = torch_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        mel = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return mel_to_waveform(mel, generator, MelConfig(),
                               gl_iters=gl_iters).cpu().numpy()


def init_config(argv=None):
    parser = argparse.ArgumentParser(
        description="wavs -> mel spectrograms (PyTorch port)")
    parser.add_argument("-i", "--input_dir",
                        default="data/features/dog/audio_10s_22050hz")
    parser.add_argument("-o", "--output_dir",
                        default="data/features/dog/melspec_10s_22050hz")
    parser.add_argument("-l", "--length", type=int, default=220500)
    parser.add_argument("-n", "--num_worker", type=int, default=32,
                        help="accepted for parity; batching replaces the pool")
    parser.add_argument("-b", "--batch_size", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Run the CLI; returns the number of mel files written."""
    args = init_config(argv)
    folder_name = Path(args.output_dir).name
    if folder_name != FOLDER:
        raise NotImplementedError(folder_name)
    device = torch_device(args.device)
    cfg = mel_config(args.length)

    audio_paths = sorted(glob(P.join(args.input_dir, "*.wav")))
    os.makedirs(args.output_dir, exist_ok=True)
    print(f"{len(audio_paths)} wavs -> {args.output_dir} "
          f"(batch {args.batch_size} on {device})")
    for start in range(0, len(audio_paths), args.batch_size):
        chunk = audio_paths[start:start + args.batch_size]
        wavs = np.zeros((len(chunk), args.length), np.float32)
        for i, p in enumerate(chunk):
            _fit(read_wav(p), args.length, wavs[i])
        for p, mel in zip(chunk, wavs_to_mels(wavs, cfg, device)):
            name = os.path.basename(p).split(".")[0]
            np.save(P.join(args.output_dir, name + "_mel.npy"), mel)
        print(f"\r{start + len(chunk)}/{len(audio_paths)}", end="",
              flush=True)
    print()
    return len(audio_paths)


if __name__ == "__main__":
    main()
