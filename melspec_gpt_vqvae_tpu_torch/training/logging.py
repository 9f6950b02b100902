"""Scalar, text, histogram, image and audio logging into a versioned run
directory, and the attention heatmap of the media callbacks.

Counterpart of melspec_gpt_vqvae_tpu/training/logging.py: each logger
takes the next free ``{save_dir}/{name}/version_N`` directory and writes
TensorBoard events there through tensorboardX where it is installed
(audio as a Summary proto of a PCM16 WAV made with the standard library,
as the JAX package writes it: tensorboardX's ``add_audio`` needs
soundfile).  Where it is not, the same records go into ``events.jsonl`` in
that directory, one JSON object per line: ``{"tag", "step"}`` with
``"value"`` (a scalar), ``"text"``, ``"histogram"`` (per-bin ``counts``
and bin ``edges``: one bin per integer for integer values, else 64),
``"image"`` (the name of a ``.npy`` file beside ``events.jsonl`` holding
the array as given, with its ``dataformats``) or ``"audio"`` (the name of
a mono PCM16 ``.wav`` file beside it, with its ``sample_rate``).

Under a process group only global rank 0 writes: the other ranks'
loggers take rank 0's version number and a writer that drops every
record, as the JAX package's TBLogger off its primary process.
"""

from __future__ import annotations

import io
import json
import os
import wave

import numpy as np


class _NullWriter:
    """The writer of every rank but 0 under a process group: it drops what
    it is given."""

    def _drop(self, *args, **kwargs):
        pass

    add_scalar = add_text = add_histogram = add_image = add_wav = _drop
    flush = close = _drop


def _summary_writer(log_dir: str):
    """tensorboardX's ``SummaryWriter`` on ``log_dir`` with ``add_wav``
    (PCM16 samples as a Summary proto of a WAV), or None where tensorboardX
    is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None

    class Writer(SummaryWriter):
        def add_wav(self, tag, pcm, step, sample_rate):
            from tensorboardX.proto.summary_pb2 import Summary
            buf = io.BytesIO()
            _write_wav(buf, pcm, sample_rate)
            audio = Summary.Audio(sample_rate=sample_rate, num_channels=1,
                                  length_frames=len(pcm),
                                  encoded_audio_string=buf.getvalue(),
                                  content_type="audio/wav")
            self._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)

    return Writer(log_dir)


class TBLogger:
    def __init__(self, save_dir: str, name: str = "TensorBoardLoggs"):
        from ..parallel.mesh import broadcast_object, is_primary
        base = os.path.join(save_dir, name)
        version = 0
        if is_primary():
            while os.path.exists(os.path.join(base, f"version_{version}")):
                version += 1
        # every rank joins the broadcast
        self.version = broadcast_object(version)
        self.log_dir = os.path.join(base, f"version_{self.version}")
        self._jsonl = None
        if not is_primary():
            self._writer = _NullWriter()
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self._writer = _summary_writer(self.log_dir)
        if self._writer is None:
            self._jsonl = open(os.path.join(self.log_dir, "events.jsonl"),
                               "a")

    def _line(self, record: dict):
        self._jsonl.write(json.dumps(record) + "\n")

    def scalar(self, tag: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)
        else:
            self._line({"tag": tag, "value": float(value), "step": int(step)})

    def scalars(self, values: dict, step: int):
        for k, v in values.items():
            self.scalar(k, v, step)

    def text(self, tag: str, text: str, step: int):
        if self._writer is not None:
            self._writer.add_text(tag, text, step)
        else:
            self._line({"tag": tag, "text": str(text), "step": int(step)})

    def histogram(self, tag: str, values, step: int):
        values = np.asarray(values).reshape(-1)
        if self._writer is not None:
            self._writer.add_histogram(tag, values, step)
            return
        if values.size and np.all(values == np.round(values)):
            lo, hi = int(values.min()), int(values.max())
            edges = np.arange(lo, hi + 2) - 0.5
        else:
            edges = 64
        counts, edges = np.histogram(values, bins=edges)
        self._line({"tag": tag, "step": int(step), "histogram": {
            "counts": counts.tolist(), "edges": edges.tolist()}})

    def image(self, tag: str, img, step: int, dataformats: str = "HWC"):
        """img in [0, 1]."""
        img = np.asarray(img)
        if self._writer is not None:
            self._writer.add_image(tag, img, step, dataformats=dataformats)
            return
        name = f"{tag.replace('/', '_')}_{int(step)}.npy"
        np.save(os.path.join(self.log_dir, name), img)
        self._line({"tag": tag, "step": int(step), "image": name,
                    "dataformats": dataformats})

    def spectrogram(self, tag: str, spec, step: int, *,
                    input_range: str = "pm1"):
        """(F, T), flipped so low mels are at the bottom (reference flips
        dims for display: GPT_callbacks.py:141-143).  ``input_range``:
        'pm1' = [-1, 1] (the dataset / codec convention, remapped to [0,
        1]) or 'unit' = already [0, 1]; explicit because a min()-based
        guess mis-renders loud clips whose [-1, 1] spec is all >= 0."""
        s = np.asarray(spec, np.float32)
        if input_range == "pm1":
            s = (s + 1.0) / 2.0
        elif input_range != "unit":
            raise ValueError(f"input_range {input_range!r}")
        s = np.clip(s, 0.0, 1.0)[::-1, :]   # flip the frequency axis
        self.image(tag, s[..., None], step)

    def audio(self, tag: str, wav, step: int, sample_rate: int = 22050):
        """A mono waveform in [-1, 1] (clipped) as 16-bit PCM WAV."""
        pcm = (np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
               * 32767.0).astype("<i2")
        if self._writer is None:
            name = f"{tag.replace('/', '_')}_{int(step)}.wav"
            _write_wav(os.path.join(self.log_dir, name), pcm, sample_rate)
            self._line({"tag": tag, "step": int(step), "audio": name,
                        "sample_rate": int(sample_rate)})
            return
        self._writer.add_wav(tag, pcm, step, sample_rate)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
        else:
            self._jsonl.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()


def _write_wav(target, pcm: np.ndarray, sample_rate: int) -> None:
    """Mono 16-bit PCM samples into a WAV file (a path or a file object)."""
    with wave.open(target, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def attention_image(att, scale_by_prior: bool = True) -> np.ndarray:
    """Per-head attention (B, H, T, T) -> one (B, T, T) heatmap in [0, 1]:
    minus the causal uniform prior, summed over heads, each map min-max
    normalised (reference _visualize_attention: GPT_callbacks.py:81-91)."""
    att = np.asarray(att, np.float32)
    b, h, t, _ = att.shape
    if scale_by_prior:
        prior = np.tril(np.ones((t, t), np.float32))
        prior = prior / np.arange(1, t + 1, dtype=np.float32)[:, None]
        att = att - prior[None, None]
    agg = att.sum(axis=1)
    lo = agg.min(axis=(1, 2), keepdims=True)
    hi = agg.max(axis=(1, 2), keepdims=True)
    return (agg - lo) / (hi - lo + 1e-8)
