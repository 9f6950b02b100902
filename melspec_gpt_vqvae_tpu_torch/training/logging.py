"""Scalar, text, histogram and image logging into a versioned run
directory.

Counterpart of melspec_gpt_vqvae_tpu/training/logging.py:17-72,106-108:
each logger takes the next free ``{save_dir}/{name}/version_N`` directory
and writes TensorBoard events there through tensorboardX where it is
installed.  Where it is not, the same records go into ``events.jsonl`` in
that directory, one JSON object per line: ``{"tag", "step"}`` with
``"value"`` (a scalar), ``"text"``, ``"histogram"`` (per-bin ``counts``
and bin ``edges``: one bin per integer for integer values, else 64) or
``"image"`` (the name of a ``.npy`` file beside ``events.jsonl`` holding
the array as given, with its ``dataformats``).
"""

from __future__ import annotations

import json
import os

import numpy as np


class TBLogger:
    def __init__(self, save_dir: str, name: str = "TensorBoardLoggs"):
        base = os.path.join(save_dir, name)
        version = 0
        while os.path.exists(os.path.join(base, f"version_{version}")):
            version += 1
        self.version = version
        self.log_dir = os.path.join(base, f"version_{version}")
        os.makedirs(self.log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._writer = None
            self._jsonl = open(os.path.join(self.log_dir, "events.jsonl"),
                               "a")
        else:
            self._writer = SummaryWriter(self.log_dir)
            self._jsonl = None

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

    def close(self):
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()
