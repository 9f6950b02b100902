"""Scalar and text logging into a versioned run directory.

Counterpart of melspec_gpt_vqvae_tpu/training/logging.py:17-50: each
logger takes the next free ``{save_dir}/{name}/version_N`` directory and
writes TensorBoard events there through tensorboardX where it is
installed.  Where it is not, the same scalars and texts go into
``events.jsonl`` in that directory, one JSON object per line
(``{"tag", "value" or "text", "step"}``).
"""

from __future__ import annotations

import json
import os


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

    def close(self):
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()
