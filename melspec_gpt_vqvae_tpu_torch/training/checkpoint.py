"""Checkpoints: ``last`` always, ``best`` on an improving metric, resume.

Counterpart of melspec_gpt_vqvae_tpu/training/checkpoint.py:130-347 with
``torch.save`` in place of orbax.  A checkpoint is a nested dict of
tensors and numbers (a train state's ``GPTTask.state_tree`` and the epoch)
written as ``{dirpath}/last.pt``; ``best.pt`` is a copy of it taken when
the monitored metric improves (mode min; a NaN is never best).
``meta.json`` keeps the JAX package's keys: ``best_metric``,
``best_step``, ``last_step`` and ``last_batch_idx`` (-1 for an
end-of-epoch save, else the last consumed batch of a mid-epoch one).

``save`` copies the tree to host memory before it returns -- the train
state may change in place right after -- and writes the file in a
background thread; ``wait`` blocks until that write (and the ``best``
copy) is on disk.  Under a process group every rank enters ``save`` (the
task's ``state_tree``, a collective, has gathered the full leaves to rank
0; the other ranks pass what they hold, None under a mesh that splits
parameters), rank 0 alone copies and writes, and ``wait`` ends in a
barrier, so that no rank reads a checkpoint before it is whole; every
rank keeps the same ``meta`` (the metric is the cross-process one) and
``restore`` reads on every rank.  ``load_tree`` and ``merge_subtree``
serve the GPT-VAE's stage-2 warm start (an encoder taken from another
run's checkpoint).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from ..parallel.mesh import barrier, is_primary


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _shape_mismatches(template, tree, path=""):
    """``path: checkpoint shape vs this run's`` for every tensor leaf whose
    shape differs, and for every template key the checkpoint lacks."""
    if isinstance(template, dict):
        out = []
        for k, v in template.items():
            p = f"{path}/{k}" if path else k
            if not isinstance(tree, dict) or k not in tree:
                out.append(f"  {p}: missing from the checkpoint")
            else:
                out += _shape_mismatches(v, tree[k], p)
        return out
    if isinstance(template, torch.Tensor):
        got = tuple(getattr(tree, "shape", ()))
        if got != tuple(template.shape):
            return [f"  {path}: checkpoint {got} vs this run "
                    f"{tuple(template.shape)}"]
    return []


class CheckpointManager:
    def __init__(self, dirpath: str):
        self.dirpath = os.path.abspath(dirpath)
        os.makedirs(self.dirpath, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._meta_path = os.path.join(self.dirpath, "meta.json")
        self.meta = {"best_metric": None, "best_step": None,
                     "last_step": None}
        self.restored_batch_idx = -1   # set by restore(); -1 = end of epoch
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    def wait(self):
        """Block until the last save is on disk, every rank with it; raise
        what its write raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, tree: Dict[str, Any], step: int,
             metric: Optional[float] = None, batch_idx: int = -1):
        """Write ``last``; copy it to ``best`` when ``metric`` improves on
        the best so far (mode min; NaN never improves, and a NaN best is
        replaced by the first finite metric)."""
        self.wait()   # the previous write must be durable first
        primary = is_primary()
        host = _to_host(tree) if primary else None
        self.meta["last_step"] = int(step)
        self.meta["last_batch_idx"] = int(batch_idx)
        prev = self.meta.get("best_metric")
        improved = metric is not None and not math.isnan(float(metric)) and (
            prev is None or math.isnan(float(prev))
            or float(metric) < float(prev))
        if improved:
            self.meta["best_metric"] = float(metric)
            self.meta["best_step"] = int(step)
        meta = dict(self.meta)
        last = os.path.join(self.dirpath, "last.pt")
        best = os.path.join(self.dirpath, "best.pt")

        def write():
            try:
                tmp = last + ".tmp"
                torch.save(host, tmp)
                os.replace(tmp, last)
                if improved:
                    shutil.copyfile(last, best + ".tmp")
                    os.replace(best + ".tmp", best)
                # after the files: a crash mid-write never records a best
                # whose file holds an older state
                with open(self._meta_path, "w") as f:
                    json.dump(meta, f)
            except Exception as e:   # raised by the next wait()
                self._error = e

        if primary:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()

    def _resolve(self, which: str) -> str:
        """'last' / 'best' in this directory, else in the newest earlier
        ``version_*`` sibling that has one (so ``--resume last`` continues
        the previous run); any other value is a path."""
        if os.sep in which or os.path.isabs(which):
            return which
        name = f"{which}.pt"
        path = os.path.join(self.dirpath, name)
        if os.path.exists(path):
            return path
        parent = os.path.dirname(self.dirpath)
        versions = sorted((d for d in os.listdir(parent)
                           if d.startswith("version_")),
                          key=lambda d: int(d.split("_")[-1]), reverse=True)
        for v in versions:
            cand = os.path.join(parent, v, name)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"no {which!r} checkpoint found: searched {path} and every "
            f"version_* sibling under {parent} (a run with --ckpt_every "
            f"0/-1 may only ever write 'last')")

    def restore(self, which: str = "last",
                template: Optional[Dict[str, Any]] = None,
                mmap: bool = False) -> Dict[str, Any]:
        """Load ``which`` ('last', 'best' or a checkpoint file) onto the
        CPU.  With a ``template`` (e.g. ``{"state": task.state_template(),
        "epoch": 0}``; only its shapes are read) every tensor leaf must
        have the template's shape, else a ValueError lists the mismatches;
        the template may name a part of the tree only.  ``mmap`` maps the
        file instead of reading it: a tensor's bytes are read when it is
        used, so a caller that needs the params alone never reads the
        optimizer moments.  Sets
        ``restored_batch_idx`` from the resolved checkpoint's meta.json
        (only ``last`` can be mid-epoch)."""
        self.wait()
        path = self._resolve(which)
        self.restored_batch_idx = -1
        if os.path.basename(path) == "last.pt":
            mp = os.path.join(os.path.dirname(path), "meta.json")
            if os.path.exists(mp):
                with open(mp) as f:
                    self.restored_batch_idx = int(
                        json.load(f).get("last_batch_idx", -1))
        out = torch.load(path, map_location="cpu", weights_only=True,
                         mmap=mmap)
        if template is not None:
            bad = _shape_mismatches(template, out)
            if bad:
                head = "\n".join(bad[:8])
                more = (f"\n  ... and {len(bad) - 8} more"
                        if len(bad) > 8 else "")
                raise ValueError(
                    f"checkpoint at {path} does not match this run's model "
                    f"geometry ({len(bad)} mismatches):\n{head}{more}\nIf "
                    f"the original run used --override, repeat the exact "
                    f"same override with --resume.")
        return out


def load_tree(path: str) -> Dict[str, Any]:
    """The nested dict of a checkpoint file, or of ``last.pt`` in a
    checkpoint directory, on the CPU (the JAX package's
    ``CheckpointManager.load_tree``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "last.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_subtree(params: Dict[str, Any], loaded: Dict[str, Any],
                  key: str = "encoder") -> Dict[str, Any]:
    """``params`` with its ``key`` subtree taken from ``loaded`` (the
    stage-2 warm start: the reference keeps the keys holding "encoder" and
    loads non-strict, GPT_VAE_train.py:133-144)."""
    if key not in loaded:
        raise KeyError(f"loaded checkpoint has no {key!r} subtree")
    return dict(params, **{key: loaded[key]})
