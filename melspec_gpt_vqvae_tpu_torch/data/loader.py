"""Batching data loader with per-host sharding and background prefetch.

Replaces the reference's torch DataLoader + Lightning DDP sampler
(reference/datasets/datamodule.py:69-88): deterministic per-epoch
shuffle, ``drop_last`` batching, per-host sharding for multi-host meshes
(the DistributedSampler equivalent Lightning inserted implicitly), and a
background prefetch thread so npy decode overlaps device compute.

The port's own copy of melspec_gpt_vqvae_tpu/data/loader.py (numpy and the
standard library only): same classes, same batches for the same seed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


def _stack_items(items: List[Dict]) -> Dict:
    keys = set(items[0])
    for it in items[1:]:
        if set(it) != keys:
            # e.g. some clips have the codes_10s/_code.npy sibling and
            # some don't — stacking item-0's keys would either KeyError
            # mid-epoch or silently drop 'codes' for the whole batch
            raise ValueError(
                "batch items disagree on keys "
                f"{sorted(keys.symmetric_difference(it))} — a clip is "
                "missing a sibling file (codes_10s?); re-run "
                "feature_extraction/extract_codes.py or fix the split")
    out: Dict = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Iterable over stacked-numpy batches.

    ``process_index``/``process_count`` shard the *global* batch order so
    each host sees a disjoint, equally-sized stream (drop_last semantics,
    reference: datamodule.py:69-84).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 783435,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, use_native: Optional[bool] = None,
                 num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.use_native = use_native  # None = auto
        # parallel batch workers (the reference runs num_workers =
        # 2*batch_size loader PROCESSES, datamodule.py:14; threads suffice
        # here - npy decode is numpy/C++ releasing the GIL).  1 = the
        # single prefetch thread (right for a 1-core dev host).
        self.num_workers = max(1, int(num_workers))
        self.start_batch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_batch(self, b: int):
        """Skip the first ``b`` batches of the NEXT iteration without
        loading their data (mid-epoch resume: the runner replays an
        interrupted epoch from the saved batch index; the epoch's batch
        order is a pure function of (seed, epoch) so the skipped prefix is
        exactly what the interrupted run consumed).  Sticky until changed —
        the runner resets it to 0 for epochs after the resumed one."""
        self.start_batch = max(0, int(b))

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _native_batch(self, idxs) -> Optional[Dict]:
        """C++ fastloader path: one threaded call per batch instead of
        len(batch) Python __getitem__s.  Falls back (returns None) for
        random-crop datasets or when any codes file is missing."""
        ds = self.dataset
        if self.use_native is False or not hasattr(ds, "item_paths") or \
                getattr(ds, "random_crop", False):
            return None
        from . import native
        if not native.available():
            return None
        import os
        items = [ds.item_paths(int(i)) for i in idxs]
        if not all(os.path.isfile(c) for _, c, _, _ in items):
            return None
        h, w = ds.crop_shape
        try:
            specs = native.load_spec_batch([s for s, _, _, _ in items],
                                           h, w, 2.0, -1.0)
            codes = native.load_codes_batch([c for _, c, _, _ in items])
        except (IOError, RuntimeError):
            return None
        return {"image": specs, "codes": codes,
                "target": np.asarray([t for _, _, t, _ in items],
                                     np.int32),
                "label": [l for _, _, _, l in items],
                "file_path_": [s for s, _, _, _ in items]}

    def _shard_order(self):
        order = self._order()
        # interleaved per-host shard (torch DistributedSampler semantics:
        # indices[rank::world]).  Interleaving makes the UNION of all
        # hosts' batch i equal the single-process global batch i (as a
        # set), so a multi-process run consumes identical global batches
        # to a single-process run with batch P*B — proven by
        # scripts/dryrun_multiprocess.py.
        per = len(order) // self.process_count
        return order[self.process_index::self.process_count][:per]

    def _build_batch(self, idxs) -> Dict:
        batch = self._native_batch(idxs)
        if batch is None:
            batch = _stack_items([self.dataset[int(i)] for i in idxs])
        return batch

    def _batches(self) -> Iterator[Dict]:
        order = self._shard_order()
        for b in range(min(self.start_batch, len(self)), len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idxs) == 0:
                return
            yield self._build_batch(idxs)

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        if self.num_workers > 1:
            yield from self._iter_pool()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()   # consumer gone (early break / GC)

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches():
                    if not _put(batch):
                        return   # abandoned iterator: exit, don't block
            except BaseException as e:  # surface loader errors to the consumer
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early (limit_*_batches loops) must not
            # leave the worker blocked on q.put forever, pinning batches
            stop.set()

    def _iter_pool(self) -> Iterator[Dict]:
        """num_workers > 1: batches build concurrently in a thread pool and
        are yielded IN ORDER (item order identical to the serial path; with
        randomised transforms the draws are thread-safe but their order is
        scheduling-dependent — see ``transforms.Crop``); at most
        prefetch + num_workers batches are in flight."""
        import concurrent.futures
        order = self._shard_order()
        nb = len(self)
        b0 = min(self.start_batch, nb)
        window = self.prefetch + self.num_workers
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            futures = {}
            for b in range(b0, min(b0 + window, nb)):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                futures[b] = ex.submit(self._build_batch, idxs)
            for b in range(b0, nb):
                batch = futures.pop(b).result()
                nxt = b + window
                if nxt < nb:
                    idxs = order[nxt * self.batch_size:
                                 (nxt + 1) * self.batch_size]
                    futures[nxt] = ex.submit(self._build_batch, idxs)
                yield batch


class DataModule:
    """Dataset selection by spec_dir_path substring
    (reference: datasets/datamodule.py:22-66)."""

    def __init__(self, batch_size: int, spec_dir_path: str,
                 num_workers: Optional[int] = None, mel_num: int = 80,
                 spec_len: int = 860, spec_crop_len: int = 848,
                 random_crop: bool = False, seed: int = 783435,
                 data_root: str = "./data",
                 process_index: int = 0, process_count: int = 1):
        self.batch_size = batch_size
        self.spec_dir_path = spec_dir_path
        # None = auto: threads to match the host's spare cores (the
        # reference default is 2*batch_size processes, datamodule.py:14 —
        # far past the point of diminishing returns for threaded npy reads)
        if num_workers is None:
            num_workers = max(1, min(8, (os.cpu_count() or 1) - 1))
        self.num_workers = max(1, int(num_workers))
        self.kw = dict(mel_num=mel_num, spec_len=spec_len,
                       spec_crop_len=spec_crop_len, random_crop=random_crop)
        self.seed = seed
        self.data_root = data_root
        self.process_index = process_index
        self.process_count = process_count
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None

    def setup(self, stage=None):
        from .datasets import VASSpecs, VGGSoundSpecs
        if "vggsound" in self.spec_dir_path:
            mk = lambda split: VGGSoundSpecs(  # noqa: E731
                split, self.spec_dir_path,
                splits_path=self.data_root,
                meta_path=f"{self.data_root}/vggsound.csv", **self.kw)
            self.train_dataset = mk("train")
            self.val_dataset = mk("valid")
            self.test_dataset = mk("test")
        elif "vas" in self.spec_dir_path:
            mk = lambda split: VASSpecs(  # noqa: E731
                split, self.spec_dir_path, data_root=self.data_root,
                **self.kw)
            self.train_dataset = mk("train")
            self.val_dataset = mk("valid")
        else:
            raise ValueError(
                f"cannot infer dataset from {self.spec_dir_path!r}")

    def _loader(self, ds, shuffle):
        return DataLoader(ds, self.batch_size, shuffle=shuffle,
                          drop_last=True, seed=self.seed,
                          process_index=self.process_index,
                          process_count=self.process_count,
                          num_workers=self.num_workers)

    def train_dataloader(self):
        return self._loader(self.train_dataset, True)

    def val_dataloader(self):
        return self._loader(self.val_dataset, False)

    def val_dataloader_shuffled(self):
        return self._loader(self.val_dataset, True)

    def test_dataloader(self):
        return self._loader(self.test_dataset, False)
