"""Split-file datasets: VAS and VGGSound.

Parity with reference/datasets/vas.py:30-91 and
reference/datasets/vggsound.py:21-174: items carry
``image`` (2*spec-1 after crop), ``codes`` (5x53 int grid when the
``codes_10s`` sibling file exists), ``label``, ``target``, ``file_path_``.
Pure numpy/filesystem code — no torch Dataset machinery; batching and
shuffling live in loader.py.

The port's own copy of melspec_gpt_vqvae_tpu/data/datasets.py (numpy and the
standard library only): same classes, same batches for the same seed.
"""

from __future__ import annotations

import collections
import csv
import os
import random
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .transforms import Crop


class VASSpecs:
    """VAS: split file ``data/vas_{split}.txt`` with ``cls/video_id`` lines
    (reference: datasets/vas.py:30-91)."""

    def __init__(self, split: str, spec_dir_path: str, mel_num=80,
                 spec_len=860, spec_crop_len=848, random_crop=False,
                 for_which_class: Optional[str] = None,
                 data_root: str = "./data"):
        self.split = split
        self.spec_dir_path = spec_dir_path
        codes_path = spec_dir_path.split("/")
        codes_path[-1] = "codes_10s"
        self.codes_dir_path = "/".join(codes_path)
        self.split_path = os.path.join(data_root, f"vas_{split}.txt")
        self.feat_suffix = "_mel.npy"
        self.feat_codes_suffix = "_mel_code.npy"

        if not os.path.exists(self.split_path):
            raise FileNotFoundError(
                f"split does not exist in {self.split_path}")

        with open(self.split_path) as f:
            full_dataset = f.read().splitlines()
        if for_which_class:
            self.dataset = [v for v in full_dataset
                            if v.startswith(for_which_class)]
        else:
            self.dataset = full_dataset

        unique_classes = sorted({cv.split("/")[0] for cv in self.dataset})
        self.label2target = {l: t for t, l in enumerate(unique_classes)}
        self.random_crop = bool(random_crop)
        self.crop_shape = (mel_num, spec_crop_len)
        self.transforms = Crop((mel_num, spec_crop_len), random_crop)

    def __len__(self):
        return len(self.dataset)

    def item_paths(self, idx: int):
        """(spec_path, codes_path, target, label) — the native fast path's
        view of an item."""
        cls, vid = self.dataset[idx].split("/")
        spec_path = os.path.join(self.spec_dir_path.replace("*", cls),
                                 f"{vid}{self.feat_suffix}")
        codes_path = os.path.join(self.codes_dir_path.replace("*", cls),
                                  f"{vid}{self.feat_codes_suffix}")
        return spec_path, codes_path, self.label2target[cls], cls

    def __getitem__(self, idx: int) -> Dict:
        cls, vid = self.dataset[idx].split("/")
        spec_path = os.path.join(self.spec_dir_path.replace("*", cls),
                                 f"{vid}{self.feat_suffix}")
        codes_path = os.path.join(self.codes_dir_path.replace("*", cls),
                                  f"{vid}{self.feat_codes_suffix}")
        spec = np.load(spec_path)
        item = {
            "image": (2 * self.transforms(spec) - 1).astype(np.float32),
            "file_path_": spec_path,
            "label": cls,
            "target": self.label2target[cls],
        }
        if os.path.isfile(codes_path):
            item["codes"] = np.load(codes_path).astype(np.int32)
        return item


class VGGSoundSpecs:
    """VGGSound: meta CSV label maps + split txts
    (reference: datasets/vggsound.py:21-174)."""

    def __init__(self, split: str, spec_dir_path: str, mel_num=80,
                 spec_len=860, spec_crop_len=848, random_crop=False,
                 splits_path: str = "./data",
                 meta_path: str = "./data/vggsound.csv"):
        self.split = split
        self.specs_dir = spec_dir_path
        self.meta_path = meta_path
        self.splits_path = splits_path

        meta = list(csv.reader(open(meta_path), quotechar='"'))
        unique_classes = sorted({row[2] for row in meta})
        self.label2target = {l: t for t, l in enumerate(unique_classes)}
        self.target2label = {t: l for l, t in self.label2target.items()}
        self.video2target = {row[0]: self.label2target[row[2]] for row in meta}

        # sibling dir: .../vggsound/melspec_10s_22050hz -> .../vggsound/codes_10s
        # (reference: datasets/vggsound.py:38-42)
        parent = os.path.dirname(spec_dir_path.rstrip("/"))
        self.codes_dir_path = os.path.join(parent, "codes_10s")
        self.feat_codes_suffix = "_mel_code.npy"

        split_file = os.path.join(splits_path, f"vggsound_{split}.txt")
        if not os.path.exists(split_file):
            make_vggsound_split_files(self.specs_dir, meta_path, splits_path)
        with open(split_file) as f:
            clip_ids = f.read().splitlines()
        self.dataset = [os.path.join(spec_dir_path, v + "_mel.npy")
                        for v in clip_ids]

        vid_classes = [self.video2target[Path(p).stem[:11]]
                       for p in self.dataset]
        c2c = collections.Counter(vid_classes)
        self.class_counts = np.array([c2c[c] for c in range(len(c2c))])
        self.random_crop = bool(random_crop)
        self.crop_shape = (mel_num, spec_crop_len)
        self.transforms = Crop((mel_num, spec_crop_len), random_crop)

    def __len__(self):
        return len(self.dataset)

    def item_paths(self, idx: int):
        spec_path = self.dataset[idx]
        video_name = Path(spec_path).stem[:11]
        fname = os.path.basename(spec_path).replace(
            "_mel.npy", self.feat_codes_suffix)
        codes_path = os.path.join(self.codes_dir_path, fname)
        target = self.video2target[video_name]
        return spec_path, codes_path, target, self.target2label[target]

    def __getitem__(self, idx: int) -> Dict:
        spec_path = self.dataset[idx]
        video_name = Path(spec_path).stem[:11]
        fname = os.path.basename(spec_path).replace(
            "_mel.npy", self.feat_codes_suffix)
        codes_path = os.path.join(self.codes_dir_path, fname)

        spec = np.load(spec_path)
        target = self.video2target[video_name]
        item = {
            "image": (2 * self.transforms(spec) - 1).astype(np.float32),
            "file_path_": spec_path,
            "target": target,
            "label": self.target2label[target],
        }
        if os.path.isfile(codes_path):
            item["codes"] = np.load(codes_path).astype(np.int32)
        return item


def make_vggsound_split_files(specs_dir: str, meta_path: str,
                              splits_path: str, seed: int = 1337):
    """Regenerate train/valid/test split txts, valid stratified to match the
    test-set class counts (reference: datasets/vggsound.py:95-148)."""
    random.seed(seed)
    available = sorted(glob(os.path.join(specs_dir, "*_mel.npy")))
    meta = list(csv.reader(open(meta_path), quotechar='"'))
    train_vids = {row[0] for row in meta if row[3] == "train"}
    test_vids = {row[0] for row in meta if row[3] == "test"}

    unique_classes = sorted({row[2] for row in meta})
    label2target = {l: t for t, l in enumerate(unique_classes)}
    video2target = {row[0]: label2target[row[2]] for row in meta}
    test_counts = collections.Counter(video2target[v] for v in test_vids)

    train_wo_valid, valid_vids = set(), set()
    for target, _ in enumerate(label2target.keys()):
        class_train = [v for v in train_vids if video2target[v] == target]
        random.shuffle(class_train)
        count = test_counts[target]
        valid_vids.update(class_train[:count])
        train_wo_valid.update(class_train[count:])

    os.makedirs(splits_path, exist_ok=True)
    files = {name: open(os.path.join(splits_path, f"vggsound_{name}.txt"),
                        "w") for name in ("train", "valid", "test")}
    try:
        for path in available:
            vid_name = Path(path.replace("_mel.npy", "")).name
            key = vid_name[:11]
            if key in train_wo_valid:
                files["train"].write(vid_name + "\n")
            elif key in valid_vids:
                files["valid"].write(vid_name + "\n")
            elif key in test_vids:
                files["test"].write(vid_name + "\n")
            else:
                raise RuntimeError(
                    f"Clip {vid_name} is neither in train, valid nor test.")
    finally:
        for f in files.values():
            f.close()
