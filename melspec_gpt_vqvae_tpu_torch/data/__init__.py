"""Datasets, transforms and the batching loader: the port's own copy of
melspec_gpt_vqvae_tpu/data (numpy and the standard library only)."""

from .transforms import center_crop, random_crop, Crop, StandardNormalizeAudio  # noqa: F401
from .datasets import VASSpecs, VGGSoundSpecs, make_vggsound_split_files  # noqa: F401
from .loader import DataLoader, DataModule  # noqa: F401
