"""The offline tokenizer of the PyTorch port: wavs -> mel files
(``extract_mel_spectrogram``, kernel D on the card) -> VQ code grids
(``extract_codes``, kernel C on the card), the files every trainer reads.
Counterpart of the repository's feature_extraction/ CLIs.

Both CLIs run on the card unless ``--device cpu`` is given; a CUDA device
on a machine without one raises, as the training CLIs do.
"""

from __future__ import annotations

import contextlib

import torch


def torch_device(name: str) -> torch.device:
    """The device a CLI named (``--device``); a CUDA one must exist."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device")
    return device


@contextlib.contextmanager
def tf32_flags(cudnn: bool = False, matmul: bool = False):
    """Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` for the scope and restore the
    caller's values after it.  With both False (the default) convolutions
    and products run in full float32: the counterpart of the JAX CLI's
    ``jax_default_matmul_precision="highest"``, which keeps code indices
    off TF32 rounding near codebook decision boundaries.  The flags are
    process-wide: a thread running beside the scope sees them too."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
