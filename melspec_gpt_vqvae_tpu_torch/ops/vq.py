"""Vector-quantisation nearest-neighbour search and codebook lookup.

Counterpart of melspec_gpt_vqvae_tpu/ops/vq.py (reference
vqvae/big_model_attn_gan.py:28-33, 56-71):

  * ``vq_nearest_index_xla`` -- the plain PyTorch version, named after the
    JAX function it mirrors: the full float32 distance matrix, then argmin;
  * ``vq_nearest_index`` -- kernel C (csrc/vq.cu), the counterpart of the
    Pallas ``vq_nearest_index_pallas``, for CUDA tensors; the plain version
    for CPU tensors.

Both run in full float32: a TF32 product flips indices near decision
boundaries, so callers on the card keep ``torch.backends.cuda.matmul.
allow_tf32`` off (its default) for the plain version.
"""

from __future__ import annotations

import torch

from .. import _build


def vq_nearest_index_xla(x: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k |x_n - e_k|^2.  x (N, D), codebook (K, D) -> int32 (N,)."""
    x = x.float()
    codebook = codebook.float()
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    e2 = torch.sum(codebook * codebook, dim=1)
    dist = x2 + e2[None, :] - 2.0 * (x @ codebook.T)
    return torch.argmin(dist, dim=1).to(torch.int32)


def vq_nearest_index(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook index for each row of x: kernel C on CUDA tensors,
    ``vq_nearest_index_xla`` on CPU tensors.  (N, D) x (K, D) -> int32 (N,);
    inputs of any float dtype are compared in float32."""
    if _build.on_cpu(x, codebook):
        return vq_nearest_index_xla(x, codebook)
    n, d = x.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"latent width {d} != codebook width "
                         f"{codebook.shape[1]}")
    if 4 * 96 * (d + 1) > 227 * 1024:
        raise ValueError(f"vq kernel: width {d} exceeds shared memory")
    x = x.detach().float().contiguous()
    codebook = codebook.detach().float().contiguous()
    e2 = torch.sum(codebook * codebook, dim=1)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    _build.launch("msgv_vq_nearest", x.device, x.data_ptr(),
                  codebook.data_ptr(), e2.data_ptr(), out.data_ptr(), n, k, d)
    vq_nearest_index.launches += 1
    return out


vq_nearest_index.launches = 0


def vq_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """indices (...,) -> embeddings (..., D)
    (reference ``get_codebook_entry``: big_model_attn_gan.py:56-71)."""
    return codebook[indices.long()]
