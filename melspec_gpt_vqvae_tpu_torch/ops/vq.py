"""Vector-quantisation nearest-neighbour search and codebook lookup.

Counterpart of melspec_gpt_vqvae_tpu/ops/vq.py (reference
vqvae/big_model_attn_gan.py:28-33, 56-71):

  * ``vq_nearest_index_xla`` -- the plain PyTorch version, named after the
    JAX function it mirrors: the full float32 distance matrix, then argmin;
  * ``vq_nearest_index`` -- kernel C (csrc/vq.cu), the counterpart of the
    Pallas ``vq_nearest_index_pallas``, for CUDA tensors; the plain version
    for CPU tensors;
  * ``vq_nearest_index_tiled`` -- kernel C's loops in plain PyTorch: the
    persistent grid over row tiles of the height ``tile_rows`` picks, rows
    and codes in chunks of 64 d against 128 codes, each thread's running
    minimum over its codes and the merge of the sixteen threads of a row.
    The CPU tests hold the design by it; nothing else calls it.

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


# kernel C's tiles (csrc/vq.cu): codes and d of a ring stage, code groups
# (threads) that share a row; a row tile has 16 R rows, R = 4 .. 8
TILE_CODES, TILE_D, ROW_LANES = 128, 64, 16


def tile_rows(n: int, ctas: int) -> int:
    """Rows of kernel C's row tile for ``n`` rows on a persistent grid of
    ``ctas``: the height 16 R (R = 4 .. 8) that leaves the busiest CTA the
    fewest rows to walk over, the taller tile on a tie."""
    def busy(rows):
        return -(-(-(-n // rows)) // ctas) * rows
    return min((16 * r for r in range(8, 3, -1)), key=busy)


def vq_nearest_index_tiled(x: torch.Tensor, codebook: torch.Tensor,
                           ctas: int = 132):
    """``vq_nearest_index_xla`` computed tile for tile as kernel C does.
    Returns (int32 (N,), stats): ``stats["tile_rows"]`` is the row tile's
    height, ``"chunks"`` the (rows + 128 codes) x 64 d chunks the grid
    stages in all, ``"busiest"`` the most row tiles one CTA walks over."""
    x, cb = x.float(), codebook.float()
    (n, d), k = x.shape, cb.shape[0]
    e2 = torch.sum(cb * cb, dim=1)
    dcs = -(-d // TILE_D)
    nchunk = -(-k // TILE_CODES) * dcs
    height = tile_rows(n, ctas)
    ntiles = -(-n // height)
    out = torch.full((n,), -1, dtype=torch.int32)
    chunks = busiest = 0
    lanes = torch.arange(ROW_LANES)
    for cta in range(min(ntiles, ctas)):
        tiles = range(cta, ntiles, ctas)
        busiest = max(busiest, len(tiles))
        for tile in tiles:
            rows = x[tile * height:(tile + 1) * height]
            m = rows.shape[0]
            # every thread's running (min, argmin): (rows, 16 lanes)
            best = torch.full((m, ROW_LANES), float("inf"))
            bidx = torch.zeros((m, ROW_LANES), dtype=torch.int64)
            for j in range(nchunk):
                kt, dc = divmod(j, dcs)
                chunks += 1
                k0, d0 = kt * TILE_CODES, dc * TILE_D
                codes = cb[k0:k0 + TILE_CODES, d0:d0 + TILE_D]
                part = rows[:, d0:d0 + TILE_D] @ codes.T
                acc = part if dc == 0 else acc + part
                if dc != dcs - 1:
                    continue
                # lane tx holds codes tx + 16 c, visited in increasing c
                for c in range(-(-codes.shape[0] // ROW_LANES)):
                    kk = k0 + lanes + ROW_LANES * c
                    live = kk < k0 + codes.shape[0]
                    col = (kk - k0).clamp(max=codes.shape[0] - 1)
                    dist = e2[kk.clamp(max=k - 1)] - 2.0 * acc[:, col]
                    upd = (dist < best) & live
                    best = torch.where(upd, dist, best)
                    bidx = torch.where(upd, kk.expand(m, -1), bidx)
            # the butterfly over the sixteen lanes, the lower index
            # winning a tie
            off = 1
            while off < ROW_LANES:
                od, oi = best[:, lanes ^ off], bidx[:, lanes ^ off]
                take = (od < best) | ((od == best) & (oi < bidx))
                best = torch.where(take, od, best)
                bidx = torch.where(take, oi, bidx)
                off *= 2
            out[tile * height:tile * height + m] = bidx[:, 0].to(torch.int32)
    return out, {"tile_rows": height, "chunks": chunks, "tiles": ntiles,
                 "busiest": busiest}


def vq_nearest_index(x: torch.Tensor, codebook: torch.Tensor
                     ) -> torch.Tensor:
    """Nearest codebook index for each row of x: kernel C on CUDA tensors,
    ``vq_nearest_index_xla`` on CPU tensors or with the kernels off.
    (N, D) x (K, D) -> int32 (N,); inputs of any float dtype are compared
    in float32."""
    if not _build.use_kernel(x, codebook):
        return vq_nearest_index_xla(x, codebook)
    n, d = x.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"latent width {d} != codebook width "
                         f"{codebook.shape[1]}")
    if d % 4:
        raise ValueError(f"vq kernel: width {d} must be a multiple of 4 "
                         "(rows are staged 16 bytes at a time)")
    x = x.detach().float().contiguous()
    codebook = codebook.detach().float().contiguous()
    e2 = torch.sum(codebook * codebook, dim=1)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    ctas = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.launch("msgv_vq_nearest", x.device, x.data_ptr(),
                  codebook.data_ptr(), e2.data_ptr(), out.data_ptr(), n, k, d,
                  ctas)
    vq_nearest_index.launches += 1
    return out


vq_nearest_index.launches = 0


def vq_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """indices (...,) -> embeddings (..., D)
    (reference ``get_codebook_entry``: big_model_attn_gan.py:56-71)."""
    return codebook[indices.long()]
