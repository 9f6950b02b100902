"""Cross-process metric reduction (DDP ``sync_dist`` parity).

Counterpart of melspec_gpt_vqvae_tpu/parallel/reduce.py.  The reference
reduces logged metrics across ranks with Lightning's ``sync_dist=True``
(/root/reference/transformer/Lit_GPT_VAE.py:310-313, 356-359), so its
ModelCheckpoint monitors a *global* validation loss.  Epoch metric
**sums** are summed across processes here before the means, NLL, PPL and
the best-checkpoint decision are derived, and the posteriors of MI / AU
are pooled over the whole corpus.

The reduction runs over the mesh's ``data`` group: the ranks of one model
or pipe group read the same rows and hold the same sums, so summing over
every rank would count them ``model * pipe`` times.  Without a mesh it
runs over the world.  Transport: ``all_gather`` of a float64 (sums) or
float32 (posteriors) vector.  Tests inject a fake transport through
``set_transport`` to simulate processes inside one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# Test seam: a callable (local_vec (K,) -> gathered (P, K)).  None = the
# real all_gather (identity when the group has one rank).
_transport: Optional[Callable[[np.ndarray], np.ndarray]] = None


def set_transport(fn: Optional[Callable[[np.ndarray], np.ndarray]]) -> None:
    global _transport
    _transport = fn


def _group_and_device(mesh):
    """(the data group, its size, the collectives' device) of ``mesh``; the
    world without one."""
    if mesh is not None:
        from .mesh import DATA_AXIS
        if not mesh.active(DATA_AXIS):
            return None, 1, mesh.device
        return mesh.group(DATA_AXIS), mesh.size(DATA_AXIS), mesh.device
    if not dist.is_initialized():
        return None, 1, torch.device("cpu")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    return None, dist.get_world_size(), dev


def _processes(mesh) -> int:
    return _group_and_device(mesh)[1]


def _default_transport(mesh) -> Callable[[np.ndarray], np.ndarray]:
    group, n, dev = _group_and_device(mesh)

    def transport(vec: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(vec)).to(dev)
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=group)
        return torch.stack(out).cpu().numpy()
    return transport


def cross_process_concat(arr: np.ndarray, mesh=None) -> np.ndarray:
    """Concatenate per-process ``(N_p, D)`` arrays along axis 0, in data
    coordinate order.  Identity when one process holds the data and no
    transport is injected.

    Pools posterior parameters (mu / logvar) so that corpus statistics (MI
    / active units) cover the FULL evaluation corpus under multi-process
    execution -- the reference computes them over the whole val set on
    every rank (callbacks/GPT_VAE_callbacks.py:429-436 via
    ``pl_module.val_data``).

    Unequal ``N_p`` is handled: a (1,)-vector gather first exchanges row
    counts, locals are zero-padded to the max, and the padding is sliced
    away after the main gather.  Values travel as float32 on both the
    single- and the multi-process path, so statistics cannot flip with the
    process count; that bounds the exact row count at 2**24, checked after
    the counts collective (every rank raises together)."""
    transport = _transport
    if transport is None:
        if _processes(mesh) == 1:
            return np.asarray(arr, np.float32)
        transport = _default_transport(mesh)
    arr = np.asarray(arr, np.float32)
    n, d = arr.shape
    counts = np.asarray(
        transport(np.asarray([float(n)], np.float64))).reshape(-1)
    counts = np.rint(counts).astype(np.int64)
    if counts.max() >= 2 ** 24:
        # after the counts collective: a raise before it on one oversized
        # rank would leave the others waiting in the gather
        raise ValueError(f"a shard of {int(counts.max())} rows exceeds the "
                         "exact-f32 count range of the gather transport")
    max_n = int(counts.max())
    if max_n == 0:          # every process is empty this round
        return arr
    if max_n != n:
        arr = np.pad(arr, ((0, max_n - n), (0, 0)))
    gathered = np.asarray(transport(arr.reshape(-1)))
    gathered = gathered.reshape(len(counts), max_n, d)
    return np.concatenate([g[:c] for g, c in zip(gathered, counts)], axis=0)


def concat_gather_fn(mesh=None
                     ) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """``cross_process_concat`` over the mesh's data group when it would do
    anything, else None: the single-process path keeps the posteriors on
    the device instead of a round trip through the host."""
    if _transport is not None or _processes(mesh) > 1:
        return lambda a: cross_process_concat(a, mesh)
    return None


def cross_process_sharded(mesh) -> bool:
    """True when the mesh splits parameters across processes (a model or
    pipe axis of more than one rank).  The same on every rank, so callers
    can branch on it before a collective without stranding a rank: where
    it holds, rank 0's media logging first gathers the parameters to full
    leaves on rank 0 (a collective of rank 0's model or pipe group)."""
    return mesh is not None and mesh.sharded


def pool_posteriors(mus, logvars, nz: int, mesh=None):
    """Pool per-batch posterior-parameter lists into full-corpus (mu,
    logvar).

    The GPT-VAE and LSTM-VAE MI / AU paths share it, so that the
    collective-participation contract lives in ONE place: an empty local
    shard still contributes a (0, nz) array to the cross-process gather (a
    skipping rank would deadlock the others), and single-process pooling
    stays on the device.

    Returns ``(mu, logvar)`` over the global corpus, float32, or ``None``
    when it holds fewer than 2 rows (MI is meaningless and the AU variance
    denominator ``N - 1`` vanishes)."""
    dev = None
    if mus:
        mu = torch.cat([m.float() for m in mus])
        logvar = torch.cat([v.float() for v in logvars])
        dev = mu.device
    else:
        mu = logvar = torch.zeros((0, int(nz)), dtype=torch.float32)
    gather = concat_gather_fn(mesh)
    if gather is not None:
        dev = dev if dev is not None else (
            mesh.device if mesh is not None else torch.device("cpu"))
        mu = torch.from_numpy(gather(mu.detach().cpu().numpy())).to(dev)
        logvar = torch.from_numpy(
            gather(logvar.detach().cpu().numpy())).to(dev)
    if mu.shape[0] < 2:
        return None
    return mu, logvar


def cross_process_sum(metrics: Dict[str, float],
                      mesh=None) -> Dict[str, float]:
    """Sum each scalar metric across the data group's processes.

    Identity when one process holds the data; keys must be identical on
    every process (they are: the epoch sums come from the same code
    everywhere)."""
    transport = _transport
    if transport is None:
        if _processes(mesh) == 1:
            return {k: float(v) for k, v in metrics.items()}
        transport = _default_transport(mesh)
    keys = sorted(metrics)
    vec = np.asarray([float(metrics[k]) for k in keys], np.float64)
    gathered = np.asarray(transport(vec)).reshape(-1, len(keys))
    total = gathered.sum(axis=0)
    return {k: float(v) for k, v in zip(keys, total)}
