"""The process mesh and the Megatron sharding rules.

Counterpart of melspec_gpt_vqvae_tpu/parallel/mesh.py.  The reference's
only distribution mechanism is Lightning DDP (/root/reference/
GPT_VAE_train.py:166-182: ``strategy="ddp..."``, ``devices=args.gpus``,
``num_nodes=args.num_nodes``): an NCCL gradient all-reduce over a
data-parallel axis.  The JAX package lays one ``jax.sharding.Mesh`` over
every chip and adds a ``model`` axis (Megatron tensor parallelism) and a
``pipe`` axis (GPipe pipeline parallelism, parallel/pipeline.py).

Here a run is one process a GPU (``torchrun``), and a ``Mesh`` names the
axes of the world's ranks in the JAX mesh's row-major order: under
``{"data": 2, "model": 4}`` global rank ``r`` has data coordinate
``r // 4`` and model coordinate ``r % 4``.  Each axis has one process
group of the ranks that differ only in that coordinate.  The collectives
are NCCL's on the card and gloo's when the caller names the CPU.  A mesh
made without a process group (world size 1, no launcher) runs no
collective: each group is that one rank.

The JAX module's ``batch_sharding``, ``put_batch``, ``shard_batch``,
``replicated`` and ``replicate_stragglers`` have no counterpart: they
place host rows and scalars on a multi-device mesh, and here each
process already holds its own rows (the loader shards them by data
coordinate, ``DataModule(process_index=, process_count=)``) and its own
parameters.  The TP sharding rules of ``gpt_param_pspecs`` (mesh.py:167-199
there) and the ``pipe`` axis's of pipeline.py's ``gpt_param_pp_pspecs``
are the shard and gather functions at the end of this module, on the
port's nested dicts of tensors.  A gather brings the full leaves to
global rank 0 alone, one leaf at a time: only rank 0 writes checkpoints
and logs.
"""

from __future__ import annotations

import gc
import math
import os
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, PIPE_AXIS)


def maybe_init_distributed(device="cuda",
                           timeout: Optional[timedelta] = None, *,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> torch.device:
    """Join a process group: the one ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or,
    given an ``init_method`` (e.g. ``file:///tmp/store``), ``world_size``
    ranks there as ``rank``, without a launcher.  NCCL on a CUDA device
    (``cuda:{LOCAL_RANK}`` under a launcher), gloo only when ``device`` is
    the CPU.  A failure to initialise raises; nothing falls back to gloo
    or the CPU.  Without a launcher's environment or an ``init_method``,
    or with a group already joined, it starts nothing.  Returns the device
    this process runs on."""
    device = torch.device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dist.is_initialized() or (init_method is None and not launched):
        return device
    kw = {"timeout": timeout}
    if init_method is not None:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    if device.type == "cpu":
        dist.init_process_group("gloo", **kw)
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device")
    if init_method is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", device_id=device, **kw)
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if one was joined.  Unreachable objects
    are collected first: a captured decode program that recorded NCCL
    collectives (serving over a mesh) holds its communicator, whose
    destruction waits for the graph's."""
    if dist.is_initialized():
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()


def process_index() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """rank_zero_only equivalent (reference:
    callbacks/GPT_callbacks.py:113 ``@rank_zero_only``): global rank 0."""
    return process_index() == 0


def parse_mesh(spec: str) -> Optional[Dict[str, int]]:
    """``"data=2,model=4"`` -> ``{"data": 2, "model": 4}`` (the CLIs'
    ``--mesh`` flag; empty string -> None -> every rank on ``data``)."""
    if not spec:
        return None
    out = {}
    for kv in spec.split(","):
        k, v = kv.split("=")
        if k not in AXES:
            raise ValueError(f"--mesh {spec!r}: unknown axis {k!r} "
                             f"(expected {', '.join(AXES)})")
        out[k] = int(v)
    return out


class Mesh:
    """Named axes over the world's ranks, row-major, with a process group
    an axis.  ``n_micro`` is the pipeline's microbatch count on a ``pipe``
    axis (0 = twice the stages).  ``device`` is where the collectives'
    tensors live (the CUDA device under NCCL)."""

    def __init__(self, shape: Dict[str, int], device, n_micro: int = 0):
        self.shape = dict(shape)
        self.device = torch.device(device)
        self.n_micro = int(n_micro)
        self.names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        self.rank = process_index()
        self.coords = dict(zip(self.names, _unravel(self.rank, sizes)))
        self.ranks: Dict[str, List[int]] = {}
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for i, name in enumerate(self.names):
            mine = None
            # every rank creates every group, in the same order
            for other in _product([s for j, s in enumerate(sizes)
                                   if j != i]):
                ranks = [_ravel(other[:i] + (c,) + other[i:], sizes)
                         for c in range(sizes[i])]
                group = (dist.new_group(ranks) if dist.is_initialized()
                         else None)
                if self.rank in ranks:
                    mine = (ranks, group)
            self.ranks[name], self.groups[name] = mine

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}, coords "
                f"{self.coords}, n_micro {self.n_micro})")

    def has(self, axis: str) -> bool:
        return axis in self.shape

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on the axis; 0 for an absent axis."""
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The axis's process group of this rank; None without a process
        group or for an absent axis (a group of this rank alone)."""
        return self.groups.get(axis)

    def active(self, axis: str) -> bool:
        """True where the axis has a process group to reduce over."""
        return self.group(axis) is not None

    @property
    def sharded(self) -> bool:
        """True when parameters are split across ranks (a model or pipe
        axis of more than one rank)."""
        return self.size(MODEL_AXIS) > 1 or self.size(PIPE_AXIS) > 1

    @property
    def token(self) -> tuple:
        """What a captured decode program bakes in of the mesh: its shape,
        this rank, and the object (its process groups' communicators)."""
        return (tuple(self.shape.items()), self.rank, id(self))

    def all_reduce_(self, t: torch.Tensor, axis: str,
                    async_op: bool = False, op: str = "sum"):
        """Reduce ``t`` in place over the axis, ``op`` "sum", "max" or
        "min" (nothing without its group)."""
        if not self.active(axis):
            return None
        return dist.all_reduce(t, op=_OPS[op], group=self.group(axis),
                               async_op=async_op)

    def all_gather(self, t: torch.Tensor, axis: str,
                   sizes: Optional[List[int]] = None,
                   dim: int = 0) -> List[torch.Tensor]:
        """Every rank's ``t`` on the axis, in coordinate order (``[t]``
        without its group).  ``sizes``: each rank's extent along ``dim``
        where the parts differ (an uneven head cut): each part is padded
        with zeros to the largest, gathered, and trimmed back (NCCL's and
        gloo's all-gather take parts of one shape)."""
        if not self.active(axis):
            return [t]
        t = _pad_to(t.contiguous(), dim, max(sizes) if sizes else None)
        parts = [torch.empty_like(t) for _ in range(self.size(axis))]
        dist.all_gather(parts, t, group=self.group(axis))
        if sizes:
            parts = [p.narrow(dim, 0, n) for p, n in zip(parts, sizes)]
        return parts

    def warm_collectives(self) -> None:
        """One small all-reduce on every axis group of this rank, on the
        current stream: joins the communicators before a CUDA graph
        records collectives over them (NCCL cannot set one up inside a
        capture)."""
        for axis in self.names:
            if self.active(axis):
                t = torch.zeros(1, device=self.device)
                dist.all_reduce(t, group=self.group(axis))

    def mean_(self, tensors: List[torch.Tensor], axis: str) -> None:
        """Average each tensor in place over the axis, all in flight at
        once: NCCL's AVG (a sum premultiplied by 1 / size; at one rank
        NCCL's one-rank kernel, a product by 1), or under gloo, which has
        no AVG, a sum and a division."""
        if not self.active(axis) or not tensors:
            return
        group = self.group(axis)
        avg = dist.get_backend(group) == "nccl"
        op = dist.ReduceOp.AVG if avg else dist.ReduceOp.SUM
        work = [dist.all_reduce(t, op=op, group=group, async_op=True)
                for t in tensors]
        for w in work:
            w.wait()
        if not avg:
            n = float(self.size(axis))
            for t in tensors:
                t.div_(n)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _pad_to(t: torch.Tensor, dim: int, n: Optional[int]) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to extent ``n`` (itself when it has
    it, or for ``n`` None)."""
    if n is None or t.shape[dim] == n:
        return t
    shape = list(t.shape)
    shape[dim] = n - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _unravel(r: int, sizes) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def _ravel(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _product(sizes) -> List[Tuple[int, ...]]:
    out = [()]
    for s in sizes:
        out = [o + (c,) for o in out for c in range(s)]
    return out


def make_mesh(shape: Optional[Dict[str, int]] = None, device="cpu",
              n_micro: int = 0) -> Mesh:
    """A mesh over the world's ranks.  Default: every rank on ``data``; a
    ``-1`` entry is inferred.  The product of the sizes must be the world
    size (the JAX mesh's "device subset" has no counterpart: a process
    that is no part of the mesh would still hold a GPU).  ``model`` and
    ``pipe`` do not combine, as in the JAX package."""
    n = process_count()
    shape = dict(shape) if shape else {DATA_AXIS: n}
    sizes = list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError("--mesh: at most one -1 axis")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        shape[list(shape)[sizes.index(-1)]] = n // known
    want = math.prod(shape.values())
    if want != n:
        raise ValueError(
            f"--mesh {','.join(f'{k}={v}' for k, v in shape.items())} spans "
            f"{want} ranks but the world size is {n}: launch one process a "
            f"rank (torchrun --nproc_per_node {want})")
    if shape.get(MODEL_AXIS, 1) > 1 and shape.get(PIPE_AXIS, 1) > 1:
        raise ValueError("--mesh: the model and pipe axes do not combine "
                         "(tensor parallelism inside pipeline stages is "
                         "not supported, as in the JAX package)")
    return Mesh(shape, device, n_micro)


def as_mesh(mesh, device, n_micro: int = 0) -> Optional[Mesh]:
    """A task's ``mesh`` argument -- None (the plain single-device path), a
    ``Mesh`` (which carries its own ``n_micro``) or a ``--mesh`` spec
    string, made here with ``n_micro`` -- as a ``Mesh`` or None."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return make_mesh(parse_mesh(mesh), device, n_micro)


def data_coordinate(mesh: Optional[Mesh]) -> int:
    """This rank's data coordinate: which shard of the batches it reads."""
    return mesh.coord(DATA_AXIS) if mesh is not None else 0


def data_size(mesh: Optional[Mesh]) -> int:
    """The number of data shards."""
    return mesh.size(DATA_AXIS) if mesh is not None else 1


def local_batch_slice(global_batch_size: int,
                      mesh: Optional[Mesh] = None) -> slice:
    """This rank's rows of a globally indexed batch (the DDP
    DistributedSampler equivalent): the data coordinate's contiguous
    share."""
    per = global_batch_size // data_size(mesh)
    i = data_coordinate(mesh)
    return slice(i * per, (i + 1) * per)


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (itself without a process
    group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# Gradients: the DP all-reduce and the pipe axis's replicated leaves
# ---------------------------------------------------------------------------


def reduce_gradients(mesh: Optional[Mesh], named_params) -> None:
    """Make every rank's gradients the global batch's, before the
    optimizer: on a ``pipe`` axis, sum the gradients of the leaves every
    stage holds (embeddings, ``ln_f``, the head: only some stages reach
    them, the rest count zeros) over the pipe group; then average every
    gradient over the ``data`` group (DDP's mean).  Runs every collective
    the mesh's axes have, one rank or more."""
    if mesh is None:
        return
    leaves = list(named_params)
    if mesh.active(PIPE_AXIS):
        work = []
        for name, t in leaves:
            if "blocks" in name:
                continue
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            work.append(mesh.all_reduce_(t.grad, PIPE_AXIS, async_op=True))
        for w in work:
            w.wait()
    mesh.mean_([t.grad for _, t in leaves if t.grad is not None],
               DATA_AXIS)


def mean_over_data(mesh: Optional[Mesh], values: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """0-d tensors averaged over the data group in one all-reduce (the
    global batch's loss and report from each shard's): new tensors."""
    if mesh is None or not mesh.active(DATA_AXIS):
        return values
    vec = torch.stack([v.detach().float().reshape(()) for v in values])
    mesh.mean_([vec], DATA_AXIS)
    return [vec[i].to(v.dtype) for i, v in enumerate(values)]


# ---------------------------------------------------------------------------
# GPT parameter sharding rules (Megatron-style TP over MODEL_AXIS).
# Leaf names are the nested dict's paths ("blocks/attn_qkv/w"), in the
# layout of models/gpt.py::init_gpt_params (2-D weights are (in, out)).
# ---------------------------------------------------------------------------

_TP_RULES = (("attn_qkv/w", "qkv"), ("attn_qkv/b", "qkv"),
             ("attn_proj/w", "heads"), ("mlp_up/w", -1), ("mlp_up/b", -1),
             ("mlp_down/w", 1))


def tp_rule(name: str):
    """How a leaf is cut over ``model``: "qkv" (the fused projection's
    columns, this rank's heads of each of q, k and v), "heads" (the input
    rows of ``attn_proj``, this rank's heads), an axis (``-1`` the output
    columns of ``mlp_up``; ``1`` the input rows of ``mlp_down``), or None
    (replicated: embeddings, layer norms, the row-parallel biases, the
    head)."""
    if "blocks" not in name:
        return None
    for suffix, rule in _TP_RULES:
        if name.endswith(suffix):
            return rule
    return None


def row_cut(rule) -> bool:
    """True for a rule that cuts a product's input rows (``attn_proj``,
    ``mlp_down``: each rank's product is a partial sum)."""
    return rule in ("heads", 1)


def cut_dim(rule) -> int:
    """The axis of a stacked (L, in, out) or (L, out) leaf a rule cuts."""
    return 1 if row_cut(rule) else -1


def head_range(n_head: int, m: int, r: int) -> Tuple[int, int]:
    """(first head, head count) of model rank ``r`` of ``m``: the first
    ``n_head % m`` ranks hold ``ceil(n_head / m)`` heads and the rest
    ``floor``, in order (23 heads over 4 ranks: 6, 6, 6, 5).  The one
    place the partition is computed."""
    q, extra = divmod(n_head, m)
    return r * q + min(r, extra), q + (r < extra)


def head_counts(n_head: int, m: int) -> List[int]:
    """Every model rank's head count, in coordinate order."""
    return [head_range(n_head, m, r)[1] for r in range(m)]


def tp_sizes(name: str, local: torch.Tensor, n_head: int, m: int,
             r: int) -> Optional[List[int]]:
    """Each model rank's extent of the leaf ``name`` along its cut axis,
    from this rank's part ``local`` (rank ``r``): by heads for the qkv and
    ``attn_proj`` cuts, None for the even MLP cuts."""
    rule = tp_rule(name)
    if rule not in ("qkv", "heads"):
        return None
    per_head = local.shape[cut_dim(rule)] // head_range(n_head, m, r)[1]
    return [per_head * c for c in head_counts(n_head, m)]


def tp_shard(name: str, full: torch.Tensor, r: int, m: int,
             n_head: int) -> torch.Tensor:
    """Rank ``r`` of ``m``'s part of the full leaf ``name``.  The fused
    ``attn_qkv`` is cut head-aligned, ``[q_r | k_r | v_r]``, and
    ``attn_proj``'s rows by the same heads (``head_range``: an uneven cut
    where ``m`` does not divide ``n_head``), not the contiguous blocks
    JAX's ``P(None, None, "model")`` names (XLA keeps the semantics
    whatever the cut; an explicit shard must hold whole heads) of the
    GPT's ``n_head``; the MLP's cuts are even."""
    rule = tp_rule(name)
    if rule is None or m == 1:
        return full
    if rule in ("qkv", "heads"):
        lo, count = head_range(n_head, m, r)
        if rule == "heads":
            hd = full.shape[1] // n_head
            return full.narrow(1, lo * hd, count * hd)
        thirds = full.chunk(3, dim=-1)
        hd = thirds[0].shape[-1] // n_head
        return torch.cat([c.narrow(-1, lo * hd, count * hd)
                          for c in thirds], dim=-1)
    return full.chunk(m, dim=rule)[r]


def tp_gather(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """The full leaf from every model rank's part, in coordinate order
    (``tp_shard``'s inverse; the parts of a head cut may differ in
    size)."""
    rule = tp_rule(name)
    if rule is None or len(parts) == 1:
        return parts[0]
    if rule == "qkv":
        thirds = [p.chunk(3, dim=-1) for p in parts]
        return torch.cat([torch.cat([t[i] for t in thirds], dim=-1)
                          for i in range(3)], dim=-1)
    return torch.cat(parts, dim=cut_dim(rule))


def pp_shard(name: str, full: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """Stage ``s`` of ``n``'s layers of a stacked ``blocks`` leaf (its
    leading layer axis); the other leaves are held whole by every stage."""
    if "blocks" not in name or n == 1:
        return full
    return full.chunk(n, dim=0)[s]


def split_axis(mesh: Optional[Mesh], name: str) -> Optional[str]:
    """The axis the leaf ``name`` is cut over under the mesh: ``model``
    (``tp_rule``), ``pipe`` (a stacked ``blocks`` leaf), or None where
    every rank holds it whole."""
    if mesh is None:
        return None
    if mesh.size(MODEL_AXIS) > 1 and tp_rule(name) is not None:
        return MODEL_AXIS
    if mesh.size(PIPE_AXIS) > 1 and "blocks" in name:
        return PIPE_AXIS
    return None


def shard_leaf(mesh: Optional[Mesh], name: str, full: torch.Tensor,
               n_head: int) -> torch.Tensor:
    """This rank's part of the full leaf ``name`` under the mesh
    (``n_head``: the GPT's, for the head cuts)."""
    if mesh is None:
        return full
    full = tp_shard(name, full, mesh.coord(MODEL_AXIS), mesh.size(MODEL_AXIS),
                    n_head)
    return pp_shard(name, full, mesh.coord(PIPE_AXIS), mesh.size(PIPE_AXIS))


def gather_leaf(mesh: Optional[Mesh], name: str, local: torch.Tensor,
                n_head: int, device="cpu") -> Optional[torch.Tensor]:
    """The full leaf ``name`` on global rank 0, a copy on ``device``; None
    on every other rank.  A leaf cut over an axis is gathered from the
    parts of rank 0's group of that axis (``dist.gather``: each of those
    ranks sends its part once, the others take no part); a whole leaf is
    rank 0's own.  Parts of unequal size (the heads of the GPT's
    ``n_head`` cut unevenly over ``model``, sized by ``tp_sizes``) go
    padded with zeros to the largest and are trimmed on rank 0.  Without
    a mesh, ``local`` itself."""
    if mesh is None:
        return local
    axis = split_axis(mesh, name)
    primary = is_primary()
    local = local.detach()
    if axis is None:
        return local.to(device, copy=True) if primary else None
    if 0 not in mesh.ranks[axis]:
        return None
    dim, sizes = 0, None
    if axis == MODEL_AXIS:
        dim = cut_dim(tp_rule(name)) % local.ndim
        sizes = tp_sizes(name, local, n_head, mesh.size(MODEL_AXIS),
                         mesh.coord(MODEL_AXIS))
    local = _pad_to(local.contiguous(), dim, max(sizes) if sizes else None)
    parts = ([torch.empty_like(local) for _ in range(mesh.size(axis))]
             if primary else None)
    dist.gather(local, parts, dst=0, group=mesh.group(axis))
    if not primary:
        return None
    if sizes:
        parts = [p.narrow(dim, 0, n) for p, n in zip(parts, sizes)]
    full = (tp_gather(name, parts) if axis == MODEL_AXIS
            else torch.cat(parts, dim=0))
    return full.to(device)


def check_divisible(mesh: Optional[Mesh], cfg) -> None:
    """Raise where a GPT config does not split over the mesh: a model axis
    wider than the heads (a rank would hold none; the heads themselves
    may split unevenly, ``head_range``), an MLP width ``4 * n_embd`` the
    model axis does not divide (its cut is even), layers over ``pipe``."""
    if mesh is None:
        return
    m, s = mesh.size(MODEL_AXIS), mesh.size(PIPE_AXIS)
    if m > cfg.n_head:
        raise ValueError(f"model={m} exceeds n_head {cfg.n_head}: a model "
                         "rank would hold no head")
    if (4 * cfg.n_embd) % m:
        raise ValueError(f"the MLP width 4 * n_embd = {4 * cfg.n_embd} is "
                         f"not divisible by model={m}")
    if cfg.n_layer % s:
        raise ValueError(f"n_layer {cfg.n_layer} not divisible by pipe={s}")


def _walk(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def shard_tree(mesh: Optional[Mesh], tree, n_head: int, prefix: str = ""):
    """A nested dict of full leaves of a GPT of ``n_head`` heads -> this
    rank's parts (by each leaf's path, ``prefix`` before it)."""
    if mesh is None:
        return tree
    return _walk(tree, lambda n, t: shard_leaf(mesh, n, t, n_head), prefix)


def gather_tree(mesh: Optional[Mesh], tree, n_head: int, prefix: str = "",
                device="cpu"):
    """This rank's nested dict of parts of a GPT of ``n_head`` heads ->
    the full leaves on global rank
    0, one leaf at a time, each moved to ``device`` (the host by default)
    before the next is gathered (``gather_leaf``); None on every other
    rank.  Without a mesh, ``tree`` itself."""
    if mesh is None:
        return tree
    full = _walk(tree, lambda n, t: gather_leaf(mesh, n, t, n_head, device),
                 prefix)
    return full if is_primary() else None


# ---------------------------------------------------------------------------
# Serving over a mesh: the shards a served pipeline holds, and its outputs
# gathered to rank 0 (the JAX package's pipeline.py:73-95, 119-122, 213-215
# under GSPMD)
# ---------------------------------------------------------------------------


def _model_cut(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(model axis size, this rank's coordinate on it)."""
    if mesh is None:
        return 1, 0
    return mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)


def shard_gpt_for_serving(mesh: Optional[Mesh], params, n_head: int,
                          device=None):
    """This rank's copy of a served GPT tree (the full leaves): the
    Megatron cut of ``tp_shard`` over ``model`` -- the qkv and
    ``attn_proj``'s rows by this rank's heads of ``n_head``
    (``head_range``), ``mlp_down`` by rows, ``mlp_up`` by columns; the
    embeddings, layer norms, the row-cut products' biases and the head
    whole -- each cut leaf a contiguous tensor of its own (a view would
    keep the full leaf alive).  Replicated over ``data``.  Each leaf is
    cut where it lies (the host, for a tree ``build_pipeline`` restored)
    and only this rank's part moves to ``device`` (None: the leaves stay
    where they are), one leaf at a time, so no full block leaf reaches
    the device."""
    m, r = _model_cut(mesh)

    def one(name, t):
        if m > 1 and tp_rule(name) is not None:
            t = tp_shard(name, t, r, m, n_head).clone(
                memory_format=torch.contiguous_format)
        return t if device is None else t.to(device)
    return _walk(params, one)


def _column_major(q: torch.Tensor) -> torch.Tensor:
    """(L, in, out) with each layer's ``in`` axis contiguous, the layout
    models/gpt.py::quantize_block_weights stores and the int8 product
    takes."""
    return q.transpose(1, 2).contiguous().transpose(1, 2)


def shard_block_weight(mesh: Optional[Mesh], name: str, leaf: Dict,
                       n_head: int, device=None) -> Dict:
    """This rank's part of one block matrix's int8 copy, quantised from
    the FULL matrix (models/gpt.py::quantize_block_weight: ``{"q": (L,
    in, out) int8, "s": (L, out)}``): ``q`` cut as its float matrix is;
    ``s`` cut with the columns of a column-cut product (``attn_qkv``,
    ``mlp_up``) and whole for a row-cut one (``attn_proj``, ``mlp_down``,
    whose output columns every rank holds), so that every scale is the
    single device's; the head cuts by ``n_head``'s ranges.  The parts move
    to ``device`` (None: where the leaf lies)."""
    m, r = _model_cut(mesh)
    q, s = leaf["q"], leaf["s"]
    if m > 1:
        path = f"blocks/{name}/w"
        q = _column_major(tp_shard(path, q, r, m, n_head))
        if not row_cut(tp_rule(path)):
            s = tp_shard(path, s, r, m, n_head).contiguous()
    if device is not None:
        q, s = q.to(device), s.to(device)
    return {"q": q, "s": s}


def shard_block_weights(mesh: Optional[Mesh], wq: Dict, n_head: int) -> Dict:
    """``shard_block_weight`` of every matrix of a
    ``quantize_block_weights`` copy."""
    return {name: shard_block_weight(mesh, name, leaf, n_head)
            for name, leaf in wq.items()}


def gather_rows(mesh: Optional[Mesh], local: torch.Tensor
                ) -> Optional[torch.Tensor]:
    """The data ranks' rows (each rank's ``local_batch_slice`` of a global
    batch, in order) concatenated on global rank 0; None on every other
    rank.  Only the ranks of rank 0's data group (model coordinate 0) take
    part: the model ranks of a data coordinate hold the same rows.
    Without a mesh, ``local``."""
    if mesh is None:
        return local
    if not mesh.active(DATA_AXIS):
        return local if is_primary() else None
    if 0 not in mesh.ranks[DATA_AXIS]:
        return None
    local = local.contiguous()
    parts = ([torch.empty_like(local) for _ in range(mesh.size(DATA_AXIS))]
             if is_primary() else None)
    dist.gather(local, parts, dst=0, group=mesh.group(DATA_AXIS))
    return torch.cat(parts) if is_primary() else None
