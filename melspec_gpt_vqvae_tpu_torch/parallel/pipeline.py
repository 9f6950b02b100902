"""GPipe pipeline parallelism over the stacked GPT block stack.

Counterpart of melspec_gpt_vqvae_tpu/parallel/pipeline.py.  The reference
is data-parallel only (/root/reference/GPT_VAE_train.py:166-182); the JAX
package splits the L blocks into S stages along a ``pipe`` mesh axis and
streams M microbatches through them, its backward the transpose of its
``ppermute`` schedule.

Here stage ``s`` (the rank's ``pipe`` coordinate) holds layers
``[s L/S, (s+1) L/S)`` of the stacked ``(L, ...)`` ``blocks`` leaves --
``models.gpt._layers`` unbinds the slab as it unbinds the whole stack --
and the embeddings, ``ln_f`` and the head whole.  The schedule is
explicit and lives inside autograd, so a caller's ``loss.backward()`` is
the mirrored pipeline and a stack composes with whatever surrounds it
(the GPT-VAE's encoder feeds its decoder through the latent):

  * every stage embeds (cheap, and the embedding dropout draws alike
    everywhere); stage 0 feeds microbatch m into its layers, stage s > 0
    receives it from stage s - 1 (``_Recv``) and every stage but the last
    sends its result on (``_Send``), in microbatch order: NCCL's ordered
    point-to-point sends make the fill and drain of GPipe, ticks
    (M + S - 1);
  * the last stage's outputs are broadcast to every stage (``_Broadcast``,
    the JAX ``psum`` of the last stage's buffer), which applies ``ln_f``,
    the head and the loss: the logits are replicated over ``pipe``, as
    the JAX function's;
  * backward, each ``_Send`` receives its output's gradient from the next
    stage and each ``_Recv`` sends its input's back, in the reverse order
    the autograd engine walks the graph (microbatch M - 1 first on every
    stage); ``_Broadcast`` sums the stages' gradients onto the last.
    Every stage runs the replicated tail, so ``loss_backward`` seeds each
    with 1/S, and ``mesh.reduce_gradients`` sums the leaves every stage
    holds over the pipe group: the embeddings (stage 0's gradient, zeros
    elsewhere), ``ln_f`` and the head.  Every stage then makes the same
    update.

Dropout: each (stage, microbatch) draws from a generator of its own,
seeded from the caller's generator state, which then moves on alike on
every stage (``_stage_generators``), so that masks differ by microbatch
and stage (JAX folds its keys per microbatch and layer, pipeline.py:
170-180) and whatever the caller draws next stays replicated.  The blocks
are ``models.gpt._block`` / ``_block_remat``, the sequential path's; the
``model`` axis does not combine with ``pipe``, as in the JAX package.

The JAX module's ``gpt_param_pp_pspecs`` and ``shard_gpt_params_pp`` are
``mesh.pp_shard`` (a stacked ``blocks`` leaf cut along its layer axis,
the others whole) and ``mesh.shard_tree``, which applies it with the
``model`` axis's rules.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import torch
import torch.distributed as dist

from ..configs import GPTConfig
from ..models.gpt import (Params, _block, _block_remat, _layers, class_embed,
                          cross_entropy_loss, embed_tokens, gpt_head)
from .mesh import PIPE_AXIS, Mesh


class _Send(torch.autograd.Function):
    """Forward, send ``x`` to rank ``dst``; returns a 0-d zero that ties
    the send into the graph.  Backward, receive ``x``'s gradient from
    ``dst``."""

    @staticmethod
    def forward(ctx, x, dst, group):
        x = x.contiguous()
        dist.send(x, dst, group=group)
        ctx.dst, ctx.group = dst, group
        ctx.like = (x.shape, x.dtype, x.device)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.dst, group=ctx.group)
        return g, None, None


class _Recv(torch.autograd.Function):
    """Forward, receive a tensor like ``like`` from rank ``src``.
    Backward, send its gradient back to ``src``.  ``anchor``, a 0-d leaf
    that requires grad, puts the receive into the graph."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        buf = torch.empty_like(like)
        dist.recv(buf, src, group=group)
        ctx.src, ctx.group = src, group
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.src, group=ctx.group)
        return None, None, None, None


class _Broadcast(torch.autograd.Function):
    """Forward, the last stage's ``y`` on every stage (``y`` elsewhere is
    a buffer of its shape).  Backward, every stage's gradient summed onto
    the last; the ``_Send`` ties get zeros, which start their receives."""

    @staticmethod
    def forward(ctx, y, src, group, is_src, *ties):
        out = y.clone()
        dist.broadcast(out, src, group=group)
        ctx.src, ctx.group, ctx.is_src = src, group, is_src
        ctx.n_ties = len(ties)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.reduce(g, ctx.src, group=ctx.group)
        ties = [g.new_zeros(()) for _ in range(ctx.n_ties)]
        return (g if ctx.is_src else None), None, None, None, *ties


def _stage_generators(generator: torch.Generator, stage: int,
                      n_micro: int) -> List[torch.Generator]:
    """A generator for each of this stage's microbatches, seeded by a
    stable hash of ``generator``'s state, the stage and the microbatch;
    ``generator`` then moves on by one draw, the same on every stage, so
    that a second pipeline call draws other masks."""
    base = hashlib.blake2b(generator.get_state().numpy().tobytes(),
                           digest_size=16).hexdigest()
    torch.empty(1, device=generator.device).random_(generator=generator)
    out = []
    for m in range(n_micro):
        h = hashlib.blake2b(f"{base}:{stage}:{m}".encode(), digest_size=8)
        seed = int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)
        out.append(torch.Generator(device=generator.device).manual_seed(seed))
    return out


def n_micro_of(mesh: Mesh) -> int:
    """The schedule's microbatch count: the mesh's, 0 meaning 2 S."""
    return mesh.n_micro or 2 * mesh.size(PIPE_AXIS)


def gpt_apply_pp(params: Params, cfg: GPTConfig,
                 idx: Optional[torch.Tensor],
                 cond_emb: Optional[torch.Tensor] = None, *, mesh: Mesh,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Pipeline-parallel ``gpt_apply`` (logits only; the attention maps
    stay on the sequential forward): ``params`` hold this stage's layers
    (``mesh.shard_tree``); returns the logits (B, P + T, out) on every
    stage.  At eval its numerics are ``gpt_apply``'s (the same blocks in
    the same order, on microbatches); in training the masks come from the
    stage generators, other samples of the same Bernoulli process.
    Raises where ``n_layer`` does not split over the stages or the local
    batch over the microbatches (pipeline.py:96-117 of the JAX
    package)."""
    if not mesh.has(PIPE_AXIS):
        raise ValueError("mesh has no 'pipe' axis")
    n_stages, stage = mesh.size(PIPE_AXIS), mesh.coord(PIPE_AXIS)
    if cfg.n_layer % n_stages != 0:
        raise ValueError(f"n_layer {cfg.n_layer} not divisible by "
                         f"pipe={n_stages}")
    if params["blocks"]["ln1_s"].shape[0] * n_stages != cfg.n_layer:
        raise ValueError(
            f"the blocks hold {params['blocks']['ln1_s'].shape[0]} layers, "
            f"not this stage's {cfg.n_layer // n_stages}: shard them with "
            "shard_tree")
    n_micro = n_micro_of(mesh)
    train = bool(train) and generator is not None
    x = embed_tokens(params, cfg, idx, cond_emb, train, generator)
    if x.shape[0] % n_micro != 0:
        raise ValueError(f"local batch {x.shape[0]} not divisible by "
                         f"n_micro={n_micro}")
    gens = (_stage_generators(generator, stage, n_micro) if train
            else [None] * n_micro)
    comm = mesh.active(PIPE_AXIS)
    ranks, group = mesh.ranks[PIPE_AXIS], mesh.group(PIPE_AXIS)
    last = stage == n_stages - 1
    block = (_block_remat if cfg.remat and torch.is_grad_enabled()
             else _block)
    layers = _layers(params["blocks"])
    micro = x.chunk(n_micro)
    outs, ties = [], []
    for m in range(n_micro):
        if stage == 0:
            h = micro[m]
        else:
            anchor = torch.zeros((), device=x.device,
                                 requires_grad=torch.is_grad_enabled())
            h = _Recv.apply(anchor, micro[m], ranks[stage - 1], group)
        for p in layers:
            h = block(h, p, cfg, train, gens[m])
        if last:
            outs.append(h)
        else:
            ties.append(_Send.apply(h, ranks[stage + 1], group))
    y = torch.cat(outs) if last else x.new_empty(x.shape)
    if comm:
        y = _Broadcast.apply(y, ranks[-1], group, last, *ties)
    return gpt_head(params, y)


def gpt_pp_loss_fn(params: Params, cfg: GPTConfig, x: torch.Tensor,
                   c: torch.Tensor, mesh: Mesh,
                   generator: Optional[torch.Generator] = None,
                   train: bool = False) -> torch.Tensor:
    """Pipeline-parallel twin of ``training.gpt_task.gpt_loss_fn``
    (conditioned next-token cross entropy, minGPT.py:260-285, 413-417),
    the same on every stage."""
    cond = class_embed(params, c)
    logits = gpt_apply_pp(params, cfg, x[:, :-1], cond, mesh=mesh,
                          train=train, generator=generator)
    return cross_entropy_loss(logits[:, cond.shape[1] - 1:], x)


def loss_backward(loss: torch.Tensor, mesh: Optional[Mesh]) -> None:
    """``loss.backward()``, seeded with 1/S on each of a pipe axis's S
    stages: every stage computes the replicated tail of the pipeline
    (``ln_f``, the head, the loss, the GPT-VAE's latent), so the stages'
    gradients of it sum to one copy's."""
    if mesh is not None and mesh.size(PIPE_AXIS) > 1:
        loss = loss / float(mesh.size(PIPE_AXIS))
    loss.backward()
