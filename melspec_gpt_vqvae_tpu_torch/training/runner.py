"""The GPT training loop: epochs, validation, checkpoints and resume.

Counterpart of melspec_gpt_vqvae_tpu/training/runner.py:56-227 for one
device (the Lightning-Trainer role of the reference's GPT_train.py).  The
loop semantics are the JAX package's: ``limit_train_batches`` /
``limit_val_batches``, ``ckpt_every`` epochs, ``ckpt_every_steps`` and
``max_steps`` (mid-epoch ``last`` saves with their batch index), and an
exact resume, also mid-epoch.  The resume is exact because the batch
order is a pure function of (seed, epoch) (the data loader) and each
step's dropout generator a pure function of (seed, epoch, batch index)
(``step_generator``), so a resumed run draws the masks the uninterrupted
run drew.  Losses stay on the device inside an epoch; the host reads them
once at its end, and every 50 steps for the step scalar.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import torch

from .checkpoint import CheckpointManager
from .logging import TBLogger
from .optim import get_lr


def step_generator(seed: int, epoch: int, gi: int,
                   device: torch.device) -> torch.Generator:
    """The dropout generator of batch ``gi`` of ``epoch``, seeded by a
    stable 63-bit hash of (seed, epoch, gi) -- the counterpart of the JAX
    loop's ``fold_in(fold_in(key(seed), epoch), gi)``."""
    h = hashlib.blake2b(f"{seed}:{epoch}:{gi}".encode(), digest_size=8)
    s = int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(s)


def _live_lr(state) -> float:
    """The optimizer's actual learning rate (what the reference's
    LearningRateMonitor logs, GPT_train.py:92)."""
    return get_lr(state["optimizer"])


def _resume_position(ckpt: CheckpointManager, restored_epoch: int):
    """(start_epoch, start_batch) of a restored checkpoint: an end-of-epoch
    save resumes at the next epoch's first batch, a mid-epoch one inside
    the same epoch at the first unconsumed batch."""
    b = ckpt.restored_batch_idx
    if b >= 0:
        return restored_epoch, b + 1
    return restored_epoch + 1, 0


def _should_save(epoch: int, epochs: int, ckpt_every: int) -> bool:
    """Save every ``ckpt_every``-th epoch and the final one; 0 = only the
    final one; -1 = never."""
    if ckpt_every < 0:
        return False
    if epoch == epochs - 1:
        return True
    return ckpt_every > 0 and (epoch + 1) % ckpt_every == 0


def _restore(task, ckpt: CheckpointManager, resume: str):
    """(train state, epoch) of checkpoint ``resume``.  The checkpoint is
    held to the task's geometry through a template of shapes alone
    (``state_template``), so a resume keeps one train state on the device,
    never a fresh one beside the restored one."""
    restored = ckpt.restore(resume, template={
        "state": task.state_template(), "epoch": 0})
    return task.load_state(restored["state"]), int(restored["epoch"])


def _val_loss(task, state, loader, limit: Optional[int]) -> float:
    """Batch-size-weighted mean validation loss."""
    total, count = 0.0, 0
    for i, batch in enumerate(loader):
        if limit and i >= limit:
            break
        b = len(batch["target"])
        total += float(task.eval_step(state, batch)) * b
        count += b
    return total / count if count else float("nan")


def fit_gpt(task, dm, *, epochs: int, log: TBLogger,
            ckpt: CheckpointManager, seed: int = 783435,
            resume: Optional[str] = None,
            limit_train_batches: Optional[int] = None,
            limit_val_batches: Optional[int] = None,
            ckpt_every: int = 1, ckpt_every_steps: int = 0,
            max_steps: Optional[int] = None):
    """Train the class-conditional GPT; returns the final train state.

    ``ckpt_every_steps=N`` also saves ``last`` every N optimizer steps with
    its mid-epoch position; ``max_steps`` stops (and saves) after that many
    steps, possibly mid-epoch.  A resumed partial epoch's printed train
    loss averages only its remaining batches."""
    if resume:
        state, epoch0 = _restore(task, ckpt, resume)
        start_epoch, start_batch = _resume_position(ckpt, epoch0)
        print(f"Restored from {resume} at epoch {start_epoch}" +
              (f" batch {start_batch}" if start_batch else ""))
    else:
        state = task.init_state(seed)
        start_epoch, start_batch = 0, 0

    train_loader = dm.train_dataloader()
    val_loader = dm.val_dataloader()
    timer = task.perf_timer(state["params"])
    step = state["step"]

    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        off = start_batch if epoch == start_epoch else 0
        if off or train_loader.start_batch:
            train_loader.set_start_batch(off)
        t0 = time.time()
        losses = []
        for i, batch in enumerate(train_loader):
            gi = i + off
            if limit_train_batches and gi >= limit_train_batches:
                break
            gen = step_generator(seed, epoch, gi, task.device)
            state, loss = task.train_step(state, batch, gen)
            losses.append(loss)
            step += 1
            perf = timer.tick(len(batch["target"]))
            if perf:
                log.scalars(perf, step)
            if gi % 50 == 0:
                log.scalar("train/loss_step", loss, step)
                log.scalar("learning_rate", _live_lr(state), step)
            hit_budget = max_steps is not None and step >= max_steps
            if hit_budget or (ckpt_every_steps and
                              step % ckpt_every_steps == 0):
                # mid-epoch: no val metric, so only `last` is written
                ckpt.save({"state": task.state_tree(state), "epoch": epoch},
                          step, batch_idx=gi)
            if hit_budget:
                print(f"max_steps {max_steps} reached at epoch {epoch} "
                      f"batch {gi}; stopping")
                ckpt.wait()
                return state

        train_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        val_loss = _val_loss(task, state, val_loader, limit_val_batches)
        log.scalar("train/loss_epoch", train_loss, step)
        log.scalar("val/loss", val_loss, step)
        print(f"epoch {epoch}: train/loss {train_loss:.4f} "
              f"val/loss {val_loss:.4f} ({time.time() - t0:.1f}s)")
        if _should_save(epoch, epochs, ckpt_every):
            ckpt.save({"state": task.state_tree(state), "epoch": epoch},
                      step, metric=val_loss)
    ckpt.wait()
    return state


def validate_gpt(task, dm, *, ckpt: CheckpointManager,
                 resume: Optional[str] = None,
                 limit_val_batches: Optional[int] = None) -> float:
    """Mean validation loss of a fresh or restored state."""
    state = (_restore(task, ckpt, resume)[0] if resume
             else task.init_state())
    val = _val_loss(task, state, dm.val_dataloader(), limit_val_batches)
    print(f"val/loss {val:.4f}")
    return val
