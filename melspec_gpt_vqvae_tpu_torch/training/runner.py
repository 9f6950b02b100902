"""The training loops: epochs, validation, checkpoints and resume.

Counterpart of melspec_gpt_vqvae_tpu/training/runner.py:56-428 for one
device (the Lightning-Trainer role of the reference's GPT_train.py and
GPT_VAE_train.py): ``fit_gpt`` / ``validate_gpt`` for the class GPT,
``fit_vae`` / ``evaluate_vae`` for the GPT-VAE.  The
loop semantics are the JAX package's: ``limit_train_batches`` /
``limit_val_batches``, ``ckpt_every`` epochs, ``ckpt_every_steps`` and
``max_steps`` (mid-epoch ``last`` saves with their batch index), and an
exact resume, also mid-epoch.  The resume is exact because the batch
order is a pure function of (seed, epoch) (the data loader) and each
step's dropout generator a pure function of (seed, epoch, batch index)
(``step_generator``), so a resumed run draws the masks the uninterrupted
run drew.  Losses stay on the device inside an epoch; the host reads them
once at its end, and every 50 steps for the step scalar.

Under a task's mesh (parallel/mesh.py) every rank runs the loop on its
data shard: the dropout generators fold in the data coordinate, the
validation sums are summed over the data group before the means, NLL,
PPL and the best-checkpoint decision (``cross_process_sum``, the
reference's ``sync_dist``; runner.py:50-53, 327, 417 of the JAX package),
checkpoints are gathered to rank 0 and written there, and only rank 0
logs and prints.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..parallel.mesh import data_coordinate, is_primary
from ..parallel.reduce import cross_process_sum
from .checkpoint import CheckpointManager
from .logging import TBLogger
from .optim import get_lr, with_lr


def step_generator(seed: int, epoch: int, gi: int,
                   device: torch.device, data_rank: int = 0
                   ) -> torch.Generator:
    """The dropout generator of batch ``gi`` of ``epoch``, seeded by a
    stable 63-bit hash of (seed, epoch, gi) -- the counterpart of the JAX
    loop's ``fold_in(fold_in(key(seed), epoch), gi)``.  A data rank other
    than 0 folds its coordinate in, so that each shard of a step's batch
    draws its own masks (JAX draws them over the global array); the ranks
    of one model or pipe group share it."""
    key = f"{seed}:{epoch}:{gi}" + (f":{data_rank}" if data_rank else "")
    h = hashlib.blake2b(key.encode(), digest_size=8)
    s = int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(s)


def _mesh(task):
    return getattr(task, "mesh", None)


def _gen(task, seed: int, epoch: int, gi: int) -> torch.Generator:
    return step_generator(seed, epoch, gi, task.device,
                          data_coordinate(_mesh(task)))


def _print(*args):
    if is_primary():
        print(*args)


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


def _restore_tree(task, ckpt: CheckpointManager, resume: str):
    """(train state, the whole restored checkpoint) of ``resume``.  The
    checkpoint is held to the task's geometry through a template of shapes
    alone (``state_template``), so a resume keeps one train state on the
    device, never a fresh one beside the restored one."""
    restored = ckpt.restore(resume, template={
        "state": task.state_template(), "epoch": 0})
    return task.load_state(restored.pop("state")), restored


def _restore(task, ckpt: CheckpointManager, resume: str):
    """(train state, epoch) of checkpoint ``resume`` (``_restore_tree``)."""
    state, restored = _restore_tree(task, ckpt, resume)
    return state, int(restored["epoch"])


def _val_loss(task, state, loader, limit: Optional[int],
              on_batch: Optional[Callable] = None) -> float:
    """Batch-size-weighted mean validation loss over every data shard;
    ``on_batch(i, batch)`` runs after batch i's loss."""
    total, count = 0.0, 0
    for i, batch in enumerate(loader):
        if limit and i >= limit:
            break
        b = len(batch["target"])
        total += float(task.eval_step(state, batch)) * b
        count += b
        if on_batch is not None:
            on_batch(i, batch)
    r = cross_process_sum({"sum": total, "count": float(count)}, _mesh(task))
    return r["sum"] / r["count"] if r["count"] else float("nan")


def fit_gpt(task, dm, *, epochs: int, log: TBLogger,
            ckpt: CheckpointManager, seed: int = 783435,
            logging_frequency: int = 200,
            media_cb: Optional[Callable] = None,
            resume: Optional[str] = None,
            limit_train_batches: Optional[int] = None,
            limit_val_batches: Optional[int] = None,
            ckpt_every: int = 1, ckpt_every_steps: int = 0,
            max_steps: Optional[int] = None):
    """Train the class-conditional GPT; returns the final train state.

    ``media_cb(state, batch, step, split)`` runs after train batch ``gi``
    and validation batch ``i`` whenever the index is a multiple of
    ``logging_frequency`` (0: never), as the JAX loop calls it
    (runner.py:156-158, 190-192 there), outside the step timer's window.
    ``ckpt_every_steps=N`` also saves ``last`` every N optimizer steps with
    its mid-epoch position; ``max_steps`` stops (and saves) after that many
    steps, possibly mid-epoch.  A resumed partial epoch's printed train
    loss averages only its remaining batches."""
    if resume:
        state, epoch0 = _restore(task, ckpt, resume)
        start_epoch, start_batch = _resume_position(ckpt, epoch0)
        _print(f"Restored from {resume} at epoch {start_epoch}" +
              (f" batch {start_batch}" if start_batch else ""))
    else:
        state = task.init_state(seed)
        start_epoch, start_batch = 0, 0

    train_loader = dm.train_dataloader()
    val_loader = dm.val_dataloader()
    timer = task.perf_timer(state["params"])
    step = state["step"]

    def val_media(i, batch):
        if media_cb and logging_frequency and i % logging_frequency == 0:
            media_cb(state, batch, step, "val")

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
            gen = _gen(task, seed, epoch, gi)
            state, loss = task.train_step(state, batch, gen)
            losses.append(loss)
            step += 1
            perf = timer.tick(len(batch["target"]))
            if perf:
                log.scalars(perf, step)
            if gi % 50 == 0:
                log.scalar("train/loss_step", loss, step)
                log.scalar("learning_rate", _live_lr(state), step)
            if media_cb and logging_frequency and gi % logging_frequency == 0:
                with timer.paused(task.device):
                    media_cb(state, batch, step, "train")
            hit_budget = max_steps is not None and step >= max_steps
            if hit_budget or (ckpt_every_steps and
                              step % ckpt_every_steps == 0):
                # mid-epoch: no val metric, so only `last` is written
                ckpt.save({"state": task.state_tree(state), "epoch": epoch},
                          step, batch_idx=gi)
            if hit_budget:
                _print(f"max_steps {max_steps} reached at epoch {epoch} "
                      f"batch {gi}; stopping")
                ckpt.wait()
                return state

        train_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        val_loss = _val_loss(task, state, val_loader, limit_val_batches,
                             val_media)
        log.scalar("train/loss_epoch", train_loss, step)
        log.scalar("val/loss", val_loss, step)
        _print(f"epoch {epoch}: train/loss {train_loss:.4f} "
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
    _print(f"val/loss {val:.4f}")
    return val


def fit_vae(task, dm, *, epochs: int, log: TBLogger,
            ckpt: CheckpointManager, seed: int = 783435,
            logging_frequency: int = 500,
            media_cb: Optional[Callable] = None,
            epoch_end_cb: Optional[Callable] = None,
            resume: Optional[str] = None,
            limit_train_batches: Optional[int] = None,
            limit_val_batches: Optional[int] = None,
            ckpt_every: int = 1, ckpt_every_steps: int = 0,
            max_steps: Optional[int] = None):
    """Train the GPT-VAE; returns the final train state (runner.py:230-386
    of the JAX package).  As ``fit_gpt``, plus: ``kl_weight`` rides in the
    state and the checkpoint carries ``extras`` (``best_loss``, ``pre_mi``,
    ``not_improved``); a validation epoch's sums give NLL and PPL under a
    generator pinned to (seed + 1, epoch, batch); an epoch not better than
    ``best_loss - lr_decay_min_delta`` counts as stale, and with
    ``train.lr_decay`` the learning rate is multiplied by it after
    ``lr_decay_patience`` stale epochs from ``lr_decay_start`` on;
    ``media_cb(state, batch, step, "train")`` runs every
    ``logging_frequency`` batches and ``epoch_end_cb(state, epoch, agg,
    extras, tokens=)`` after each validation with its token arrays."""
    extras: Dict[str, Any] = {"best_loss": 1e4, "pre_mi": 0.0,
                              "not_improved": 0}
    if resume:
        state, restored = _restore_tree(task, ckpt, resume)
        extras = dict(restored.get("extras", extras))
        start_epoch, start_batch = _resume_position(ckpt,
                                                    int(restored["epoch"]))
        _print(f"Restored from {resume} at epoch {start_epoch}" +
              (f" batch {start_batch}" if start_batch else ""))
    else:
        state = task.init_state(seed)
        start_epoch, start_batch = 0, 0

    train_loader = dm.train_dataloader()
    val_loader = dm.val_dataloader()
    timer = task.perf_timer(state["params"])
    step = state["step"]
    tr = task.exp.train

    def save(epoch, **kw):
        ckpt.save({"state": task.state_tree(state), "epoch": epoch,
                   "extras": dict(extras)}, step, **kw)

    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        off = start_batch if epoch == start_epoch else 0
        if off or train_loader.start_batch:
            train_loader.set_start_batch(off)
        t0 = time.time()
        for i, batch in enumerate(train_loader):
            gi = i + off
            if limit_train_batches and gi >= limit_train_batches:
                break
            gen = _gen(task, seed, epoch, gi)
            state, _, report = task.train_step(state, batch, gen, epoch=epoch)
            step += 1
            perf = timer.tick(len(batch["codes"]))
            if perf:
                log.scalars(perf, step)
            if gi % 50 == 0:
                log.scalars(report, step)
            if media_cb and logging_frequency and gi % logging_frequency == 0:
                with timer.paused(task.device):
                    media_cb(state, batch, step, "train")
            hit_budget = max_steps is not None and step >= max_steps
            if hit_budget or (ckpt_every_steps and
                              step % ckpt_every_steps == 0):
                save(epoch, batch_idx=gi)
            if hit_budget:
                _print(f"max_steps {max_steps} reached at epoch {epoch} "
                      f"batch {gi}; stopping")
                ckpt.wait()
                return state

        outputs, val_tokens = [], []
        for i, batch in enumerate(val_loader):
            if limit_val_batches and i >= limit_val_batches:
                break
            outputs.append(task.eval_step(
                state, batch, _gen(task, seed + 1, epoch, i)))
            if epoch_end_cb:
                val_tokens.append(task.batch_tokens(batch))
        # every rank joins the sum, an empty shard too
        sums = cross_process_sum(task.sum_outputs(outputs), _mesh(task))
        agg = task.metrics_from_sums(sums) if sums["num_sents"] else {}
        for k, v in agg.items():
            log.scalar(f"val/{k}", v, step)
        _print(f"epoch {epoch}: " +
              " ".join(f"val/{k} {v:.4f}" for k, v in agg.items()) +
              f" kl_w {float(state['kl_weight']):.4f}"
              f" ({time.time() - t0:.1f}s)")
        if agg:
            # the reference's callbeck_of_my_dreams bookkeeping
            # (GPT_VAE_callbacks.py:449-515) and its plateau decay
            if agg["loss"] > extras["best_loss"] - tr.lr_decay_min_delta:
                extras["not_improved"] = extras.get("not_improved", 0) + 1
                if (tr.lr_decay and extras["not_improved"]
                        >= tr.lr_decay_patience
                        and epoch >= tr.lr_decay_start):
                    new_lr = _live_lr(state) * tr.lr_decay
                    with_lr(state["optimizer"], new_lr)
                    extras["not_improved"] = 0
                    _print(f"epoch {epoch}: val loss plateaued "
                          f"{tr.lr_decay_patience} epochs -> lr "
                          f"{new_lr:.3e}")
            else:
                extras["not_improved"] = 0
                extras["best_loss"] = agg["loss"]
            log.scalar("learning_rate", _live_lr(state), step)
        if _should_save(epoch, epochs, ckpt_every):
            save(epoch, metric=agg.get("loss"))
        if epoch_end_cb:
            epoch_end_cb(state, epoch, agg, extras, tokens=val_tokens or None)
    ckpt.wait()
    return state


def evaluate_vae(task, dm, *, split: str = "val",
                 ckpt: Optional[CheckpointManager] = None,
                 resume: Optional[str] = None, compute_mi_au: bool = False,
                 iw_nsamples: int = 0,
                 limit_batches: Optional[int] = None) -> Dict[str, float]:
    """Loss, NLL, KL, reconstruction and PPL of a restored (or fresh)
    state over one loader pass, plus the corpus MI and AU and the IW NLL
    and PPL over the same batches' tokens (Lit_GPT_VAE.py:571-607,
    utils.py:50-77); the noise from one generator seeded 0."""
    state = (_restore_tree(task, ckpt, resume)[0] if resume and ckpt
             else task.init_state())
    loader = dm.test_dataloader() if split == "test" else dm.val_dataloader()
    gen = torch.Generator(device=task.device).manual_seed(
        data_coordinate(_mesh(task)))
    outputs, tokens = [], []
    for i, batch in enumerate(loader):
        if limit_batches and i >= limit_batches:
            break
        outputs.append(task.eval_step(state, batch, gen))
        if compute_mi_au or iw_nsamples > 0:
            tokens.append(task.batch_tokens(batch))
    agg = task.metrics_from_sums(cross_process_sum(
        task.sum_outputs(outputs), _mesh(task)))
    if compute_mi_au:
        mi, au, _ = task.calc_mi_au(state, tokens)
        agg["mutual_info"] = mi
        agg["active_units"] = au
    if iw_nsamples > 0:
        agg["iw_nll"], agg["iw_ppl"] = task.calc_iwnll(state, tokens,
                                                       nsamples=iw_nsamples)
    _print(f"{split}: " + " ".join(f"{k} {v:.4f}" for k, v in agg.items()))
    return agg
