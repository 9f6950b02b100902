"""GPT-VAE training CLI of the PyTorch port.

    python -m melspec_gpt_vqvae_tpu_torch.train_gpt_vae --dataset vas \\
        --experiment my_vae --train 1 [--device cuda] [--override k=v,...]
    torchrun --nproc_per_node 4 -m melspec_gpt_vqvae_tpu_torch.train_gpt_vae \\
        --dataset vas --experiment my_vae --train 1 --mesh data=2,pipe=2

The counterpart of the JAX package's GPT_VAE_train.py, with its flags,
preset merge (``load_preset("GPT_VAE", dataset)``, ``--override``, the VAE
knobs from the flags) and run layout (``lightning_logs/{experiment}-
{dataset}``: TensorBoard scalars and token text in
``TensorBoardLoggs/version_N``, checkpoints in ``checkpoints/version_N``),
plus ``--device`` (the card unless the caller names the CPU).  ``--train``,
``--eval 1`` (with MI and AU), ``--test 1`` (adding the IW-NLL over
``--iw_nsamples``), the stage-2 ``--load_path``, ``--reconstruct_from`` /
``--decoding_strategy``, ``--save_latent`` and ``--test_interpolation``
are ported, and so is the media logging: every ``--logging_frequency``
train batch ``VAETextLogger`` logs an original and its reconstructions as
token text and, through ``--reconstruct_spec`` (a reference VQ-VAE file or
a port VQ-GAN run) and ``--vocoder`` (a reference MelGAN directory), as
spectrograms and audio.  ``--model lstm`` trains, evaluates and tests the
legacy LSTM-VAE (``run_lstm``: the ``VAE_{dataset}`` preset with
``--override``, ``LSTMTextLogger``).  ``--mesh`` / ``--pp_micro``
distribute the run as ``train_gpt``'s do (``train_gpt.init_mesh``: one
process a GPU under ``torchrun``; data, model and pipe axes for the
GPT-VAE, a data axis only for the LSTM-VAE, as in the JAX package); the
reconstruction, latent and interpolation tools then run on rank 0 on the
gathered parameters.  The JAX-only ``--prng`` and ``--platform`` are not
taken; ``--gpus``, ``--num_nodes`` and ``--workers`` are taken and change
nothing, as there (the launcher sets the world).
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def init_config(argv=None):
    parser = argparse.ArgumentParser(description="GPT-VAE (PyTorch port)")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--experiment", type=str, required=True)
    parser.add_argument("--model", type=str, choices=["gpt", "lstm"],
                        default="gpt")
    parser.add_argument("--gpus", nargs="+", type=int, default=[0])
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--opt", type=str,
                        choices=["sgd", "adam", "adamw", "adafactor"],
                        default=None, help="default: the preset's (adamw)")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr_decay", type=float, default=0.0,
                        help="val-plateau LR decay factor (0 = off)")
    parser.add_argument("--lr_decay_patience", type=int, default=5)
    parser.add_argument("--lr_decay_start", type=int, default=15)
    parser.add_argument("--nsamples", type=int, default=1)
    parser.add_argument("--iw_train_nsamples", type=int, default=-1)
    parser.add_argument("--iw_train_ns", type=int, default=1)
    parser.add_argument("--iw_nsamples", type=int, default=500)
    parser.add_argument("--train", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--eval", type=int, default=0)
    parser.add_argument("--test", type=int, default=0)
    parser.add_argument("--logging_frequency", type=int, default=500)
    parser.add_argument("--load_path", type=str, default="",
                        help="stage 2: the encoder from this checkpoint "
                             "(a .pt file or a checkpoint directory)")
    parser.add_argument("--test_interpolation", type=int, default=0)
    parser.add_argument("--reconstruct_from", type=str, default="")
    parser.add_argument("--reconstruct_to", type=str, default="decoding.txt")
    parser.add_argument("--decoding_strategy", type=str,
                        choices=["greedy", "beam", "sample"],
                        default="greedy")
    parser.add_argument("--reconstruct_spec", type=str, default="",
                        help="frozen VQ-VAE for spectrogram decode: a "
                             "reference .pt/.ckpt or a port VQ-GAN run")
    parser.add_argument("--vocoder", type=str, default="",
                        help="frozen MelGAN dir (best_netG.pt, args.yml) "
                             "for audio decode")
    parser.add_argument("--warm_up", type=int, default=10)
    parser.add_argument("--kl_start", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=783435)
    parser.add_argument("--save_latent", type=int, default=0)
    parser.add_argument("--fix_var", type=float, default=-1)
    parser.add_argument("--freeze_epoch", type=int, default=-1)
    parser.add_argument("--beta", type=float, default=1.0,
                        help="0 => plain AE")
    parser.add_argument("--fb", type=int, default=0,
                        help="free bits mode 0/1/2/3")
    parser.add_argument("--target_kl", type=float, default=-1)
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    parser.add_argument("--mesh", type=str, default="",
                        help="e.g. 'data=8', 'data=4,model=2', "
                             "'data=2,pipe=4' (pipeline parallel)")
    parser.add_argument("--pp_micro", type=int, default=0,
                        help="pipeline microbatches (0 = 2*stages)")
    parser.add_argument("--limit_train_batches", type=int, default=0)
    parser.add_argument("--limit_val_batches", type=int, default=0)
    parser.add_argument("--epochs_override", type=int, default=0)
    parser.add_argument("--ckpt_every", type=int, default=1,
                        help="checkpoint every N epochs (+ final); 0 = "
                             "final only, -1 = never")
    parser.add_argument("--ckpt_every_steps", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=0)
    parser.add_argument("--param_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler trace into this dir")
    parser.add_argument("--override", type=str, default="",
                        help="comma k=v preset overrides, e.g. "
                             "'n_layer=2,n_embd=32,batch_size=4'")
    return parser.parse_args(argv)


def _train_flags(exp, args):
    """``exp.train`` with the epochs, optimiser and learning-rate flags
    merged in, as GPT_VAE_train.py merges them."""
    tr = exp.train
    if args.epochs_override:
        tr = dataclasses.replace(tr, epochs=args.epochs_override)
    if args.opt is not None:
        tr = dataclasses.replace(tr, optimizer=args.opt,
                                 momentum=args.momentum)
    if args.lr is not None:
        tr = dataclasses.replace(tr, learning_rate=args.lr)
    if args.lr_decay:
        tr = dataclasses.replace(tr, lr_decay=args.lr_decay,
                                 lr_decay_patience=args.lr_decay_patience,
                                 lr_decay_start=args.lr_decay_start)
    return tr


def build_experiment(args):
    """The preset with ``--override``, the VAE knobs and the optimiser
    flags merged in, as GPT_VAE_train.py merges them."""
    from .configs import VAEConfig, load_preset, parse_overrides
    exp = load_preset("GPT_VAE", args.dataset,
                      **parse_overrides(args.override))
    exp.vae = VAEConfig(
        nz=exp.model.n_embd, nsamples=args.nsamples,
        iw_train_nsamples=args.iw_train_nsamples,
        iw_train_ns=args.iw_train_ns, iw_nsamples=args.iw_nsamples,
        warm_up=args.warm_up, kl_start=args.kl_start, beta=args.beta,
        fb=args.fb, target_kl=args.target_kl, fix_var=args.fix_var,
        freeze_epoch=args.freeze_epoch, save_latent=args.save_latent)
    exp.train = _train_flags(exp, args)
    if args.param_dtype != "float32":
        exp.model = exp.model.replace(dtype=args.param_dtype)
    return exp


def main(args):
    """Run the CLI.  Returns (task, the trained state or None, the
    checkpoint manager, {"eval": metrics, "test": metrics} of the passes
    that ran) for callers that drive it from Python."""
    import numpy as np
    import torch

    from .data import DataModule
    from .training import runner
    from .training.callbacks import VAETextLogger, metrics_epoch_end
    from .training.checkpoint import (CheckpointManager, load_tree,
                                      merge_subtree)
    from .training.logging import TBLogger
    from .training.vae_task import VAETask
    from .parallel import data_coordinate, data_size, is_primary
    from .train_gpt import init_mesh, load_decoders
    from .utils import vae_tools
    from .utils.profiling import trace

    device, mesh = init_mesh(args)
    np.random.seed(args.seed)
    if args.model == "lstm":
        return run_lstm(args, device, mesh)
    exp = build_experiment(args)
    if is_primary():
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else "")
              + (f", {mesh}" if mesh is not None else ""))
    decoders = load_decoders(args, exp, device)

    dm = DataModule(batch_size=exp.train.batch_size,
                    spec_dir_path=exp.data.spec_dir_path,
                    data_root=args.data_root,
                    process_index=data_coordinate(mesh),
                    process_count=data_size(mesh))
    dm.setup()
    task = VAETask(exp, len(dm.train_dataloader()), device, mesh)

    run_dir = os.path.join("lightning_logs",
                           f"{args.experiment}-{args.dataset}")
    log = TBLogger(run_dir)
    ckpt = CheckpointManager(os.path.join(
        run_dir, "checkpoints", f"version_{log.version}"))
    media_cb = VAETextLogger(task, log, decoders,
                             sample_rate=exp.data.sample_rate)
    epoch_cb = metrics_epoch_end(task, dm, log,
                                 limit_batches=args.limit_val_batches or None)
    limit_val = args.limit_val_batches or None

    state, metrics = None, {}
    if args.train:
        with trace(args.profile or None):
            if args.load_path and args.resume is None:
                # stage 2 (GPT_VAE_train.py:133-144): the encoder from
                # another run, saved as this run's resumable `last`
                loaded = load_tree(os.path.abspath(args.load_path))
                loaded = loaded.get("state", loaded).get("params", loaded)
                fresh = task.init_state(args.seed)
                tree = task.state_tree(fresh)   # None off rank 0
                if tree is not None:
                    tree["params"] = merge_subtree(tree["params"], loaded,
                                                   "encoder")
                ckpt.save({"state": tree, "epoch": -1,
                           "extras": {"best_loss": 1e4, "pre_mi": 0.0,
                                      "not_improved": 0}}, 0)
                ckpt.wait()
                del fresh, tree
                if is_primary():
                    print(f"loaded encoder from: {args.load_path}")
                args.resume = "last"
            state = runner.fit_vae(
                task, dm, epochs=exp.train.epochs, log=log, ckpt=ckpt,
                seed=args.seed, logging_frequency=args.logging_frequency,
                media_cb=media_cb, epoch_end_cb=epoch_cb, resume=args.resume,
                limit_train_batches=args.limit_train_batches or None,
                limit_val_batches=limit_val, ckpt_every=args.ckpt_every,
                ckpt_every_steps=args.ckpt_every_steps,
                max_steps=args.max_steps or None)
    if args.eval == 1:
        metrics["eval"] = runner.evaluate_vae(
            task, dm, split="val", ckpt=ckpt, resume=args.resume,
            compute_mi_au=True, limit_batches=limit_val)
    if args.test == 1:
        metrics["test"] = runner.evaluate_vae(
            task, dm,
            split="test" if "vggsound" in exp.data.spec_dir_path else "val",
            ckpt=ckpt, resume=args.resume, compute_mi_au=True,
            iw_nsamples=args.iw_nsamples, limit_batches=limit_val)

    def limited_val():
        for i, b in enumerate(dm.val_dataloader()):
            if limit_val and i >= limit_val:
                break
            yield b

    def restored_full(which):
        # the tools run on rank 0, on one device, on the full parameters
        return task.media_state(runner._restore(task, ckpt, which)[0])

    if args.reconstruct_from:
        restored = restored_full(args.reconstruct_from)
        if is_primary():
            vae_tools.reconstruct(task, restored, limited_val(),
                                  args.decoding_strategy,
                                  args.reconstruct_to)
            print(f"reconstructions ({args.decoding_strategy}) -> "
                  f"{args.reconstruct_to}")
    if args.save_latent:
        restored = restored_full(args.resume or "last")
        if is_primary():
            fname = os.path.join(run_dir, "latent.txt")
            vae_tools.visualize_latent(task, restored, limited_val(), fname)
            print(f"latents -> {fname}")
    if args.test_interpolation:
        # the logger gathers the parameters itself
        restored, _ = runner._restore(task, ckpt, args.resume or "last")
        media_cb.log_interpolation(restored, next(iter(dm.val_dataloader())),
                                   int(restored["step"]))
        if is_primary():
            print("interpolation logged")
    log.close()
    return task, state, ckpt, metrics


def run_lstm(args, device, mesh=None):
    """``--model lstm``: the legacy LSTM-VAE (GPT_VAE_train.py:322-399):
    the ``VAE_{dataset}`` preset with ``--override``, its ``VAEConfig``
    from the flags, ``fit_vae`` with ``LSTMTextLogger`` and the epoch-end
    MI / AU, then ``--eval 1`` / ``--test 1`` through ``evaluate_vae``
    (both on the validation split, as there).  Returns what ``main``
    returns."""
    import torch

    from .configs import VAEConfig, load_lstm_preset, parse_overrides
    from .data import DataModule
    from .training import runner
    from .training.callbacks import LSTMTextLogger, metrics_epoch_end
    from .training.checkpoint import CheckpointManager
    from .training.logging import TBLogger
    from .training.lstm_task import LSTMVAETask
    from .parallel import data_coordinate, data_size, is_primary

    exp, cfg = load_lstm_preset(args.dataset,
                                **parse_overrides(args.override))
    exp.vae = VAEConfig(
        nz=cfg.nz, nsamples=args.nsamples,
        iw_train_nsamples=args.iw_train_nsamples,
        iw_train_ns=args.iw_train_ns, iw_nsamples=args.iw_nsamples,
        warm_up=args.warm_up, kl_start=args.kl_start, beta=args.beta,
        fb=args.fb, target_kl=args.target_kl, fix_var=args.fix_var)
    if args.fix_var > 0:
        cfg = cfg._replace(fix_var=args.fix_var)
    exp.train = _train_flags(exp, args)
    if is_primary():
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else "")
              + (f", {mesh}" if mesh is not None else ""))

    dm = DataModule(batch_size=exp.train.batch_size,
                    spec_dir_path=exp.data.spec_dir_path,
                    data_root=args.data_root,
                    process_index=data_coordinate(mesh),
                    process_count=data_size(mesh))
    dm.setup()
    task = LSTMVAETask(exp, cfg, len(dm.train_dataloader()), device, mesh)
    run_dir = os.path.join("lightning_logs",
                           f"{args.experiment}-{args.dataset}")
    log = TBLogger(run_dir)
    ckpt = CheckpointManager(os.path.join(
        run_dir, "checkpoints", f"version_{log.version}"))
    limit_val = args.limit_val_batches or None
    state, metrics = None, {}
    if args.train:
        state = runner.fit_vae(
            task, dm, epochs=exp.train.epochs, log=log, ckpt=ckpt,
            seed=args.seed, logging_frequency=args.logging_frequency,
            media_cb=LSTMTextLogger(task, log),
            epoch_end_cb=metrics_epoch_end(task, dm, log,
                                           limit_batches=limit_val),
            resume=args.resume,
            limit_train_batches=args.limit_train_batches or None,
            limit_val_batches=limit_val, ckpt_every=args.ckpt_every,
            ckpt_every_steps=args.ckpt_every_steps,
            max_steps=args.max_steps or None)
    if args.eval == 1:
        metrics["eval"] = runner.evaluate_vae(
            task, dm, split="val", ckpt=ckpt, resume=args.resume,
            compute_mi_au=True, limit_batches=limit_val)
    if args.test == 1:
        metrics["test"] = runner.evaluate_vae(
            task, dm, split="val", ckpt=ckpt, resume=args.resume,
            compute_mi_au=True, iw_nsamples=args.iw_nsamples,
            limit_batches=limit_val)
    log.close()
    return task, state, ckpt, metrics


if __name__ == "__main__":
    from .parallel import shutdown_distributed
    try:
        main(init_config())
    finally:
        shutdown_distributed()
