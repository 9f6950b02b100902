"""Class-conditional GPT training CLI of the PyTorch port.

    python -m melspec_gpt_vqvae_tpu_torch.train_gpt --dataset vas \\
        --experiment my_gpt --train 1 [--device cuda] [--override k=v,...]
    torchrun --nproc_per_node 4 -m melspec_gpt_vqvae_tpu_torch.train_gpt \\
        --dataset vas --experiment my_gpt --train 1 --mesh data=2,model=2

The counterpart of the JAX package's GPT_train.py, with its flags, preset
merge (``load_preset("GPT", dataset)`` plus ``--override``) and log and
checkpoint layout (``lightning_logs/{experiment}-{dataset}``, TensorBoard
scalars in ``TensorBoardLoggs/version_N``, checkpoints in
``checkpoints/version_N``), minus the JAX-only ``--prng`` and
``--platform`` and plus ``--device``.  The data are the
same split files and ``_mel.npy`` / ``_mel_code.npy`` trees, read by the
port's own ``data`` module.  Every ``--logging_frequency`` train and
validation batch the media callback (``GPTImageLogger``) logs the
gallery of ``GPTTask.log_samples``; with ``--reconstruct_spec`` (a
reference VQ-VAE ``.pt`` / ``.ckpt``, or a port VQ-GAN run or checkpoint
directory) its code rows are also logged as spectrograms, and with
``--vocoder`` (a reference MelGAN directory: ``best_netG.pt`` and
``args.yml``) the spectrograms as audio; a decoder that does not load
stops the run before it starts.  ``--eval 1`` and ``--test 1`` each
validate once (both: twice), as GPT_train.py does; a forward without
``use_flash_train`` runs kernel A in every layer.

Distribution: one process a GPU under ``torchrun`` (NCCL; gloo with
``--device cpu``), ``--mesh`` naming the axes over the world's ranks
(``data``: DDP; ``model``: Megatron tensor parallelism; ``pipe``: the
GPipe schedule with ``--pp_micro`` microbatches), its product the world
size; without ``--mesh`` every rank is on ``data``.  Each data rank reads
its shard of the split with the preset's batch size (the global batch is
``data`` times that), rank 0 alone logs and writes checkpoints, which hold
full leaves and restore under any mesh.  ``--gpus`` and ``--num_nodes``
are taken for the JAX CLI's command lines and change nothing: the
launcher sets the world.
"""

from __future__ import annotations

import argparse
import os


def init_config(argv=None):
    parser = argparse.ArgumentParser(
        description="GPT transformer for VQVAE_spec (PyTorch port)")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--experiment", type=str, required=True)
    parser.add_argument("--train", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None)
    # --workers and --test_interpolation are taken for GPT_train.py's
    # command lines and change nothing, as there
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--eval", type=int, default=0)
    parser.add_argument("--test", type=int, default=0)
    parser.add_argument("--logging_frequency", type=int, default=200,
                        help="media logging every N train / val batches "
                             "(0 = off)")
    parser.add_argument("--test_interpolation", type=int, default=0)
    parser.add_argument("--reconstruct_spec", type=str, default="",
                        help="frozen VQ-VAE for spectrogram decode: a "
                             "reference .pt/.ckpt or a port VQ-GAN run")
    parser.add_argument("--vocoder", type=str, default="",
                        help="frozen MelGAN dir (best_netG.pt, args.yml) "
                             "for audio decode")
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--mesh", type=str, default="",
                        help="e.g. 'data=8', 'data=4,model=2', "
                             "'data=2,pipe=4' (pipeline parallel)")
    parser.add_argument("--pp_micro", type=int, default=0,
                        help="pipeline microbatches (0 = 2*stages)")
    parser.add_argument("--gpus", nargs="+", type=int, default=[0],
                        help="accepted for parity; torchrun sets the world")
    parser.add_argument("--num_nodes", type=int, default=1,
                        help="accepted for parity; torchrun sets the world")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on, e.g. 'cuda', "
                             "'cuda:1' or 'cpu' (under torchrun, "
                             "cuda:LOCAL_RANK)")
    parser.add_argument("--limit_train_batches", type=int, default=0)
    parser.add_argument("--limit_val_batches", type=int, default=0)
    parser.add_argument("--epochs_override", type=int, default=0)
    parser.add_argument("--ckpt_every", type=int, default=1,
                        help="checkpoint every N epochs (+ final); 0 = "
                             "final only, -1 = never")
    parser.add_argument("--ckpt_every_steps", type=int, default=0,
                        help="also save 'last' every N train steps with "
                             "its mid-epoch position; resume continues at "
                             "the exact next batch (0 = off)")
    parser.add_argument("--max_steps", type=int, default=0,
                        help="stop (and checkpoint) after this many total "
                             "optimizer steps, possibly mid-epoch (0 = no "
                             "budget)")
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler trace into this dir")
    parser.add_argument("--override", type=str, default="",
                        help="comma k=v preset overrides, e.g. "
                             "'n_layer=2,n_embd=32,use_flash_train=True'")
    args = parser.parse_args(argv)
    args.seed = 783435
    return args


def load_decoders(args, exp, device):
    """The media callbacks' ``FrozenDecoders`` from ``--reconstruct_spec``
    and ``--vocoder`` (each optional; one that does not load raises),
    on ``device``."""
    from .training.callbacks import FrozenDecoders
    from .utils.convert import load_vocoder_params, load_vqvae_params
    vq = (load_vqvae_params(args.reconstruct_spec, exp.vqvae)
          if args.reconstruct_spec else None)
    vocoder = (load_vocoder_params(args.vocoder)[0] if args.vocoder
               else None)
    return FrozenDecoders(vq, vocoder, code_h=exp.vqvae.code_h,
                          code_w=exp.vqvae.code_w, device=device)


def init_mesh(args):
    """(device, mesh or None) of a run: join the launcher's process group
    first (``maybe_init_distributed``: NCCL on ``cuda:{LOCAL_RANK}``, gloo
    for ``--device cpu``), then the ``--mesh`` over its ranks; no mesh for
    a single process without ``--mesh``, every rank on ``data`` for a
    launched one without it.  A mesh that does not span the world
    raises."""
    import torch

    from .parallel import (make_mesh, maybe_init_distributed, parse_mesh,
                           process_count)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    device = maybe_init_distributed(device)
    if not args.mesh and process_count() == 1:
        return device, None
    return device, make_mesh(parse_mesh(args.mesh), device, args.pp_micro)


def main(args):
    """Run the CLI.  Returns (task, final train state or None, checkpoint
    manager) for callers that drive it from Python."""
    import numpy as np
    import torch

    from .configs import load_preset, parse_overrides
    from .data import DataModule
    from .parallel import data_coordinate, data_size, is_primary

    from .training import runner
    from .training.callbacks import GPTImageLogger
    from .training.checkpoint import CheckpointManager
    from .training.gpt_task import GPTTask
    from .training.logging import TBLogger
    from .utils.profiling import trace

    device, mesh = init_mesh(args)
    np.random.seed(args.seed)
    exp = load_preset("GPT", args.dataset, **parse_overrides(args.override))
    if args.epochs_override:
        exp.train = exp.train.__class__(
            learning_rate=exp.train.learning_rate,
            epochs=args.epochs_override, batch_size=exp.train.batch_size)
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
    task = GPTTask(exp, device, mesh)

    run_dir = os.path.join("lightning_logs",
                           f"{args.experiment}-{args.dataset}")
    log = TBLogger(run_dir)
    ckpt = CheckpointManager(os.path.join(
        run_dir, "checkpoints", f"version_{log.version}"))
    media_cb = GPTImageLogger(task, log, decoders,
                              sample_rate=exp.data.sample_rate)

    state = None
    if args.train:
        with trace(args.profile or None):
            state = runner.fit_gpt(
                task, dm, epochs=exp.train.epochs, log=log, ckpt=ckpt,
                seed=args.seed, logging_frequency=args.logging_frequency,
                media_cb=media_cb, resume=args.resume,
                limit_train_batches=args.limit_train_batches or None,
                limit_val_batches=args.limit_val_batches or None,
                ckpt_every=args.ckpt_every,
                ckpt_every_steps=args.ckpt_every_steps,
                max_steps=args.max_steps or None)
    for wanted in (args.eval, args.test):   # GPT_train.py:157-162
        if wanted == 1:
            runner.validate_gpt(
                task, dm, ckpt=ckpt, resume=args.resume,
                limit_val_batches=args.limit_val_batches or None)
    log.close()
    return task, state, ckpt


if __name__ == "__main__":
    from .parallel import shutdown_distributed
    try:
        main(init_config())
    finally:
        shutdown_distributed()
