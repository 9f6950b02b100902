"""VQ-VAE(+GAN) first-stage training CLI of the PyTorch port.

    python -m melspec_gpt_vqvae_tpu_torch.train_vqvae --dataset vas \\
        --experiment my_vq --train 1 [--device cuda] [--override k=v,...]

The counterpart of the JAX package's VQVAE_train.py, with its flags minus
``--platform`` and plus ``--device``: the codebook default (128 codes for
vas, 1024 for vggsound), ``VQVAEConfig`` overrides through
``parse_overrides``, the ``GPT_VAE`` preset's ``spec_dir_path``, the run
directory ``lightning_logs/{experiment}-{dataset}`` (TensorBoard events in
``TensorBoardLoggs/version_N``, checkpoints in ``checkpoints/version_N``),
``--resume``, and per epoch the validation means, the code-usage histogram
and ``val/zero_hit_codes``, the input and reconstruction spectrograms of
the last validation batch, the epoch line and a checkpoint; ``--eval 1``
validates once more and prints the means.  Train logs go out every 50
batches, as there.
"""

from __future__ import annotations

import argparse
import os


def init_config(argv=None):
    parser = argparse.ArgumentParser(description="VQ-VAE GAN (PyTorch port)")
    parser.add_argument("--dataset", type=str, required=True,
                        help="vas | vggsound")
    parser.add_argument("--experiment", type=str, required=True)
    parser.add_argument("--train", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--eval", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--num_embeddings", type=int, default=None,
                        help="defaults: 128 (vas) / 1024 (vggsound)")
    parser.add_argument("--disc_start", type=int, default=2001)
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--limit_train_batches", type=int, default=0)
    parser.add_argument("--limit_val_batches", type=int, default=0)
    parser.add_argument("--seed", type=int, default=783435)
    parser.add_argument("--override", type=str, default="",
                        help="comma k=v VQVAEConfig overrides, e.g. "
                             "'ch=16,num_res_blocks=1,resolution=64'")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on, e.g. 'cuda', "
                             "'cuda:1' or 'cpu'")
    return parser.parse_args(argv)


def _limited(loader, limit):
    for i, batch in enumerate(loader):
        if limit and i >= limit:
            break
        yield batch


def validate(task, state, loader, limit, n_e):
    """Means of the eval logs over the validation batches, the code-usage
    counts (int64 (n_e,)), and the last batch with its reconstruction
    (None without batches)."""
    import numpy as np

    from .models.vqvae import codebook_usage_counts
    counts = np.zeros(n_e, np.int64)
    vals, last = [], None
    for batch in _limited(loader, limit):
        logs, recon, idx = task.eval_step(state, batch)
        vals.append(logs)
        counts += codebook_usage_counts(idx, n_e).cpu().numpy()
        last = (batch, recon)
    agg = ({k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
           if vals else {})
    return agg, counts, last


def main(args):
    """Run the CLI.  Returns (task, train state, checkpoint manager, the
    last validation means) for callers that drive it from Python."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from .configs import VQVAEConfig, parse_overrides, preset_params
    from .data import DataModule
    from .training.checkpoint import CheckpointManager
    from .training.logging import TBLogger
    from .training.vqvae_task import VQVAETask

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")

    n_e = args.num_embeddings or (1024 if args.dataset == "vggsound" else 128)
    cfg = VQVAEConfig(num_embeddings=n_e, disc_start=args.disc_start,
                      learning_rate=args.learning_rate)
    ov = parse_overrides(args.override)
    if ov:
        cfg = dataclasses.replace(cfg, **ov)
    spec_dir = preset_params("GPT_VAE", args.dataset)["spec_dir_path"]
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    dm = DataModule(batch_size=args.batch_size, spec_dir_path=spec_dir,
                    data_root=args.data_root)
    dm.setup()
    task = VQVAETask(cfg, device)

    run_dir = os.path.join("lightning_logs",
                           f"{args.experiment}-{args.dataset}")
    log = TBLogger(run_dir)
    ckpt = CheckpointManager(os.path.join(
        run_dir, "checkpoints", f"version_{log.version}"))

    state = task.init_state(args.seed)
    start_epoch = 0
    if args.resume:
        restored = ckpt.restore(args.resume, template={
            "state": task.state_template(), "epoch": 0})
        state = task.load_state(restored["state"])
        start_epoch = int(restored["epoch"]) + 1
        del restored

    agg = {}
    if args.train:
        train_loader = dm.train_dataloader()
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            for i, batch in enumerate(_limited(train_loader,
                                               args.limit_train_batches)):
                state, logs = task.train_step(state, batch)
                if i % 50 == 0:
                    log.scalars(logs, state["step"])
                    log.scalar("learning_rate", args.learning_rate,
                               state["step"])

            # validation + codebook-usage histogram
            # (reference: big_model_attn_gan.py:780-826)
            step = state["step"]
            agg, counts, last = validate(task, state, dm.val_dataloader(),
                                         args.limit_val_batches, n_e)
            log.scalars(agg, step)
            zero_hit = int((counts == 0).sum())
            log.scalar("val/zero_hit_codes", zero_hit, step)
            if counts.sum() > 0:
                log.histogram("val/code_hits",
                              np.repeat(np.arange(n_e), counts), step)
            if last is not None:
                # input / reconstruction images (reference log_images
                # :810-826)
                batch, recon = last
                log.spectrogram("images_inputs",
                                np.asarray(batch["image"][0]), step)
                log.spectrogram("images_reconstructions",
                                recon[0, :, :, 0].cpu().numpy(), step)
            print(f"epoch {epoch}: "
                  + " ".join(f"{k} {v:.4f}" for k, v in agg.items())
                  + f" zero_hit_codes {zero_hit}"
                  f" ({time.time() - t0:.1f}s)")
            ckpt.save({"state": task.state_tree(state), "epoch": epoch}, step,
                      metric=agg.get("val/aeloss"))
        ckpt.wait()   # the background write must be durable before exit

    if args.eval:
        agg, _, _ = validate(task, state, dm.val_dataloader(),
                             args.limit_val_batches, n_e)
        print(" ".join(f"{k} {v:.4f}" for k, v in agg.items()))
    log.close()
    return task, state, ckpt, agg


if __name__ == "__main__":
    main(init_config())
