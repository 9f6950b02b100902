#!/usr/bin/env python
"""Real multi-process training of the PyTorch port: two gloo processes on
the CPU against one.  The port of scripts/dryrun_multiprocess.py.

On a synthetic VAS tree (16 train and 8 val clips, vocabulary 16) it
shows that

  * two ranks of ``data=2`` (the port's DDP: each reads its interleaved
    shard of the split, the gradients averaged over the data group) run
    ``fit_gpt`` for 2 epochs to the same global val loss as one process
    with the global batch (``cross_process_sum`` of the val sums);
  * the checkpoint rank 0 wrote restores in a fresh single process and
    gives the same val loss;
  * the GPT-VAE's corpus MI / AU over the two ranks' val shards
    (``pool_posteriors`` over a real all_gather) equal one process's over
    the whole corpus in the same row order;
  * ``fit_vae`` runs an epoch over the two ranks, both ranks reporting the
    same global validation metrics.

The last line of its output is one JSON object: ``ok``,
``val_multiprocess``, ``val_singleprocess``, ``val_restored``,
``mi_multiprocess``, ``mi_singleprocess``, ``au_multiprocess``,
``au_singleprocess``, ``vae_val_multiprocess`` (the fit_vae's global val
loss, rank 0's).  It exits non-zero when a process fails or a check does
not hold (val 1e-4, restored 1e-6, MI 1e-6, AU exact, the ranks agreeing
to 1e-9).

Usage: python scripts/torch_dryrun_multiprocess.py   (about a minute on a
few CPU cores; no card, no network: the ranks meet through a file store
in a temporary directory)
Roles (internal): --role child|single|restore
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_ITEMS_TRAIN, N_ITEMS_VAL = 16, 8
BATCH_PER_RANK = 4            # global batch 8 with 2 processes
EPOCHS = 2                    # two saves: the best copy and an overwrite
SEED = 783435
TIMEOUT = 600


def make_tree(root: str):
    """Tiny on-disk VAS layout: features/<cls>/melspec_10s_22050hz/*_mel.npy
    and codes_10s/*_mel_code.npy, split files under data/."""
    import numpy as np
    rng = np.random.default_rng(0)
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    lines = []
    for cls in ("baby", "dog"):
        mel_dir = os.path.join(root, "features", cls, "melspec_10s_22050hz")
        codes_dir = os.path.join(root, "features", cls, "codes_10s")
        os.makedirs(mel_dir, exist_ok=True)
        os.makedirs(codes_dir, exist_ok=True)
        for i in range((N_ITEMS_TRAIN + N_ITEMS_VAL) // 2):
            vid = f"video_{i:05d}"
            np.save(os.path.join(mel_dir, f"{vid}_mel.npy"),
                    rng.uniform(0, 1, (80, 860)).astype(np.float32))
            np.save(os.path.join(codes_dir, f"{vid}_mel_code.npy"),
                    rng.integers(0, 16, (5, 53)).astype(np.int64))
            lines.append(f"{cls}/{vid}")
    order = lines[0::2] + lines[1::2]
    with open(os.path.join(data, "vas_train.txt"), "w") as f:
        f.write("\n".join(order[:N_ITEMS_TRAIN]) + "\n")
    with open(os.path.join(data, "vas_valid.txt"), "w") as f:
        f.write("\n".join(order[N_ITEMS_TRAIN:]) + "\n")


def _dm(tree, batch_size, pidx=0, pcount=1):
    from melspec_gpt_vqvae_tpu_torch.data import DataModule
    dm = DataModule(batch_size=batch_size, spec_dir_path=os.path.join(
        tree, "features", "*", "melspec_10s_22050hz"),
        data_root=os.path.join(tree, "data"), seed=SEED, num_workers=1,
        process_index=pidx, process_count=pcount)
    dm.setup()
    return dm


def _exps(batch_size):
    """The tiny class GPT (dropout 0, float32: one process and two see the
    same global batches only as sets, so the math must not depend on the
    row order) and the tiny GPT-VAE."""
    from melspec_gpt_vqvae_tpu_torch.configs import (DataConfig,
                                                     ExperimentConfig,
                                                     GPTConfig, TrainConfig,
                                                     VAEConfig)

    def exp(model, **vae):
        return ExperimentConfig(
            model=model, vae=VAEConfig(**vae),
            train=TrainConfig(learning_rate=1e-3, epochs=EPOCHS,
                              batch_size=batch_size),
            data=DataConfig(batch_size=batch_size))
    gpt = exp(GPTConfig(vocab_size=16, block_size=266, n_layer=2, n_head=2,
                        n_embd=32, class_size=2))
    vae = exp(GPTConfig(vocab_size=16, block_size=265, n_layer=1, n_head=2,
                        n_embd=16, class_size=None), nz=16, warm_up=1)
    return gpt, vae


def _mi(task, toks):
    state = task.init_state(SEED)
    mi, au, _ = task.calc_mi_au(state, toks)
    return mi, au


def run_child(args):
    import torch
    torch.set_num_threads(1)
    from melspec_gpt_vqvae_tpu_torch.parallel import (data_coordinate,
                                                      make_mesh,
                                                      maybe_init_distributed,
                                                      shutdown_distributed)
    from melspec_gpt_vqvae_tpu_torch.training import runner
    from melspec_gpt_vqvae_tpu_torch.training.callbacks import \
        metrics_epoch_end
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask

    maybe_init_distributed("cpu", init_method="file://" + os.path.join(
        args.out, "store"), rank=args.pid, world_size=2)
    try:
        mesh = make_mesh(None, "cpu")
        d = data_coordinate(mesh)
        dm = _dm(args.tree, BATCH_PER_RANK, d, 2)
        gexp, vexp = _exps(BATCH_PER_RANK)
        task = GPTTask(gexp, "cpu", mesh)
        log = TBLogger(os.path.join(args.out, "tb_mp"))
        ckpt = CheckpointManager(args.ckpt)
        runner.fit_gpt(task, dm, epochs=EPOCHS, log=log, ckpt=ckpt,
                       seed=SEED)
        val = runner.validate_gpt(task, dm, ckpt=ckpt, resume="last")

        vtask = VAETask(vexp, len(dm.train_dataloader()), "cpu", mesh)
        toks = [vtask.batch_tokens(b) for b in dm.val_dataloader()]
        mi, au = _mi(vtask, toks)
        agg = {}
        runner.fit_vae(vtask, dm, epochs=1, log=log, seed=SEED,
                       ckpt=CheckpointManager(args.ckpt + "_vae"),
                       epoch_end_cb=lambda s, e, a, x, tokens=None:
                       agg.update(a) or metrics_epoch_end(
                           vtask, dm, log)(s, e, a, x, tokens))
        log.close()
    finally:
        shutdown_distributed()
    print(json.dumps({"role": "child", "pid": args.pid, "val": val,
                      "mi": mi, "au": au, "vae_val": agg.get("loss")}),
          flush=True)


def run_single(args):
    import torch
    torch.set_num_threads(1)
    from melspec_gpt_vqvae_tpu_torch.training import runner
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
    from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask

    gexp, vexp = _exps(2 * BATCH_PER_RANK)
    dm = _dm(args.tree, 2 * BATCH_PER_RANK)
    task = GPTTask(gexp, "cpu")
    ckpt = CheckpointManager(args.ckpt)
    runner.fit_gpt(task, dm, epochs=EPOCHS,
                   log=TBLogger(os.path.join(args.out, "tb_single")),
                   ckpt=ckpt, seed=SEED)
    val = runner.validate_gpt(task, dm, ckpt=ckpt, resume="last")
    # the corpus in the two ranks' gathered order: rank 0's rows, rank 1's
    vtask = VAETask(vexp, 1, "cpu")
    toks = [vtask.batch_tokens(b) for p in (0, 1)
            for b in _dm(args.tree, BATCH_PER_RANK, p, 2).val_dataloader()]
    mi, au = _mi(vtask, toks)
    print(json.dumps({"role": "single", "val": val, "mi": mi, "au": au}),
          flush=True)


def run_restore(args):
    """A fresh single process restores the checkpoint the two ranks wrote
    and validates it on the whole split."""
    import torch
    torch.set_num_threads(1)
    from melspec_gpt_vqvae_tpu_torch.training import runner
    from melspec_gpt_vqvae_tpu_torch.training.checkpoint import \
        CheckpointManager
    from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask

    gexp, _ = _exps(2 * BATCH_PER_RANK)
    dm = _dm(args.tree, 2 * BATCH_PER_RANK)
    ckpt = CheckpointManager(args.ckpt)
    task = GPTTask(gexp, "cpu")
    val = runner.validate_gpt(task, dm, ckpt=ckpt, resume="last")
    best = runner.validate_gpt(task, dm, ckpt=ckpt, resume="best")
    print(json.dumps({"role": "restore", "val": val, "val_best": best}),
          flush=True)


def _last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise SystemExit(f"no JSON line in output:\n{out}")


def _wait(procs, what):
    """Each process's output; kills them all past TIMEOUT or on a failure."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
            if p.returncode != 0:
                raise SystemExit(f"{what} failed ({p.returncode}):\n"
                                 f"{outs[-1]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_parent():
    tmp = tempfile.mkdtemp(prefix="torch_mp_dryrun_")
    try:
        _parent(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _parent(tmp):
    tree = os.path.join(tmp, "vas")   # the dataset is read off the path
    make_tree(tree)
    me = os.path.abspath(__file__)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    mp_ckpt = os.path.join(tmp, "ckpt_mp")

    def spawn(role, pid=0, ckpt=None):
        return subprocess.Popen(
            [sys.executable, me, "--role", role, "--pid", str(pid),
             "--tree", tree, "--out", tmp, "--ckpt", ckpt or tmp],
            env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    print("two gloo ranks (data=2) and one process, side by side...",
          flush=True)
    procs = [spawn("child", i, mp_ckpt) for i in range(2)]
    procs.append(spawn("single", ckpt=os.path.join(tmp, "ckpt_sp")))
    outs = _wait(procs, "a run")
    ranks = [_last_json(o) for o in outs[:2]]
    single = _last_json(outs[2])
    for key in ("val", "mi", "vae_val"):
        assert abs(ranks[0][key] - ranks[1][key]) < 1e-9, \
            f"the ranks disagree on the global {key}: {ranks}"
    assert ranks[0]["au"] == ranks[1]["au"], ranks
    print(f"two-rank val loss {ranks[0]['val']}, one process "
          f"{single['val']}")
    assert abs(ranks[0]["val"] - single["val"]) < 1e-4, (ranks, single)
    assert abs(ranks[0]["mi"] - single["mi"]) < 1e-6, (ranks, single)
    assert ranks[0]["au"] == single["au"], (ranks, single)

    print("the two-rank checkpoint in a fresh process...", flush=True)
    restored = _last_json(_wait([spawn("restore", ckpt=mp_ckpt)],
                                "the restore")[0])
    print(f"restored val loss {restored['val']} (best "
          f"{restored['val_best']})")
    assert abs(restored["val"] - ranks[0]["val"]) < 1e-6, (restored, ranks)
    print(json.dumps({"ok": True, "val_multiprocess": ranks[0]["val"],
                      "val_singleprocess": single["val"],
                      "val_restored": restored["val"],
                      "mi_multiprocess": ranks[0]["mi"],
                      "mi_singleprocess": single["mi"],
                      "au_multiprocess": ranks[0]["au"],
                      "au_singleprocess": single["au"],
                      "vae_val_multiprocess": ranks[0]["vae_val"]}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="parent",
                    choices=["parent", "child", "single", "restore"])
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--tree", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args()
    if args.role == "parent":
        run_parent()
        return
    sys.path.insert(0, REPO)
    {"child": run_child, "single": run_single,
     "restore": run_restore}[args.role](args)


if __name__ == "__main__":
    main()
