"""Training CLI (reference tools/train.py:86-121).

    python -m fullsubnet_plus_torch.cli.train -C configs/train.toml [-R] [-V]
        [-P ckpt.npz] [--from-torch ckpt.tar] [--bf16] [--remat] [--epochs N]
        [--supervise N [--heartbeat-timeout S]] [--device cuda|cpu]

Counterpart of fullsubnet_plus_tpu/cli/train.py with the same flags and
files (checkpoints in the JAX package's `.npz` layout, so a run resumes in
either package). It trains on CUDA unless `--device cpu` is given; a
request for CUDA where there is none raises. With `--device cuda` (the
default) one process trains on the visible cards as the JAX CLI does on a
host's chips (`auto_mesh`): the config's batch split over as many cards as
divide it, the largest such count, each card with its own copy of the
model, validation over the same cards; on one card, no mesh.
`--device cuda:N` trains on that card alone.

Data-parallel training over processes runs one process (rank) per card,
each started with the same flags plus its rank, the JAX package's
multi-host flags:

    python -m fullsubnet_plus_torch.cli.train -C cfg.toml \
        --coordinator HOST:PORT --num-hosts N --host-id R [--device cuda|cpu]

`--coordinator` is rank 0's rendezvous address, `--num-hosts` the number
of ranks, `--host-id` this rank. Rank R trains on `cuda:{R % cards}` (or
the card `--device cuda:N` names, or the CPU), over NCCL where each rank
has a card of its own and gloo on the CPU or where the ranks outnumber the
cards (parallel/mesh.py `initialize_distributed`). Each rank
reads its shard of the clean list (`host_id::num_hosts`) at the config's
batch size, so the global batch is that times the ranks. Only rank 0 makes
the save directory and writes train.log, config.toml, checkpoints, events
and the heartbeat, and validates; `--supervise` supervises each rank's
own process.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np
import torch

from fullsubnet_plus_torch.device import resolve_device
from fullsubnet_plus_torch.utils import logger
from fullsubnet_plus_torch.utils.config import dump_config, load_config


def save_dir_of(config: dict) -> str:
    meta = config["meta"]
    return os.path.join(meta["save_dir"], meta.get("experiment_name", "")).rstrip("/")


def mesh_devices(flag: str, card_count: int) -> list:
    """The devices `auto_mesh` may split a one-process run's batch over, for
    `--device flag`: every one of the `card_count` visible cards for a bare
    "cuda", else the one device the flag names."""
    dev = torch.device(flag)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(card_count)]
    return [dev]


def build_trainer(config: dict, args):
    """The Trainer that `main` runs, from a loaded config and parsed args."""
    from fullsubnet_plus_torch.data.datasets import TrainDataset, ValidationDataset
    from fullsubnet_plus_torch.data.loader import BatchLoader
    from fullsubnet_plus_torch.models import get_model
    from fullsubnet_plus_torch.parallel import mesh as parallel
    from fullsubnet_plus_torch.train.loss import get_loss
    from fullsubnet_plus_torch.train.step import make_optimizer
    from fullsubnet_plus_torch.train.trainer import Trainer

    device = parallel.rank_device(args.device, args.host_id or 0)
    distributed = parallel.check_distributed_args(args.coordinator, args.num_hosts, args.host_id)
    parallel.initialize_distributed(args.coordinator, args.num_hosts, args.host_id,
                                    device=device)
    is_primary = parallel.is_primary()
    seed = config.get("meta", {}).get("seed", 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    save_dir = save_dir_of(config)
    if is_primary:
        os.makedirs(save_dir, exist_ok=True)
        logger.init(os.path.join(save_dir, "train.log"))
        dump_config(config, os.path.join(save_dir, "config.toml"))

    model_def = get_model(config["model"]["path"])
    model_config = model_def.make_config(config["model"]["args"])
    train_args = dict(config["train_dataset"]["args"])
    train_args.pop("num_workers", None)
    dl_cfg = config["train_dataset"].get("dataloader", {})
    batch_size = dl_cfg.get("batch_size", 18)
    dataset = TrainDataset(**train_args, seed=seed, host_id=parallel.process_index(),
                           num_hosts=parallel.process_count())
    train_loader = BatchLoader(dataset, batch_size=batch_size,
                               num_workers=dl_cfg.get("num_workers", 4),
                               drop_last=dl_cfg.get("drop_last", True), seed=seed)
    valid_dataset = None
    if "validation_dataset" in config:
        valid_dataset = ValidationDataset(**config["validation_dataset"]["args"])

    # a rank trains on its own device; one process on every card the flag allows
    devices = [device] if distributed else mesh_devices(args.device, torch.cuda.device_count())
    mesh = parallel.auto_mesh(batch_size, devices=devices)
    logger.log(f"training on {mesh if mesh is not None else device}")

    opt_cfg = config.get("optimizer", {})
    trainer_cfg = config.get("trainer", {})
    train_cfg = trainer_cfg.get("train", {})
    valid_cfg = trainer_cfg.get("validation", {})
    vis_cfg = trainer_cfg.get("visualization", {})
    optimizer = make_optimizer(lr=opt_cfg.get("lr", 1e-3), beta1=opt_cfg.get("beta1", 0.9),
                               beta2=opt_cfg.get("beta2", 0.999),
                               clip_grad_norm=train_cfg.get("clip_grad_norm_value", 10.0))
    trainer = Trainer(
        model_def, model_config, save_dir=save_dir, train_loader=train_loader,
        valid_dataset=valid_dataset,
        loss_fn=get_loss(config.get("loss_function", {}).get("name", "mse_loss")),
        optimizer=optimizer, acoustics=config.get("acoustics", {}),
        epochs=args.epochs or train_cfg.get("epochs", 9999),
        save_checkpoint_interval=train_cfg.get("save_checkpoint_interval", 1),
        validation_interval=valid_cfg.get("validation_interval", 1),
        validation_metrics=vis_cfg.get("metrics", ["STOI", "SI_SDR"]),
        metric_workers=vis_cfg.get("num_workers", 4),
        save_max_metric_score=valid_cfg.get("save_max_metric_score", True),
        valid_batch_size=valid_cfg.get("batch_size", 8),
        valid_num_buckets=valid_cfg.get("num_buckets", 2),
        lr=opt_cfg.get("lr", 1e-3), compute_dtype="bfloat16" if args.bf16 else None,
        remat=args.remat or train_cfg.get("remat", False), seed=seed, device=device,
        mesh=mesh, is_primary=is_primary)
    if args.resume:
        trainer.resume()
    if args.from_torch:
        if args.resume:
            # a resumed run (the supervisor's relaunch of a --from-torch job)
            # goes on from its own checkpoint
            logger.log(f"--from-torch {args.from_torch} ignored: -R takes precedence")
        else:
            trainer.resume_from_torch(args.from_torch)
    if args.preloaded_model_path:
        trainer.preload(args.preloaded_model_path)
    return trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="FullSubNet+ training (PyTorch port)")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("-R", "--resume", action="store_true")
    parser.add_argument("-V", "--only_validation", action="store_true")
    parser.add_argument("-P", "--preloaded_model_path", default=None)
    parser.add_argument("--from-torch", default=None, metavar="CKPT.tar",
                        help="continue a reference PyTorch run: its weights, Adam moments, "
                             "step and epoch from a latest_model.tar / best_model.tar")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the model forward in the backward (activation "
                             "memory for FLOPs)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="rank 0's rendezvous address of a multi-rank run")
    parser.add_argument("--num-hosts", type=int, default=None, help="the number of ranks")
    parser.add_argument("--host-id", type=int, default=None, help="this rank")
    parser.add_argument("--supervise", type=int, default=None, metavar="N",
                        help="run under the supervisor (train/supervisor.py): relaunch with "
                             "-R up to N times on an abnormal exit or a stalled heartbeat")
    parser.add_argument("--heartbeat-timeout", type=float, default=1800.0,
                        help="supervisor: seconds without a heartbeat before the child is "
                             "taken as wedged")
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    return parser.parse_args(argv)


def child_argv(argv) -> list:
    """The command line without the supervisor's own flags."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--supervise", "--heartbeat-timeout"):
            skip = True
        elif not a.startswith(("--supervise=", "--heartbeat-timeout=")):
            out.append(a)
    return out


def main(argv=None):
    from fullsubnet_plus_torch.parallel.mesh import check_distributed_args

    args = parse_args(argv)
    # both raise before anything is launched or written
    check_distributed_args(args.coordinator, args.num_hosts, args.host_id)
    resolve_device(args.device)
    config = load_config(args.configuration)
    if args.supervise is not None:
        from fullsubnet_plus_torch.train.supervisor import supervise

        raise SystemExit(supervise(
            child_argv(sys.argv[1:] if argv is None else argv), save_dir_of(config),
            max_restarts=args.supervise, heartbeat_timeout=args.heartbeat_timeout,
            is_primary=not args.host_id))
    build_trainer(config, args).train(only_validation=args.only_validation)


if __name__ == "__main__":
    main()
