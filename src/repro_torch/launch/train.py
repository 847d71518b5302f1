"""Training launcher CLI (the port's counterpart of ``repro.launch.train``).

Examples:
  # a ~100M-parameter LM on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --preset 100m \\
      --steps 300 --batch 8 --seq-len 256 --dtype bfloat16 --ckpt-dir /tmp/ckpt

  # the reduced config on the CPU (the plain torch backend):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --preset reduced \\
      --steps 50 --device cpu

It runs on the CUDA device unless ``--device cpu`` asks for the CPU, and
never falls back to the CPU by itself. On the card every forward GEMM runs
on the hand-written kernels the selector picks, with its gradient from
:class:`~repro_torch.core.gemm.GemmGrad`.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.configs import list_archs, preset_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.lm import resolve_device
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig, init_train_state
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")

__all__ = ["main", "preset_config"]


def main(argv=None) -> int:
    """Parse arguments, build the model and train it; 0 when the last loss
    is finite."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--preset", default="100m", choices=["full", "reduced", "100m"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32", help="model dtype (as repro's CLI: float32)")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg)
    log.info(
        "arch=%s preset=%s params=%.1fM device=%s", args.arch, args.preset,
        cfg.param_count() / 1e6, device,
    )

    params = model.init_params(device, torch.Generator(device=device).manual_seed(args.seed))
    opt = make_optimizer(args.optimizer, warmup_cosine(args.lr, args.warmup, args.steps))
    data = SyntheticLMData(cfg, batch=args.batch, seq_len=args.seq_len, seed=args.seed)
    trainer = Trainer(
        model,
        opt,
        data,
        TrainerConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            log_every=10,
            microbatches=args.microbatches,
            grad_compression=args.grad_compression,
            handle_sigterm=args.ckpt_dir is not None,
        ),
    )
    state = init_train_state(model, opt, params, args.grad_compression)
    trainer.fit(state)
    log.info("final loss %.4f (first %.4f)", trainer.history[-1], trainer.history[0])
    return 0 if math.isfinite(trainer.history[-1]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
