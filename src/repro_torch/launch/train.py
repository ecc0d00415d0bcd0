"""Training driver — counterpart of ``repro/launch/train.py``: synthetic LM
data, AdamW at a warmup-cosine rate, checkpoints and a metrics CSV in
``--workdir``; on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --reduce \\
      --steps 50 --batch 8 --seq 128 --workdir /tmp/run --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 8  # full width, the card

Weights are the port's ``init_model`` from seed 0; the batches are
``lm_batch_stream``'s from seed 0 (the reference's token ids); the
encoder-decoder and vlm families get all-zero ``enc_embed`` /
``patch_embed``, as the reference's driver gives them.  ``--mesh`` and
``--qcomm-bits`` are parsed and not used: the reference's driver parses
them and passes neither on (``make_train_step``'s ``qcomm_bits`` and
``group`` are the way to the quantized reduce).  ``main`` returns the
losses it logged and the final params.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..core.protocols.base import resolve_device
from ..data import lm_batch_stream
from ..models import COMPUTE_DTYPE, init_train_state, make_train_step, param_count

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true", help="CPU-scale reduced variant")
    ap.add_argument("--width", type=int, default=None, help="override d_model (reduced)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    help="parsed and not used, as in the reference's driver")
    ap.add_argument("--qcomm-bits", type=int, default=0,
                    help="parsed and not used, as in the reference's driver (the quantized "
                         "gradient reduce is make_train_step(qcomm_bits=..., group=...))")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    if args.width:
        cfg = dataclasses.replace(cfg, d_model=args.width, head_dim=args.width // cfg.num_heads)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    params, opt = init_train_state(cfg, seed=0, device=dev)
    print(f"arch={cfg.name} family={cfg.family} params={param_count(params) / 1e6:.1f}M "
          f"layers={cfg.num_layers} d={cfg.d_model}", flush=True)

    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps)
    stream = lm_batch_stream(cfg.vocab_size, args.batch, args.seq, device=dev)

    extra = {}
    if cfg.family == "encdec":
        extra["enc_embed"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                         dtype=COMPUTE_DTYPE, device=dev)
    if cfg.family == "vlm":
        extra["patch_embed"] = torch.zeros((args.batch, cfg.num_patches, cfg.d_model),
                                           dtype=COMPUTE_DTYPE, device=dev)

    log_path = os.path.join(args.workdir, "metrics.csv") if args.workdir else None
    if log_path:
        os.makedirs(args.workdir, exist_ok=True)
        with open(log_path, "w") as f:
            f.write("step,loss,grad_norm,lr,sec_per_step\n")

    logged = []
    t_last = time.time()
    for i in range(args.steps):
        batch = {**next(stream), **extra}
        params, opt, metrics = step_fn(params, opt, batch)
        if (i + 1) % args.log_every == 0 or i == 0:
            loss = float(metrics["loss"])  # waits for the step
            gnorm, lr = float(metrics["grad_norm"]), float(metrics["lr"])
            dt = (time.time() - t_last) / (args.log_every if i else 1)
            t_last = time.time()
            print(f"step {i+1:5d}  loss {loss:.4f}  gnorm {gnorm:.3f} "
                  f"lr {lr:.2e}  {dt:.2f}s/step", flush=True)
            logged.append((i + 1, loss, gnorm, lr, dt))
            if log_path:
                with open(log_path, "a") as f:
                    f.write(f"{i+1},{loss},{gnorm},{lr},{dt}\n")
        if args.workdir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.workdir, i + 1, params)
    if args.workdir:
        save_checkpoint(args.workdir, args.steps, params)
        print(f"final checkpoint in {args.workdir}")
    return {"cfg": cfg, "params": params, "opt": opt, "logged": logged}


if __name__ == "__main__":
    main()
