"""Batched decode serving — counterpart of ``repro/launch/serve.py``:
prefill a prompt batch by repeated decode steps, then greedy-decode with
the per-family cache machinery, every attention layer through the
``decode_attn`` kernel on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --batch 4 --prompt-len 32 --gen 16            # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --reduce \\
      --device cpu                                  # the reduced config, on the CPU

Weights are random (the port's ``init_model`` from seed 0, as the
reference's ``init_train_state(PRNGKey(0))``), cast to the compute dtype
once before the first step; the prompt is drawn from a numpy generator
seeded with 1.  Prints ms/step and the first row's token ids; ``main``
returns what it measured.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.protocols.base import resolve_device
from ..kernels import runtime
from ..models import cast_compute, init_decode_state, init_model, make_decode_step
from .common import sync

__all__ = ["main", "serve"]


def serve(cfg, *, batch: int, prompt_len: int, gen: int, device, params=None,
          prompt=None) -> dict:
    """Prefill ``prompt`` (``batch`` x ``prompt_len`` token ids; drawn
    from seed 1 when None) by ``prompt_len`` decode steps, then decode
    ``gen - 1`` more greedily.  ``params``: the compute-cast tree on
    ``device`` (the port's seed-0 init when None).  Returns the tokens
    (``batch`` x ``gen``, numpy), the seconds of the steps (synchronized),
    the step count, the ``decode_attn`` launches they made, the final state
    and the prompt and weights it ran with."""
    if params is None:
        params = cast_compute(init_model(cfg, seed=0, device=device))
    if prompt is None:
        prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, prompt_len),
                                                   dtype=np.int32)
    prompt = torch.as_tensor(prompt, dtype=torch.int32).to(device)
    max_len = prompt_len + gen
    state = init_decode_state(cfg, batch, max_len, device, params["embedding"].dtype)
    positions = torch.arange(max_len, dtype=torch.int32, device=device)  # 0-d views: no copies
    step = make_decode_step(cfg)
    attn = runtime.family("decode_attn")
    sync()
    before = attn.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        for p in range(prompt_len):
            nxt, state = step(params, state, prompt[:, p:p + 1], positions[p])
        out = [nxt]
        for g in range(gen - 1):
            nxt, state = step(params, state, nxt, positions[prompt_len + g])
            out.append(nxt)
        toks = torch.cat(out, dim=1)
    sync()
    seconds = time.perf_counter() - t0
    return {"tokens": toks.cpu().numpy(), "prompt": prompt.cpu().numpy(), "seconds": seconds,
            "steps": prompt_len + gen - 1, "attn_launches": attn.launches - before,
            "state": state, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=dev)
    dt, n_steps = out["seconds"], out["steps"]
    print(f"arch={cfg.name} batch={args.batch} steps={n_steps} "
          f"{dt:.2f}s total, {1e3 * dt / n_steps:.1f} ms/step")
    print("generated token ids (first row):", out["tokens"][0].tolist())
    return {**out, "cfg": cfg, "ms_per_step": 1e3 * dt / n_steps}


if __name__ == "__main__":
    main()
