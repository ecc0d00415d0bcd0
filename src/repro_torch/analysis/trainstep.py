"""One train step of the port run twice from the same weights and batch —
on the card and on the CPU — and the readings that hold one run to the
other: the comparison core of the training checks on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s phase 4n).  The CPU
parity tests hold the port against the reference with the same batch
(``tests/_torch_train.py``).

:func:`run_step` gives a run's forward logits, ``loss_fn``'s total and
metrics, every gradient leaf at the given weights, and the params after
one ``make_train_step`` at ``peak_lr`` (warmup 0, so the step moves
them).  :func:`compare` reads the second run against the first: the
logits, the loss, and each gradient leaf as a fraction of the first run's
scale (max |value|, at least 1e-12; the worst leaf named), and the update
in units of lr.  AdamW's first step moves an element by lr times
g / (|g| + eps): +-lr whatever the gradient's size, so two runs whose
gradients part only by rounding still move an element 2 lr apart where
its gradient is within rounding of 0; ``update_lr`` is the largest such
distance (never above 2 (1 + wd |p|) lr) and ``update_moved`` the share
of elements more than 1e-3 lr apart; both are reported.  What is held is
each run's own update: ``adamw_err``, the largest distance (in lr, beyond
two ulps of the result) between a run's updated params and AdamW's first
step recomputed in float64 from that run's own gradients and weights.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["batch_arrays", "rel_err", "run_step", "compare"]


def batch_arrays(cfg, B: int, S: int, seed: int = 0) -> dict:
    """A seeded numpy batch: tokens, labels (the next token; each row's
    last label -1, masked) and, for the encdec / vlm families, random
    ``enc_embed`` / ``patch_embed`` (float32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    out = {"tokens": toks[:, :-1].copy(), "labels": labels}
    if cfg.family == "encdec":
        out["enc_embed"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embed"] = rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def rel_err(ref, got) -> float:
    """max |ref - got| / max(max |ref|, 1e-12), in float64 (numpy arrays
    or tensors; computed on the card where either lies there)."""
    ref, got = (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
                for a in (ref, got))
    dev = got.device if got.device.type != "cpu" else ref.device
    ref, got = ref.to(dev, torch.float64), got.to(dev, torch.float64)
    return float((ref - got).abs().max() / torch.clamp(ref.abs().max(), min=1e-12))


def run_step(cfg, params_np, batch_np, device, dtype=torch.float32, peak_lr=1e-3) -> dict:
    """The readings of one step of ``cfg`` on ``device`` in ``dtype`` from
    the numpy weights ``params_np`` on the numpy batch ``batch_np``:
    {"logits", "total", "metrics", "grads": {leaf path: tensor}, "params":
    {leaf path: tensor after the step}, "adamw_err"} (float32 tensors on
    ``device``)."""
    from ..models import forward, loss_fn, make_train_step, params_from_numpy
    from ..optim import adamw_init
    from .lockstep import flat, unflat

    device = torch.device(device)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in batch_np.items()}
    leaves = {k: v.requires_grad_() for k, v in flat(params_from_numpy(params_np, device)).items()}
    total, metrics = loss_fn(unflat(leaves), cfg, batch, dtype=dtype)
    grads = torch.autograd.grad(total, list(leaves.values()))
    out = {"total": float(total.detach()), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: g.float() for k, g in zip(leaves, grads)}}
    del grads, total
    params = unflat({k: v.detach() for k, v in leaves.items()})
    p0 = {k: v.detach().clone() for k, v in leaves.items()}
    with torch.no_grad():
        out["logits"] = forward(params, cfg, batch, dtype=dtype)[0].float()
    step = make_train_step(cfg, peak_lr=peak_lr, warmup=0, total_steps=8, dtype=dtype)
    params, opt, m = step(params, adamw_init(params), batch)
    out["params"] = flat(params)
    out["step_metrics"] = {k: float(v) for k, v in m.items()}
    out["adamw_err"] = adamw_first_step_err(p0, out["grads"], out["params"], peak_lr)
    return out


@torch.no_grad()
def adamw_first_step_err(p0, grads, p1, lr, *, weight_decay=0.1, eps=1e-8, clip_norm=1.0):
    """max over the elements of |p1 - AdamW's first step from p0 and
    ``grads``| in float64, less two ulps of the result, in units of ``lr``
    (flat dicts of tensors on one device; at step 1 the bias-corrected
    moments are the clipped gradient and its square)."""
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in grads.values())))
    scale = min(1.0, clip_norm / max(gnorm, 1e-9))
    worst = 0.0
    for k, g in grads.items():  # in place: a leaf's float64 temporaries, four at a time
        g = g.double().mul_(scale)
        step = g.div_(g.abs().add_(eps))  # the normalized moment g / (|g| + eps)
        want = p0[k].double()
        want.sub_(step.add_(want, alpha=weight_decay).mul_(lr))
        err = p1[k].double().sub_(want).abs_().sub_(want.abs_().mul_(2.0 ** -22))
        worst = max(worst, float(err.max()))
    return max(worst, 0.0) / lr


@torch.no_grad()
def compare(ref: dict, got: dict, peak_lr: float = 1e-3) -> dict:
    """``got``'s readings against ``ref``'s (see the module docstring)."""
    assert set(ref["grads"]) == set(got["grads"]), "the two runs' trees differ"
    g = {k: rel_err(ref["grads"][k], got["grads"][k]) for k in ref["grads"]}
    worst = max(g, key=g.get)
    apart, moved, n = 0.0, 0, 0
    for k, b in got["params"].items():
        d = (ref["params"][k].to(b.device) - b).abs()
        apart = max(apart, float(d.max()))
        moved += int((d > 1e-3 * peak_lr).sum())
        n += d.numel()
    aux = [k for k in ref["metrics"] if k.startswith("moe/")]
    return {
        "logits": rel_err(ref["logits"], got["logits"]),
        "loss": abs(ref["metrics"]["loss"] - got["metrics"]["loss"]) / abs(ref["metrics"]["loss"]),
        "aux": max([abs(ref["metrics"][k] - got["metrics"][k]) / max(abs(ref["metrics"][k]),
                                                                      1e-12) for k in aux],
                   default=0.0),
        "grads": g[worst], "worst_leaf": worst,
        "update_lr": apart / peak_lr,
        "update_moved": moved / n,
        "max_param": max(float(a.abs().max()) for a in ref["params"].values()),
        "adamw_err": max(ref["adamw_err"], got["adamw_err"]),
        "finite": bool(torch.isfinite(got["logits"]).all()) and all(
            bool(torch.isfinite(a).all()) for a in got["grads"].values()),
    }


# card against CPU, float32, TF32 off (the hybrid family: its mamba layers'
# C.B cancellation amplifies rounding, as in decode); set from the readings
# of chip_smoke.py's phase 4n (PERF.md §6, PR 28)
# (the H100's largest readings, PR 28: logits 7.1e-5 and gradients 1.7e-4,
# whisper's encoder; hybrid 1.7e-4 / 4.4e-4; loss 2.3e-7, aux 1.1e-7, each
# update its own AdamW step within 3.1e-7 lr; the limits are 4-6x those,
# the AdamW check 30x)
CARD_F32_LIMITS = {"logits": 3e-4, "loss": 1e-6, "aux": 1e-6, "grads": 7e-4, "adamw_err": 1e-5}
CARD_HYBRID_F32_LIMITS = {**CARD_F32_LIMITS, "logits": 1e-3, "grads": 2e-3}


def limits(cfg) -> dict:
    return CARD_HYBRID_F32_LIMITS if cfg.family == "hybrid" else CARD_F32_LIMITS


def faults(rep: dict, cfg, weight_decay: float = 0.1) -> list:
    """Every limit a float32 :func:`compare` report breaks, as text: the
    quantities within :func:`limits` (each run's update its own AdamW step
    within ``adamw_err``), the two updates never more than one AdamW step
    apart (2 (1 + wd max |p|) lr), finite readings."""
    lim = limits(cfg)
    out = [f"{q} {rep[q]:.3e} > {lim[q]:.1e}" for q in lim if rep[q] > lim[q]]
    if rep["update_lr"] > 2 * (1 + weight_decay * rep["max_param"]) + 1e-3:
        out.append(f"update {rep['update_lr']:.3f} lr apart: more than one step")
    if not rep["finite"]:
        out.append("non-finite logits or gradients")
    return out
