"""The reference's training path and the port's on the same weights and
batch, on the CPU — shared by the ``tests/test_torch_train_*.py`` files,
which split the ten architectures so that none jits many.

The weights are the port's ``init_model(cfg, seed=0)`` (the reduced
config) as a numpy tree, given to the reference as arrays and to the port
through ``params_from_numpy``; the batch is
``repro_torch.analysis.trainstep.batch_arrays`` (B 2, S 64, so that the
reduced window of 32 bites; each row's last label -1, masked; random
``enc_embed`` / ``patch_embed``).  :func:`run` takes one architecture
through both packages in both compute dtypes ("float32", the algorithm,
and "bfloat16", the working type; the reference's set with the
``compute_dtype`` context of ``tests/_torch_decode.py``): each side's
forward logits and aux, ``loss_fn``'s loss, every gradient leaf at step
0, and an 8-step loss trace (peak lr 1e-3, warmup 2).  The reference's
trace is its ``make_train_step`` written out — the jitted
``value_and_grad(loss_fn)``, ``cosine_warmup`` at the state's step, then
``adamw_update`` — so that each dtype jits the gradient once;
``tests/test_torch_train_system.py`` holds the reference's own
``make_train_step`` against the port's.  Gradients and the loss trace are
compared, not params after many steps: Adam turns a gradient within
rounding of 0 into a full +-lr step whose sign is the rounding's.

:func:`report` reads each quantity as a fraction of the reference's scale
(``trainstep.rel_err``: max |difference| / max |reference|, per gradient
leaf, the worst leaf named); :func:`faults` holds a report to the limits,
set from the readings (``PYTHONPATH=src JAX_PLATFORMS=cpu python
tests/_torch_train.py <arch> ...`` prints them):

* float32, the port against the reference (``F32_LIMITS``; the hybrid
  family ``HYBRID_F32_LIMITS``: its mamba layers' C.B cancellation
  amplifies rounding, as in decode).  Largest readings over the ten
  archs: logits 3.0e-5 (hybrid 1.5e-4), gradients 1.04e-4 (whisper's
  encoder; hybrid 2.7e-4), loss 1.5e-7, MoE aux 1.1e-7, trace 2.0e-3
  (hybrid 6.3e-3); the limits are 3-7x those.
* bfloat16: both packages' bf16 runs part from the float32 truth by far
  more than from each other's rounding (MoE routing flips against fp32
  in both; zamba2's cancellation), so the port's bf16 run is held against
  the reference's float32 run to no more than ``BF16_RATIO`` (2) times
  the reference's own bf16 run's distance plus the float32 limit, for the
  logits, the loss, the aux and the gradients (readings: at most 1.26
  times), and its 8-step trace within ``BF16_TRACE`` (5e-2; readings
  <= 2.2e-2).  The port's bf16 run against the reference's bf16 run is
  reported.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_decode import compute_dtype
from repro.configs import get_config as ref_get_config
from repro.models import forward as ref_forward
from repro.models.steps import loss_fn as ref_loss_fn
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_warmup as ref_cosine_warmup
from repro_torch.analysis.lockstep import flat, unflat
from repro_torch.analysis.trainstep import batch_arrays, rel_err
from repro_torch.configs import get_config
from repro_torch.models import (forward, init_model, loss_fn, make_train_step,
                                params_from_numpy)
from repro_torch.models.weights import _map
from repro_torch.optim import adamw_init

B, S = 2, 64
TRACE = dict(peak_lr=1e-3, warmup=2, total_steps=8)
TRACE_STEPS = 8
F32_LIMITS = {"logits": 1e-4, "loss": 1e-6, "aux": 1e-6, "grads": 5e-4, "trace": 1e-2}
HYBRID_F32_LIMITS = {"logits": 1e-3, "loss": 1e-6, "aux": 1e-6, "grads": 2e-3, "trace": 3e-2}
TRACE_TOL = F32_LIMITS["trace"]
BF16_RATIO = 2.0
BF16_TRACE = 5e-2


def params_np(cfg, seed=0):
    """The port's seed-``seed`` fp32 init of ``cfg`` as a numpy tree."""
    return _map(lambda _, t: t.numpy(), init_model(cfg, seed=seed, device="cpu"))


def batch_np(cfg, seed=0):
    return batch_arrays(cfg, B, S, seed)


def _np(a):
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def ref_side(arch, name, p_np, b_np):
    """The reference's readings of ``arch`` (reduced) in dtype ``name``."""
    cfg = ref_get_config(arch).reduced()
    params = jax.tree.map(jnp.asarray, p_np)
    batch = {k: jnp.asarray(v) for k, v in b_np.items()}
    with compute_dtype(name):
        # the forward and the gradient in one program: one compile a dtype
        both = jax.jit(lambda p, b: (ref_forward(p, cfg, b), jax.value_and_grad(
            lambda q: ref_loss_fn(q, cfg, b), has_aux=True)(p)))
        (logits, aux), ((total, metrics), grads) = both(params, batch)
        out = {"logits": _np(logits), "aux": {k: float(v) for k, v in aux.items()},
               "loss": float(metrics["loss"]),
               "grads": {k: _np(v) for k, v in flat(grads).items()}}
        upd = jax.jit(ref_adamw_update)
        p, opt, out["trace"] = params, ref_adamw_init(params), []
        for _ in range(TRACE_STEPS):
            _, ((_, m), g) = both(p, batch)
            lr = ref_cosine_warmup(opt.step, peak_lr=TRACE["peak_lr"],
                                   warmup_steps=TRACE["warmup"], total_steps=TRACE["total_steps"])
            p, opt, _ = upd(p, g, opt, lr)
            out["trace"].append(float(m["loss"]))
    return out


def port_side(arch, name, p_np, b_np):
    """The port's readings of ``arch`` (reduced) in dtype ``name``, on the CPU."""
    cfg = get_config(arch).reduced()
    dtype = getattr(torch, name)
    batch = {k: torch.from_numpy(v) for k, v in b_np.items()}
    leaves = {k: v.requires_grad_() for k, v in flat(params_from_numpy(p_np, "cpu")).items()}
    total, metrics = loss_fn(unflat(leaves), cfg, batch, dtype=dtype)
    grads = torch.autograd.grad(total, list(leaves.values()))
    with torch.no_grad():
        logits, aux = forward(unflat(leaves), cfg, batch, dtype=dtype)
    out = {"logits": logits.float().numpy(), "aux": {k: float(v) for k, v in aux.items()},
           "loss": float(metrics["loss"]),
           "grads": {k: g.float().numpy() for k, g in zip(leaves, grads)}}
    step = make_train_step(cfg, dtype=dtype, **TRACE)
    p = params_from_numpy(p_np, "cpu")
    opt, out["trace"] = adamw_init(p), []
    for _ in range(TRACE_STEPS):
        p, opt, m = step(p, opt, batch)
        out["trace"].append(float(m["loss"]))
    return out


def errors(ref, got):
    """{quantity: ``got``'s distance from ``ref`` as a fraction of ref's
    scale}; grads: the largest over the leaves (and which leaf)."""
    assert set(ref["grads"]) == set(got["grads"]), "the two trees differ"
    g = {k: rel_err(ref["grads"][k], got["grads"][k]) for k in ref["grads"]}
    worst = max(g, key=g.get)
    return {"logits": rel_err(ref["logits"], got["logits"]),
            "loss": abs(ref["loss"] - got["loss"]) / abs(ref["loss"]),
            "aux": max([abs(ref["aux"][k] - got["aux"][k]) / max(abs(ref["aux"][k]), 1e-12)
                        for k in ref["aux"]], default=0.0),
            "grads": g[worst], "worst_leaf": worst,
            "trace": max(abs(a - b) / abs(a) for a, b in zip(ref["trace"], got["trace"])),
            "finite": bool(np.isfinite(got["logits"]).all()) and all(
                bool(np.isfinite(a).all()) for a in got["grads"].values())}


def run(arch):
    """Both sides of ``arch`` in both dtypes: {(side, dtype): readings}."""
    cfg = get_config(arch).reduced()
    p_np, b_np = params_np(cfg), batch_np(cfg)
    return {(side, name): fn(arch, name, p_np, b_np)
            for name in ("float32", "bfloat16")
            for side, fn in (("ref", ref_side), ("port", port_side))}


def report(sides):
    """The float32 run against the reference's, the bf16 run against the
    reference's bf16 run, and each bf16 run against the reference's
    float32 run (the algorithm)."""
    truth = sides["ref", "float32"]
    return {"f32": errors(truth, sides["port", "float32"]),
            "bf16": errors(sides["ref", "bfloat16"], sides["port", "bfloat16"]),
            "port_bf16_vs_f32": errors(truth, sides["port", "bfloat16"]),
            "ref_bf16_vs_f32": errors(truth, sides["ref", "bfloat16"])}


def faults(arch, rep):
    """Every limit ``rep`` (a :func:`report`) breaks, as text."""
    lim = HYBRID_F32_LIMITS if get_config(arch).family == "hybrid" else F32_LIMITS
    out = [f"float32 {q} {rep['f32'][q]:.3e} > {lim[q]:.1e}" for q in lim
           if rep["f32"][q] > lim[q]]
    port, ref = rep["port_bf16_vs_f32"], rep["ref_bf16_vs_f32"]
    out += [f"bf16 {q}: {port[q]:.3e} from float32, the reference's bf16 {ref[q]:.3e}"
            for q in ("logits", "loss", "aux", "grads")
            if port[q] > BF16_RATIO * ref[q] + lim[q]]
    if port["trace"] > BF16_TRACE:
        out.append(f"bf16 trace {port['trace']:.3e} from float32 > {BF16_TRACE:.1e}")
    out += [f"{k}: non-finite logits or gradients" for k in ("f32", "bf16")
            if not rep[k]["finite"]]
    return out


def check_arch(arch):
    """:func:`run` and :func:`report` of ``arch``, held to :func:`faults`;
    returns (report, the sides)."""
    sides = run(arch)
    rep = report(sides)
    assert not faults(arch, rep), f"{arch}: {faults(arch, rep)}"
    return rep, sides


def remat_grads(arch, **remat):
    """The port's float32 gradients of ``arch`` (reduced, its layer count
    doubled so that a group of layers exists) under ``remat`` settings, and
    the count of tensors the forward saved for the backward outside the
    checkpointed regions (remat saves fewer)."""
    import dataclasses

    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, num_layers=2 * base.num_layers, **remat)
    p_np, b_np = params_np(cfg), batch_np(cfg)
    leaves = {k: v.requires_grad_() for k, v in flat(params_from_numpy(p_np, "cpu")).items()}
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = loss_fn(unflat(leaves), cfg,
                           {k: torch.from_numpy(v) for k, v in b_np.items()},
                           dtype=torch.float32)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return dict(zip(leaves, (g.numpy() for g in grads))), saved[0]


if __name__ == "__main__":
    # the readings of each run, against which the limits are set:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_train.py gemma2-2b [...]
    import json
    import sys

    for arch in sys.argv[1:]:
        rep = report(run(arch))
        print(json.dumps({"arch": arch, **rep, "faults": faults(arch, rep)}))


_SIDES = {}


def sides_of(arch):
    """:func:`run` of ``arch``, once a process (the test files' tests share it)."""
    if arch not in _SIDES:
        _SIDES[arch] = run(arch)
    return _SIDES[arch]
