"""Multi-pod dry run: trace every (arch x shape x mesh) combination on fake
tensors (no allocation) and extract the roofline terms — counterpart of
``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.json]

Shape skips (as the reference's):
  * long_500k only for sub-quadratic-state archs (ssm / hybrid / gemma2
    sliding window); skipped for pure full-attention archs.

PyTorch's counterpart of GSPMD plus ShapeDtypeStruct: :func:`run_one`
sets up a ``fake`` process group of 256 or 512 ranks in this process
(``launch.mesh.fake_world``; nothing is sent), builds the production
``DeviceMesh``, and under ``FakeTensorMode`` makes every parameter,
optimiser and state leaf a DTensor of fake local shards placed by the
logical-axis rules (``models.sharding``).  It runs the train step
(forward, backward, the in-place AdamW), the prefill step or one decode
step once, as rank 0, under the cost counter (``repro_torch.roofline``)
and ``MemTracker``.  The fake tensors live on ``cuda`` where torch is
built with CUDA (no card is needed), so ``runtime.choose`` picks the
hand-written kernels, which trace as custom ops and launch nothing; on a
CPU-only build they live on the CPU and the kernels' plain versions run.

The result keeps the reference's keys where the quantity is the same:
``n_chips``, ``per_device.{hlo_flops, hlo_bytes, collective_bytes,
collectives}`` (the counter's, per device: the shard's ops and the
collectives DTensor issues; ``calls`` beside them counts each op),
``memory.peak_bytes`` (``MemTracker``'s peak of rank 0: the sharded leaves
plus every live temporary), ``roofline``,
``model_flops_global`` and ``useful_flops_ratio``.  Differences:
``trace_s`` (the eager trace) replaces ``lower_s`` and ``compile_s``;
``xla_flops_noloop`` (XLA's loop-blind count) has no counterpart — eager
execution runs every loop; ``memory`` has no argument / output / temp
split.

``REPRO_MB_TOKENS`` sets the microbatch size as in the reference.
``REPRO_QCOMM_BITS`` > 0 on the multi-pod mesh reduces each gradient
leaf's local shard over the pod axis with the paper's quantized all-reduce
(``comm.q_psum`` over the mesh's ``"pod"`` group; ``make_train_step``'s
``qcomm_bits`` and ``group``), as the reference's does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..configs import get_config, input_specs, list_archs
from ..models import SHAPES, cast_compute, init_decode_state, init_model
from ..models.config import ModelConfig, ShapeConfig
from ..models.decode import decode_state_specs
from ..models.sharding import (axes_size, contiguous_stride, logical_rules, mesh_sizes,
                               rules_long_context, rules_multi_pod, rules_single_pod,
                               to_placements, tree_param_specs)
from ..models.steps import make_decode_step, make_prefill_step, make_train_step
from ..optim import adamw_init
from ..roofline import CostCounter
from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, fake_world, make_production_mesh

__all__ = ["LONG_CONTEXT_OK", "skip_reason", "param_counts", "model_flops_estimate",
           "roofline_terms", "run_one", "trace_device", "main"]

LONG_CONTEXT_OK = {"xlstm-125m", "zamba2-2.7b", "gemma2-2b"}


def skip_reason(arch: str, shape_name: str):
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "full-attention arch: 500k dense KV decode is quadratic-state; skipped per assignment"
    return None


def trace_device() -> str:
    """Where the dry run's fake tensors live: ``cuda`` where torch is built
    with CUDA (the card's path, kernels as custom ops), else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def model_flops_estimate(arch: str, shape_name: str, cfg: ModelConfig = None,
                         shape: ShapeConfig = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D = batch tokens."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    n_params, n_active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per sequence


def param_counts(cfg):
    """(total, active-per-token) parameter counts from the config algebra."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, Hq, Hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    attn = D * hd * (Hq + 2 * Hkv) + Hq * hd * D
    gate = 2 if cfg.activation in ("swiglu", "geglu") else 1
    mlp = D * F * gate + F * D if F else 0
    embed = V * D * (1 if cfg.tie_embeddings else 2)
    total = active = 0
    if cfg.family in ("dense", "vlm"):
        total = active = cfg.num_layers * (attn + mlp)
    elif cfg.family == "moe":
        e_mlp = D * cfg.moe_d_ff * gate + cfg.moe_d_ff * D
        shared = (D * cfg.shared_d_ff * gate + cfg.shared_d_ff * D) if cfg.num_shared_experts else 0
        dense_res = mlp if cfg.moe_dense_residual else 0
        total = cfg.num_layers * (attn + cfg.num_experts * e_mlp + shared + dense_res)
        active = cfg.num_layers * (attn + cfg.top_k * e_mlp + shared + dense_res)
    elif cfg.family == "ssm":
        # mLSTM ~ 4 D*Hq*hd + gates; sLSTM ~ 4 D*H*hd + rec
        pair = ((4 * D * Hq * hd + D * 2 * Hq + D * Hq * hd)
                + (4 * D * Hq * hd + Hq * hd * 4 * hd + Hq * hd * D))
        total = active = (cfg.num_layers // 2) * pair
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * D
        mamba = D * (2 * d_inner + 2 * cfg.ssm_state + Hq) + d_inner * D
        total = active = cfg.num_layers * mamba + (attn + mlp)  # one shared block
    elif cfg.family == "encdec":
        total = active = cfg.enc_layers * (attn + mlp) + cfg.num_layers * (2 * attn + mlp)
    total += embed
    active += embed
    return float(total), float(active)


def roofline_terms(flops_dev, bytes_dev, coll_bytes_dev):
    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    coll_s = coll_bytes_dev / ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    return {**terms, "dominant": dom.replace("_s", "")}


# --- sharded fake leaves ---------------------------------------------------------

def _shard(leaf, spec, mesh):
    """A DTensor of ``leaf``'s global shape and dtype, placed by ``spec``,
    whose local shard is an empty tensor on the mesh's device (fake under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)
    local = [dim // axes_size(ax, sizes) for dim, ax in zip(leaf.shape, spec)]
    t = torch.empty(local, dtype=leaf.dtype, device=mesh.device_type)
    return DTensor.from_local(t, mesh, to_placements(spec, mesh), run_check=False,
                              shape=tuple(leaf.shape), stride=contiguous_stride(leaf.shape))


def _shard_tree(tree, specs, mesh):
    return {k: _shard_tree(v, specs[k], mesh) if isinstance(v, dict) else _shard(v, specs[k], mesh)
            for k, v in tree.items()}


def _batch_spec(t, rules):
    return (rules.get("batch"),) + (None,) * (t.ndim - 1)


def _microbatches(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool) -> int:
    # gradient accumulation: keep ~128k global tokens per microbatch
    # (REPRO_MB_TOKENS overrides); per-device microbatch share halves across
    # pods, so the global microbatch doubles to keep live activations constant
    default_mb = cfg.train_mb_tokens * (2 if multi_pod else 1)
    mb_tokens = int(os.environ.get("REPRO_MB_TOKENS", default_mb))
    mb = max(1, shape.global_batch * shape.seq_len // mb_tokens)
    while shape.global_batch % mb:
        mb -= 1
    return mb


def _rules(shape_name: str, kind: str, multi_pod: bool) -> dict:
    if kind == "decode" and shape_name == "long_500k":
        return rules_long_context(multi_pod)
    return rules_multi_pod() if multi_pod else rules_single_pod()


def _trace(cfg, shape, shape_name, mesh, multi_pod, device):
    """Build the sharded fake step inputs and run the step once under the
    counter and the memory tracker.  -> (counter, peak bytes of rank 0)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    rules = _rules(shape_name, shape.kind, multi_pod)
    with logical_rules(rules):
        abstract = init_model(cfg, device="meta")
        params = _shard_tree(abstract, tree_param_specs(abstract, mesh), mesh)
        del abstract
        tracked = [params]
        if shape.kind == "train":
            opt = adamw_init(params)
            batch = input_specs(cfg, shape, device="meta")
            batch = {k: _shard(v, _batch_spec(v, rules), mesh) for k, v in batch.items()}
            qbits = int(os.environ.get("REPRO_QCOMM_BITS", 0)) if multi_pod else 0
            step = make_train_step(cfg, microbatches=_microbatches(cfg, shape, multi_pod),
                                   qcomm_bits=qbits,
                                   group=mesh.get_group("pod") if qbits else None)
            args = (params, opt, batch)
            tracked += [opt.m, opt.v]
        elif shape.kind == "prefill":
            batch = input_specs(cfg, shape, device="meta")
            batch = {k: _shard(v, _batch_spec(v, rules), mesh) for k, v in batch.items()}
            step = make_prefill_step(cfg)
            args = (params, batch)
        else:
            B = shape.global_batch
            params = cast_compute(params)  # the server's one cast, before any step
            tracked = [params]
            abstract = init_decode_state(cfg, B, shape.seq_len, device="meta")
            state = _shard_tree(abstract, decode_state_specs(abstract, mesh), mesh)
            tok = _shard(torch.empty((B, 1), dtype=torch.int32, device="meta"),
                         (rules.get("batch"), None), mesh)
            pos = torch.zeros((), dtype=torch.int32, device=device)
            step = make_decode_step(cfg)
            args = (params, state, tok, pos)
            tracked.append(state)
        mt = MemTracker()
        mt.track_external(*[t for tree in tracked for t in _leaves(tree)])
        with mt, CostCounter() as counter, implicit_replication():
            step(*args)
        peak = mt.get_tracker_snapshot("peak")
    return counter, sum(v["Total"] for v in peak.values())


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def run_one(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True, *,
            cfg: ModelConfig = None, shape: ShapeConfig = None, mesh_shape=None, device=None):
    """One combo's result dict.  ``cfg``, ``shape`` and ``mesh_shape``
    replace the arch's config, the named shape and the production mesh's
    axis sizes (a reduced run for tests); ``device`` the fake tensors'
    device (:func:`trace_device` when None)."""
    reason = skip_reason(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "skipped": reason}
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    device = device or trace_device()
    n_chips = 1
    for n in (mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))):
        n_chips *= n
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device, shape=mesh_shape)
        with FakeTensorMode(allow_non_fake_inputs=True):
            counter, peak = _trace(cfg, shape, shape_name, mesh, multi_pod, device)
    t_trace = time.time() - t0

    c = counter.cost
    res = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "n_chips": n_chips,
        "trace_s": round(t_trace, 1),
        "per_device": {
            "hlo_flops": c.flops,
            "hlo_bytes": c.bytes,
            "collective_bytes": c.collective_bytes,
            "collectives": dict(c.collectives),
            "calls": dict(counter.calls),
        },
        "memory": {"peak_bytes": peak},
        "roofline": roofline_terms(c.flops, c.bytes, c.collective_bytes),
        "model_flops_global": model_flops_estimate(arch, shape_name, cfg, shape),
    }
    res["roofline"]["useful_flops_ratio"] = (
        res["model_flops_global"] / (c.flops * n_chips) if c.flops else None
    )
    if verbose:
        r = res["roofline"]
        print(
            f"{arch:20s} {shape_name:12s} pods={2 if multi_pod else 1} "
            f"trace={t_trace:6.1f}s  compute={r['compute_s']:.3e}s "
            f"memory={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
            f"dom={r['dominant']}  peakGB={peak / 1e9:.2f}",
            flush=True,
        )
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    combos = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    results = []
    for a, s, mp in combos:
        try:
            results.append(run_one(a, s, mp))
        except Exception as e:  # a failure here is a bug in the system
            results.append({"arch": a, "shape": s, "multi_pod": mp,
                            "error": f"{type(e).__name__}: {e}"})
            print(f"{a:20s} {s:12s} FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_err = sum("error" in r for r in results)
    print(f"\n{len(results)} combos, {n_err} failures, "
          f"{sum('skipped' in r for r in results)} documented skips")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
