"""Spawned gloo ranks for the port's mesh tests, and the jobs they run.

A test file takes one pool of ranks for the whole file::

    from _torch_mesh import mesh_pool
    pool = mesh_pool(8)          # a module-scoped fixture named ``pool``

and runs a job of this module on ranks 0..world-1 with
``pool.run(job, *args, world=m)``, which returns every rank's result (its
tensors as numpy arrays).  The jobs are here, at module level, because the
spawned ranks import them by name; nothing here imports JAX or the JAX
package, so the ranks stay light (one torch thread each).  Every job runs
on the CPU (on the card where it takes ``device="cuda"``) and reads, on
rank i, only ``parts[i]`` of the parts it is
given — except where a test hands it poisoned peer parts on purpose.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.ranks import RankPool


def mesh_pool(n: int):
    """A module-scoped ``pool`` fixture of ``n`` ranks (a collective waits a
    minute for its peers before the ranks give up)."""

    @pytest.fixture(scope="module")
    def pool():
        with RankPool(n, timeout=60) as p:
            yield p

    return pool


def _params(start):
    from repro_torch.core import GPParams

    return None if start is None else GPParams(*(torch.tensor(v, dtype=torch.float32)
                                                 for v in start))


def _config(cfg: dict):
    from repro_torch.core import DGPConfig

    return DGPConfig(impl="mesh", **cfg)


def _summary(art) -> dict:
    """An artifact's integers and this rank's factor and data shapes."""
    return {
        "wire_bits": art.wire_bits, "payload_bits": art.payload_bits,
        "integrity_bits": art.integrity_bits, "rows_demoted": art.rows_demoted,
        "lengths": art.lengths, "fit_lengths": art.fit_lengths, "impl": art.impl,
        "params": torch.stack(list(art.params)),
        "rates": None if art.wire is None else art.wire.rates,
        "codes": None if art.wire is None else art.wire.codes,
        "decoded": None if art.wire is None else art.wire.decoded,
        "shapes": {f"{g}/{k}": tuple(v.shape) for g in ("factors", "data")
                   for k, v in getattr(art, g).items()},
    }


def fit_predict(cfg: dict, parts, X_q, start=None, available=None, save_dir=None,
                factors=False, device="cpu"):
    """Fit ``impl="mesh"`` with ``cfg`` on ``device``, serve ``X_q`` (and,
    with ``available``, a degraded request); optionally save to
    ``save_dir`` and return this rank's factors and data."""
    from repro_torch.core import DistributedGP

    est = DistributedGP(_config(cfg), device=device)
    art = est.fit(parts=parts, params=_params(start))
    mu, var = est.predict(art, X_q)
    out = {"mu": mu, "var": var, **_summary(art)}
    if factors:
        out["factors"], out["data"] = art.factors, art.data
    if available is not None:
        out["mu_d"], out["var_d"] = est.predict(art, X_q, available=available)
    if save_dir is not None:
        out["path"] = est.save(art, save_dir)
    return out


def fit_predict_poisoned(cfg: dict, parts, X_q, start=None):
    """:func:`fit_predict` on parts whose every block but this rank's own is
    NaN: what the rank learns of its peers must come through the wire."""
    rank = dist.get_rank()
    poisoned = [(X, y) if j == rank else (np.full_like(X, np.nan), np.full_like(y, np.nan))
                for j, (X, y) in enumerate(parts)]
    return fit_predict(cfg, poisoned, X_q, start)


def fit_stream(cfg: dict, parts, X_q, batches, start=None):
    """Fit, then stream ``batches`` of ``(machine, X_new, y_new)``; the
    integers after each update and the final answers."""
    from repro_torch.core import DistributedGP
    from repro_torch.core.protocols.streaming import update_growth_count

    est = DistributedGP(_config(cfg), device="cpu")
    art = est.fit(parts=parts, params=_params(start))
    steps = []
    for j, Xn, yn in batches:
        art = est.update(art, Xn, yn, machine=j)
        steps.append({"wire_bits": art.wire_bits, "payload_bits": art.payload_bits,
                      "integrity_bits": art.integrity_bits, "lengths": art.lengths,
                      "rows_demoted": art.rows_demoted})
    mu, var = est.predict(art, X_q)
    return {"mu": mu, "var": var, "steps": steps,
            "growths": update_growth_count(cfg.get("protocol", "center")), **_summary(art)}


def serve_structure(cfg: dict, parts, X_q, start=None, device="cpu"):
    """The warm serve's structure on every rank: the contract report of
    one predict and the ops of another, recorded under the dispatcher."""
    from repro_torch.analysis import check_contracts
    from repro_torch.analysis.op_walk import collective_stats, primitive_counts
    from repro_torch.analysis.contracts import predict_ops
    from repro_torch.core import DistributedGP

    est = DistributedGP(_config(cfg), device=device)
    art = est.fit(parts=parts, params=_params(start))
    est.predict(art, X_q)  # warm
    report = check_contracts(art, X_q, raise_on_violation=False)
    ops = predict_ops(art, X_q)
    return {"ok": report.ok, "findings": [str(f) for f in report.findings],
            "contract": report.contract, "op_counts": report.op_counts,
            "collectives": collective_stats(ops),
            "factorizations": dict(primitive_counts(ops, names=("cholesky", "eigh")))}


def quantize(parts, bits: int, center: int = 0):
    """``quantize_to_center(impl="mesh")``."""
    from repro_torch.core.protocols.center import quantize_to_center

    X, y, wire, K, sq = quantize_to_center(parts, bits, center, impl="mesh", device="cpu")
    return {"X": X, "y": y, "wire_bits": wire, "n_center": K, "sq": sq}


def gather_blocks(blocks, bits: int, max_bits: int = 8, masks=None, mode="broadcast",
                  center=0, faults=None, scheme_states=None, group_size=None):
    """``comm.q_all_gather`` of rank i's ``blocks[i]`` (with ``masks[i]``),
    on a group of the first ``group_size`` ranks (all when None).
    ``scheme_states``: per-rank scheme states (numpy dicts) substituted for
    the rank's own fit, the one function the wire fits through."""
    from repro_torch.comm import q_all_gather
    from repro_torch.core import torch_scheme

    rank = dist.get_rank()
    group = None if group_size is None else dist.new_group(list(range(group_size)))
    if group_size is not None and rank >= group_size:
        return None
    fit = torch_scheme.fit_scheme
    if scheme_states is not None:
        own = {k: torch.as_tensor(np.asarray(v)) for k, v in scheme_states[rank].items()}
        torch_scheme.fit_scheme = lambda *a, **k: own
    try:
        x = torch.as_tensor(blocks[rank])
        mask = None if masks is None else torch.as_tensor(masks[rank])
        view, st = q_all_gather(x, group, bits, max_bits, mask=mask, mode=mode,
                                center=center, return_state=True, faults=faults)
    finally:
        torch_scheme.fit_scheme = fit
    return {"view": view, **st}


def psum(rows, bits: int, faults=None):
    """``comm.q_psum`` of rank i's ``rows[i]``."""
    from repro_torch.comm import q_psum

    return q_psum(torch.as_tensor(rows[dist.get_rank()]), None, bits, faults)


def psum_grad(rows, bits: int):
    """The gradient of sum(q_psum(x)^2) / m with respect to rank i's x."""
    from repro_torch.comm import q_psum

    x = torch.as_tensor(rows[dist.get_rank()]).clone().requires_grad_(True)
    (torch.sum(q_psum(x, None, bits) ** 2) / dist.get_world_size()).backward()
    return x.grad


def one_shot(X_blocks, y_blocks, X_star, start, bits: int):
    """``broadcast_gp_mesh`` on rank i's block."""
    from repro_torch.core.distributed_gp import broadcast_gp_mesh

    r = dist.get_rank()
    return broadcast_gp_mesh(None, X_blocks[r], y_blocks[r], X_star, _params(start),
                             kernel="se", bits_per_sample=bits)


def call(fn_path: str, *args, **kwargs):
    """Any port function by dotted path, on every rank (for the legacy
    entry points); an artifact comes back as its :func:`_summary`."""
    import importlib

    from repro_torch.core import FittedProtocol

    mod, _, name = fn_path.rpartition(".")
    out = getattr(importlib.import_module(mod), name)(*args, **kwargs)
    return _summary(out) if isinstance(out, FittedProtocol) else out


def batch_slices(batch: dict, device="cpu"):
    """This rank's slices of ``batch`` through ``data.pipeline.ShardedBatcher``
    on ``device`` (None: the batcher's default)."""
    from repro_torch.data.pipeline import ShardedBatcher

    return ShardedBatcher(device=device)(batch)


def batcher_default_device():
    """Where a ``ShardedBatcher`` built without a device puts its slices: the
    device's type, or the error it raises."""
    from repro_torch.data.pipeline import ShardedBatcher

    try:
        return ShardedBatcher().device.type
    except RuntimeError as e:
        return str(e)


def rank_leaks(cfg: dict, parts, X_q):
    """``find_rank_leaks`` of a mesh artifact as fitted, with ``y`` changed on
    rank 1 alone, and with ``wire/sigma`` cut to this rank's row; and the
    contract findings of the changed artifact."""
    import dataclasses

    from repro_torch.analysis import check_contracts
    from repro_torch.analysis.contracts import find_rank_leaks
    from repro_torch.core import DistributedGP

    allow = ("factors/", "data/")
    rank = dist.get_rank()
    art = DistributedGP(_config(cfg), device="cpu").fit(parts=parts)
    y = art.y.clone()
    if rank == 1:
        y[0] += 1.0
    differs = dataclasses.replace(art, y=y)
    sliced = dataclasses.replace(art, wire=dataclasses.replace(
        art.wire, sigma=art.wire.sigma[rank: rank + 1]))
    report = check_contracts(differs, X_q, raise_on_violation=False)
    return {"clean": find_rank_leaks(art, allow), "differs": find_rank_leaks(differs, allow),
            "sliced": find_rank_leaks(sliced, allow),
            "findings": [(f.contract, f.rule) for f in report.findings]}


def train_qcomm(arch: str, bits: int, steps: int = 8, device="cpu"):
    """``arch`` (reduced) trained ``steps`` steps with ``qcomm_bits=bits``
    over the default group (this rank's shard of the batch), on the batch
    of ``tests/test_qcomm.py`` (rows of seeded token ids, labels the tokens
    themselves); every step's loss (averaged over the ranks) and a digest of
    the final params."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_train_state, make_train_step

    cfg = get_config(arch).reduced()
    params, opt = init_train_state(cfg, seed=0, device=device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)).to(device)
    step = make_train_step(cfg, qcomm_bits=bits, peak_lr=1e-3, warmup=2, total_steps=12)
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "digest": torch.stack([p.double().sum() for p in _leaves(params)])}


def _leaves(tree):
    for _, v in sorted(tree.items()):
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def sharded_forward(arch: str, overrides: dict, rows: int = 8, seq: int = 32):
    """The reduced ``arch`` (``overrides`` replaced) forward in float32 on the
    default group's 4 ranks as a (2, 2) ("data", "model") ``DeviceMesh``
    under the single-pod rules: every parameter distributed by
    ``tree_param_specs``, the seeded (rows, seq) tokens by rows.  Returns
    the gathered logits and aux (the same on every rank)."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    from repro_torch.models.sharding import (logical_rules, rules_single_pod, to_placements,
                                             tree_param_specs)

    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    params = init_model(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (rows, seq)).astype(np.int32))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def place(tree, specs):
        return {k: place(v, specs[k]) if isinstance(v, dict) else
                distribute_tensor(v, mesh, to_placements(specs[k], mesh)) for k, v in tree.items()}

    with logical_rules(rules_single_pod()):
        sharded = place(params, tree_param_specs(params, mesh))
        batch = {"tokens": distribute_tensor(toks, mesh, to_placements(("data", None), mesh))}
        with implicit_replication():
            logits, aux = forward(sharded, cfg, batch, dtype=torch.float32)
    full = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in aux.items()}
    return {"logits": logits.full_tensor(), "aux": full, "sharded": isinstance(logits, DTensor)}


def sharded_train(arch: str, bits: int, steps: int = 8):
    """The reduced ``arch`` trained ``steps`` steps on the default group's 4
    ranks as a (2, 1, 2) ("pod", "data", "model") ``DeviceMesh`` under the
    multi-pod rules, the gradients reduced over the pod axis with
    ``qcomm_bits=bits``, on the batch of
    ``tests/test_qcomm.py`` (seeded token rows, labels the tokens) split by
    rows over the pods.  Every step's loss and a digest of the final
    params."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import init_train_state, make_train_step
    from repro_torch.models.sharding import (logical_rules, rules_multi_pod, to_placements,
                                             tree_param_specs)
    from repro_torch.optim import adamw_init

    cfg = get_config(arch).reduced()
    params, _ = init_train_state(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))
    mesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pod", "data", "model"))

    def place(tree, specs):
        return {k: place(v, specs[k]) if isinstance(v, dict) else
                distribute_tensor(v, mesh, to_placements(specs[k], mesh)) for k, v in tree.items()}

    def full(v):
        return v.full_tensor() if isinstance(v, DTensor) else v

    losses = []
    with logical_rules(rules_multi_pod()), implicit_replication():
        params = place(params, tree_param_specs(params, mesh))
        opt = adamw_init(params)
        rows = to_placements((("pod", "data"), None), mesh)
        batch = {"tokens": distribute_tensor(toks, mesh, rows),
                 "labels": distribute_tensor(toks, mesh, rows)}
        step = make_train_step(cfg, qcomm_bits=bits, group=mesh.get_group("pod") if bits else None,
                               peak_lr=1e-3, warmup=2, total_steps=12)
        for _ in range(steps):
            params, opt, m = step(params, opt, batch)
            losses.append(float(full(m["loss"])))
        digest = torch.stack([full(p).double().sum() for p in _leaves(params)])
    return {"losses": losses, "digest": digest}
