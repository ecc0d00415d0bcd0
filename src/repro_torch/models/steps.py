"""Step factories — counterpart of ``repro/models/steps.py``: the train step
(AdamW, microbatches, the quantized gradient reduce), the prefill step and
the decode step.  The loss is next-token cross-entropy in fp32 with the
logsumexp trick.

The port has no TPU pods.  ``qcomm_bits > 0`` makes the "pods" the ranks
of a ``torch.distributed`` group (``group``; the default group when None,
e.g. the gloo group of ``launch/ranks.py``): each rank takes its
contiguous shard of the global batch, computes its gradients, and every
gradient leaf is summed with the paper's quantized all-reduce
(``comm.q_psum``) and divided by the rank count; the metrics are averaged
over the ranks.  ``qcomm_bits = 0`` is the plain step in one process.
"""
from __future__ import annotations

import torch

from ..comm import q_psum
from ..comm import collectives as C
from ..optim import AdamWState, adamw_init, adamw_update, cosine_warmup
from .backbone import forward, init_model
from .config import ModelConfig
from .decode import decode_step as _decode_step
from .sharding import (constrain, current_rules, gather_last, is_dtensor, logical_rules,
                       microbatch_rows, pod_local, without_axis)

__all__ = ["MOE_AUX_WEIGHT", "ROUTER_Z_WEIGHT", "loss_fn", "make_train_step",
           "make_prefill_step", "make_decode_step", "init_train_state"]

MOE_AUX_WEIGHT = 0.01
ROUTER_Z_WEIGHT = 1e-3


def loss_fn(params, cfg: ModelConfig, batch, dtype=None):
    """-> (total loss, metrics): the mean next-token NLL over the labels
    >= 0 (fp32), plus the MoE family's weighted load-balance and router
    z-loss.  metrics: loss (the NLL alone) and moe/<aux>, detached."""
    logits, aux = forward(params, cfg, batch, kind="train", dtype=dtype)
    labels = batch["labels"].long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # a masked label's gold logit is read at 0 and multiplied by 0
    gold = gather_last(logits, labels.clamp_min(0))
    mask = (labels >= 0).float()
    nll = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = nll
    if aux:
        total = total + MOE_AUX_WEIGHT * aux["load_balance"]
        total = total + ROUTER_Z_WEIGHT * aux["router_z"]
    metrics = {"loss": nll.detach(), **{f"moe/{k}": v.detach() for k, v in aux.items()}}
    return total, metrics


def _leaf_list(tree):
    """The leaves of a nested dict, in its order."""
    out = []
    for a in tree.values():
        if isinstance(a, dict):
            out += _leaf_list(a)
        else:
            out.append(a)
    return out


def _like(tree, leaves):
    """``leaves`` (in :func:`_leaf_list`'s order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(t):
        return {k: build(a) if isinstance(a, dict) else next(it) for k, a in t.items()}

    return build(tree)


def _zero_metrics(cfg: ModelConfig, device=None):
    m = {"loss": torch.zeros((), dtype=torch.float32, device=device)}
    if cfg.family == "moe":
        for k in ("moe/load_balance", "moe/router_z", "moe/drop_frac"):
            m[k] = torch.zeros((), dtype=torch.float32, device=device)
    return m


def make_train_step(cfg: ModelConfig, *, peak_lr=3e-4, warmup=100, total_steps=10000,
                    microbatches: int = 1, qcomm_bits: int = 0, group=None, dtype=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one AdamW
    step at the warmup-cosine rate of ``opt_state.step``, params and moments
    updated in place.  metrics: 0-d tensors on the params' device (loss,
    grad_norm, lr, and the MoE aux), so a step makes no host sync.
    ``dtype``: the forward's compute dtype (``COMPUTE_DTYPE`` when None).

    ``microbatches > 1`` splits the batch on its leading axis and
    accumulates fp32 gradients over the pieces (divided by their count);
    the metrics are the last microbatch's.  ``qcomm_bits > 0``: the
    gradients of this rank's shard of the batch, reduced over ``group``
    with ``comm.q_psum`` (module docstring); on a DTensor batch ``group``
    is a mesh axis's (the pods): each pod's gradients on the mesh without
    that axis (``sharding.pod_local``), then each leaf's local shard summed
    over the pods so, as the reference's multi-pod step does."""

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in _leaf_list(params)]
        total, metrics = loss_fn(_like(params, leaves), cfg, batch, dtype)
        return list(torch.autograd.grad(total, leaves)), metrics

    def accumulate_grads(params, batch):
        if microbatches == 1:
            return grad_fn(params, batch)
        B = batch["tokens"].shape[0]
        assert B % microbatches == 0, (B, microbatches)
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in _leaf_list(params)]
        metrics = _zero_metrics(cfg, g_acc[0].device)  # the carry, as the reference's scan
        for i in range(microbatches):
            g, metrics = grad_fn(params, {k: microbatch_rows(v, i, microbatches)
                                          for k, v in batch.items()})
            for a, b in zip(g_acc, g):
                a.add_(b.float())
            del g
        return [g / microbatches for g in g_acc], metrics

    def train_step(params, opt_state: AdamWState, batch):
        if qcomm_bits and is_dtensor(batch["tokens"]):
            # the pods are an axis of the batch's mesh: each pod computes its
            # gradients on the mesh without that axis, on its own rows, under
            # the rules with the axis struck out (no pod collective inside);
            # then every leaf's local shard is summed over the pods
            from torch.distributed.tensor import DTensor

            leaves = _leaf_list(params)
            views = [pod_local(p, group) for p in leaves]
            pod_leaves, axis = [v for v, _ in views], views[0][1]
            pod_params = _like(params, pod_leaves)
            pod_batch = {k: pod_local(v, group)[0] for k, v in batch.items()}
            with logical_rules(without_axis(current_rules(), axis)):
                grads, metrics = accumulate_grads(pod_params, pod_batch)
            n = C.group_size(group)
            with torch.no_grad():
                # the pod's sums over its other axes first, placed as its params
                grads = [g.redistribute(q.device_mesh, q.placements)
                         for g, q in zip(grads, pod_leaves)]
                grads = [DTensor.from_local(q_psum(g.to_local(), group, qcomm_bits) / n,
                                            p.device_mesh, p.placements, run_check=False,
                                            shape=p.shape, stride=p.stride())
                         for g, p in zip(grads, leaves)]
                metrics = {k: C.all_reduce(v.full_tensor() if is_dtensor(v) else v, group) / n
                           for k, v in metrics.items()}
        elif qcomm_bits:
            n, r = C.group_size(group), C.group_rank(group)
            B = batch["tokens"].shape[0]
            assert B % n == 0, (B, n)
            shard = {k: v[r * B // n:(r + 1) * B // n] for k, v in batch.items()}
            grads, metrics = accumulate_grads(params, shard)
            with torch.no_grad():
                grads = [q_psum(g, group, qcomm_bits) / n for g in grads]
                metrics = {k: C.all_reduce(v, group) / n for k, v in metrics.items()}
        else:
            grads, metrics = accumulate_grads(params, batch)
        lr = cosine_warmup(opt_state.step, peak_lr=peak_lr, warmup_steps=warmup,
                           total_steps=total_steps)
        params, opt_state, gnorm = adamw_update(params, _like(params, grads), opt_state, lr)
        return params, opt_state, {**metrics, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits (B, V): the inference
    prefill (no gradients)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward(params, cfg, batch, kind="prefill")
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, state, tokens (B, 1), pos) -> (next_tokens (B, 1) int32,
    state): one decode step and the greedy argmax of its fp32 logits (the
    first index among equal maxima, as ``jnp.argmax``).  ``params`` is the
    compute-cast tree."""

    def step(params, state, tokens, pos):
        logits, state = _decode_step(params, cfg, state, tokens, pos)
        # under sharding rules the vocab is gathered first: DTensor's argmax
        # over shards reads values on the host
        nxt = torch.argmax(constrain(logits[:, -1], "batch", None).float(), dim=-1)
        return nxt[:, None].to(torch.int32), state

    return step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None):
    """(the fp32 params of ``init_model(cfg, seed, device)``, their AdamW
    state) on ``device`` (the card unless the caller names another)."""
    params = init_model(cfg, seed=seed, device=device)
    return params, adamw_init(params)
