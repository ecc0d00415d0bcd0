"""Mixture-of-Experts FFN (arctic-480b, qwen2-moe) — counterpart of
``repro/models/moe.py``, its single-device branch:

  * router softmax -> top-k experts per token + renormalized gates,
  * capacity C per expert with GShard-style dropping: C =
    round(T K capacity_factor / E), rounded up to a multiple of 8 and
    capped at max(T, 8); a choice's place in its expert's buffer is its
    token-major rank among that expert's choices, and a choice at place
    >= C is dropped,
  * dispatch into a dense (E, C, D) buffer, the expert matmuls, gather
    back, gate and sum over the k choices,
  * the shared-expert and dense-residual MLPs added on top.

Aux numbers, computed only when asked for: load-balance (Switch), router
z-loss and the drop fraction, as the reference's, and the router's
probabilities (``router_probs``), from which a checker reads how near a
top-k choice came to flipping.
Under sharding rules on a DTensor batch with a model axis wider than one
device, the dispatch runs expert-parallel (the reference's ``shard_map``
branch, here ``local_map``: :func:`_expert_parallel`); otherwise, and on
every plain tensor, single-device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Init, _gelu, _init, init_mlp, mlp_apply
from .sharding import (_layout, axes_size, current_rules, is_dtensor, mesh_sizes, settle,
                       to_placements)

__all__ = ["init_moe", "_routed_local", "moe_apply"]


def init_moe(rng: Init, cfg, lead=()):
    E, D, Fw = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    width = 2 * Fw if cfg.activation in ("swiglu", "geglu") else Fw
    p = {
        "router": _init(rng, (D, E), scale=0.02, lead=lead),
        "w_in_e": _init(rng, (E, D, width), lead=lead),
        "w_out_e": _init(rng, (E, Fw, D), lead=lead),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(rng, D, cfg.shared_d_ff, cfg.activation, lead)
    if cfg.moe_dense_residual:
        p["dense_res"] = init_mlp(rng, D, cfg.d_ff, cfg.activation, lead)
    return p


def _routed_local(xt, expert_idx, gate_vals, w_in, w_out, cfg, e_offset, e_total):
    """Dispatch / expert / combine over a slab of experts.

    xt: (T, D); expert_idx / gate_vals: (T, K) global expert ids; w_in /
    w_out: (E_loc, ...) the slab's expert weights; e_offset: the slab's
    first global id.  Choices of other slabs contribute zero.  Returns
    (combined (T, D), keep (T, K))."""
    T, D = xt.shape
    E_loc = w_in.shape[0]
    K = expert_idx.shape[1]
    capacity = int(max(1, round(T * K * cfg.capacity_factor / max(e_total, 1))))
    capacity = min(-(-capacity // 8) * 8, max(T, 8))

    flat_e = expert_idx.reshape(-1)  # (T K,) global ids
    local_e = flat_e - e_offset
    mine = (local_e >= 0) & (local_e < E_loc)
    safe_e = torch.where(mine, local_e, torch.zeros_like(local_e))
    # place within the expert's buffer: the running count of its choices
    experts = torch.arange(E_loc, device=xt.device)
    onehot = ((safe_e[:, None] == experts) & mine[:, None]).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, safe_e[:, None])[:, 0]
    keep = mine & (pos < capacity)
    safe_pos = torch.where(keep, pos, torch.full_like(pos, capacity - 1))

    tok_of_choice = torch.arange(T, device=xt.device).repeat_interleave(K)
    contrib = torch.where(keep[:, None], xt[tok_of_choice], torch.zeros((), dtype=xt.dtype,
                                                                         device=xt.device))
    buf = torch.zeros((E_loc, capacity, D), dtype=xt.dtype, device=xt.device)
    buf.index_put_((safe_e, safe_pos), contrib, accumulate=True)

    h = torch.bmm(buf, w_in)
    if cfg.activation in ("swiglu", "geglu"):
        g, u = h.chunk(2, dim=-1)
        h = (F.silu(g) if cfg.activation == "swiglu" else _gelu(g)) * u
    else:
        h = _gelu(h)
    out_buf = torch.bmm(h, w_out)

    gathered = torch.where(keep[:, None], out_buf[safe_e, safe_pos],
                           torch.zeros((), dtype=out_buf.dtype, device=xt.device))
    gates = gate_vals.reshape(-1)[:, None].to(gathered.dtype)
    combined = (gathered * gates).reshape(T, K, D).sum(dim=1)
    return combined, keep.reshape(T, K)


def _pad_experts(w, n_pad):
    if n_pad == 0:
        return w
    return torch.cat([w, torch.zeros((n_pad,) + tuple(w.shape[1:]), dtype=w.dtype,
                                     device=w.device)], dim=0)


def _expert_parallel(params, xt, expert_idx, gate_vals, cfg, model_ax, batch_ax, n_model):
    """The reference's expert-parallel branch, on DTensors: every (data,
    model) device scatters its batch-local tokens into a dense buffer for
    its model-local slab of experts (``_routed_local`` under ``local_map``),
    and the only cross-device collective is the sum of the combined (T, D)
    output (and the keep counts) over the model axis.  Experts that don't
    divide the model axis (qwen2's 60) are zero-padded to the next
    multiple; the router never selects the dead experts."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    E = cfg.num_experts
    n_pad = (-E) % n_model
    w_in = _pad_experts(params["w_in_e"], n_pad)
    w_out = _pad_experts(params["w_out_e"], n_pad)
    E_loc = (E + n_pad) // n_model
    mesh = xt.device_mesh
    tokens = to_placements((batch_ax, None), mesh)
    experts = to_placements((model_ax, None, None), mesh)
    m = mesh.mesh_dim_names.index(model_ax)
    coord = _layout(mesh)[1]
    summed = [Partial() if i == m else p for i, p in enumerate(tokens)]

    def body(xt_l, ei_l, gv_l, w_in_l, w_out_l):
        off = coord[m] * E_loc
        combined, keep = _routed_local(xt_l, ei_l, gv_l, w_in_l, w_out_l, cfg, off, E + n_pad)
        return combined, keep.to(torch.int32)

    combined, keep_ct = local_map(
        body, out_placements=(summed, summed),
        in_placements=(tokens, tokens, tokens, experts, experts),
        device_mesh=mesh, redistribute_inputs=True,
    )(xt, expert_idx, gate_vals, w_in, w_out)
    combined = combined.redistribute(mesh, tokens)
    keep = keep_ct.redistribute(mesh, tokens) > 0
    return combined, keep


def _expert_counts(flat_e, kept, E):
    """(E,) fp32: the sum of ``kept`` over the choices of each expert; a
    DTensor's shards count their own choices and the counts are summed."""
    def count(fe, k):
        return torch.zeros(E, device=fe.device).index_add_(0, fe, k)

    if not is_dtensor(flat_e):
        return count(flat_e, kept)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = flat_e.device_mesh
    pl = list(flat_e.placements)
    out = [Replicate() if p.is_replicate() else Partial() for p in pl]
    return local_map(count, out_placements=out, in_placements=(pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(flat_e, kept).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def moe_apply(params, x, cfg, with_aux=True):
    """x: (B, S, D) -> (out (B, S, D), aux dict, or None when not
    ``with_aux``)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    logits = (xt @ params["router"]).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_vals = gate_vals.to(xt.dtype)

    rules = current_rules()
    sizes = mesh_sizes(x.device_mesh) if rules and is_dtensor(x) else {}
    model_ax, batch_ax = rules.get("tensor"), rules.get("batch")
    n_model = sizes.get(model_ax, 1) if isinstance(model_ax, str) else 1
    if n_model > 1 and batch_ax is not None and T % axes_size(batch_ax, sizes) == 0:
        combined, keep = _expert_parallel(params, xt, expert_idx, gate_vals, cfg, model_ax,
                                          batch_ax, n_model)
    else:
        combined, keep = _routed_local(xt, expert_idx, gate_vals, params["w_in_e"],
                                       params["w_out_e"], cfg, 0, E)
    if "shared" in params:
        combined = combined + mlp_apply(params["shared"], xt, cfg.activation)
    if "dense_res" in params:
        combined = combined + mlp_apply(params["dense_res"], xt, cfg.activation)
    if not with_aux:
        return combined.reshape(B, S, D), None

    flat_e = expert_idx.reshape(-1)
    me = probs.mean(dim=0)  # mean router prob per expert
    kept = keep.reshape(-1).float()
    ce = _expert_counts(flat_e, kept, E) / kept.sum().clamp_min(1.0)
    aux = {
        "load_balance": E * torch.sum(me * ce),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "drop_frac": 1.0 - kept.mean(),
        "router_probs": probs,  # the port's own: (T, E)
    }
    aux = {k: settle(v) for k, v in aux.items()}  # a DTensor's pending means and sums reduced
    return combined.reshape(B, S, D), aux
