"""Logical-axis sharding for the model zoo — counterpart of
``repro/models/sharding.py``.

Activations are annotated with *logical* names; a context-scoped rules table
maps them to physical mesh axes.  The launcher sets the rules per mesh:

    single-pod (16, 16) ("data", "model"):   batch->data,  tensor->model
    multi-pod (2, 16, 16) ("pod","data","model"): batch->(pod,data), tensor->model
    long-context decode:                      seq->data (batch is 1)

Parameter shardings are derived from leaf names via PARAM_RULES — every
parameter name in the zoo encodes its role (see models/*.py).

A spec is a tuple with one entry per dimension: None, an axis name, or a
tuple of axis names (the reference's ``PartitionSpec``, padded to the
leaf's rank).  :func:`to_placements` turns it into DTensor placements on
a ``DeviceMesh``: an axis named on dimension d is ``Shard(d)`` on that
mesh dimension, every other mesh dimension ``Replicate()``.
:func:`constrain` and :func:`gather_layer_params` redistribute DTensors
where the reference places ``with_sharding_constraint``; on plain tensors,
or with no rules active, they return their argument untouched, so the
single-card path keeps its bits.
"""
from __future__ import annotations

import contextlib
import sys

import torch

__all__ = ["current_rules", "logical_rules", "resolve", "mesh_sizes", "axes_size",
           "contiguous_stride", "fit_spec_to_mesh", "to_placements", "is_dtensor", "constrain",
           "settle", "batch_like", "split_dim", "gated_halves", "gather_last", "shard_local",
           "ring_write", "lookup", "without_axis", "pod_local", "microbatch_rows",
           "PARAM_RULES", "STACKED_KEYS", "gather_layer_params", "param_spec_for",
           "tree_param_specs", "rules_single_pod", "rules_multi_pod", "rules_long_context"]

# process-wide, not per thread (the reference's is thread-local): autograd
# runs a CUDA backward, remat's recompute included, on threads of its own
_rules: dict = {}


def current_rules() -> dict:
    return _rules


@contextlib.contextmanager
def logical_rules(rules: dict):
    """rules: logical name -> physical axis (str, tuple, or None)."""
    global _rules
    prev, _rules = _rules, rules
    try:
        yield
    finally:
        _rules = prev


def resolve(*logical_names) -> tuple:
    rules = current_rules()
    return tuple(rules.get(n, None) for n in logical_names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of a mapping given as such."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, _layout(mesh)[0]))


def _layout(mesh):
    """(axis sizes, this rank's coordinate) of a ``DeviceMesh``, read outside
    any fake mode: a sliced mesh builds its rank table with tensor ops."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return tuple(mesh.mesh.shape), mesh.get_coordinate()


def _shard_index(mesh, placements, dim: int) -> int:
    """This device's index among the shards of tensor dim ``dim`` (the mesh
    dims that shard it in order, major first)."""
    from torch.distributed.tensor import Shard

    sizes, coord = _layout(mesh)
    index = 0
    for i, p in enumerate(placements):
        if p == Shard(dim):
            index = index * sizes[i] + coord[i]
    return index


def fit_spec_to_mesh(spec, shape, mesh) -> tuple:
    """Drop sharding on any dim whose size isn't divisible by the mesh-axis
    product (e.g. a 51865 vocab or 4 KV heads can't split 16 ways), or
    that names an axis the mesh lacks.  Pads the spec to ``len(shape)``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if mesh is None:
        return spec
    sizes = mesh_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 0)
        fixed.append(ax if (prod and dim % prod == 0) else None)
    return tuple(fixed)


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension that dimension d's entry names, ``Replicate()`` elsewhere.
    Axes sharing one dimension must come in the mesh's order (major
    first), as ("pod", "data") does."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} on one dimension must follow the mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor — without importing DTensor's package (a
    second of start-up) on a path that never made one."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def _redistribute(x, spec):
    mesh = x.device_mesh
    return x.redistribute(mesh, to_placements(fit_spec_to_mesh(spec, x.shape, mesh), mesh))


def constrain(x, *logical_names):
    """Redistribute a DTensor to the rules' sharding of ``logical_names``
    (axes that don't divide the corresponding dim are dropped); ``x``
    itself when no rules are active or it is a plain tensor.  As with
    GSPMD's sharding constraint, the gradient arriving at the result is
    placed the same way (a partial sum is reduced there), so that the
    backward's matmuls run on shards, not on gathered weights."""
    if not current_rules() or not is_dtensor(x):
        return x
    y = _redistribute(x, resolve(*logical_names))
    if y.requires_grad:
        mesh, placements = y.device_mesh, y.placements  # not y: no cycle through the hook
        y.register_hook(lambda g: g.redistribute(mesh, placements))
    return y


def settle(x):
    """A DTensor's pending sums (``Partial`` placements) reduced, its
    shards kept; anything else untouched.  XLA reduces a partial sum where
    a nonlinear op reads it; a DTensor carries it through the linear part
    of a norm, whose output would stay a sum of shards and send every
    product downstream onto gathered operands."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def batch_like(t, x):
    """``t`` — a plain tensor of the same global values on every device,
    whose dim 0 is ``x``'s batch (positions) — placed as the rules' batch
    sharding when ``x`` is a DTensor under active rules; ``t`` itself
    otherwise.  Each device keeps its own rows; nothing is sent."""
    if not current_rules() or not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return constrain(t, "batch", *([None] * (t.ndim - 1)))


def split_dim(t, dim: int, sizes):
    """``t.unflatten(dim, sizes)``.  A DTensor sharded on ``dim`` over n
    devices with sizes[0] not divisible by n (gemma2's 4 KV heads on a
    16-wide model axis) is first replicated on that dim: a DTensor cannot
    split one sharded dim across two, as GSPMD can."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        dim = dim % t.ndim
        on = [p == Shard(dim) for p in t.placements]
        axis = _layout(t.device_mesh)[0]
        n = 1
        for i, hit in enumerate(on):
            n *= axis[i] if hit else 1
        if sizes[0] % n:
            t = t.redistribute(t.device_mesh, [Replicate() if hit else p
                                               for hit, p in zip(on, t.placements)])
    return t.unflatten(dim, sizes)


def gated_halves(x, w):
    """``(x @ w).chunk(2, -1)``: the gate and up halves of a fused (D, 2F)
    projection.  A DTensor ``w`` sharded on its 2F columns mixes the halves
    across devices (GSPMD moves each shard's half to its place after the
    product); here the weight is gathered over that axis and each half
    sharded again, so both products run on shards."""
    if not is_dtensor(w) or not current_rules():
        return (x @ w).chunk(2, dim=-1)
    halves = split_dim(w, -1, (2, w.shape[-1] // 2))
    spec = (None,) * (w.ndim - 1) + (current_rules().get("tensor"),)
    return tuple(x @ _redistribute(halves[..., i, :], spec) for i in range(2))


def gather_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]``.  A DTensor ``x`` sharded on
    its last dim (the vocab of the logits) gathers within each shard — an
    index outside the shard's range gives 0 there — and sums over the
    shards, as GSPMD's partitioned gather does (DTensor's own gather
    strategy fails on this shape)."""
    if not is_dtensor(x):
        return x.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    last = x.ndim - 1
    mesh = x.device_mesh
    on = [p == Shard(last) for p in x.placements]
    rest = [Replicate() if hit else p for hit, p in zip(on, x.placements)]
    n_loc = x.to_local().shape[-1]
    off = _shard_index(mesh, x.placements, last) * n_loc

    def local(xl, il):
        j = il - off
        mine = (j >= 0) & (j < n_loc)
        g = xl.gather(-1, j.clamp(0, n_loc - 1)[..., None])[..., 0]
        return torch.where(mine, g, torch.zeros((), dtype=g.dtype, device=g.device))

    out = [Partial() if hit else p for hit, p in zip(on, x.placements)]
    fn = local_map(local, out_placements=out, in_placements=(list(x.placements), rest),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, idx).redistribute(mesh, rest)


def shard_local(fn, args, dims, out_dims):
    """``fn(*args)`` on each device's own batch rows and heads when the
    first argument is a DTensor under rules (``local_map``); a plain call
    otherwise.  ``dims[i]``: (batch dim, head dim or None) of ``args[i]``
    (a tensor or None); ``out_dims``: the same for each output.  Heads go
    on the tensor axis when they divide it, else every device takes them
    all; a recurrence (a GLA scan, a sLSTM cell) runs whole on its rows."""
    x = args[0]
    if not current_rules() or not is_dtensor(x):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rules = current_rules()
    H = x.shape[dims[0][1]]
    tensor = rules.get("tensor") if H % axes_size(rules.get("tensor"), mesh_sizes(mesh)) == 0 \
        else None

    def spec(ndim, bd, hd):
        out = [None] * ndim
        if bd is not None:
            out[bd] = rules.get("batch")
        if hd is not None:
            out[hd] = tensor
        return out

    placed, in_pl = [], []
    for a, (bd, hd) in zip(args, dims):
        if a is None:
            placed.append(None)
            in_pl.append(None)
            continue
        if not is_dtensor(a):  # the same values on every device
            from torch.distributed.tensor import DTensor, Replicate

            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        a = _redistribute(settle(a), spec(a.ndim, bd, hd))
        placed.append(a)
        in_pl.append(list(a.placements))
    out_pl = [to_placements(fit_spec_to_mesh(spec(len(s), bd, hd), s, mesh), mesh)
              for s, (bd, hd) in out_dims]
    return local_map(fn, out_placements=tuple(out_pl) if len(out_pl) > 1 else out_pl[0],
                     in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*placed)


def axes_size(ax, sizes: dict) -> int:
    """The number of devices along ``ax`` (None, an axis name or a tuple of
    names) given the axis ``sizes``."""
    n = 1
    for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes.get(a, 1)
    return n


def contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def ring_write(caches, rows, slot):
    """Write ``rows[i]`` (B, 1, ...) at ``slot`` (a 1-element index) of
    dim 1 of ``caches[i]`` (B, S, ...), in place.  On a DTensor cache the
    rows are placed as the cache (its sequence dim aside) and written into
    the local shards; a cache sharded on its sequence writes only on the
    shard that holds the slot."""
    if not is_dtensor(caches[0]):
        for c, r in zip(caches, rows):
            c.index_copy_(1, slot, r)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    for c, r in zip(caches, rows):
        mesh = c.device_mesh
        if not is_dtensor(r):  # the same rows on every device
            r = DTensor.from_local(r, mesh, [Replicate()] * mesh.ndim, run_check=False)
        r = settle(r).redistribute(mesh, [Replicate() if p == Shard(1) else p
                                          for p in c.placements])
        cl, rl = c.to_local(), r.to_local()
        j = slot - _shard_index(mesh, c.placements, 1) * cl.shape[1]
        mine = ((j >= 0) & (j < cl.shape[1])).reshape((1,) * rl.ndim)
        j = j.clamp(0, cl.shape[1] - 1)
        cl.index_copy_(1, j, torch.where(mine, rl, cl.index_select(1, j)))


def lookup(table, tokens):
    """``table[tokens]``; ``F.embedding`` for a DTensor table (its sharding
    strategies cover the lookup and its backward on every torch this runs
    on, where DTensor's ``index_put`` backward is not)."""
    if not is_dtensor(table):
        return table[tokens]
    import torch.nn.functional as F

    return F.embedding(tokens, table)


def _axis_of(mesh, group) -> int:
    """The mesh dimension whose ranks through this rank are ``group``'s (by
    ranks: DTensor's caches may hand back an equal mesh of other groups)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    want = sorted(dist.get_process_group_ranks(group))
    coord = _layout(mesh)[1]
    with unset_fake_temporarily():  # the mesh's own (real) rank table, under a dry run too
        ranks = mesh.mesh.tolist()
    for i in range(mesh.ndim):
        line = [ranks]
        for j, c in enumerate(coord):
            line = [r for sub in line for r in (sub if j == i else [sub[c]])]
        if sorted(line) == want:
            return i
    raise ValueError(f"ranks {want} are no axis of {mesh}")


def without_axis(rules: dict, axis: str) -> dict:
    """``rules`` with mesh axis ``axis`` struck from every entry (the
    reference's inner rules of a pod)."""
    out = {}
    for k, v in rules.items():
        if isinstance(v, tuple):
            v = tuple(a for a in v if a != axis) or None
            v = v[0] if isinstance(v, tuple) and len(v) == 1 else v
        elif v == axis:
            v = None
        out[k] = v
    return out


def pod_local(x, group):
    """``x``, a DTensor replicated or sharded over ``group``'s mesh axis
    (the pods), as a DTensor of the same local shard on the mesh without
    that axis: this pod's part of the batch, or its copy of a parameter.
    Returns (the view, that axis's name)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    i = _axis_of(mesh, group)
    names = tuple(n for j, n in enumerate(mesh.mesh_dim_names) if j != i)
    shape = list(x.shape)
    p = x.placements[i]
    if p.is_shard():
        shape[p.dim] //= _layout(mesh)[0][i]
    elif not p.is_replicate():
        raise ValueError(f"a pending sum over {mesh.mesh_dim_names[i]} has no pod's part")
    with unset_fake_temporarily():  # slicing the mesh reads its (real) rank table
        sub = mesh[names if len(names) > 1 else names[0]]
    view = DTensor.from_local(x.to_local(), sub, [q for j, q in enumerate(x.placements) if j != i],
                              run_check=False, shape=tuple(shape),
                              stride=contiguous_stride(shape))
    return view, mesh.mesh_dim_names[i]


def microbatch_rows(x, i: int, n: int):
    """Microbatch ``i`` of ``n`` along dim 0: rows i B/n .. (i+1) B/n of a
    plain tensor.  A DTensor sharded on dim 0 takes the i-th piece of each
    local shard instead, so that no row moves between devices (the
    reference's reshape to (n, B/n) under GSPMD moves none either)."""
    B = x.shape[0]
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Shard

        local = x.to_local()
        if any(p == Shard(0) for p in x.placements) and local.shape[0] % n == 0:
            b = local.shape[0] // n
            shape = (B // n,) + tuple(x.shape[1:])
            return DTensor.from_local(local[i * b:(i + 1) * b], x.device_mesh, x.placements,
                                      run_check=False, shape=shape, stride=x.stride())
    return x[i * B // n:(i + 1) * B // n]


# --- parameter rules -------------------------------------------------------
# leaf-name -> logical axes for the *trailing* dims (a leading scan/layer dim,
# if present, is unsharded).  fsdp == the data axis, tensor == the model axis.

PARAM_RULES = {
    # embeddings
    "embedding": ("tensor", "fsdp"),        # (V, D)
    "unembed": ("fsdp", "tensor"),          # (D, V)
    "pos_embedding": (None, "fsdp"),        # (S, D)
    # attention
    "wq": ("fsdp", "tensor"),               # (D, H*hd)
    "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"),
    "wo": ("tensor", "fsdp"),               # (H*hd, D)
    # dense mlp (wi covers fused gate+up)
    "wi": ("fsdp", "tensor"),               # (D, {1,2}F)
    "wo_mlp": ("tensor", "fsdp"),           # (F, D)
    # moe — expert-parallel over the model axis; F stays unsharded (the same
    # physical axis cannot appear twice in one spec)
    "router": ("fsdp", None),               # (D, E) — E small, replicate
    "w_in_e": ("expert", "fsdp", None),     # (E, D, {1,2}F)
    "w_out_e": ("expert", None, "fsdp"),    # (E, F, D)
    # ssm / xlstm
    "w_ssm_in": ("fsdp", "tensor"),
    "w_ssm_out": ("tensor", "fsdp"),
    "conv_w": (None, "tensor"),             # (K, d_inner)
    "a_log": ("tensor",),
    "dt_bias": ("tensor",),
    "r_h": (None, "tensor"),                # sLSTM recurrent (hd, H*hd) blocks
    # norms / scalars
    "scale": (None,),
    "bias": (None,),
}

# dict keys whose leaves carry a leading layer-stack dim
STACKED_KEYS = ("layers", "blocks", "enc_layers", "dec_layers", "mamba_layers")


def gather_layer_params(layer_params):
    """FSDP gather inside the per-layer loop.

    Redistributes every weight leaf of one layer to its compute sharding
    with the fsdp axis dropped (tensor-parallel axis kept).  Called on one
    layer's leaves at a time, it pins the all-gather to one layer — the
    reference places the constraint inside its scan body so that XLA
    cannot hoist the gather of the whole stacked (L, ...) parameter out of
    the loop (observed: 433 GB/device on mistral-large-123b)."""
    rules = current_rules()
    if not rules:
        return layer_params

    def f(name, leaf):
        if isinstance(leaf, dict):
            return {k: f(k, v) for k, v in leaf.items()}
        logical = PARAM_RULES.get(name)
        if logical is None or not is_dtensor(leaf):
            return leaf
        axes = [rules.get(a, None) if a not in (None, "fsdp") else None for a in logical]
        pad = leaf.ndim - len(axes)
        if pad < 0:
            return leaf
        return _redistribute(leaf, (None,) * pad + tuple(axes))

    return {k: f(k, v) for k, v in layer_params.items()}


def param_spec_for(name: str, ndim: int, stacked: bool) -> tuple:
    rules = current_rules()
    logical = PARAM_RULES.get(name)
    if logical is None:
        # default: replicate
        return (None,) * ndim
    axes = [rules.get(a, None) if a else None for a in logical]
    # ndim may exceed the rule (e.g. grouped dims) — pad with None on the left
    # after the optional stacked dim
    lead = [None] if stacked else []
    pad = ndim - len(axes) - len(lead)
    return tuple(lead + [None] * pad + axes)


def tree_param_specs(params_tree, mesh=None, _keys=()):
    """A nested dict of tensors (any device, ``meta`` included) -> the same
    structure of specs, by leaf name.  A leaf is 'stacked' when its first
    dim is a layer-stack dim — a key of ``STACKED_KEYS`` on its path."""
    out = {}
    for k, leaf in params_tree.items():
        if isinstance(leaf, dict):
            out[k] = tree_param_specs(leaf, mesh, _keys + (k,))
            continue
        stacked = any(p in STACKED_KEYS for p in _keys)
        out[k] = fit_spec_to_mesh(param_spec_for(k, leaf.ndim, stacked), leaf.shape, mesh)
    return out


# canonical rule tables used by the launcher -------------------------------

def rules_single_pod() -> dict:
    return {"batch": "data", "fsdp": "data", "tensor": "model", "expert": "model", "seq": None}


def rules_multi_pod() -> dict:
    # pure data-parallel across pods: params replicated over 'pod', batch
    # sharded over (pod, data)
    return {"batch": ("pod", "data"), "fsdp": "data", "tensor": "model", "expert": "model",
            "seq": None}


def rules_long_context(multi_pod: bool) -> dict:
    # batch==1: shard the KV sequence over the data axis instead
    base = rules_multi_pod() if multi_pod else rules_single_pod()
    base = dict(base)
    base["batch"] = None
    base["seq"] = "data"
    return base
