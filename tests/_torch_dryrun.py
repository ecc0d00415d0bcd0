"""The per-device matmul FLOPs of one reduced train step on a small mesh,
the reference's and the port's, for ``tests/test_torch_dryrun_*.py``.

The reference lowers its train step on the conftest's 8 CPU devices, with
its ``tree_param_specs`` and single-pod rules, and counts the optimised
HLO with ``analyze_hlo``; the port traces ``make_train_step`` on fake
tensors over a fake group of 8 ranks (``launch.dryrun.run_one``) and
counts at the dispatcher.  Both count matmul FLOPs only (HLO ``dot``s;
``torch.utils.flop_counter``'s registry: mm, bmm, ...).

The readings, (4, 2) ("data", "model") and (2, 4), batch 16 x 64 tokens:
  gemma-7b, gemma2-2b   ref 1660944384 / 1660944384; port 1660944384 /
                        1811939328
  qwen2-moe-a2.7b       ref 2704277504 / 2975858688; port 2704277504 /
                        3126853632
On (4, 2) the two counts are equal.  On (2, 4) the port's exceeds the
reference's by :func:`attention_excess` exactly: the reduced configs have
2 KV heads, which a 4-wide model axis cannot split, and a DTensor cannot
split the (KV, G) head pair across two dims as GSPMD does, so every model
rank computes every head's attention (``sharding.per_head``).
"""
import os

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.compat import make_mesh, set_mesh
from repro.configs import get_config as ref_get_config, input_specs as ref_input_specs
from repro.models import make_train_step as ref_make_train_step
from repro.models.config import ShapeConfig as RefShapeConfig
from repro.models.sharding import logical_rules, rules_single_pod, tree_param_specs
from repro.models.steps import init_train_state as ref_init_train_state
from repro.roofline import analyze_hlo

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_one
from repro_torch.models.config import ShapeConfig

ROWS, SEQ = 16, 64
TOL = 0.02  # the stated limit; the readings above are exact


def ref_flops(arch: str, mesh_shape) -> float:
    cfg = ref_get_config(arch).reduced()
    shape = RefShapeConfig("train_4k", SEQ, ROWS, "train")
    mesh = make_mesh(mesh_shape, ("data", "model"))
    rules = rules_single_pod()
    with logical_rules(rules):
        params, opt = jax.eval_shape(lambda: ref_init_train_state(jax.random.PRNGKey(0), cfg))

        def shard(tree, specs):
            return jax.tree.map(lambda a, sp: jax.ShapeDtypeStruct(
                a.shape, a.dtype, sharding=NamedSharding(mesh, sp)), tree, specs)

        batch = ref_input_specs(cfg, shape)
        bspec = jax.tree.map(lambda s: P(rules["batch"], *([None] * (len(s.shape) - 1))), batch)
        args = (shard(params, tree_param_specs(params, mesh)),
                type(opt)(step=jax.ShapeDtypeStruct((), jnp.int32,
                                                    sharding=NamedSharding(mesh, P())),
                          m=shard(opt.m, tree_param_specs(opt.m, mesh)),
                          v=shard(opt.v, tree_param_specs(opt.v, mesh))),
                shard(batch, bspec))
    with set_mesh(mesh), logical_rules(rules):
        compiled = jax.jit(ref_make_train_step(cfg)).lower(*args).compile()
    return analyze_hlo(compiled.as_text()).flops


def port_flops(arch: str, mesh_shape) -> float:
    res = run_one(arch, "train_4k", False, verbose=False, cfg=get_config(arch).reduced(),
                  shape=ShapeConfig("train_4k", SEQ, ROWS, "train"), mesh_shape=mesh_shape,
                  device="cpu")
    return res["per_device"]["hlo_flops"]


def attention_excess(arch: str, mesh_shape) -> float:
    """FLOPs a device spends on the heads of other model ranks when the KV
    heads do not divide the model axis: the attention's two einsums, forward
    (4 B S^2 Hq hd a layer on this device's B rows) and backward (twice
    that), times (1 - 1 / model)."""
    cfg = get_config(arch).reduced()
    data, model = mesh_shape
    if cfg.num_kv_heads % model == 0:
        return 0.0
    per_layer = 12 * (ROWS // data) * SEQ * SEQ * cfg.num_heads * cfg.hd
    return per_layer * cfg.num_layers * (1 - 1 / model)


def check(arch: str, mesh_shape):
    os.environ.pop("REPRO_MB_TOKENS", None)
    ref, port = ref_flops(arch, mesh_shape), port_flops(arch, mesh_shape)
    excess = attention_excess(arch, mesh_shape)
    assert abs(port - excess - ref) <= TOL * ref, (arch, mesh_shape, port, excess, ref)
    return ref, port, excess
