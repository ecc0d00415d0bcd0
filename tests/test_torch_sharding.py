"""repro_torch's logical-axis sharding against the reference's, for all ten
architectures at full width: the parameter, AdamW-moment and decode-state
specs (``tree_param_specs``, ``decode_state_specs``) under all three rule
tables on both production meshes, spec for spec; ``input_specs``'
shapes and dtypes; the dry run's ``param_counts``, ``model_flops_estimate``
and ``skip_reason`` for every arch x shape.

The port's trees come from ``init_model(cfg, device="meta")`` and
``init_decode_state(..., device="meta")``, the reference's from
``jax.eval_shape``; the reference's specs are taken against a
``jax.sharding.AbstractMesh`` (no devices, no compile), the port's against
the production meshes' axis sizes — and the production ``DeviceMesh``es
themselves are built on a fake process group and checked to have those
sizes.  A reference spec is ``tuple(PartitionSpec)`` padded with None to
the leaf's rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.configs import get_config as ref_get_config, input_specs as ref_input_specs  # noqa: E402
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.models import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.models.decode import decode_state_specs as ref_decode_state_specs  # noqa: E402
from repro.models.decode import init_decode_state as ref_init_decode_state  # noqa: E402
from repro.models.steps import init_train_state as ref_init_train_state  # noqa: E402

from repro_torch.configs import get_config, input_specs, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.models import SHAPES, init_decode_state, init_model  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.decode import decode_state_specs  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCHS = list_archs()
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
TABLES = ("single_pod", "multi_pod", "long_context")
_DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _rules(mod, table, multi_pod):
    if table == "long_context":
        return mod.rules_long_context(multi_pod)
    return getattr(mod, f"rules_{table}")()


def _abstract(multi_pod):
    shape, names = MESHES[multi_pod]
    return AbstractMesh(shape, names)


def _sizes(multi_pod):
    shape, names = MESHES[multi_pod]
    return dict(zip(names, shape))


def _padded(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _pairs(port, ref, path=()):
    """(path, port leaf, reference leaf) over the port tree's leaves."""
    for k, v in port.items():
        if isinstance(v, dict):
            yield from _pairs(v, ref[k], path + (k,))
        else:
            yield path + (k,), v, ref[k]


def _same_specs(port_specs, ref_specs, port_tree):
    n = 0
    for path, leaf, ref_spec in _pairs(port_tree, ref_specs):
        got = port_specs
        for k in path:
            got = got[k]
        assert got == _padded(ref_spec, leaf.ndim), (path, got, ref_spec)
        n += 1
    return n


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def production(request):
    multi_pod = request.param
    shape, names = MESHES[multi_pod]
    n = int(np.prod(shape))
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        yield multi_pod, mesh


def test_production_mesh_shapes(production):
    multi_pod, mesh = production
    assert mesh.mesh_dim_names == MESHES[multi_pod][1]
    assert sharding.mesh_sizes(mesh) == _sizes(multi_pod)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    params = init_model(cfg, device="meta")
    opt = adamw_init(params)
    ref_params, ref_opt = jax.eval_shape(lambda: ref_init_train_state(jax.random.PRNGKey(0),
                                                                      ref_cfg))
    for path, leaf, ref_leaf in _pairs(params, ref_params):
        assert tuple(leaf.shape) == tuple(ref_leaf.shape), path
    checked = 0
    for multi_pod in (False, True):
        for table in TABLES:
            with sharding.logical_rules(_rules(sharding, table, multi_pod)):
                port = [sharding.tree_param_specs(t, _sizes(multi_pod))
                        for t in (params, opt.m, opt.v)]
            with ref_sharding.logical_rules(_rules(ref_sharding, table, multi_pod)):
                ref = [ref_sharding.tree_param_specs(t, _abstract(multi_pod))
                       for t in (ref_params, ref_opt.m, ref_opt.v)]
            for p, r, tree in zip(port, ref, (params, opt.m, opt.v)):
                checked += _same_specs(p, r, tree)
    assert checked == 18 * len(list(_pairs(params, ref_params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        B, S = shape.global_batch, shape.seq_len
        state = init_decode_state(cfg, B, S, device="meta")
        ref_state = jax.eval_shape(lambda: ref_init_decode_state(ref_cfg, B, S))
        extra = {"cross_kpos"} if cfg.family == "encdec" else set()
        assert set(state) == set(ref_state) | extra
        for multi_pod in (False, True):
            for table in TABLES:
                with sharding.logical_rules(_rules(sharding, table, multi_pod)):
                    port = decode_state_specs(state, _sizes(multi_pod))
                with ref_sharding.logical_rules(_rules(ref_sharding, table, multi_pod)):
                    ref = ref_decode_state_specs(ref_state, _abstract(multi_pod))
                for k in extra:  # the port's own row of the cross attention: replicated
                    assert port.pop(k) == (None,) * state[k].ndim
                _same_specs(port, ref, {k: v for k, v in state.items() if k not in extra})


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_counts_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert dryrun.param_counts(cfg) == ref_dryrun.param_counts(ref_cfg)
    for name in SHAPES:
        assert dryrun.skip_reason(arch, name) == ref_dryrun.skip_reason(arch, name)
        assert dryrun.model_flops_estimate(arch, name) == ref_dryrun.model_flops_estimate(arch,
                                                                                          name)
        if SHAPES[name].kind == "decode":
            continue
        port = input_specs(cfg, SHAPES[name])
        ref = ref_input_specs(ref_cfg, REF_SHAPES[name])
        assert set(port) == set(ref)
        for k, t in port.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), (name, k)
            assert _DTYPES[t.dtype] == ref[k].dtype, (name, k)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert sharding.to_placements((("pod", "data"), None, "model"), mesh) == [
            Shard(0), Shard(0), Shard(2)]
        assert sharding.to_placements((None, None), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="mesh order"):
            sharding.to_placements((("data", "pod"),), mesh)


def test_hooks_are_identities_without_rules():
    x = torch.randn(2, 3, 4)
    assert sharding.current_rules() == {}
    assert sharding.constrain(x, "batch", None, "tensor") is x
    assert sharding.settle(x) is x
    lp = {"attn": {"wq": torch.randn(4, 4)}, "ln1": {"scale": torch.ones(4)}}
    assert sharding.gather_layer_params(lp) is lp
    with sharding.logical_rules(sharding.rules_single_pod()):
        assert sharding.constrain(x, "batch", None, "tensor") is x  # a plain tensor
    idx = torch.tensor([[0, 3, 1], [2, 2, 0]])
    torch.testing.assert_close(sharding.gather_last(x, idx), x.gather(-1, idx[..., None])[..., 0],
                               rtol=0, atol=0)
