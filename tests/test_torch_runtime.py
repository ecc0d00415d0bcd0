"""repro_torch's kernel runtime against the reference's: the same family
names, one signature per family, the dispatch rule, and the shape sweep's
contract (a backend that cannot run a case gives nan; the sweep goes on)."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels  # noqa: E402,F401  (registers every reference family)
from repro.kernels import runtime as ref_runtime  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402


def _params(fn):
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


def test_family_names_equal_the_reference_kernel_ops():
    names = runtime.families()
    assert names == tuple(sorted(ref_runtime.KERNEL_OPS.names()))
    assert len(names) == 8


@pytest.mark.parametrize("name", sorted(ref_runtime.KERNEL_OPS.names()))
def test_kernel_and_plain_share_a_signature(name):
    runtime.families()
    fam = runtime.family(name)
    assert fam.name == name and fam.kernel is not fam.plain
    assert _params(fam.kernel) == _params(fam.plain)


@pytest.mark.parametrize("name", sorted(ref_runtime.KERNEL_OPS.names()))
def test_choose_routes_cpu_to_plain_and_refuses_other_devices(name):
    runtime.families()
    assert runtime.choose(name, torch.zeros(1)) is runtime.family(name).plain
    with pytest.raises(ValueError, match="no implementation"):
        runtime.choose(name, torch.zeros(1, device="meta"))


def test_unknown_family_lists_the_menu():
    runtime.families()
    with pytest.raises(ValueError, match="known families are .*quant_encode"):
        runtime.family("no_such_kernel")


def test_shape_sweep_on_cpu_gives_finite_plain_rows_and_nan_for_a_failing_case():
    runtime.families()
    rng = np.random.default_rng(0)
    good = lambda n: (lambda: (torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)),
                               torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))))
    bad = lambda: (torch.zeros(4, 3), torch.zeros(5, 8))  # d mismatch: the call raises
    runtime.reset_launches()
    rows = runtime.shape_sweep("gram", [("16x8x5", good(16), None), ("bad", bad, None),
                                        ("64x8x5", good(64), None)], reps=2)
    assert [(label, backend) for label, backend, _ in rows] == [
        ("16x8x5", "plain"), ("bad", "plain"), ("64x8x5", "plain")]
    assert math.isfinite(rows[0][2]) and rows[0][2] > 0
    assert math.isnan(rows[1][2])
    assert math.isfinite(rows[2][2]) and rows[2][2] > 0
    assert not any(runtime.launches().values())  # the CPU ran no kernel


def test_shape_sweep_passes_keyword_arguments():
    runtime.families()
    from repro_torch.kernels.decode_attn.cases import decode_attn_operands

    args = decode_attn_operands(1, 32, 1, 2, 8, pos=31, kv_dtype=torch.float32)
    rows = runtime.shape_sweep("decode_attn", [
        ("window", lambda: (*args, 31), {"window": 8}),
        ("bad window", lambda: (*args, 31), {"window": "eight"}),
    ], reps=1)
    assert math.isfinite(rows[0][2]) and math.isnan(rows[1][2])
