"""The tenant-batched serve epilogue (``epilogue_fleet``): the port's plain
version against the reference's, for all six ``fuse`` forms, at a ragged
shape (T = 3 tenants, m = 5 experts, t = 37, K = 19) where every tenant
has an expert of weight 0 and test points whose variance sits at its
1e-12 floor.

The operands come from ``kernels/epilogue/cases.py::epilogue_fleet_operands``
(float32; tenant n made from its own seed): real Nyström serve caches and
generic well-conditioned operands.  The reference runs twice:
``epilogue_moments_fleet_ref`` (its oracle, a vmap of the single-tenant
one) and the Pallas body ``epilogue_fleet_pallas`` itself in interpret mode
(``REPRO_FORCE_PALLAS=1``, padded to 128 as its wrapper does).

Tolerance: ``epilogue_fleet_error_bound`` — ``epilogue_error_bound``
applied to each tenant (the sums of K terms taken in different orders,
against the sum of their ABSOLUTE terms, carried through each fusion's
rows; ``tests/test_torch_epilogue.py`` checks that bound against fp64).
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels.epilogue.ops import epilogue_moments_fleet as ref_fleet  # noqa: E402
from repro.kernels.epilogue.ref import epilogue_moments_fleet_ref  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.epilogue.cases import epilogue_fleet_operands  # noqa: E402
from repro_torch.kernels.epilogue.ops import (  # noqa: E402
    Plan, epilogue_fleet_cuda, epilogue_moments_fleet, fleet_epilogue_block, plan, plan_fleet,
)
from repro_torch.kernels.epilogue.ref import (  # noqa: E402
    EPILOGUE_FUSES, epilogue_error_bound, epilogue_fleet_error_bound,
    epilogue_moments_fleet_plain, epilogue_moments_plain,
)


T, M, T_PTS, K = 3, 5, 37, 19
FLOORED = (0, 5, 36)  # test points whose gss is 0: s2 floors at 1e-12
KINDS = ["serve_cache", "generic"]
OPERANDS = {kind: epilogue_fleet_operands(T, M, T_PTS, K, seed=0, kind=kind,
                                          floored=FLOORED, lost=(1,))
            for kind in KINDS}
OPS = OPERANDS["serve_cache"]


def _within(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = np.asarray(bound, np.float64)
    excess = np.abs(got - want) - bound
    assert np.all(np.isfinite(got)) and np.all(excess <= 0), (
        f"worst excess {excess.max():.3e} at {np.unravel_index(excess.argmax(), excess.shape)}"
    )


def test_operands_have_lost_experts_and_floors():
    G, Ainv, P, walpha, gss, prior, w = OPS
    assert G.shape == (T, M, T_PTS, K) and w.shape == (T, M) and gss.shape == (T, T_PTS)
    assert bool((w[:, 1] == 0).all()) and bool((gss[:, list(FLOORED)] == 0).all())
    assert not torch.equal(G[0], G[1])  # the tenants differ


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
def test_plain_matches_reference_oracle(fuse, kind):
    ops = OPERANDS[kind]
    got = epilogue_moments_fleet_plain(*ops, fuse=fuse)
    assert got.shape == (T, 3, T_PTS) and got.dtype == torch.float32
    want = epilogue_moments_fleet_ref(*(jnp.asarray(a.numpy()) for a in ops), fuse=fuse)
    _within(got.numpy(), want, epilogue_fleet_error_bound(*ops, fuse=fuse).numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
def test_plain_matches_reference_pallas_interpret(fuse, kind, monkeypatch):
    ops = OPERANDS[kind]
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    want = ref_fleet(*(jnp.asarray(a.numpy()) for a in ops), fuse=fuse, interpret=True)
    got = epilogue_moments_fleet(*ops, fuse=fuse)  # CPU tensors: the plain version
    _within(got.numpy(), want, epilogue_fleet_error_bound(*ops, fuse=fuse).numpy())


@pytest.mark.parametrize("fuse", ["kl", "poe", "rbcm"])
def test_each_tenant_matches_the_single_tenant_epilogue(fuse):
    got = epilogue_moments_fleet_plain(*OPS, fuse=fuse)
    for n in range(T):
        one = tuple(a[n] for a in OPS)
        _within(got[n].numpy(), epilogue_moments_plain(*one, fuse=fuse).numpy(),
                epilogue_error_bound(*one, fuse=fuse).numpy())


@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
def test_tenants_are_independent(fuse):
    """Changing tenant 0's operands (NaN queries' kernel rows, all experts
    lost) leaves every other tenant's rows bitwise unchanged."""
    base = epilogue_moments_fleet_plain(*OPS, fuse=fuse)
    G, Ainv, P, walpha, gss, prior, w = (a.clone() for a in OPS)
    G[0, :, 3] = float("nan")
    Ainv[0] *= 3.0
    w[0] = 0.0
    got = epilogue_moments_fleet_plain(G, Ainv, P, walpha, gss, prior, w, fuse=fuse)
    assert torch.equal(got[1:], base[1:])
    assert not torch.equal(got[0], base[0])


def test_w_zeros_drop_their_experts():
    G, Ainv, P, walpha, gss, prior, w = OPS
    keep = [i for i in range(M) if i != 1]
    for fuse in ("kl", "poe", "rbcm"):
        full = epilogue_moments_fleet_plain(*OPS, fuse=fuse)
        sub = epilogue_moments_fleet_plain(G[:, keep], Ainv[:, keep], P[:, keep],
                                           walpha[:, keep], gss, prior, w[:, keep], fuse=fuse)
        np.testing.assert_allclose(full.numpy(), sub.numpy(), rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    runtime.reset_launches()
    got = epilogue_moments_fleet(*OPS, fuse="kl")
    assert runtime.launches()["epilogue_fleet"] == 0
    assert runtime.launches()["epilogue"] == 0
    np.testing.assert_array_equal(got.numpy(),
                                  epilogue_moments_fleet_plain(*OPS, fuse="kl").numpy())
    assert runtime.choose("epilogue_fleet", OPS[0]) is epilogue_moments_fleet_plain


def test_kernel_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="not a CUDA device"):
        epilogue_fleet_cuda(*OPS, fuse="kl")
    with pytest.raises(ValueError, match="unknown fuse"):
        epilogue_fleet_cuda(*OPS, fuse="mean")
    with pytest.raises(ValueError, match=r"G must be \(T, m, t, K\)"):
        epilogue_moments_fleet_plain(*(a[0] for a in OPS), fuse="kl")


@pytest.mark.parametrize("T_,m,t,K_,want", [
    (16, 40, 16, 25, Plan("small", 16, 40)),  # a fleet flush: one expert per block, 640 blocks
    (8, 40, 128, 25, Plan("small", 32, 20)),  # serve-sized requests: 20 groups of 2 experts
    (5, 5, 37, 19, Plan("small", 32, 5)),
    (64, 40, 128, 25, Plan("mma", 128, 14)),  # 64 test tiles: 14 groups of 3 experts
    (1, 40, 4449, 25, Plan("mma", 128, 20)),  # one tenant plans as the single-tenant kernel
])
def test_plan_fleet_tiles_and_expert_groups(T_, m, t, K_, want):
    assert plan_fleet(T_, m, t, K_) == want
    assert fleet_epilogue_block(T_, m, t, K_) == want.tt
    if T_ == 1:
        assert plan(m, t, K_) == want
