"""The fused serve epilogue: the port's plain version against the
reference's, for all six ``fuse`` forms, at a ragged shape (t = 37,
K = 19, m = 5) with availability weights that hold a zero and test points
whose variance sits at its 1e-12 floor.

The operands come from ``kernels/epilogue/cases.py`` (float32): a real
Nyström serve cache of random SE experts, whose variance cancels as in
serving, and generic well-conditioned operands.  The reference runs twice:
``epilogue_moments_ref`` (its oracle) and the Pallas body itself in
interpret mode (``REPRO_FORCE_PALLAS=1``, padded to 128 as its wrapper
does).

Tolerance: ``epilogue_error_bound`` — mu, quad and s2 = gss - quad are
sums of K terms taken in different orders, so each may differ by
max(1e-5, 3 K u) (u = 2^-24) times the sum of its ABSOLUTE terms (s2
cancels heavily: the bound is against |G||Ainv|^T and |P|, not against
s2), carried to first order through each fusion's rows, plus two ulps per
``log`` and the rounding of the sum over experts.  The bound itself is
checked to cover the float32-vs-float64 error of the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.epilogue.ops import epilogue_moments as ref_epilogue  # noqa: E402
from repro.kernels.epilogue.ref import epilogue_moments_ref  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.epilogue.cases import epilogue_operands  # noqa: E402
from repro_torch.kernels.epilogue.ops import (  # noqa: E402
    Plan, epilogue_cuda, epilogue_moments, plan, smem_bytes,
)
from repro_torch.kernels.epilogue.ref import (  # noqa: E402
    EPILOGUE_FUSES, epilogue_error_bound, epilogue_moments_plain,
)

M, T, K = 5, 37, 19
FLOORED = (0, 5, 36)  # test points whose gss is 0: s2 floors at 1e-12


KINDS = ["serve_cache", "generic"]
OPERANDS = {kind: epilogue_operands(M, T, K, seed=0, kind=kind, floored=FLOORED, lost=(1,))
            for kind in KINDS}
OPS = OPERANDS["serve_cache"]


def _within(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = np.asarray(bound, np.float64)
    excess = np.abs(got - want) - bound
    assert np.all(np.isfinite(got)) and np.all(excess <= 0), (
        f"worst excess {excess.max():.3e} at {np.unravel_index(excess.argmax(), excess.shape)}"
    )


@pytest.mark.parametrize("kind", KINDS)
def test_operands_exercise_the_floor_and_a_lost_expert(kind):
    G, Ainv, P, walpha, gss, prior, w = OPERANDS[kind]
    quad = torch.sum((G @ Ainv.mT) * ((G @ Ainv.mT) @ P.mT), -1)
    assert bool((gss[list(FLOORED)] - quad[:, list(FLOORED)] < 1e-12).all())
    live = [i for i in range(T) if i not in FLOORED]
    assert bool((gss[live] - quad[:, live] > 1e-3).all())
    assert float(w[1]) == 0.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
def test_plain_matches_reference_oracle(fuse, kind):
    ops = OPERANDS[kind]
    got = epilogue_moments_plain(*ops, fuse=fuse)
    assert got.shape == (3, T) and got.dtype == torch.float32
    want = epilogue_moments_ref(*(jnp.asarray(a.numpy()) for a in ops), fuse=fuse)
    _within(got.numpy(), want, epilogue_error_bound(*ops, fuse=fuse).numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
def test_plain_matches_reference_pallas_interpret(fuse, kind, monkeypatch):
    ops = OPERANDS[kind]
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    want = ref_epilogue(*(jnp.asarray(a.numpy()) for a in ops), fuse=fuse, interpret=True)
    got = epilogue_moments(*ops, fuse=fuse)  # CPU tensors: the plain version
    _within(got.numpy(), want, epilogue_error_bound(*ops, fuse=fuse).numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fuse", EPILOGUE_FUSES)
def test_error_bound_covers_float32_against_float64(fuse, kind):
    # the float64 evaluation of the SAME fp32-rounded inputs
    ops = OPERANDS[kind]
    S32 = epilogue_moments_plain(*ops, fuse=fuse)
    S64 = epilogue_moments_plain(*(a.double() for a in ops), fuse=fuse)
    _within(S32.numpy(), S64.numpy(), epilogue_error_bound(*ops, fuse=fuse).numpy())


def test_lost_expert_contributes_nothing():
    G, Ainv, P, walpha, gss, prior, w = OPS
    keep = [i for i in range(M) if float(w[i]) > 0]
    for fuse in ("kl", "poe", "rbcm"):
        full = epilogue_moments_plain(*OPS, fuse=fuse)
        sub = epilogue_moments_plain(G[keep], Ainv[keep], P[keep], walpha[keep],
                                     gss, prior, w[keep], fuse=fuse)
        np.testing.assert_allclose(full.numpy(), sub.numpy(), rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    runtime.reset_launches()
    got = epilogue_moments(*OPS, fuse="kl")
    assert runtime.launches()["epilogue"] == 0
    np.testing.assert_array_equal(got.numpy(), epilogue_moments_plain(*OPS, fuse="kl").numpy())
    assert runtime.choose("epilogue", OPS[0]) is epilogue_moments_plain


def test_kernel_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="not a CUDA device"):
        epilogue_cuda(*OPS, fuse="kl")
    with pytest.raises(ValueError, match="unknown fuse"):
        epilogue_cuda(*OPS, fuse="mean")
    with pytest.raises(ValueError, match="unknown epilogue fuse"):
        epilogue_moments_plain(*OPS, fuse="mean")


@pytest.mark.parametrize("m,t,K,want", [
    (40, 128, 25, Plan("small", 32, 40)),  # a broadcast request: one expert per block
    (40, 4449, 25, Plan("mma", 128, 20)),  # the whole test set: 20 groups of 2 experts
    (5, 37, 19, Plan("small", 32, 5)),
    (40, 130, 300, Plan("mma", 32, 40)),
    (1, 1, 1, Plan("small", 16, 1)),
])
def test_plan_tiles_and_expert_groups(m, t, K, want):
    assert plan(m, t, K) == want


def test_plan_shrinks_the_tile_for_large_K_and_refuses_what_cannot_fit():
    pl = plan(2, 10, 2000)
    assert pl.tt < plan(2, 10, 300).tt and smem_bytes(pl.variant, pl.tt, 2000) <= 232_448
    assert plan(2, 10, 2688).tt == 16
    with pytest.raises(ValueError, match="does not fit"):
        plan(2, 10, 3000)
