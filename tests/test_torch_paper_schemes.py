"""The paper's §4 schemes in repro_torch against the reference's: the
Theorem-3 dimension reduction and PCA, the eq. 6 / eq. 7 distortions, the
Theorem-1/2 optimal scheme, the per-symbol roundtrip, and the Fig. 2, Fig.
3 and bit-ablation scripts.

What is held, and within what:
* bitwise: ``make_dim_reduction`` and ``make_pca`` (the same float64 numpy
  code on the same inputs), the optimal channel's ``A`` and ``W_half``,
  every rate, allocation, ``wire_bits`` and ``side_info_bits`` (integers);
* within 1e-5 of the data scale: ``dr_encode`` / ``dr_decode``, the four
  schemes' roundtrips (one fp32 matmul or two each side; the optimal
  scheme's with the reference's noise put in at ``channel_noise``, the one
  function the channel draws from);
* eq. 6 == eq. 7 within rtol 1e-4 (``tests/test_schemes.py``), and each
  within rtol 1e-5 of the reference's;
* per-symbol codes: equal except where a symbol lies within 2 ulp of a bin
  edge (each package forms the symbols X T^T with its own fp32 matmul), the
  flips counted;
* the scripts' rows (``main(quick=True, device="cpu")``): Fig. 3 and the
  ablation have no random draw beyond the seeded numpy generator, Fig. 2's
  optimal column takes the reference's noise; their distortions within
  rtol 2e-5 plus 1e-5 of the column's largest value in the same setting
  of the reference script's rows.  Each package computes the second
  moments and the symbols with its own fp32 matmul; the small distortions
  at large m are differences of nearly equal sums, so their gaps are
  absolute (read: 5.3e-7 on Fig. 3c's 4.9e-3 at m = 40, whose column
  reaches 1.28).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import ablation_bits as ref_ablation  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig2_distortion as ref_fig2  # noqa: E402
from benchmarks import fig3_pca as ref_fig3  # noqa: E402
from repro.core import distortion as ref_dist  # noqa: E402
from repro.core import quantizers as RQ  # noqa: E402
from repro.core import schemes as ref_schemes  # noqa: E402
from repro.core import transforms as ref_tr  # noqa: E402
from repro_torch.core import distortion as dist  # noqa: E402
from repro_torch.core import rate_distortion as rd  # noqa: E402
from repro_torch.core import schemes  # noqa: E402
from repro_torch.core import transforms as tr  # noqa: E402
from repro_torch.core.protocols import base  # noqa: E402
from repro_torch.launch import ablation_bits, fig2_distortion, fig3_pca  # noqa: E402

TOL = 1e-5
TOL_ROWS = 2e-5


def _cov(rng, d, scale=1.0):
    A = rng.normal(size=(d, d))
    return scale * A @ A.T / d


def _data(seed, d=10, n=2000):
    rng = np.random.default_rng(seed)
    Qx, Qy = _cov(rng, d), _cov(rng, d)
    X = rng.multivariate_normal(np.zeros(d), Qx, size=n).astype(np.float32)
    return Qx, Qy, X


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def _ref_key_noise(shape, seed, stream):
    # the reference's scripts and tests key the channel by PRNGKey(seed)
    assert stream == 0
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), tuple(shape),
                                                       jnp.float32)))


@pytest.mark.parametrize("m", [1, 4, 9, 10])
def test_dim_reduction_and_pca_bitwise(m):
    Qx, Qy, X = _data(m)
    Sx = np.asarray(ref_dist.second_moment(X), np.float64)
    for got, want in ((tr.make_dim_reduction(Sx, Qy, m), ref_tr.make_dim_reduction(Sx, Qy, m)),
                      (tr.make_pca(Sx, m), ref_tr.make_pca(Sx, m))):
        for f in ("U", "P", "eigenvalues", "left_out"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        Z = tr.dr_encode(got, torch.from_numpy(X))
        _close(Z.numpy(), ref_tr.dr_encode(want, X))
        _close(tr.dr_decode(got, Z).numpy(), ref_tr.dr_decode(want, ref_tr.dr_encode(want, X)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_eq6_equals_eq7_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    n, d = 50, 6
    X, Xh, Y = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(3))
    Xt, Xht, Yt = map(torch.from_numpy, (X, Xh, Y))
    a = float(dist.distortion_pairwise(Xt, Xht, Yt))
    b = float(dist.distortion_quadratic(Xt, Xht, dist.second_moment(Yt)))
    assert a == pytest.approx(b, rel=1e-4)
    assert a == pytest.approx(float(ref_dist.distortion_pairwise(X, Xh, Y)), rel=TOL)
    assert b == pytest.approx(
        float(ref_dist.distortion_quadratic(X, Xh, ref_dist.second_moment(Y))), rel=TOL)


@pytest.mark.parametrize("R", [3.0, 24.0, 48.0])
def test_optimal_scheme_channel_and_roundtrip(monkeypatch, R):
    monkeypatch.setattr(rd, "channel_noise", _ref_key_noise)
    Qx, Qy, X = _data(2)
    got, want = schemes.OptimalScheme(R).fit(Qx, Qy), ref_schemes.OptimalScheme(R).fit(Qx, Qy)
    np.testing.assert_array_equal(got.channel.A, want.channel.A)
    np.testing.assert_array_equal(got.channel.W_half, want.channel.W_half)
    assert got.expected_distortion == want.expected_distortion
    n, d = X.shape
    assert got.wire_bits(n) == want.wire_bits(n) and type(got.wire_bits(n)) is int
    assert got.side_info_bits(d) == want.side_info_bits(d)
    _close(got.roundtrip(torch.from_numpy(X), 7).numpy(),
           want.roundtrip(X, jax.random.PRNGKey(7)))


@pytest.mark.parametrize("cls", ["DimReductionScheme", "PCAScheme"])
@pytest.mark.parametrize("m", [1, 3, 6])
def test_projection_schemes_roundtrip_and_ledgers(cls, m):
    Qx, Qy, X = _data(3)
    got = getattr(schemes, cls)(m).fit(Qx, Qy)
    want = getattr(ref_schemes, cls)(m).fit(Qx, Qy)
    assert got.expected_distortion == want.expected_distortion
    _close(got.roundtrip(torch.from_numpy(X)).numpy(), want.roundtrip(X))
    n, d = X.shape
    assert got.wire_bits(n) == want.wire_bits(n) == 16 * (m * n + m * d)
    assert got.side_info_bits(d) == want.side_info_bits(d)


def _near_edge(xp, sigma, rates, edges_table, ulps=2):
    """(n, d) bool: symbols within ``ulps`` ulp of one of their scaled edges."""
    sc = (edges_table[rates] * sigma[:, None]).astype(np.float32)
    fin = np.isfinite(sc)
    gap = np.abs(xp[:, :, None] - np.where(fin, sc, 0)[None])
    ulp = np.spacing(np.abs(np.where(fin, sc, 0))).astype(np.float32)
    return ((gap <= ulps * ulp[None]) & fin[None]).any(-1)


@pytest.mark.parametrize("R", [8, 30, 60])
def test_per_symbol_roundtrip(R):
    Qx, Qy, X = _data(0)
    got, want = schemes.PerSymbolScheme(R).fit(Qx, Qy), ref_schemes.PerSymbolScheme(R).fit(Qx, Qy)
    np.testing.assert_array_equal(got.rates, want.rates)
    codes, ref_codes = got.encode(torch.from_numpy(X)).numpy(), np.asarray(want.encode(X))
    xp = (torch.from_numpy(X) @ torch.from_numpy(got._tr.T.astype(np.float32)).T).numpy()
    near = _near_edge(xp, got.sigma, got.rates, np.asarray(RQ.build_codebook_tables(
        int(got.rates.max()))[0]))
    flips = codes != ref_codes
    assert not (flips & ~near).any()
    same = ~flips.any(1)
    _close(got.roundtrip(torch.from_numpy(X)).numpy()[same], np.asarray(want.roundtrip(X))[same])


def _ref_rows(mod, **kw):
    ref_common.RESULTS.clear()
    mod.main(quick=True, **kw)
    return list(ref_common.RESULTS)


def _same_rows(got, want, keys):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for k in keys:
        scale = {}  # the column's largest value in each setting
        for w in want:
            scale[w["name"]] = max(scale.get(w["name"], 0.0), abs(w["derived"][k]))
        for g, w in zip(got, want):
            a, b = g["derived"][k], w["derived"][k]
            assert abs(a - b) <= TOL_ROWS * abs(b) + TOL * scale[w["name"]], (g, w, k)


def test_fig3_rows_match_the_reference_script():
    got = fig3_pca.main(quick=True, device="cpu")
    want = _ref_rows(ref_fig3)
    _same_rows(got, want, ("m", "proposed", "pca", "ratio"))
    for r in got:  # Theorem 3: never worse than PCA under (7); ties allowed
        assert r["derived"]["proposed"] <= 1.01 * r["derived"]["pca"]
        assert r["ledger"]["side_info_bits"][1] == 0


def test_fig2_rows_match_the_reference_script(monkeypatch):
    monkeypatch.setattr(rd, "channel_noise", _ref_key_noise)
    got = fig2_distortion.main(quick=True, device="cpu")
    want = [r for r in _ref_rows(ref_fig2) if r["name"] == "fig2"]
    _same_rows(got, want, ("bits", "lb", "opt", "per_symbol", "dim_red", "zero_rate"))
    Qx, Qy, _ = fig2_distortion.gaussian_setting(np.random.default_rng(0), 20, 4000)
    for r in got:
        R = r["derived"]["bits"]
        assert r["ledger"]["rates"] == ref_schemes.PerSymbolScheme(R).fit(Qx, Qy).rates.tolist()
        assert r["ledger"]["wire_bits"][1] == R * 4000
    # the paper's Fig. 2 ordering at the reference test's margins, from R = 20
    for r in got[2:]:
        e = r["derived"]
        assert e["opt"] <= 1.05 * e["per_symbol"] and e["per_symbol"] < e["dim_red"]


def test_ablation_rows_and_allocations_match_the_reference():
    got = ablation_bits.main(quick=True, device="cpu")
    want = _ref_rows(ref_ablation)
    _same_rows(got, want, ("R", "greedy", "uniform", "waterfill_rounded"))
    Qx, Qy, X = fig2_distortion.gaussian_setting(np.random.default_rng(0), 20, 4000)
    t = ref_tr.make_decorrelating_transform(Qx, Qy)
    lam = np.maximum(t.variances, 0)
    flips = near_flips = 0
    for r in got:
        R = r["derived"]["R"]
        led = r["ledger"]
        assert led["greedy"] == RQ.allocate_bits_greedy(lam, R, 10).tolist()
        assert led["uniform"] == ref_ablation._alloc_uniform(lam, R, 10).tolist()
        assert led["waterfill_rounded"] == ref_ablation._alloc_waterfill_rounded(
            lam, R, 10).tolist()
        for rates in map(np.asarray, led.values()):
            codes = ablation_bits.codes(torch.from_numpy(X), t, rates).numpy()
            xp = X @ t.T.T.astype(np.float32)  # the reference's symbols (numpy fp32)
            edges = np.asarray(RQ.build_codebook_tables(int(max(rates.max(), 1)))[0])
            sigma = np.sqrt(lam).astype(np.float32)
            want_codes = np.asarray(RQ.quantize(jnp.asarray(xp), jnp.asarray(sigma),
                                                jnp.asarray(rates), edges))
            near = _near_edge(xp, sigma, rates, edges)
            flip = codes != want_codes
            assert not (flip & ~near).any()
            flips += int(flip.sum())
            near_flips += int(near.sum())
    assert flips <= near_flips


def test_scripts_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (fig2_distortion, fig3_pca, ablation_bits):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.main()
    assert base.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("mod", [fig2_distortion, fig3_pca, ablation_bits])
def test_cli_passes_full_and_device(monkeypatch, mod):
    calls = []
    monkeypatch.setattr(mod, "main", lambda **kw: calls.append(kw) or [])
    mod.cli(["--device", "cpu"])
    mod.cli(["--full", "--device", "cpu"])
    assert calls == [{"quick": True, "device": "cpu"}, {"quick": False, "device": "cpu"}]
