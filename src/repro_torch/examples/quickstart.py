"""Quickstart: the paper's machinery in a few dozen lines, on the port —
counterpart of the repository's ``examples/quickstart.py``.

1. Two 'machines' hold Gaussian datasets X and Y.
2. Machine M_x compresses X with the per-symbol scheme (§4.2) at a few
   bits/sample and 'transmits' int codes.
3. Machine M_y reconstructs X̂ and computes the cross gram matrix — compare
   its distortion to the Theorem-1 optimum and to PCA-style reduction.
4. Train a distributed GP across 8 machines and compare with BCM/rBCM.
5. Fit once / serve many: checkpoint the fitted protocol artifact, reload it,
   serve queries from cached factors, and stream new points in.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
(the CUDA card by default; PYTHONPATH=src if not installed).
"""
import argparse
import tempfile


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import (
        DGPConfig, DimReductionScheme, DistributedGP, PerSymbolScheme, split_machines,
        train_gp,
    )
    from repro_torch.core.distortion import distortion_quadratic
    from repro_torch.core.protocols.base import resolve_device
    from repro_torch.core.rate_distortion import distortion_for_rate

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    d, n = 16, 2000
    A = rng.normal(size=(d, d)); Qx = A @ A.T / d
    B = rng.normal(size=(d, d)); Qy = B @ B.T / d
    X = rng.multivariate_normal(np.zeros(d), Qx, size=n).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)

    R = 48  # bits per sample = 3 bits/dim
    print(f"== inner-product compression at {R} bits/sample ({R/d:.1f} bits/dim) "
          f"on {dev} ==")
    print(f"zero-rate distortion: {np.trace(Qx @ Qy):.4f}")
    print(f"theorem-1 optimum   : {distortion_for_rate(Qx, Qy, R):.4f}")

    ps = PerSymbolScheme(R).fit(Qx, Qy)
    codes = ps.encode(Xd)  # int codes — this is all that crosses the wire
    Xh = ps.decode(codes)
    d_ps = float(distortion_quadratic(Xd, Xh, Qy))
    print(f"per-symbol (§4.2)   : {d_ps:.4f} "
          f"({ps.wire_bits(n)} wire bits vs {32 * d * n} for fp32)")

    dr = DimReductionScheme(R // 16).fit(Qx, Qy)
    d_dr = float(distortion_quadratic(Xd, dr.roundtrip(Xd), Qy))
    print(f"dim-reduction (Thm3): {d_dr:.4f}")

    print("\n== distributed GP regression, 8 machines ==")
    W = rng.normal(size=(d, 2))
    f = lambda Z: np.sin(Z @ W[:, 0]) + 0.4 * (Z @ W[:, 1])
    y = (f(X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    Xt = rng.multivariate_normal(np.zeros(d), Qx, size=400).astype(np.float32)
    yt = f(Xt)
    sm = lambda mu: float(np.mean((yt - mu.detach().cpu().numpy()) ** 2) / np.var(yt))

    full = train_gp(Xd[:600], torch.from_numpy(y[:600]).to(dev), kernel="se", steps=100)
    smse = {"full": sm(full.predict(torch.from_numpy(Xt).to(dev))[0])}
    print(f"full GP           smse={smse['full']:.4f}")
    parts = split_machines(X[:600], y[:600], 8, torch.Generator().manual_seed(0))
    # one validated config per protocol point — everything else is est.fit/predict
    for method in ("bcm", "rbcm"):
        est = DistributedGP(DGPConfig(protocol="poe", fusion=method, bits_per_sample=0,
                                      gram_mode="dense", steps=100), device=dev)
        mu, _ = est.predict(est.fit(parts=parts), Xt)
        smse[method] = sm(mu)
        print(f"{method:5s} (zero rate) smse={smse[method]:.4f}")
    for bits in (8, 32, 64):
        est = DistributedGP(DGPConfig(protocol="center", bits_per_sample=bits,
                                      gram_mode="direct", steps=100), device=dev)
        m = est.fit(parts=parts)
        smse[f"R{bits}"] = sm(est.predict(m, Xt)[0])
        print(f"quantized GP R={bits:3d} smse={smse[f'R{bits}']:.4f} "
              f"(wire {m.wire_bits/1e3:.0f} kbit)")

    print("\n== fit once / serve many ==")
    # est.fit already returned the serving artifact: checkpoint it, reload and
    # serve — predictions from the loaded copy are bitwise identical
    with tempfile.TemporaryDirectory() as ckpt_dir:
        est.save(m, ckpt_dir)
        served = est.load(ckpt_dir)   # meta.json carries the DGPConfig
    mu0, _ = est.predict(served, Xt)
    smse["loaded"] = sm(mu0)
    print(f"loaded artifact     smse={smse['loaded']:.4f} (bitwise-identical serve, "
          f"{served.wire_bits/1e3:.0f} kbit ledger)")
    # stream 50 new points into machine 3: its FROZEN codebook re-encodes only
    # the new symbols; factors grow by rank-k updates — no refit anywhere
    Xn = rng.multivariate_normal(np.zeros(d), Qx, size=50).astype(np.float32)
    yn = (f(Xn) + 0.05 * rng.normal(size=50)).astype(np.float32)
    served = est.update(served, Xn, yn, machine=3)
    smse["updated"] = sm(est.predict(served, Xt)[0])
    print(f"after update(+50)   smse={smse['updated']:.4f} "
          f"(ledger {served.wire_bits/1e3:.0f} kbit)")
    return {"distortion": {"per_symbol": d_ps, "dim_reduction": d_dr,
                           "optimum": distortion_for_rate(Qx, Qy, R),
                           "zero_rate": float(np.trace(Qx @ Qy))},
            "smse": smse}


if __name__ == "__main__":
    main()
