"""End-to-end run of the paper's §6 experiment on the port: SARCOS-scale
distributed GP regression, 1000 points over 40 machines, single-center and
broadcast protocols against BCM/rBCM at several wire rates — counterpart of
the repository's ``examples/distributed_gp_sarcos.py``.

Run:  python -m repro_torch.examples.distributed_gp_sarcos [--machines 40]
      [--data-dir DIR] [--device cpu]

With ``--data-dir`` the real ``sarcos.npz`` there is read; otherwise the
port's SARCOS-shaped synthetic data (``repro_torch.data``) is used.
Nothing is downloaded.
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.distributed_gp_sarcos")
    ap.add_argument("--machines", type=int, default=40)
    ap.add_argument("--kernel", default="se", choices=["se", "linear"])
    ap.add_argument("--rates", type=int, nargs="+", default=[8, 21, 42, 84])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--data-dir", default=None, help="directory with sarcos.npz (real data)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import (
        broadcast_gp, poe_baseline, single_center_gp, split_machines, train_gp,
    )
    from repro_torch.core.protocols.base import resolve_device
    from repro_torch.data.synthetic import regression_dataset

    dev = resolve_device(args.device)
    X, y, Xt, yt = regression_dataset("sarcos", data_dir=args.data_dir)
    Xt, yt = Xt[:500], yt[:500]
    d = X.shape[1]
    sm = lambda mu: float(np.mean((yt - mu.detach().cpu().numpy()) ** 2) / np.var(yt))
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    print(f"SARCOS-scale: n={X.shape[0]} d={d} machines={args.machines} "
          f"kernel={args.kernel} on {dev}")
    full = train_gp(to(X), to(y), kernel=args.kernel, steps=args.steps)
    smse = {"full": sm(full.predict(to(Xt))[0])}
    print(f"full GP (all data at center)      smse={smse['full']:.4f}")

    parts = split_machines(X, y, args.machines, torch.Generator().manual_seed(0))
    for method in ("poe", "bcm", "rbcm"):
        mu, _, _ = poe_baseline(parts, Xt, kernel=args.kernel, method=method,
                                steps=args.steps, device=dev)
        smse[method] = sm(mu)
        print(f"{method:4s} (zero-rate baseline)         smse={smse[method]:.4f}")

    wire = {}
    for R in args.rates:
        m = single_center_gp(parts, R, kernel=args.kernel, steps=args.steps,
                             gram_mode="direct", device=dev)
        mu, _ = m.predict(Xt)
        smse[f"center R{R}"], wire[f"center R{R}"] = sm(mu), m.wire_bits
        print(f"single-center R={R:3d} ({R/d:4.1f} b/dim) smse={sm(mu):.4f} "
              f"wire={m.wire_bits/1e3:.0f} kbit")
        mu, s2, bits, _ = broadcast_gp(parts, R, Xt, kernel=args.kernel, steps=args.steps,
                                       gram_mode="direct", device=dev)
        smse[f"broadcast R{R}"], wire[f"broadcast R{R}"] = sm(mu), bits
        print(f"broadcast     R={R:3d} ({R/d:4.1f} b/dim) smse={sm(mu):.4f} "
              f"wire={bits/1e3:.0f} kbit")
    return {"smse": smse, "wire_bits": wire}


if __name__ == "__main__":
    main()
