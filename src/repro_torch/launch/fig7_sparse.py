"""Paper Fig. 7 on the port: a sparse GP with quantized inducing inputs
(single center) on KIN40K-shaped data, the paper's remedy for the very-low-
rate regime ("transmit fewer samples at acceptable quality") — counterpart
of ``benchmarks/fig7_sparse.py``.

  python -m repro_torch.launch.fig7_sparse [--full] [--device cpu] \\
      [--gram-backend pallas|xla] [--data-dir DIR]

Protocol: each machine trains Titsias inducing points locally, quantizes the
inducing inputs Z_j with the per-symbol scheme fitted against the center's
second moment, and ships them with its variational summary q(u_j) =
N(m_j, diag S_j) (16 bits a float).  The center treats the pooled pseudo-
points as heteroscedastic observations (noise S_i) of one GP, its own raw
block entering exactly with the trained noise, and serves the posterior.
The zero-rate rBCM baseline is the first row.  The paper's claim: at low
bits a sample this beats the non-sparse quantized model (Fig. 6) and the
PoE baselines.

Everything runs on ``device`` (the card unless the caller names another);
under ``--gram-backend pallas`` (the default) every gram goes through the
``gram`` kernel: the rBCM's own blocks and requests, the local SGPRs'
training (all machines of one shard size in one batch: two launches
forward and three backward an Adam step), their q(u), and at each R the
center's pseudo-point gram and its test cross-gram.  Machines are split by
the seeded numpy split (:func:`~.common.machine_parts`); machine j's
inducing rows start from ``inducing_init`` seeded 100 + j, as the
reference keys ``PRNGKey(100 + j)``.  Quick by default (10 machines, 10
inducing points, 120 steps, 300 test points, R in {2, 4, 8, 16, 32});
``--full`` is the paper's setting (``configs/gp_paper.py`` FIG7: 40
machines, 15 inducing points, 250 steps, 2000 test points, R = 1..64).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.gp_paper import FIG7
from ..core.distortion import second_moment
from ..core.gp import GPParams, gram_fn, posterior_apply, posterior_factors, prior_diag
from ..core.protocols.base import resolve_device
from ..core.protocols.poe import poe_baseline
from ..core.schemes import PerSymbolScheme
from ..core.sparse_gp import train_sgpr
from ..data.synthetic import regression_dataset
from .common import emit, machine_parts, smse, sync

__all__ = ["fit_locals", "center_posterior", "main", "cli"]


def fit_locals(parts, n_inducing: int, steps: int, gram_backend: str, device,
               seed: int = 100):
    """Every machine's local SGPR, trained on ``device``: machine 0's
    hyperparameters (the center's) and ``[(Z_j, m_u_j, s_u_j), ...]`` in
    machine order (the inducing inputs and q(u)).  Each run of machines of
    one shard size trains as one batch; machine j's inducing rows start
    from seed ``seed + j``."""
    out, p0, j = [], None, 0
    while j < len(parts):
        end = j + 1
        while end < len(parts) and len(parts[end][0]) == len(parts[j][0]):
            end += 1
        X = torch.from_numpy(np.stack([p[0] for p in parts[j:end]])).to(device)
        y = torch.from_numpy(np.stack([p[1] for p in parts[j:end]])).to(device)
        sg = train_sgpr(X, y, n_inducing, kernel=FIG7.kernel, steps=steps, seed=seed + j,
                        gram_backend=gram_backend)
        m_u, s_u = sg.qu()
        if p0 is None:
            p0 = GPParams(*(a[0] for a in sg.params))
        out += [(sg.Z[b], m_u[b], s_u[b]) for b in range(end - j)]
        j = end
    return p0, out


def center_posterior(parts, p0, locals_, R: int, gram_backend: str, device):
    """The center's posterior factors over its own exact block (noise: the
    trained sigma^2) and the peers' pseudo-points quantized at R bits a
    sample (noise: their q(u) variances): ``(Z_all, factors, wire_bits,
    rates)``, with ``rates`` each peer's per-symbol allocation."""
    X0 = torch.from_numpy(parts[0][0]).to(device)
    y0 = torch.from_numpy(parts[0][1]).to(device)
    d = X0.shape[1]
    S_c = second_moment(X0).cpu().double().numpy()
    Zs, mus = [X0], [y0]
    noise = [torch.exp(p0.log_noise).expand(X0.shape[0])]
    wire, rates = 0, []
    for Z, m_u, s_u in locals_[1:]:
        Qz = np.cov(Z.cpu().double().numpy().T) + 1e-4 * np.eye(d)
        sch = PerSymbolScheme(R).fit(Qz, S_c)
        Zs.append(sch.roundtrip(Z))
        rates.append(sch.rates.tolist())
        wire += sch.wire_bits(Z.shape[0]) + sch.side_info_bits(d)
        wire += 2 * Z.shape[0] * 16  # m_u and S_u at 16 bits each
        mus.append(m_u)
        noise.append(s_u)
    Z_all = torch.cat(Zs)
    G = gram_fn(FIG7.kernel, gram_backend)(p0, Z_all)
    return Z_all, posterior_factors(G, torch.cat(mus), torch.cat(noise)), wire, rates


def main(quick: bool = True, device=None, data_dir: str | None = None, seed: int = 0,
         gram_backend: str = "pallas") -> list:
    dev = resolve_device(device)
    X, y, Xt, yt = regression_dataset(FIG7.dataset, data_dir=data_dir)
    n_test = 300 if quick else 2000
    Xt, yt = torch.from_numpy(Xt[:n_test]).to(dev), yt[:n_test]
    m_machines = 10 if quick else FIG7.n_machines
    n_inducing = 10 if quick else 15
    steps = 120 if quick else 250
    parts = machine_parts(X, y, m_machines, seed)

    rows = []
    mu, _, _ = poe_baseline(parts, Xt, kernel=FIG7.kernel, method="rbcm", steps=steps,
                            gram_backend=gram_backend, device=dev)
    rows.append(emit("fig7", 0.0, model="rbcm", R=0, smse=smse(yt, mu.cpu().numpy())))

    # the machines' local sparse GPs (the communication-free part)
    p0, locals_ = fit_locals(parts, n_inducing, steps, gram_backend, dev)
    sq_t = torch.sum(Xt**2, -1)
    k = gram_fn(FIG7.kernel, gram_backend)
    for R in ([2, 4, 8, 16, 32] if quick else list(FIG7.rates)):
        sync()
        t0 = time.perf_counter()
        Z_all, factors, wire, rates = center_posterior(parts, p0, locals_, R, gram_backend, dev)
        sync()
        us = (time.perf_counter() - t0) * 1e6
        mu, _ = posterior_apply(factors, k(p0, Xt, Z_all), prior_diag(FIG7.kernel, p0, sq_t))
        row = emit("fig7", us, model="sparse_quantized", R=R, smse=smse(yt, mu.cpu().numpy()),
                   wire_kbits=wire / 1e3)
        row["ledger"] = {"rates": rates, "wire_bits": wire}
        rows.append(row)
    return rows


def cli(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the paper's setting")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--gram-backend", default="pallas", choices=["pallas", "xla"],
                    help="pallas: the gram kernel (its plain version on the CPU)")
    ap.add_argument("--data-dir", default=None,
                    help="a directory holding kin40k.npz (default: the synthetic data)")
    a = ap.parse_args(argv)
    return main(quick=not a.full, device=a.device, data_dir=a.data_dir,
                gram_backend=a.gram_backend)


if __name__ == "__main__":
    cli()
