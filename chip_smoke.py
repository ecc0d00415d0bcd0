#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero (nothing is caught and turned
into a pass):

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the four Hopper kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel): build time, registers and shared memory
   per kernel.
3. Each kernel (and the gram backward) against its plain PyTorch version on
   the card — at the main paths' shapes, one larger shape at the same width
   (40 machines x 1000 rows, d = 21, 4449 queries) and the edge layouts
   (R = 24 and R = 100 words, width-0 dims, masked rows, ragged tiles; for
   the epilogue all six fusion forms, ragged t and K, a large K, an expert
   of weight 0 and variances at their 1e-12 floor; for the fleet epilogue
   all six fusion forms at a fleet flush, a ragged case and serve-sized
   requests, each tenant also against the single-tenant kernel) — with the
   max abs / relative error against the stated tolerance, and the device
   time of the kernel, the plain version and ``torch.matmul`` where it
   applies.
4. The paths at the paper's Fig. 6 SARCOS setting (N = 1000, d = 21,
   m = 40, SE kernel, R = 24 bits/sample, 150 Adam steps, 4449 test points
   in 35 batches of 128), each on the card with ``gram_backend="pallas"``
   and its launch counts read from zero:
   a. §5.1 center: fit, save, load, serve.  Checks: ``gram`` and
      ``qgram_packed`` launched during the fit and ``gram`` on every
      request; the loaded artifact's answers bitwise equal to the pre-save
      ones; the same checkpoint served on the CPU (plain versions) within
      tolerance; a finite SMSE below 1.
   b. §5.2 broadcast (KL fusion): the same, with ``gram`` and
      ``qgram_packed`` launched during the fit and ``gram`` and
      ``epilogue`` exactly once per request.
   c. the zero-rate rBCM baseline (``protocol="poe"``): fit and serve
      through ``gram``; its SMSE beside the other two.
   d. multi-tenant fleet serving: 64 tenants, exact y-scaled variants of
      b's artifact, in an ``ArtifactStore``; a ``FleetServer`` (cache 32
      artifacts, flush width 16, 32 stack slots, 2 ms budget) serves 512
      zipf(1.1) requests of 16 test points after a warm pass.  Checks:
      one ``epilogue_fleet`` launch per fused flush (and no single-tenant
      ``epilogue``), no stacked tensor reallocated in the steady state, a
      stacked flush equal to the serial ``predict`` of each tenant within
      the epilogue's rounding bound, and bitwise tenant isolation under a
      neighbour's NaN request and degraded mask; the serial-vs-stacked q/s
      on 16 resident tenants is printed.
5. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the repository's ``src/repro_torch`` beside it,
the script fails before printing any result.  It imports nothing of JAX.
"""
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
TOL = 1e-5  # of max(|A| |B|^T): fp32 sums in different orders, no TF32
U32 = 2.0 ** -24  # fp32 unit roundoff


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import DGPConfig, DistributedGP
    from repro_torch.core import torch_scheme as TS
    from repro_torch.core.fleet import artifact_nbytes
    from repro_torch.core.gp import kernel_from_inner, prior_diag
    from repro_torch.core.protocols.base import split_machines
    from repro_torch.core.protocols.broadcast import (
        _epilogue_projector, _expert_cross_gram, _fused_epilogue_operands,
    )
    from repro_torch.core.registry import FUSIONS
    from repro_torch.data.synthetic import regression_dataset
    from repro_torch.kernels import build, runtime
    from repro_torch.kernels.gram.ops import gram, gram_cuda, gram_plain
    from repro_torch.kernels.qgram.ops import qgram_packed_cuda, qgram_packed_plain
    from repro_torch.kernels.epilogue.cases import epilogue_fleet_operands, epilogue_operands
    from repro_torch.kernels.epilogue.ops import (
        epilogue_cuda, epilogue_fleet_cuda, epilogue_moments, plan, plan_fleet,
    )
    from repro_torch.kernels.epilogue.ref import (
        EPILOGUE_FUSES, epilogue_error_bound, epilogue_fleet_error_bound,
        epilogue_moments_fleet_plain, epilogue_moments_plain,
    )
    from repro_torch.launch.fleet import FleetServer, build_fleet, serve_loop, zipf_tenants

    dev = torch.device("cuda")

    # ---- 1. versions and the card ----------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s for {', '.join(libs)} "
          f"into {build.build_dir()}", flush=True)
    for b in libs.values():
        for line in b.ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {b.name}: {line.strip()}", flush=True)

    # ---- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator().manual_seed(0)
    results = {"gram": [], "qgram_packed": [], "epilogue": [], "epilogue_fleet": []}

    def device_ms(fn, reps):
        """Device time per call: ``reps`` calls captured in a CUDA graph,
        replayed and timed with CUDA events (host overhead excluded)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        iters = 5
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (iters * reps)
        del graph
        torch.cuda.empty_cache()
        return ms

    def compare(name, tag, got, want, scale):
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        tol = TOL * max(1.0, scale)
        rel = err / max(1e-30, float(want.abs().max())) if want.numel() else 0.0
        print(f"[kernel] {name:13s} {tag:44s} max_abs_err {err:.3e} "
              f"rel {rel:.3e} tol {tol:.3e}", flush=True)
        check(torch.isfinite(got).all().item(), f"{name} {tag}: non-finite output")
        check(err <= tol, f"{name} {tag}: error {err:.3e} above tolerance {tol:.3e}")
        return err

    def bound(nbytes, flops):
        t_b, t_f = nbytes / HBM_BYTES * 1e3, flops / FP32_FLOPS * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    def gram_case(tag, n, p, d, reps, timed=True, backward=True):
        x = torch.randn(n, d, generator=gen).to(dev)
        y = torch.randn(p, d, generator=gen).to(dev)
        scale = float((x.abs() @ y.abs().T).max())
        err = compare("gram", tag, gram_cuda(x, y), gram_plain(x, y), scale)
        row = {"tag": tag, "err": err}
        if backward:
            g = torch.randn(n, p, generator=gen).to(dev)
            xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
            gram(xr, yr).backward(g)
            err_b = max(
                compare("gram", tag + " bwd dX", xr.grad, g @ y,
                        float((g.abs() @ y.abs()).max())),
                compare("gram", tag + " bwd dY", yr.grad, g.T @ x,
                        float((g.abs().T @ x.abs()).max())),
            )
            row["err_bwd"] = err_b
        if timed:
            row["ms"] = device_ms(lambda: gram_cuda(x, y), reps)
            row["plain_ms"] = device_ms(lambda: gram_plain(x, y), reps)
            row["library_ms"] = device_ms(lambda: torch.matmul(x, y.T), reps)
            row["bound_ms"], row["bound_by"] = bound(4 * (n * d + p * d + n * p),
                                                     2 * n * p * d)
            msg = (f"[time]   gram          {tag:44s} kernel {row['ms']:.4f} ms  "
                   f"plain {row['plain_ms']:.4f} ms  torch.matmul "
                   f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                   f"({row['bound_by']})")
            if backward:
                bwd = lambda: (gram_cuda(g, y.T), gram_cuda(g.T, x.T))
                row["bwd_ms"] = device_ms(bwd, reps)
                row["bwd_library_ms"] = device_ms(lambda: (g @ y, g.T @ x), reps)
                # dX = g Y and dY = g^T X: read g, X, Y once, write dX, dY
                row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
                    4 * (n * p + 2 * n * d + 2 * p * d), 4 * n * p * d)
                msg += (f"  | bwd kernel {row['bwd_ms']:.4f} ms  torch.matmul "
                        f"{row['bwd_library_ms']:.4f} ms  bound {row['bwd_bound_ms']:.7f} ms "
                        f"({row['bwd_bound_by']})")
            print(msg, flush=True)
        results["gram"].append(row)
        return row

    def packed_inputs(m, n, d, p, R, zero_dims=(), mask_frac=0.0, cap=12):
        rates = torch.zeros(m, d, dtype=torch.int64)
        live = torch.tensor([j for j in range(d) if j not in zero_dims])
        for _ in range(R):  # one bit at a time to a random live dim, capped
            j = live[torch.randint(len(live), (m,), generator=gen)]
            rates[torch.arange(m), j] = torch.clamp(rates[torch.arange(m), j] + 1, max=cap)
        codes = (torch.rand(m, n, d, generator=gen) * (2.0 ** rates[:, None, :])).long()
        words = TS.pack_codes(codes, rates, total_bits=R)
        cents = torch.randn(m, d, 2**cap, generator=gen)
        proj = torch.randn(m, p, d, generator=gen)
        mask = (torch.rand(m, n, generator=gen) >= mask_frac).float()
        return [t.to(dev) for t in (words, rates.int(), cents, proj, mask)]

    def qgram_case(tag, m, n, d, p, R, reps, timed=True, **kw):
        words, rates, cents, proj, mask = packed_inputs(m, n, d, p, R, **kw)
        got = qgram_packed_cuda(words, rates, cents, proj, total_bits=R, mask=mask)
        want = qgram_packed_plain(words, rates, cents, proj, total_bits=R, mask=mask)
        codes = TS.unpack_codes(words, rates, total_bits=R)
        from repro_torch.kernels.qgram.ref import decode_gathered

        xhat = decode_gathered(codes, cents) * mask[..., None]
        scale = float((xhat.abs() @ proj.abs().transpose(-1, -2)).max())
        row = {"tag": tag, "err": compare("qgram_packed", tag, got, want, scale)}
        if timed:
            row["ms"] = device_ms(lambda: qgram_packed_cuda(
                words, rates, cents, proj, total_bits=R, mask=mask), reps)
            row["plain_ms"] = device_ms(lambda: qgram_packed_plain(
                words, rates, cents, proj, total_bits=R, mask=mask), reps)
            row["matmul_ms"] = device_ms(
                lambda: torch.matmul(xhat, proj.transpose(-1, -2)), reps)
            row["library_ms"] = None  # no single PyTorch call unpacks + decodes
            # bytes this run's data needs: the words, the meta, the centroid
            # entries the valid rows look up (each distinct one once), the
            # projection, the mask and the output
            b = torch.arange(m, device=dev)[:, None, None].expand_as(codes)
            j = torch.arange(d, device=dev)[None, None, :].expand_as(codes)
            looked_up = torch.unique(((b * d + j) * cents.shape[-1] + codes)[mask > 0])
            nbytes = 4 * (words.numel() + rates.numel() + looked_up.numel()
                          + proj.numel() + mask.numel() + m * n * p)
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * p * d)
            print(f"[time]   qgram_packed  {tag:44s} kernel {row['ms']:.4f} ms  "
                  f"plain {row['plain_ms']:.4f} ms  torch.matmul(x̂, proj) "
                  f"{row['matmul_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                  f"({row['bound_by']})", flush=True)
        results["qgram_packed"].append(row)
        return row

    main_gram = gram_case("serve: X* (128x21) . Xc (25x21)", 128, 25, 21, 200)
    gram_case("fit: Xc (25x21) . Xc (25x21)", 25, 25, 21, 200)
    gram_case("larger: 4449 queries . 40000 rows, d=21", 4449, 40000, 21, 3)
    gram_case("ragged: 130x70, d=50", 130, 70, 50, 50, timed=False)
    gram_case("ragged: 1x1, d=1", 1, 1, 1, 50, timed=False)
    main_qgram = qgram_case("fit: 39 machines x 25 rows, p=25, R=24 (W=1)",
                            39, 25, 21, 25, 24, 200)
    qgram_case("larger: 40 x 1000 rows, p=4449, R=24", 40, 1000, 21, 4449, 24, 3)
    qgram_case("R=100 (W=4, straddling codes)", 39, 25, 21, 25, 100, 50)
    qgram_case("width-0 dims + masked rows, R=24", 3, 70, 21, 45, 24, 50,
               timed=False, zero_dims=(0, 5, 20), mask_frac=0.3)
    qgram_case("ragged tiles n=37 p=11 d=8, R=100, masked", 2, 37, 8, 11, 100, 50,
               timed=False, zero_dims=(7,), mask_frac=0.2)
    qgram_case("R=7, width-0 dim", 4, 33, 21, 17, 7, 50, timed=False, zero_dims=(2,))

    def epilogue_case(tag, m, t, K, fuses, reps, **kw):
        ops = epilogue_operands(m, t, K, seed=m + t + K, device=dev, **kw)
        rows = []
        for fuse in fuses:
            got = epilogue_cuda(*ops, fuse=fuse)
            again = epilogue_cuda(*ops, fuse=fuse)
            want = epilogue_moments_plain(*ops, fuse=fuse)
            tol_rows = epilogue_error_bound(*ops, fuse=fuse)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = float(((got - want).abs() / tol_rows).max())
            print(f"[kernel] epilogue      {tag + ' ' + fuse:44s} max_abs_err {err:.3e} "
                  f"worst err/bound {worst:.3e}", flush=True)
            check(bool(torch.isfinite(got).all()), f"epilogue {tag} {fuse}: non-finite output")
            check(torch.equal(got, again), f"epilogue {tag} {fuse}: two launches differ")
            check(worst <= 1.0, f"epilogue {tag} {fuse}: error above epilogue_error_bound")
            row = {"tag": f"{tag} {fuse}", "err": err}
            row["ms"] = device_ms(lambda: epilogue_cuda(*ops, fuse=fuse), reps)
            row["plain_ms"] = device_ms(lambda: epilogue_moments_plain(*ops, fuse=fuse), reps)
            row["library_ms"] = None  # no single PyTorch call computes it
            nbytes = 4 * (m * t * K + 2 * m * K * K + m * K + 2 * t + m + 3 * t)
            row["bound_ms"], row["bound_by"] = bound(nbytes, m * t * (4 * K * K + 4 * K + 6))
            print(f"[time]   epilogue      {tag + ' ' + fuse:44s} kernel {row['ms']:.4f} ms  "
                  f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                  f"({row['bound_by']})", flush=True)
            results["epilogue"].append(row)
            rows.append(row)
        return rows

    main_epi = epilogue_case("serve: m=40 t=128 K=25", 40, 128, 25, EPILOGUE_FUSES, 200)
    epilogue_case("larger: m=40 t=4449 K=25", 40, 4449, 25, ("kl", "rbcm"), 20)
    epilogue_case("ragged: m=40 t=37 K=19", 40, 37, 19, ("kl", "rbcm"), 50)
    epilogue_case("large K: m=40 t=130 K=300", 40, 130, 300, ("kl", "rbcm"), 20,
                  kind="generic")
    epilogue_case("w zeros + floored s2: m=40 t=128 K=25", 40, 128, 25, EPILOGUE_FUSES,
                  50, floored=(0, 7, 127), lost=(3, 17, 39))
    epilogue_case("ragged + w zeros + floors: m=5 t=37 K=19", 5, 37, 19,
                  EPILOGUE_FUSES, 50, floored=(0, 36), lost=(1,))

    def fleet_case(tag, T, m, t, K, fuses, reps, **kw):
        ops = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, device=dev, **kw)
        same_plan = plan_fleet(T, m, t, K) == plan(m, t, K)
        rows = []
        for fuse in fuses:
            got = epilogue_fleet_cuda(*ops, fuse=fuse)
            again = epilogue_fleet_cuda(*ops, fuse=fuse)
            want = epilogue_moments_fleet_plain(*ops, fuse=fuse)
            tol_rows = epilogue_fleet_error_bound(*ops, fuse=fuse)
            # each tenant against the single-tenant kernel on its operands:
            # the same bits where both plan the same tile and expert groups,
            # else both within the bound of the plain version
            single = torch.stack([epilogue_cuda(*(a[n] for a in ops), fuse=fuse)
                                  for n in range(T)])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = float(((got - want).abs() / tol_rows).max())
            worst_single = float(((got - single).abs() / (2 * tol_rows)).max())
            print(f"[kernel] epilogue_fleet {tag + ' ' + fuse:43s} max_abs_err {err:.3e} "
                  f"worst err/bound {worst:.3e}  vs single-tenant kernel: "
                  f"{'same bits' if torch.equal(got, single) else f'worst/(2 bound) {worst_single:.3e}'}",
                  flush=True)
            check(bool(torch.isfinite(got).all()), f"epilogue_fleet {tag} {fuse}: non-finite output")
            check(torch.equal(got, again), f"epilogue_fleet {tag} {fuse}: two launches differ")
            check(worst <= 1.0, f"epilogue_fleet {tag} {fuse}: error above the per-tenant bound")
            check(torch.equal(got, single) if same_plan else worst_single <= 1.0,
                  f"epilogue_fleet {tag} {fuse}: a tenant disagrees with the single-tenant kernel")
            row = {"tag": f"{tag} {fuse}", "err": err}
            row["ms"] = device_ms(lambda: epilogue_fleet_cuda(*ops, fuse=fuse), reps)
            row["plain_ms"] = device_ms(lambda: epilogue_moments_fleet_plain(*ops, fuse=fuse),
                                        reps)
            row["library_ms"] = None  # no single PyTorch call computes it
            nbytes = 4 * T * (m * t * K + 2 * m * K * K + m * K + 2 * t + m + 3 * t)
            row["bound_ms"], row["bound_by"] = bound(nbytes, T * m * t * (4 * K * K + 4 * K + 6))
            print(f"[time]   epilogue_fleet {tag + ' ' + fuse:43s} kernel {row['ms']:.4f} ms  "
                  f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                  f"({row['bound_by']})", flush=True)
            results["epilogue_fleet"].append(row)
            rows.append(row)
        return rows

    main_fleet = fleet_case("flush: T=16 m=40 t=16 K=25", 16, 40, 16, 25, EPILOGUE_FUSES, 200)
    fleet_case("ragged + w zeros + floors: T=5 m=5 t=37 K=19", 5, 5, 37, 19, EPILOGUE_FUSES,
               50, floored=(0, 36), lost=(1,))
    fleet_case("serve-sized: T=8 m=40 t=128 K=25", 8, 40, 128, 25, ("kl", "rbcm"), 50)

    # ---- 4. the paths: Fig. 6 SARCOS, fit -> save -> load -> serve --------
    X_tr, y_tr, X_te, y_te = regression_dataset("sarcos", seed=0)
    parts = split_machines(X_tr, y_tr, 40, torch.Generator().manual_seed(0))
    batches = [X_te[i:i + 128] for i in range(0, X_te.shape[0], 128)]
    check(len(batches) == 35, f"expected 35 batches, got {len(batches)}")
    y_true = torch.from_numpy(y_te)
    path_launches = {}

    def smse_of(mu):
        return float(((mu.cpu() - y_true) ** 2).mean() / y_true.var(unbiased=False))

    def run_path(name, cfg, per_request, fit_kernels, roundtrip=True):
        """Fit on the card, then (optionally save and load and) serve the 35
        requests, with the launch counts read from zero.  ``per_request``:
        the kernels every request must launch exactly once."""
        est = DistributedGP(cfg)  # the card
        runtime.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = est.fit(parts=parts)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = runtime.launches()
        print(f"[{name}] fit {fit_s:.3f} s  launches {fit_launches}  ledgers wire "
              f"{art.wire_bits} payload {art.payload_bits} integrity "
              f"{art.integrity_bits}", flush=True)
        for k in fit_kernels:
            check(fit_launches[k] > 0, f"{name}: the fit did not launch {k}: {fit_launches}")
        ckpt = ROOT / "build" / f"chip_smoke_ckpt_{name}"
        served = [art]
        if roundtrip:
            shutil.rmtree(ckpt, ignore_errors=True)
            est.save(art, str(ckpt))
            served.append(est.load(str(ckpt)))
        answers = []
        for artifact in served:
            mus, vars_, times = [], [], []
            for xb in batches:
                before = runtime.launches()
                torch.cuda.synchronize()
                t = time.perf_counter()
                mu, var = est.predict(artifact, xb)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                after = runtime.launches()
                for k in per_request:
                    check(after[k] == before[k] + 1,
                          f"{name}: a request launched {k} {after[k] - before[k]} times, not once")
                mus.append(mu)
                vars_.append(var)
            answers.append((torch.cat(mus), torch.cat(vars_), times))
        launches = runtime.launches()
        path_launches[name] = launches
        mu, var, times = answers[-1]
        if roundtrip:
            check(torch.equal(answers[0][0], mu) and torch.equal(answers[0][1], var),
                  f"{name}: the loaded artifact's answers differ from the pre-save answers")
            print(f"[{name}] loaded artifact answers == pre-save answers (bitwise)", flush=True)
        smse = smse_of(mu)
        t_ms = np.array(times) * 1e3
        print(f"[{name}] SMSE {smse:.4f}  request p50 {np.percentile(t_ms, 50):.3f} ms  "
              f"p99 {np.percentile(t_ms, 99):.3f} ms  (35 x 128 queries, host clock)  "
              f"fit {fit_s:.3f} s  launches {launches}", flush=True)
        check(np.isfinite(smse) and smse < 1.0, f"{name}: SMSE {smse} is not finite and below 1")
        check(bool(torch.isfinite(var).all()) and bool((var > 0).all()),
              f"{name}: non-finite or non-positive predictive variances")
        return {"smse": smse, "fit_s": fit_s, "p50": float(np.percentile(t_ms, 50)),
                "p99": float(np.percentile(t_ms, 99)), "mu": mu, "var": var, "ckpt": ckpt,
                "art": served[-1]}

    def cpu_serve(cfg, ckpt):
        cpu_est = DistributedGP(cfg, device="cpu")
        cpu_art = cpu_est.load(str(ckpt))
        answers = [cpu_est.predict(cpu_art, xb) for xb in batches]
        return cpu_art, torch.cat([a[0] for a in answers]), torch.cat([a[1] for a in answers])

    def finalize_tol(spec, S, E, m, prior):
        """Per-query tolerances of (mu, var) from moment rows S known to
        within E: the largest change over the eight corners of S +- E
        carried through the fusion's finalize, plus 8 ulps for the
        finalize's own rounding."""
        mu0, var0 = spec.finalize(S, m, prior)
        tol_mu, tol_var = torch.zeros_like(mu0), torch.zeros_like(var0)
        for signs in itertools.product((-1.0, 1.0), repeat=3):
            shift = torch.tensor(signs, device=S.device)[:, None] * E
            mu_s, var_s = spec.finalize(S + shift, m, prior)
            tol_mu = torch.maximum(tol_mu, (mu_s - mu0).abs())
            tol_var = torch.maximum(tol_var, (var_s - var0).abs())
        return tol_mu + 8 * U32 * mu0.abs(), tol_var + 8 * U32 * var0.abs()

    def agree(name, mu_c, var_c, mu, var, tol_mu, tol_var):
        d_mu = (mu_c - mu.cpu()).abs()
        d_var = (var_c - var.cpu()).abs()
        print(f"[{name}] CPU plain serve vs card: mu max {float(d_mu.max()):.3e} "
              f"(worst/tol {float((d_mu / tol_mu).max()):.3e})  var max "
              f"{float(d_var.max()):.3e} (worst/tol {float((d_var / tol_var).max()):.3e})",
              flush=True)
        check(bool((d_mu <= tol_mu).all()) and bool((d_var <= tol_var).all()),
              f"{name}: the CPU serve of the same checkpoint disagrees with the card")

    # a. §5.1 center
    cfg_c = DGPConfig(gram_backend="pallas", steps=150, bits_per_sample=24)
    center = run_path("center", cfg_c, ("gram",), ("gram", "qgram_packed"))
    cpu_art, mu_c, var_c = cpu_serve(cfg_c, center["ckpt"])
    # Tolerance per query: the cached serve computes mu = B^T walpha and
    # var = g_ss - sum(B * (P B)) with B = Ainv G_sK^T and
    # P = (U - U M^{-1} U) / s2; both are fp32 sums whose rounding is
    # bounded by a few eps times the sum of the ABSOLUTE terms.  On this
    # checkpoint those magnitudes reach ~1e4 while var is ~1, so var cancels
    # heavily; 1e-5 x the magnitude is ~100 x the fp32 rounding (the
    # fp32-vs-fp64 error of the same formula on the CPU is <= 1.3e-7 x it).
    f, p = cpu_art.factors, cpu_art.params
    K = cpu_art.n_center
    Xq = torch.from_numpy(X_te)
    sq = (Xq**2).sum(-1)
    G_sK = kernel_from_inner(cfg_c.kernel, p, Xq @ cpu_art.data["Xc"].T, sq,
                             cpu_art.data["sq_cols"][:K])
    B = (f["Ainv"] @ G_sK.T).abs()
    MU = torch.cholesky_solve(f["U"], f["L_M"]).abs()
    s2 = torch.exp(p.log_noise) + 1e-6
    P_mag = (f["U"].abs() + f["U"].abs() @ MU) / s2
    agree("center", mu_c, var_c, center["mu"], center["var"],
          1e-5 * (B.T @ f["walpha"].abs()), 1e-5 * (B * (P_mag @ B)).sum(0))

    # b. §5.2 broadcast, KL fusion: gram + epilogue on every request
    cfg_b = DGPConfig(protocol="broadcast", fusion="kl", gram_backend="pallas",
                      steps=150, bits_per_sample=24)
    bcast = run_path("broadcast", cfg_b, ("gram", "epilogue"), ("gram", "qgram_packed"))
    cpu_art, mu_c, var_c = cpu_serve(cfg_b, bcast["ckpt"])
    # Tolerance per query: the CPU's fused operands and moment rows S with
    # epilogue_error_bound widened for what the two serves compute apart —
    # P rebuilt on each side (its sum of absolute terms, P_mag, in place of
    # |P|) and G from another matmul and exp (G_err: the inner products'
    # d-term rounding on both sides, carried through the SE map) — then
    # carried through the KL finalize as the largest change over the eight
    # corners of S +- bound, plus 8 ulps for the finalize's own rounding.
    f, p = cpu_art.factors, cpu_art.params
    noise = torch.exp(p.log_noise)
    g_ss = prior_diag(cfg_b.kernel, p, sq)
    Gt, Ainv, P, walpha, g_ss, prior, w = _fused_epilogue_operands(
        cpu_art, Xq, sq, g_ss, noise, None)
    S = epilogue_moments_plain(Gt, Ainv, P, walpha, g_ss, prior, w, fuse="kl")
    P_mag = (f["U"].abs() + f["U"].abs() @ torch.cholesky_solve(f["U"], f["L_M"]).abs()) / (
        noise + 1e-6)
    Xs = cpu_art.data["Xs"]
    C_mag = torch.einsum("td,ind->itn", Xq.abs(), Xs.abs())
    dist_mag = sq[None, :, None] + cpu_art.data["sq_exact"][:, None, :] + 2 * C_mag
    d = Xq.shape[1]
    G_err = Gt * ((4 * d + 9) * U32 * dist_mag / torch.exp(p.log_b) + 4 * U32)
    E = epilogue_error_bound(Gt, Ainv, P, walpha, g_ss, prior, w, fuse="kl",
                             P_mag=P_mag, G_err=G_err)
    tol_mu, tol_var = finalize_tol(FUSIONS.get("kl"), S, E, Gt.shape[0], prior)
    agree("broadcast", mu_c, var_c, bcast["mu"], bcast["var"], tol_mu, tol_var)

    # where a broadcast request's time goes: the steps of the fused serve,
    # each timed apart on the host clock with a synchronize after it
    art_b = bcast["art"]
    parts_ms = {k: [] for k in ("query prep", "cross-gram (gram + SE map)",
                                "projector P", "epilogue", "finalize")}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts_ms[name].append((time.perf_counter() - t) * 1e3)
        return out

    noise_b = torch.exp(art_b.params.log_noise)
    for xb in batches:
        def prep():
            xq = torch.as_tensor(xb, dtype=torch.float32, device=dev)
            sq_b = torch.sum(xq**2, -1)
            return xq, sq_b, prior_diag(art_b.kernel, art_b.params, sq_b).contiguous()

        xq, sq_b, gss_b = step("query prep", prep)
        Gq = step("cross-gram (gram + SE map)",
                  lambda: _expert_cross_gram(art_b, xq, sq_b).contiguous())
        Pq = step("projector P", lambda: _epilogue_projector(art_b, noise_b).contiguous())
        prior_b = gss_b + noise_b
        ones = torch.ones(Gq.shape[0], device=dev)
        Sq = step("epilogue", lambda: epilogue_moments(
            Gq, art_b.factors["Ainv"], Pq, art_b.factors["walpha"], gss_b, prior_b,
            ones, fuse="kl"))
        step("finalize", lambda: FUSIONS.get("kl").finalize(Sq, Gq.shape[0], prior_b))
    print("[broadcast] request steps, median ms over 35 (host clock, synchronized): "
          + "  ".join(f"{k} {np.median(v):.3f}" for k, v in parts_ms.items()), flush=True)

    # c. the zero-rate rBCM baseline: gram on every request, nothing on the wire
    cfg_p = DGPConfig(protocol="poe", fusion="rbcm", gram_backend="pallas", steps=150)
    rbcm = run_path("poe-rbcm", cfg_p, ("gram",), ("gram",), roundtrip=False)
    check(path_launches["poe-rbcm"]["qgram_packed"] == 0
          and path_launches["poe-rbcm"]["epilogue"] == 0,
          "the zero-rate baseline launched a wire or epilogue kernel")
    print(f"[paths] SMSE center {center['smse']:.4f}  broadcast {bcast['smse']:.4f}  "
          f"poe-rbcm {rbcm['smse']:.4f}  (R = 24 bits/sample; rbcm sends nothing)",
          flush=True)
    for ck in (center["ckpt"], bcast["ckpt"]):
        shutil.rmtree(ck, ignore_errors=True)

    # d. multi-tenant fleet serving of b's artifact (Fig. 6 SARCOS broadcast)
    n_tenants, width, t_req, n_req = 64, 16, 16, 512
    est_b, art_b = DistributedGP(cfg_b), bcast["art"]
    store_dir = ROOT / "build" / "chip_smoke_fleet_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    t0 = time.perf_counter()
    store, tids = build_fleet([art_b], n_tenants, str(store_dir))
    print(f"[fleet] stored {n_tenants} tenants ({artifact_nbytes(art_b) / 1e6:.1f} MB each) "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    server = FleetServer(store, cache_artifacts=32, slots=width, budget_ms=2.0,
                         stack_slots=32)
    stream = zipf_tenants(tids, n_req, a=1.1, seed=0)
    n_te = X_te.shape[0]
    make_query = lambda i: X_te[(t_req * i + np.arange(t_req)) % n_te]
    runtime.reset_launches()
    serve_loop(server, stream[: 4 * width], make_query)  # warm: builds the stack
    warm_fused, warm_flushes = server.fused_dispatches, server.flushes
    server.reset_stats()
    ptrs = {st: st.data_ptrs() for st in server.stacks()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = serve_loop(server, stream, make_query)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = runtime.launches()
    path_launches["fleet"] = launches
    fused = warm_fused + stats["fused_dispatches"]
    cache = stats["cache"]
    print(f"[fleet] served {stats['completed']} requests x {t_req} points in {wall:.3f} s -> "
          f"{n_req * t_req / wall:.0f} q/s  p50 {stats['p50_ms']:.3f} ms  p99 "
          f"{stats['p99_ms']:.3f} ms (host clock, from submit)  hit rate "
          f"{cache['hit_rate']:.3f} ({cache['hits']} hits, {cache['misses']} misses, "
          f"{cache['evictions']} evictions)  swaps {stats['stack_swaps']}  flushes "
          f"{stats['flushes']} (+{warm_flushes} warm)  launches {launches}", flush=True)
    check(stats["completed"] == n_req, f"fleet: {stats['completed']} of {n_req} answered")
    check(stats["stacks"] == 1 and fused == warm_flushes + stats["flushes"],
          f"fleet: expected one fused stack, got {stats}")
    check(launches["epilogue_fleet"] == fused and launches["epilogue"] == 0,
          f"fleet: {launches['epilogue_fleet']} epilogue_fleet launches for {fused} fused "
          f"flushes (and {launches['epilogue']} single-tenant epilogues)")
    check(launches["gram"] == width * fused, f"fleet: gram launches {launches['gram']}")
    check(all(st.data_ptrs() == p for st, p in ptrs.items()),
          "fleet: a stacked tensor was reallocated in the steady state")
    print(f"[fleet] where the measured {wall:.3f} s went (host clock): residency (cache "
          f"get + load on miss + admit) {stats['residency_s']:.3f} s for {cache['misses']} "
          f"misses; stacked predicts {stats['predict_s']:.3f} s for {stats['flushes']} "
          f"flushes ({stats['predict_s'] / stats['flushes'] * 1e3:.3f} ms each); the rest "
          f"(batching, query copies) {wall - stats['residency_s'] - stats['predict_s']:.3f} s",
          flush=True)
    print(f"[fleet] steady state: {launches['epilogue_fleet']} epilogue_fleet launches = "
          f"{fused} fused flushes, 0 single-tenant epilogues, no stacked tensor "
          "reallocated", flush=True)

    # one stacked flush against the serial predict of each of its tenants
    stack = server.stacks()[0]
    tids16 = list(stack.tenants()[-width:])
    X16 = torch.stack([torch.as_tensor(make_query(7 * s)) for s in range(width)]).to(dev)
    mu_st, var_st = stack.predict(tids16, X16)
    arts16 = [store.load(tid) for tid in tids16]
    spec, worst = FUSIONS.get("kl"), 0.0
    for s, (art_s, xq) in enumerate(zip(arts16, X16)):
        mu_1, var_1 = est_b.predict(art_s, xq)
        # the bound of phase b: the epilogue's rounding with P rebuilt on
        # each side (P_mag), carried through the KL finalize
        f_s, noise_s = art_s.factors, torch.exp(art_s.params.log_noise)
        sq_s = (xq**2).sum(-1)
        g_s = prior_diag(cfg_b.kernel, art_s.params, sq_s)
        ops_s = _fused_epilogue_operands(art_s, xq, sq_s, g_s, noise_s, None)
        P_mag = (f_s["U"].abs() + f_s["U"].abs() @ torch.cholesky_solve(
            f_s["U"], f_s["L_M"]).abs()) / (noise_s + 1e-6)
        E = epilogue_error_bound(*ops_s, fuse="kl", P_mag=P_mag)
        S_s = epilogue_moments_plain(*ops_s, fuse="kl")
        tol_mu, tol_var = finalize_tol(spec, S_s, E, ops_s[0].shape[0], ops_s[5])
        worst = max(worst, float(((mu_st[s] - mu_1).abs() / tol_mu).max()),
                    float(((var_st[s] - var_1).abs() / tol_var).max()))
    print(f"[fleet] stacked flush vs serial predict, 16 tenants: worst err/tol {worst:.3e}",
          flush=True)
    check(worst <= 1.0, "fleet: the stacked flush disagrees with the serial predicts")

    # isolation: a neighbour's NaN request or degraded mask changes no bit
    hostile = X16.clone()
    hostile[1] = float("nan")
    mu_h, var_h = stack.predict(tids16, hostile)
    healthy = torch.ones(width, len(art_b.fit_lengths), device=dev)
    mu_a, var_a = stack.predict(tids16, X16, healthy)
    degraded = healthy.clone()
    degraded[1, :5] = 0.0
    mu_d, var_d = stack.predict(tids16, X16, degraded)
    others = [s for s in range(width) if s != 1]
    check(torch.equal(mu_h[others], mu_st[others]) and torch.equal(var_h[others], var_st[others]),
          "fleet: a neighbour's NaN request changed another tenant's answer")
    check(torch.equal(mu_d[others], mu_a[others]) and torch.equal(var_d[others], var_a[others]),
          "fleet: a neighbour's degraded mask changed another tenant's answer")
    check(bool((mu_h[1] == 0).all()) and bool(torch.isfinite(var_h[1]).all())
          and not torch.equal(mu_d[1], mu_a[1]),
          "fleet: the hostile / degraded tenant's own answer is wrong")
    print("[fleet] isolation: neighbours bitwise unchanged under a NaN request and a "
          "degraded mask", flush=True)

    # serial vs stacked q/s on the same 16 resident tenants (print only)
    def per_s(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps

    serial_s = per_s(lambda: [est_b.predict(a, x) for a, x in zip(arts16, X16)])
    stacked_s = per_s(lambda: stack.predict(tids16, X16))
    print(f"[fleet] 16 resident tenants x {t_req} points: serial {width * t_req / serial_s:.0f} "
          f"q/s ({serial_s * 1e3:.3f} ms)  stacked {width * t_req / stacked_s:.0f} q/s "
          f"({stacked_s * 1e3:.3f} ms)  ratio {serial_s / stacked_s:.2f}x (host clock)",
          flush=True)
    shutil.rmtree(store_dir, ignore_errors=True)

    # ---- 5. the kernels line and the result line ---------------------------
    src = "src/repro_torch/kernels/csrc"
    main_rows = {"gram": main_gram, "qgram_packed": main_qgram,
                 "epilogue": next(r for r in main_epi if r["tag"].endswith(" kl")),
                 "epilogue_fleet": next(r for r in main_fleet if r["tag"].endswith(" kl"))}
    kernels = []
    for name, replaces in (
        ("gram", "src/repro/kernels/gram/gram.py:35"),
        ("qgram_packed", "src/repro/kernels/qgram/packed.py:87"),
        ("epilogue", "src/repro/kernels/epilogue/epilogue.py:142"),
        ("epilogue_fleet", "src/repro/kernels/epilogue/epilogue.py:113"),
    ):
        row = main_rows[name]
        errs = [r["err"] for r in results[name]] + [
            r["err_bwd"] for r in results[name] if "err_bwd" in r]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}/{name}.cu",
            "replaces": replaces,
            "launches": sum(counts[name] for counts in path_launches.values()),
            "max_abs_err": max(errs), "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
