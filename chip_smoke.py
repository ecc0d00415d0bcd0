#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero (nothing is caught and turned
into a pass):

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build both Hopper kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   each, in parallel): build time, registers and shared memory per kernel.
3. Each kernel (and the gram backward) against its plain PyTorch version on
   the card — at the main path's shapes, one larger shape at the same width
   (40 machines x 1000 rows, d = 21, 4449 queries) and the edge layouts
   (R = 24 and R = 100 words, width-0 dims, masked rows, ragged tiles) —
   with the max abs / relative error against the stated tolerance, and the
   device time of the kernel, the plain version and ``torch.matmul``.
4. The main path at the paper's Fig. 6 SARCOS setting (N = 1000, d = 21,
   m = 40, SE kernel, R = 24 bits/sample, 150 Adam steps): fit on the card
   with ``gram_backend="pallas"``, save, load, answer the 4449 test points
   in 35 batches of 128.  Checks: both kernels launched during the fit and
   ``gram`` on every request; the loaded artifact's answers bitwise equal to
   the pre-save ones; the same checkpoint served on the CPU (plain versions)
   within tolerance; a finite SMSE below 1.
5. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the repository's ``src/repro_torch`` beside it,
the script fails before printing any result.  It imports nothing of JAX.
"""
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
    from repro_torch.core.gp import kernel_from_inner
    from repro_torch.core.protocols.base import split_machines
    from repro_torch.data.synthetic import regression_dataset
    from repro_torch.kernels import build, runtime
    from repro_torch.kernels.gram.ops import gram, gram_cuda, gram_plain
    from repro_torch.kernels.qgram.ops import qgram_packed_cuda, qgram_packed_plain

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
    results = {"gram": [], "qgram_packed": []}

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
                   f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms "
                   f"({row['bound_by']})")
            if backward:
                bwd = lambda: (gram_cuda(g, y.T), gram_cuda(g.T, x.T))
                row["bwd_ms"] = device_ms(bwd, reps)
                row["bwd_library_ms"] = device_ms(lambda: (g @ y, g.T @ x), reps)
                msg += (f"  | bwd kernel {row['bwd_ms']:.4f} ms  torch.matmul "
                        f"{row['bwd_library_ms']:.4f} ms")
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
                  f"{row['matmul_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms "
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

    # ---- 4. the main path: Fig. 6 SARCOS, fit -> save -> load -> serve -----
    X_tr, y_tr, X_te, y_te = regression_dataset("sarcos", seed=0)
    parts = split_machines(X_tr, y_tr, 40, torch.Generator().manual_seed(0))
    cfg = DGPConfig(gram_backend="pallas", steps=150, bits_per_sample=24)
    est = DistributedGP(cfg)  # the card
    runtime.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = est.fit(parts=parts)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = runtime.launches()
    print(f"[path] fit {fit_s:.3f} s  launches {fit_launches}  ledgers wire "
          f"{art.wire_bits} payload {art.payload_bits} integrity "
          f"{art.integrity_bits}  rates/machine {art.wire.rates.sum(1).tolist()[:3]}…",
          flush=True)
    check(fit_launches["gram"] > 0 and fit_launches["qgram_packed"] > 0,
          f"the fit did not launch both kernels: {fit_launches}")

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    est.save(art, str(ckpt))
    loaded = est.load(str(ckpt))
    batches = [X_te[i:i + 128] for i in range(0, X_te.shape[0], 128)]
    check(len(batches) == 35, f"expected 35 batches, got {len(batches)}")

    def serve(artifact, record):
        mus, vars_, times = [], [], []
        for xb in batches:
            before = runtime.family("gram").launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            mu, var = est.predict(artifact, xb)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if record:
                check(runtime.family("gram").launches > before,
                      "a request did not launch the gram kernel")
            mus.append(mu)
            vars_.append(var)
        return torch.cat(mus), torch.cat(vars_), times

    mu0, var0, _ = serve(art, True)
    mu1, var1, times = serve(loaded, True)
    launches = runtime.launches()
    check(torch.equal(mu0, mu1) and torch.equal(var0, var1),
          "the loaded artifact's answers differ from the pre-save answers")
    print("[path] loaded artifact answers == pre-save answers (bitwise)", flush=True)

    cpu_est = DistributedGP(cfg, device="cpu")
    cpu_art = cpu_est.load(str(ckpt))
    answers = [cpu_est.predict(cpu_art, xb) for xb in batches]
    mu_c = torch.cat([a[0] for a in answers])
    var_c = torch.cat([a[1] for a in answers])
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
    G_sK = kernel_from_inner(cfg.kernel, p, Xq @ cpu_art.data["Xc"].T, sq,
                             cpu_art.data["sq_cols"][:K])
    B = (f["Ainv"] @ G_sK.T).abs()
    MU = torch.cholesky_solve(f["U"], f["L_M"]).abs()
    s2 = torch.exp(p.log_noise) + 1e-6
    P_mag = (f["U"].abs() + f["U"].abs() @ MU) / s2
    tol_mu = 1e-5 * (B.T @ f["walpha"].abs())
    tol_var = 1e-5 * (B * (P_mag @ B)).sum(0)
    d_mu = (mu_c - mu1.cpu()).abs()
    d_var = (var_c - var1.cpu()).abs()
    print(f"[path] CPU plain serve vs card: mu max {float(d_mu.max()):.3e} "
          f"(worst/tol {float((d_mu / tol_mu).max()):.3e})  var max "
          f"{float(d_var.max()):.3e} (worst/tol {float((d_var / tol_var).max()):.3e})",
          flush=True)
    check(bool((d_mu <= tol_mu).all()) and bool((d_var <= tol_var).all()),
          "the CPU serve of the same checkpoint disagrees with the card")

    y = torch.from_numpy(y_te)
    mu = mu1.cpu()
    smse = float(((mu - y) ** 2).mean() / y.var(unbiased=False))
    t_ms = np.array(times) * 1e3
    print(f"[path] SMSE {smse:.4f}  request p50 {np.percentile(t_ms, 50):.3f} ms  "
          f"p99 {np.percentile(t_ms, 99):.3f} ms  (35 x 128 queries, host clock)  "
          f"fit {fit_s:.3f} s  launches after serving {launches}", flush=True)
    check(np.isfinite(smse) and smse < 1.0, f"SMSE {smse} is not finite and below 1")
    check(bool(torch.isfinite(var1).all()) and bool((var1 > 0).all()),
          "non-finite or non-positive predictive variances")
    shutil.rmtree(ckpt, ignore_errors=True)

    # ---- 5. the kernels line and the result line ---------------------------
    src = "src/repro_torch/kernels/csrc"
    kernels = []
    for name, row, replaces in (
        ("gram", main_gram, "src/repro/kernels/gram/gram.py:35"),
        ("qgram_packed", main_qgram, "src/repro/kernels/qgram/packed.py:87"),
    ):
        errs = [r["err"] for r in results[name]] + [
            r["err_bwd"] for r in results[name] if "err_bwd" in r]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}/{name}.cu",
            "replaces": replaces, "launches": launches[name],
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
