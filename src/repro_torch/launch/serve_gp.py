"""Distributed-GP serving CLI: fit the communication-limited protocol ONCE,
checkpoint the artifact, then serve query batches (and optionally stream new
points) from the cached factors — counterpart of
``repro/launch/serve_gp.py``.

  python -m repro_torch.launch.serve_gp --protocol center --m 40 \\
      --bits 24 --n 2000 --d 8 --steps 60 --queries 50 --batch 128 \\
      --artifact-dir ckpt/ [--stream-every 20 --stream-size 16] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (without a card the
default raises).  The CLI builds ONE validated ``DGPConfig`` from the
flags and drives everything through the ``DistributedGP`` facade, so the
command line mirrors the API one for one.  The serve loop round-trips
through the checkpoint (save -> load) when ``--artifact-dir`` is given, so
what is timed is a server that never refits: it loads factors and answers.

The loop is hardened for unattended runs: fit and checkpoint load retry
with exponential backoff, ``--timeout-ms`` counts requests over a latency
budget, ``--chaos`` injects a :class:`repro_torch.faults.FaultPlan` (drops,
NaN shards, packed-word bit flips, stragglers: a straggler's slot of the
serve rotation sleeps its delay) and serves every 7th batch under a
degraded availability mask with a health report.  ``--fleet`` serves
y-scaled tenants of the fit through :mod:`repro_torch.launch.fleet`.
``--mesh`` runs ``impl="mesh"``: the CLI spawns ``--m`` processes, one per
machine (:mod:`repro_torch.launch.ranks`), which fit, serve and stream
together, rank 0 printing; with ``--artifact-dir`` the checkpoint is
reloaded single-process and must answer within 1e-4 of the mesh.

At the end the warm path's structure is printed: the capacity growths of
the streamed updates (the port's form of the reference's retraces), the
factorizations in one predict and the contract verdict of
:func:`repro_torch.analysis.check_contracts`; a violated contract exits 1.
:func:`main` returns what it measured (the artifact, the report, latencies
and the kernel launches of each warm request), for callers that drive it
in-process.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..analysis import check_contracts
from ..core import DGPConfig, DistributedGP
from ..core.protocols.streaming import update_growth_count
from ..faults import FaultPlan, corrupt_words, drop_machine, nan_shard, straggler
from ..kernels import runtime
from .fleet import FleetServer, build_fleet, serve_loop, zipf_tenants


def _retry(label: str, fn, attempts: int = 3, backoff: float = 0.5,
           sleep=time.sleep):
    """Run ``fn()`` with exponential-backoff retries; re-raise after the last
    attempt (a transient load or fit failure should not kill an unattended
    server, a persistent one should).  ``sleep`` is injectable so tests
    see the backoff schedule without waiting it out."""
    for k in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - the last attempt re-raises
            if k == attempts - 1:
                raise
            wait = backoff * (2 ** k)
            print(f"  [{label}] attempt {k + 1}/{attempts} failed "
                  f"({type(e).__name__}: {e}); retrying in {wait:.1f}s",
                  file=sys.stderr)
            sleep(wait)


def _parse_chaos(spec: str):
    """``--chaos`` spec -> FaultPlan: comma-joined ``drop:J``, ``nan:J``,
    ``flip:RATE``, ``straggle:J@SECONDS`` clauses, e.g.
    ``drop:1,flip:0.01,straggle:3@0.2``."""
    plan = FaultPlan()
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, val = clause.partition(":")
        if kind == "drop":
            plan = plan | drop_machine(int(val))
        elif kind == "nan":
            plan = plan | nan_shard(int(val))
        elif kind == "flip":
            plan = plan | corrupt_words(float(val))
        elif kind == "straggle":
            j, _, delay = val.partition("@")
            plan = plan | straggler(int(j), float(delay or 0.1))
        else:
            raise ValueError(
                f"unknown chaos clause {clause!r} (known: drop:J, nan:J, "
                "flip:RATE, straggle:J@SECONDS)"
            )
    return plan


def _sync(device) -> None:
    """Wait for the card (a no-op on the CPU), so a host clock reads the
    device's work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_delta(before: dict, after: dict) -> dict:
    """The kernel launches between two ``runtime.launches()`` readings
    (families that launched only)."""
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _run_fleet(args, art, degraded_avail, rng, device) -> dict:
    """``--fleet`` mode: serve a multi-tenant fleet derived from the fitted
    artifact through the :mod:`repro_torch.launch.fleet` server (LRU
    artifact cache, latency-budgeted micro-batching, one stacked predict per
    flush).  Chaos applies PER TENANT: every 7th flush-width block tags one
    tenant's request with the degraded mask.  The steady state must
    reallocate no stacked tensor (the port's form of "no retrace") and, on
    the card, launch ``epilogue_fleet`` once per fused flush."""
    n_requests = max(args.queries, 4 * args.fleet_slots)
    with tempfile.TemporaryDirectory() as td:
        store_dir = args.artifact_dir or td
        store, tids = build_fleet([art], args.fleet_tenants, store_dir, device=device)
        print(f"fleet: {len(tids)} tenants (y-scaled variants of the fit) "
              f"stored under {store_dir}")
        server = FleetServer(
            store,
            cache_artifacts=args.fleet_cache,
            cache_bytes=args.fleet_cache_bytes or None,
            slots=args.fleet_slots,
            budget_ms=args.fleet_budget_ms,
            device=device,
        )
        stream = zipf_tenants(tids, n_requests, a=args.fleet_zipf)
        make_query = lambda i: rng.normal(size=(args.batch, args.d)).astype(np.float32)
        degraded_every = 7 if degraded_avail is not None else 0
        # the warm pass creates the stacks; the measured loop must then
        # reallocate none of their tensors
        serve_loop(server, stream[: 4 * args.fleet_slots], make_query,
                   degraded_every=degraded_every, degraded_avail=degraded_avail)
        server.reset_stats()
        ptrs = {s: s.data_ptrs() for s in server.stacks()}
        before = runtime.launches()
        t0 = time.perf_counter()
        stats = serve_loop(server, stream, make_query, degraded_every=degraded_every,
                           degraded_avail=degraded_avail)
        wall = time.perf_counter() - t0
        launches = _launch_delta(before, runtime.launches())
        realloc = sum(1 for s, p in ptrs.items() if s.data_ptrs() != p)
        qps = stats["completed"] * args.batch / wall
        c = stats["cache"]
        print(f"fleet serve: {stats['completed']} requests x {args.batch} "
              f"pts in {wall:.2f}s -> {qps:.0f} q/s | p50 "
              f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms "
              f"(budget {args.fleet_budget_ms} ms, flush width "
              f"{args.fleet_slots})")
        print(f"fleet cache: hit rate {c['hit_rate']:.2f} "
              f"({c['hits']}h/{c['misses']}m, {c['evictions']} evictions) | "
              f"{stats['stacks']} stack(s), {stats['stack_swaps']} tenant "
              f"swaps | flushes {stats['flushes']} (fused "
              f"{stats['fused_dispatches']}), kernel launches {launches} | "
              f"stacks reallocated: {realloc}")
        if realloc:
            print("FATAL: a stacked tensor was reallocated in the steady state",
                  file=sys.stderr)
            sys.exit(1)
        want = stats["fused_dispatches"] if device.type == "cuda" else 0
        if launches.get("epilogue_fleet", 0) != want or launches.get("epilogue", 0):
            print(f"FATAL: expected {want} epilogue_fleet launches (one per fused "
                  f"flush) and no single-tenant epilogue, got {launches}", file=sys.stderr)
            sys.exit(1)
    return {"art": art, "stats": stats, "wall_s": wall, "qps": qps,
            "launches": launches, "reallocated": realloc}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_gp")
    ap.add_argument("--protocol", default="center",
                    choices=["center", "broadcast", "poe"])
    ap.add_argument("--scheme", default="per_symbol",
                    choices=["per_symbol", "vq"],
                    help="wire scheme: §4.2 per-symbol int codes or the §4.1 "
                         "Theorem-2 optimal test channel (batched impl only)")
    ap.add_argument("--m", type=int, default=40, help="machines (paper §6: 40)")
    ap.add_argument("--bits", type=int, default=24, help="R bits/sample")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--steps", type=int, default=60, help="hyperparameter steps")
    ap.add_argument("--gram-mode", default="nystrom")
    ap.add_argument("--gram-backend", default="xla", choices=["xla", "pallas"],
                    help="pallas runs the gram products through the hand-written "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--fusion", default=None,
                    help="broadcast fusion / poe combiner (registry name); "
                         "default: kl for broadcast, rbcm for poe")
    ap.add_argument("--queries", type=int, default=50, help="warm query batches")
    ap.add_argument("--batch", type=int, default=128, help="points per query batch")
    ap.add_argument("--artifact-dir", default=None,
                    help="checkpoint the artifact here and serve from the "
                         "loaded copy (omit to serve the in-memory artifact)")
    ap.add_argument("--stream-every", type=int, default=0,
                    help="every k query batches, stream new points in via "
                         "update() (0 = never)")
    ap.add_argument("--stream-size", type=int, default=16,
                    help="points per streaming update")
    ap.add_argument("--mesh", action="store_true",
                    help="machines as processes (impl='mesh'): spawn --m gloo ranks "
                         "that fit, serve and stream together; rank 0 prints")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec, e.g. 'drop:1,flip:0.01,"
                         "straggle:3@0.2'; every 7th serve batch also runs "
                         "under a degraded availability mask with a health report")
    ap.add_argument("--timeout-ms", type=float, default=0.0,
                    help="per-request latency budget; over-budget requests "
                         "are counted and reported (0 = no budget)")
    ap.add_argument("--retries", type=int, default=3,
                    help="fit/load attempts before giving up")
    ap.add_argument("--fleet", action="store_true",
                    help="multi-tenant mode: derive --fleet-tenants y-scaled "
                         "tenants from the fit and serve them through the "
                         "launch.fleet server (LRU artifact cache + "
                         "latency-budgeted micro-batching); chaos/degraded "
                         "masks apply per tenant")
    ap.add_argument("--fleet-tenants", type=int, default=16)
    ap.add_argument("--fleet-cache", type=int, default=8,
                    help="artifact cache capacity (count)")
    ap.add_argument("--fleet-cache-bytes", type=int, default=0,
                    help="artifact cache capacity in bytes (0 = unbounded)")
    ap.add_argument("--fleet-budget-ms", type=float, default=2.0,
                    help="micro-batch latency budget")
    ap.add_argument("--fleet-slots", type=int, default=4,
                    help="micro-batch flush width")
    ap.add_argument("--fleet-zipf", type=float, default=1.1,
                    help="zipf exponent of the tenant traffic mix")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.mesh:
        if args.fleet:
            raise ValueError("--fleet serves single-process artifacts: drop --mesh")
        if not (dist.is_initialized() and dist.get_world_size() == args.m):
            # one process per machine: the counterpart of the reference
            # forcing --m host devices for itself
            from .ranks import RankPool

            with RankPool(args.m, device=args.device) as pool:
                return pool.run(_mesh_rank, list(sys.argv[1:] if argv is None else argv))[0]
    return _serve(args)


def _mesh_rank(argv) -> dict:
    """``main(argv)`` on one rank of the ``--mesh`` process group; what it
    measured, without the artifact (which stays on its rank)."""
    out = main(argv)
    report = out["report"]
    return {"fit_s": out["fit_s"], "lat_ms": out["lat_ms"], "p50_ms": out["p50_ms"],
            "p99_ms": out["p99_ms"], "growths": out["growths"], "n_updates": out["n_updates"],
            "reload_dmu": out["reload_dmu"], "contract_ok": report.ok,
            "contract": report.contract, "op_counts": report.op_counts,
            "collectives": report.collectives, "wire_bits": out["art"].wire_bits,
            "payload_bits": out["art"].payload_bits,
            "integrity_bits": out["art"].integrity_bits, "lengths": out["art"].lengths,
            "impl": out["art"].impl}


def _serve(args) -> dict:
    fusion = args.fusion
    if fusion is None:
        fusion = "rbcm" if args.protocol == "poe" else "kl"
    chaos = _parse_chaos(args.chaos) if args.chaos else None
    cfg = DGPConfig(
        protocol=args.protocol,
        scheme=args.scheme,
        fusion=fusion,
        impl="mesh" if args.mesh else "batched",
        gram_backend=args.gram_backend,
        gram_mode="dense" if args.protocol == "poe" else args.gram_mode,
        bits_per_sample=0 if args.protocol == "poe" else args.bits,
        steps=args.steps,
        faults=chaos,
    )
    est = DistributedGP(cfg, device=args.device)
    if chaos is not None:
        print(f"chaos: {chaos}")

    rng = np.random.default_rng(0)
    W = rng.normal(size=(args.d, 2))
    f = lambda Z: np.sin(Z @ W[:, 0]) + 0.4 * (Z @ W[:, 1])
    X = rng.normal(size=(args.n, args.d)).astype(np.float32)
    y = (f(X) + 0.05 * rng.normal(size=args.n)).astype(np.float32)

    t0 = time.perf_counter()
    art = _retry("fit", lambda: est.fit(X, y, args.m,
                                        generator=torch.Generator().manual_seed(0)),
                 attempts=args.retries)
    _sync(est.device)
    t_fit = time.perf_counter() - t0
    print(f"fit: protocol={cfg.protocol} scheme={cfg.scheme} impl={art.impl} "
          f"m={args.m} n={args.n} d={args.d} "
          f"R={cfg.bits_per_sample} -> {t_fit:.2f}s on {est.device}, "
          f"wire {art.wire_bits/1e3:.1f} kbit "
          f"(packed payload {art.payload_bits/1e3:.1f} kbit, "
          f"crc {art.integrity_bits/1e3:.1f} kbit, "
          f"{art.rows_demoted} rows demoted)")

    reload_dmu = None
    if args.artifact_dir and args.mesh:
        # the checkpoint loads single-process; keep serving the mesh
        # artifact, but verify the round trip
        path = est.save(art, args.artifact_dir)
        loaded = _retry("load", lambda: est.load(args.artifact_dir), attempts=args.retries)
        Xv = rng.normal(size=(8, args.d)).astype(np.float32)
        reload_dmu = float(torch.max(torch.abs(est.predict(art, Xv)[0]
                                               - est.predict(loaded, Xv)[0])))
        if not np.isfinite(reload_dmu) or reload_dmu > 1e-4:
            print(f"FATAL: single-process reload of {path} diverges from the mesh "
                  f"artifact (max |dmu| = {reload_dmu:.3e} > 1e-4) — refusing to serve",
                  file=sys.stderr)
            sys.exit(1)
        print(f"artifact: saved {path}; single-process reload agrees to "
              f"{reload_dmu:.1e} (serving the mesh copy); recorded config: "
              f"{loaded.config.protocol}/{loaded.config.scheme}")
    elif args.artifact_dir:
        path = est.save(art, args.artifact_dir)
        art = _retry("load", lambda: est.load(args.artifact_dir), attempts=args.retries)
        print(f"artifact: saved+reloaded {path} (serving the loaded copy)")

    # degraded-mode serving under chaos: every 7th batch drops the chaos
    # plan's machines (or the last machine when the plan names none) and the
    # fusion renormalizes over survivors
    degraded_avail = health = None
    if chaos is not None and args.protocol in ("broadcast", "poe"):
        lost = set(chaos.drop) or {args.m - 1}
        degraded_avail = np.asarray(
            [0.0 if j in lost else 1.0 for j in range(args.m)], np.float32
        )
        health = est.health(art, degraded_avail)
        print(f"health (degraded mask): status={health.status} "
              f"lost={list(health.machines_lost)} demoted={health.rows_demoted} "
              f"var_inflation={health.variance_inflation:.2f}")
    stragglers = dict(chaos.straggle) if chaos is not None else {}

    if args.fleet:
        out = _run_fleet(args, art, degraded_avail, rng, est.device)
        out.update(est=est, fit_s=t_fit, health=health)
        return out

    lat, machine, n_updates = [], 1 % args.m, 0
    n_over = 0  # requests over the --timeout-ms budget
    g0 = None  # growth count after the first batch
    request_launches = []  # the kernel launches of each warm request
    for q in range(args.queries):
        Xq = rng.normal(size=(args.batch, args.d)).astype(np.float32)
        if stragglers and (q % args.m) in stragglers:
            # a straggler holds up its slot of the serve rotation
            time.sleep(stragglers[q % args.m])
        before = runtime.launches()
        t0 = time.perf_counter()
        if degraded_avail is not None and (q + 1) % 7 == 0:
            mu, var = est.predict(art, Xq, available=degraded_avail)
        else:
            mu, var = est.predict(art, Xq)
        _sync(est.device)
        dt = time.perf_counter() - t0
        lat.append(dt)
        if q > 0:
            request_launches.append(_launch_delta(before, runtime.launches()))
        if args.timeout_ms and dt * 1e3 > args.timeout_ms and q > 0:
            n_over += 1
        if g0 is None:
            g0 = update_growth_count(args.protocol)
        if args.stream_every and (q + 1) % args.stream_every == 0:
            Xn = rng.normal(size=(args.stream_size, args.d)).astype(np.float32)
            yn = (f(Xn) + 0.05 * rng.normal(size=args.stream_size)).astype(np.float32)
            t0 = time.perf_counter()
            art = est.update(art, Xn, yn, machine=machine)
            _sync(est.device)
            n_updates += 1
            print(f"  [q{q+1}] streamed {args.stream_size} pts -> machine "
                  f"{machine} in {time.perf_counter()-t0:.3f}s "
                  f"(ledger {art.wire_bits/1e3:.1f} kbit)")

    # the contract check is side-effect-neutral (repro_torch.analysis): it
    # moves neither the growth count nor the launch counts
    report = check_contracts(
        art, rng.normal(size=(args.batch, args.d)).astype(np.float32),
        raise_on_violation=False,
    )
    growths = update_growth_count(args.protocol) - g0
    lat_ms = np.asarray(lat[1:]) * 1e3  # drop the first (cold) batch
    p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
    print(f"serve: {args.queries} batches x {args.batch} pts | warm p50 "
          f"{p50:.2f} ms, p99 {p99:.2f} ms"
          f" | {args.batch / (np.median(lat_ms) / 1e3):.0f} queries/s")
    if args.timeout_ms:
        print(f"timeout budget: {n_over}/{args.queries - 1} warm requests over "
              f"{args.timeout_ms:.0f} ms")
    ops = report.op_counts
    n_coll = sum(v["count"] for v in report.collectives.values())
    print(f"warm path: growths={growths} (of {n_updates} streamed updates; one "
          f"per bucket crossing) cholesky_ops={ops.get('cholesky', 0)} "
          f"eigh_ops={ops.get('eigh', 0)} collectives={n_coll} "
          f"contract={report.contract}:{'ok' if report.ok else 'VIOLATED'}")
    if not report.ok:
        for finding in report.findings:
            print(f"contract violation: {finding}", file=sys.stderr)
        sys.exit(1)
    return {"art": art, "est": est, "report": report, "fit_s": t_fit,
            "lat_ms": lat_ms, "p50_ms": float(p50), "p99_ms": float(p99),
            "request_launches": request_launches, "growths": growths,
            "n_updates": n_updates, "n_over": n_over, "health": health,
            "reload_dmu": reload_dmu}


if __name__ == "__main__":
    main()
