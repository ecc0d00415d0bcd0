"""Fleet serving CLI: many tenants, one stacked predict per flush —
counterpart of ``repro/launch/fleet.py``.

  python -m repro_torch.launch.fleet --tenants 64 --protocol broadcast \\
      --gram-backend pallas --cache 32 --budget-ms 2 --slots 8 \\
      --requests 400 --batch 16 --zipf 1.1 [--store-dir DIR] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (without a card the
default raises).  The pieces:

* :class:`MicroBatcher` — coalesces per-tenant queries into micro-batches
  under a latency budget: a batch flushes when its ``slots`` fill OR when
  the oldest queued request has waited ``budget_ms``.  The clock is
  injectable so tests drive deadlines without sleeping.
* :class:`FleetServer` — an :class:`~repro_torch.core.fleet.ArtifactCache`
  (LRU, checkpoint-backed load-on-miss), one
  :class:`~repro_torch.core.fleet.FleetStack` per homogeneity bucket, and
  the batcher.  A flush groups the batch by bucket, pads each group to the
  fixed flush width (repeating the first row; results sliced off, so every
  launch sees one batch shape) and answers every tenant of a group in one
  stacked predict — on the fused broadcast route one ``epilogue_fleet``
  launch.
* :func:`build_fleet` / :func:`zipf_tenants` / :func:`serve_loop` — build a
  tenant store from a handful of base fits (exact y-scaled variants) and
  drive zipf-mixed traffic against the server.  ``zipf_tenants`` draws
  from numpy's ``default_rng`` as the reference does, so both packages
  serve the same tenant stream.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class _Pending:
    tenant: object
    X: object
    avail: object
    enqueued_at: float


class MicroBatcher:
    """Coalesce per-tenant requests into fixed-width micro-batches under a
    deadline: flush on ``slots`` full or on the oldest request aging past
    ``budget_ms``.  ``clock`` is injectable (seconds, monotonic) so tests
    exercise the deadline without sleeping."""

    def __init__(self, slots: int = 8, budget_ms: float = 2.0, clock=time.monotonic):
        if slots < 1:
            raise ValueError("MicroBatcher: slots must be >= 1")
        self.slots = int(slots)
        self.budget_ms = float(budget_ms)
        self.clock = clock
        self._queue: list[_Pending] = []

    def __len__(self) -> int:
        return len(self._queue)

    def add(self, tenant, X, avail=None):
        """Enqueue one request; returns the flushed batch when this request
        fills the last slot, else None."""
        self._queue.append(_Pending(tenant, X, avail, self.clock()))
        if len(self._queue) >= self.slots:
            return self.flush()
        return None

    def due(self) -> bool:
        """True when the oldest queued request has exhausted the budget."""
        if not self._queue:
            return False
        age_ms = (self.clock() - self._queue[0].enqueued_at) * 1e3
        return age_ms >= self.budget_ms

    def flush(self) -> list:
        """Drain the queue (flush on budget: callers poll :meth:`due`)."""
        batch, self._queue = self._queue, []
        return batch


class FleetServer:
    """Multi-tenant GP serving: LRU artifact cache over a checkpoint store,
    resident :class:`~repro_torch.core.fleet.FleetStack` per bucket, and
    latency-budgeted micro-batching in front.

    ``store`` is an :class:`~repro_torch.core.fleet.ArtifactStore` (or any
    object with ``load(tenant)``) that loads onto ``device`` — the card
    unless the caller names another (without CUDA the default raises);
    ``stack_slots`` fixes each stack's resident rows (default 2x the flush
    width, so a working set larger than one batch stays resident)."""

    def __init__(self, store, cache_artifacts: int | None = 64,
                 cache_bytes: int | None = None, slots: int = 8,
                 budget_ms: float = 2.0, stack_slots: int | None = None,
                 clock=time.monotonic, device=None):
        from ..core.fleet import ArtifactCache
        from ..core.protocols.base import resolve_device

        self.device = resolve_device(device)
        self.store = store
        self.cache = ArtifactCache(store.load, capacity=cache_artifacts,
                                   capacity_bytes=cache_bytes)
        self.batcher = MicroBatcher(slots=slots, budget_ms=budget_ms, clock=clock)
        self.stack_slots = int(stack_slots) if stack_slots else 2 * int(slots)
        if self.stack_slots < int(slots):
            raise ValueError(
                f"FleetServer: stack_slots ({self.stack_slots}) must cover a "
                f"full flush width ({slots}) or a batch could evict its own "
                "members"
            )
        self.clock = clock
        self._stacks: dict = {}
        self.flushes = 0
        self.fused_dispatches = 0  # stacked predicts on the fused route
        self.latencies_ms: list[float] = []
        # host seconds making batch members resident (cache get + admit)
        # and in the stacked predicts (until the device is done)
        self.residency_s = 0.0
        self.predict_s = 0.0

    # -- residency ---------------------------------------------------------

    def _resident(self, tenant):
        """The stack with ``tenant`` resident — cache hit/miss and stack
        admit happen here, off the per-request hot path."""
        from ..core.fleet import FleetStack, bucket_key

        art = self.cache.get(tenant)
        if art.device.type != self.device.type:
            raise ValueError(
                f"FleetServer on {self.device}: tenant {tenant!r} loaded onto "
                f"{art.device} (give the store the server's device)"
            )
        key = bucket_key(art)
        stack = self._stacks.get(key)
        if stack is None:
            stack = FleetStack({tenant: art}, slots=self.stack_slots)
            self._stacks[key] = stack
        elif tenant not in stack:
            stack.admit(tenant, art)
        else:
            # refresh recency so a later admit in this SAME batch can never
            # evict a tenant that is about to be co-batched
            stack.touch(tenant)
        return stack

    def stacks(self) -> list:
        return list(self._stacks.values())

    # -- request plane -----------------------------------------------------

    def submit(self, tenant, X, avail=None) -> list:
        """Enqueue one request; returns completed ``(tenant, mu, var,
        latency_ms)`` tuples when this submit triggered a flush (slots
        full), else []."""
        batch = self.batcher.add(tenant, X, avail)
        return self._serve(batch) if batch else []

    def poll(self) -> list:
        """Flush on deadline: serve the queue iff the oldest request has
        exhausted the latency budget."""
        if self.batcher.due():
            return self._serve(self.batcher.flush())
        return []

    def drain(self) -> list:
        """Serve whatever is queued regardless of deadline (shutdown)."""
        if len(self.batcher):
            return self._serve(self.batcher.flush())
        return []

    def _serve(self, batch) -> list:
        """Answer one flushed micro-batch: group by bucket, pad each group
        to the fixed flush width, ONE stacked predict per bucket."""
        self.flushes += 1
        groups: dict = {}
        t0 = time.perf_counter()
        for req in batch:
            stack = self._resident(req.tenant)
            groups.setdefault(id(stack), (stack, []))[1].append(req)
        self.residency_s += time.perf_counter() - t0
        out = []
        width = self.batcher.slots
        for stack, reqs in groups.values():
            S = len(reqs)
            tids = [r.tenant for r in reqs]
            Xq = torch.stack([torch.as_tensor(r.X, dtype=torch.float32) for r in reqs])
            avail = None
            if any(r.avail is not None for r in reqs):
                m = len(stack.tree.fit_lengths)
                avail = np.ones((S, m), np.float32)
                for s, r in enumerate(reqs):
                    if r.avail is not None:
                        avail[s] = np.asarray(r.avail, np.float32)
            if S < width:
                # pad to the flush width by repeating row 0: every launch
                # sees ONE (width, t, d) shape; padded rows are sliced off
                # before anyone sees them
                reps = width - S
                tids = tids + [tids[0]] * reps
                Xq = torch.cat([Xq, Xq[:1].expand(reps, *Xq.shape[1:])])
                if avail is not None:
                    avail = np.concatenate([avail, np.repeat(avail[:1], reps, 0)])
            t0 = time.perf_counter()
            mu, var = stack.predict(tids, Xq, avail)
            self.fused_dispatches += int(stack.fused)
            if mu.is_cuda:
                torch.cuda.synchronize(mu.device)
            self.predict_s += time.perf_counter() - t0
            done = self.clock()
            for s, r in enumerate(reqs):
                lat = (done - r.enqueued_at) * 1e3
                self.latencies_ms.append(lat)
                out.append((r.tenant, mu[s], var[s], lat))
        return out

    def reset_stats(self) -> None:
        """Zero the latency/flush counters (between the warm pass and the
        measured steady state, so first-use costs never pollute p99)."""
        self.flushes = 0
        self.fused_dispatches = 0
        self.latencies_ms = []
        self.residency_s = self.predict_s = 0.0

    def stats(self) -> dict:
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        return {
            "flushes": self.flushes,
            "fused_dispatches": self.fused_dispatches,
            "requests": len(self.latencies_ms),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "cache": self.cache.stats(),
            "stacks": len(self._stacks),
            "stack_swaps": sum(s.swaps for s in self._stacks.values()),
            "residency_s": self.residency_s,
            "predict_s": self.predict_s,
        }


# --------------------------------------------------------------------------
# fleet construction + traffic loop (CLI, chip_smoke.py)
# --------------------------------------------------------------------------


def build_fleet(base_arts, n_tenants: int, store_dir: str, device=None):
    """Populate an :class:`~repro_torch.core.fleet.ArtifactStore` (loading
    onto ``device``) with ``n_tenants`` artifacts derived from a handful of
    base fits: tenant i is an EXACT y-scaled variant
    (:func:`~repro_torch.core.fleet.scale_targets`) of
    ``base_arts[i % len(base_arts)]`` — distinct posteriors, same bucket, no
    per-tenant fit.  Returns ``(store, tenant_ids)``; ids are zero-padded
    strings so directory listings sort."""
    from ..core.fleet import ArtifactStore, scale_targets

    store = ArtifactStore(store_dir, device=device)
    width = max(4, len(str(n_tenants - 1)))
    tids = []
    for i in range(n_tenants):
        c = 0.25 + 1.5 * ((i * 2654435761) % 1000) / 1000.0  # spread scales
        tid = str(i).zfill(width)
        store.save(tid, scale_targets(base_arts[i % len(base_arts)], c))
        tids.append(tid)
    return store, tids


def zipf_tenants(tids, n_requests: int, a: float = 1.1, seed: int = 0):
    """A zipf-mixed request stream over the tenant ids: tenant popularity
    p(rank) ∝ 1/rank^a — a few hot tenants dominate, a long cold tail
    exercises cache misses and stack swaps."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(tids) + 1, dtype=np.float64)
    p = ranks ** (-float(a))
    p /= p.sum()
    order = rng.permutation(len(tids))  # popularity decoupled from id order
    return [tids[order[i]] for i in rng.choice(len(tids), size=n_requests, p=p)]


def serve_loop(server: FleetServer, tenant_stream, make_query,
               degraded_every: int = 0, degraded_avail=None) -> dict:
    """Drive a request stream through the server: submit every request,
    poll the deadline between submits, drain at the end.  Every
    ``degraded_every``-th flush-width block tags ONE tenant's request with
    the ``degraded_avail`` mask.  Returns the server's stats plus the
    completed-request count."""
    done = 0
    for i, tid in enumerate(tenant_stream):
        avail = None
        if degraded_every and degraded_avail is not None \
                and i % (degraded_every * server.batcher.slots) == 0:
            avail = degraded_avail
        done += len(server.submit(tid, make_query(i), avail))
        done += len(server.poll())
    done += len(server.drain())
    stats = server.stats()
    stats["completed"] = done
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", default="broadcast", choices=["center", "broadcast", "poe"])
    ap.add_argument("--gram-backend", default="pallas", choices=["xla", "pallas"],
                    help="pallas routes broadcast serving through the "
                         "tenant-batched fused epilogue kernel")
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--base-fits", type=int, default=2,
                    help="distinct fits; tenants are exact y-scaled variants")
    ap.add_argument("--m", type=int, default=4, help="machines per tenant")
    ap.add_argument("--n", type=int, default=256, help="points per tenant fit")
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cache", type=int, default=32, help="artifact cache capacity (count)")
    ap.add_argument("--cache-bytes", type=int, default=0,
                    help="artifact cache capacity in bytes (0 = unbounded)")
    ap.add_argument("--slots", type=int, default=8, help="micro-batch flush width")
    ap.add_argument("--stack-slots", type=int, default=0,
                    help="resident stack rows (0 = 2x slots)")
    ap.add_argument("--budget-ms", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16, help="query points per request")
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--store-dir", default=None,
                    help="tenant checkpoint store (default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import tempfile

    from ..core import DGPConfig, DistributedGP
    from ..kernels import runtime

    est = DistributedGP(DGPConfig(
        protocol=args.protocol,
        gram_backend=args.gram_backend,
        gram_mode="dense" if args.protocol == "poe" else "nystrom",
        bits_per_sample=0 if args.protocol == "poe" else args.bits,
        steps=args.steps,
    ), device=args.device)
    rng = np.random.default_rng(0)
    W = rng.normal(size=(args.d, 2))
    f = lambda Z: np.sin(Z @ W[:, 0]) + 0.4 * (Z @ W[:, 1])

    t0 = time.perf_counter()
    base_arts = []
    for b in range(args.base_fits):
        X = rng.normal(size=(args.n, args.d)).astype(np.float32)
        y = (f(X) + 0.05 * rng.normal(size=args.n)).astype(np.float32)
        base_arts.append(est.fit(X, y, args.m, generator=torch.Generator().manual_seed(b)))
    print(f"fit {args.base_fits} base artifact(s) in {time.perf_counter() - t0:.2f}s "
          f"on {est.device}")

    with tempfile.TemporaryDirectory() as td:
        store_dir = args.store_dir or td
        t0 = time.perf_counter()
        store, tids = build_fleet(base_arts, args.tenants, store_dir, device=est.device)
        print(f"stored {len(tids)} tenant artifacts under {store_dir} in "
              f"{time.perf_counter() - t0:.2f}s")
        server = FleetServer(
            store, cache_artifacts=args.cache, cache_bytes=args.cache_bytes or None,
            slots=args.slots, budget_ms=args.budget_ms,
            stack_slots=args.stack_slots or None, device=est.device,
        )
        stream = zipf_tenants(tids, args.requests, a=args.zipf)
        make_query = lambda i: rng.normal(size=(args.batch, args.d)).astype(np.float32)
        # the warm pass creates the stacks; the measured steady state must
        # then reallocate no stacked tensor and launch the fleet kernel
        # exactly once per fused flush (the single-tenant epilogue never)
        serve_loop(server, stream[: 4 * args.slots], make_query)
        server.reset_stats()
        ptrs = {s: s.data_ptrs() for s in server.stacks()}
        runtime.reset_launches()
        t0 = time.perf_counter()
        stats = serve_loop(server, stream, make_query)
        wall = time.perf_counter() - t0
        launches = runtime.launches()
        realloc = [s for s, p in ptrs.items() if s.data_ptrs() != p]
        qps = args.requests * args.batch / wall
        print(f"served {stats['completed']} requests x {args.batch} pts in "
              f"{wall:.2f}s -> {qps:.0f} q/s aggregate")
        print(f"latency p50 {stats['p50_ms']:.2f} ms  p99 {stats['p99_ms']:.2f} ms  "
              f"(budget {args.budget_ms} ms, flush width {args.slots})")
        c = stats["cache"]
        print(f"cache: {c['hits']} hits / {c['misses']} misses "
              f"(rate {c['hit_rate']:.2f}), {c['evictions']} evictions; "
              f"stacks: {stats['stacks']} bucket(s), {stats['stack_swaps']} tenant swaps")
        want = stats["fused_dispatches"] if est.device.type == "cuda" else 0
        print(f"flushes {stats['flushes']} (fused {stats['fused_dispatches']}); kernel "
              f"launches {launches}; stacks reallocated: {len(realloc)}")
        if realloc:
            raise SystemExit("FATAL: a stacked tensor was reallocated in the steady state")
        if launches.get("epilogue_fleet", 0) != want or launches.get("epilogue", 0):
            raise SystemExit(
                f"FATAL: expected {want} epilogue_fleet launches (one per fused flush) "
                f"and no single-tenant epilogue, got {launches}"
            )


if __name__ == "__main__":
    main()
