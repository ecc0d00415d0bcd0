#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero (nothing is caught and turned
into a pass):

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the eight Hopper kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel): build time, registers and shared memory
   per kernel; then the launch floor (a one-element in-place add, timed
   as the kernels are).
3. Each kernel (and the gram backward) against its plain PyTorch version on
   the card — at the main paths' shapes, one larger shape at the same width
   (40 machines x 1000 rows, d = 21, 4449 queries) and the edge layouts
   (R = 24 and R = 100 words, width-0 dims, masked rows, ragged tiles; for
   the epilogue all six fusion forms, ragged t and K, a large K, an expert
   of weight 0 and variances at their 1e-12 floor, the small variant's
   largest K (32) and one past it, each path's point tile whole and one
   point past it (t = 32/33 at K = 25, 2048/2049 on the 128-point tensor-
   core tile, 64/65 at K = 300), and a request-shape call counted as one
   device activity by ``torch.profiler``; for the fleet epilogue
   all six fusion forms at a fleet flush, a ragged case and serve-sized
   requests, each tenant also against the single-tenant kernel; for
   ``quant_encode`` / ``quant_decode`` bitwise at the kernels bench shape
   (n = 1024, d = 128, Algorithm-1 rates at 4 d bits, max 8), a 4096-edge
   row, a ragged shape with NaN, +-inf, on-edge symbols and rate-0 dims,
   and bits = 0, decode also at -1 and >= C (INT32_MAX among them) and at
   each ``decode_plan`` variant's edges (flat at 64 x 128, the tile at
   65 x 128, 64-row tiles at 33761 x 33, d = 1), through views with a
   storage offset or 4 bytes past a 16-byte boundary and on a table of
   NaN, +-inf and -0.0 (bit for bit), timed also at 65536 x 128 and with a
   256-entry row, each ``[time]`` and ``[kernel]`` line naming the plan;
   encode also on the tables
   of ``ENCODE_TABLE_KINDS`` (a decreasing row, a NaN edge, duplicates,
   -0.0 beside +0.0, +-inf edges) at E = 128 and at E = 4096 with
   n = 1024, and timed at n = 1024 against a 4096-edge row; ``qgram`` within TOL at
   (1024, 128, 1024), a ragged batched shape with -1 rows, a wide p (3001)
   and a ragged d (45) gathered from L2 and from staged tables;
   ``qgram_packed`` also at broadcast's fit call (40 x 25 x 1000, a
   projection per machine, timed) and at each variant of ``qgram.plan``
   (small, flat, wide, long) with its tile whole and one row or column
   past it, and at the wide variant with p odd, W = 4, width-0 dims and
   masked rows — every ``qgram`` and ``qgram_packed`` case checks the
   variant the plan names and the same bits on two launches, and a timed
   ``qgram_packed`` or fleet epilogue case times the autotune cache's plan,
   the paths' (checked against the plain version too);
   ``decode_attn`` within 1e-5 max|V| at the bench shape B = 8, S = 8192,
   KV = 4, G = 8, hd = 128 with bf16 K/V, a gemma2-2b local layer (G = 2,
   hd = 256, window 4096) on a permuted ring cache and on a ring in slot
   order (slot = kpos mod S), the bench shape partly filled (pos = 2047)
   and with fp32 K/V (the block kernel), a ragged S, rows with no valid key (an emptied row, window 0: the mean
   of V), window 1, a row whose valid slots all fall in one split and
   hd = 512 (the block kernel), and with gemma2's attention softcap (50)
   at the full-width decode step's shapes (B = 4, q bf16: a wrapped local
   ring of 4096, window 4096; a global cache of 8192 filled to 6003) and
   on the block kernel; two launches give the same bits) — with
   the max abs / relative error against the stated tolerance, and the
   device time of the kernel, the plain version and one PyTorch call that
   computes the same function where there is one (``torch.matmul``,
   ``torch.searchsorted``, ``torch.gather``,
   ``F.scaled_dot_product_attention``).  ``gram`` prints the plan (tile
   configuration / splits of K) of every timed product, checks the tiles'
   residency that ``gram.plan`` assumes against the card's occupancy,
   gives the same bits on two launches at 4449 x 40000, forward and
   backward (split K), and holds a ragged long-K product (130 x 21,
   K = 20000, split) forward and backward against the plain version.
4. The paths at the paper's Fig. 6 SARCOS setting (N = 1000, d = 21,
   m = 40, SE kernel, R = 24 bits/sample, 150 Adam steps, 4449 test points
   in 35 batches of 128), each on the card with ``gram_backend="pallas"``
   and its launch counts read from zero:
   a. §5.1 center: fit, save, load, serve.  Checks: ``gram`` launched
      during the fit, ``qgram_packed`` exactly once, and ``gram`` on every
      request; the loaded artifact's answers bitwise equal to the pre-save
      ones; the same checkpoint served on the CPU (plain versions) within
      tolerance; a finite SMSE below 1.
   b. §5.2 broadcast (KL fusion): the same, with ``gram`` launched
      during the fit, ``qgram_packed`` exactly once, and ``gram`` and
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
   e. the Fig. 6 wire through the quantizer kernels, on a.'s artifact,
      launch counts read from zero: each of the 40 machines' symbols
      X_i T_i^T encoded against ``build_scaled_tables(sigma_i, rates_i)``
      (== the plain version bitwise; == the wire's unpacked codes except
      within 2 ulp of an edge, counted) and decoded with the wire's
      4096-entry tables (== plain, bitwise); one ``qgram_batched`` launch
      over the 39 non-center machines (rows padded to 32 with -1, the
      center's ``proj``) against ``qgram_packed_batched`` on the same words
      and decode-then-multiply, within TOL.  Counts: 40 ``quant_encode``,
      40 ``quant_decode``, 1 ``qgram``, 1 ``qgram_packed``.
   f. ``runtime.shape_sweep`` over all eight families at the shapes above,
      counts read from zero; a ``nan`` in a ``"cuda"`` row fails the run.
   g. the paper's Fig. 6 at its full setting for one dataset, as
      ``python -m repro_torch.launch.fig56_regression --full`` runs it:
      SARCOS-shaped data, SE kernel, 1000 training points over 40 machines
      (the script's seeded numpy split), 150 Adam steps, the first 1000
      test points in requests of 128 (served four times), all
      ``gram_backend="pallas"``; the full GP, BCM, rBCM, center
      ``nystrom`` / ``direct`` / ``nystrom_fitc`` and broadcast
      ``nystrom`` / ``direct`` at R = 5, 16 and 40 (the zero-rate models
      once).  Per model and rate: SMSE, fit seconds, request p50 / p99
      (host clock, synchronized) and the launches of the fit and of every
      request read from zero and held to ``FIG6_LAUNCHES``.  For the three
      new modes at R = 16: save -> load -> the same answers bitwise, and the
      same fit on the CPU (same parts, same starting hyperparameters) with
      equal ledgers, its trained log-params, mu, var and SMSE within
      ``FIG6_PARAM_TOL``, ``FIG6_OUT_TOL`` and ``FIG6_SMSE_TOL`` of the
      card's.  Then the committed format-v1 checkpoint
      (``tests/fixtures/legacy_artifact``) loaded onto the card and served,
      within ``LEGACY_TOL`` of the same load on the CPU.
   h. streaming ``update`` (``stream_phase``) on a.'s center, b.'s
      broadcast and c.'s rBCM artifacts: eight batches of 16 fresh test
      rows (machines 1-7, then the center; the first crosses 1000 -> 1024
      columns, a later one 1024 -> 2048; poe's experts their own edges).
      Checks per batch: the launches of the update and of a request after
      it, from zero, exactly ``STREAM_LAUNCHES``; the ledgers' increments
      the ``comm/accounting.py`` formulas as integers; ``counts`` and
      ``cols``; the growth counter +1 at a bucket crossing and flat
      otherwise.  After the stream: the same stream on the CPU from the
      same checkpoint, its mu and var within ``STREAM_TOL`` of scale (the
      factors' differences printed);
      save -> load -> the same answers bitwise; one more update of the
      loaded artifact equal to that of the unsaved one.  Prints update
      p50 / p99 (host clock, synchronized) over the stream and over 32
      in-bucket repeats, and the aten ops and device kernels of one
      in-bucket update, after the card's name and power limit.
   i. fault injection (``fault_phase``) at the same width: center and
      broadcast (KL) fitted under ``drop_machine(3) | nan_shard(5) |
      corrupt_words(1e-3, seed=7)``, poe-rBCM under the drop and NaN shard,
      all ``gram_backend="pallas"``.  Checks: ``rows_demoted`` equal to the
      CRC mismatches recomputed from the flip masks (CRC-16 is affine over
      XOR, so a mask breaks a row's CRC whatever its words); ``fit_lengths``
      the transmitted lengths less the demotions, machine 3 empty; the
      ledgers the ``comm/accounting.py`` formulas on the transmitted
      lengths, as integers; launches from zero per fit and per request
      exactly ``FAULT_LAUNCHES`` (one ``qgram_packed`` over the survivors'
      compacted words); ``health()`` degraded, machine 3 lost, the
      demotions counted; with four more machines masked the KL
      ``variance_inflation`` m / m_alive and no variance below the healthy
      request's; SMSE finite and below 1, printed beside 4a-c's; save ->
      load bitwise with the plan in ``meta.json``; the same fit on the CPU
      with equal demotions, lengths and ledgers, trained log-params within
      ``FIG6_PARAM_TOL``, mu and var within ``FAULT_OUT_TOL`` of scale (the
      Nyström views' fused serve cancels: see the constant).  Then four corrupted 16-row batches into
      the center and broadcast artifacts (an update to machine 3 refused):
      the whole batch charged, the demotions the masks' CRC mismatches,
      launches ``STREAM_LAUNCHES``.  Then center and broadcast with
      ``scheme="vq"`` at R = 24 (no kernel: the config's ``xla`` rule):
      the ledger sum_j ceil(L_j R_j) + side info recomputed from the
      channels, payload == ledger, integrity 0, within 5 % of 4a-b's
      per-symbol ledger, one update charged ceil(16 R), save -> load
      bitwise, the CPU fit within ``FAULT_OUT_TOL``.  Prints fit seconds,
      request p50 / p99 and SMSE per path after the card's name and power
      limit.
   j. the paper's §4 experiments (``paper_phase``), each through its
      ``repro_torch.launch`` script at ``--full`` on the card and again on
      the CPU: Fig. 2 (d = 20, n = 4000, R = 5..120 in steps of 5), Fig. 3
      ((a)-(d): m = 1..19 on the d = 20 Gaussians, m = 2, 5, 10, 20, 40, 80
      at d = 784 with 1000 points a digit), the bit ablation (R = 5..120),
      Fig. 4 (n = 200, R = 1..8, 300 Adam steps, ``gram_backend="pallas"``)
      and Fig. 7 (KIN40K-shaped, 40 machines, 15 inducing points, 250
      steps, 2000 test points, R = 1..64, ``"pallas"``).  Checks: rates,
      allocations, wire and side-info bits equal to the CPU's (Fig. 7's
      allocations up to ``FIG7_RATE_FLIPS`` near-ties, its wire bits
      exactly); distortions within ``PAPER_TOL`` of scale, Fig. 4's
      MSEs within ``FIG4_TOL`` and Fig. 7's SMSE within ``FIG7_SMSE_TOL`` of
      the CPU's; codes equal but within ``CODE_ULPS`` ulp of a bin edge
      (counted); the paper's orderings at the reference tests' margins
      (e_dr <= 1.01 e_pca at every m, e_opt <= 1.05 e_ps and e_ps < e_dr at
      every R) wherever they hold on the CPU (one that the CPU breaks too is
      printed as a finding); ``gram`` launches from zero exactly as the
      docstring of ``paper_phase`` counts them, no kernel in Figs. 2, 3 and
      the ablation.
   k. the serving CLI (``serve_phase``): ``repro_torch.launch.serve_gp.
      main`` in-process at the paper's §6 widths (``SERVE_ARGS``: m = 40,
      R = 24, n = 2000, d = 21, 60 steps, 50 requests of 128, ``pallas``)
      for center (saved, reloaded and served, 16 rows streamed every 20
      requests), broadcast (KL) under ``drop:1,flip:0.01,straggle:3@0.05``
      with a 50 ms budget, poe-rBCM and a broadcast ``--fleet`` of 16
      tenants (cache 8, flushes of 4), then ``repro_torch.examples.
      quickstart`` and ``distributed_gp_sarcos``.  Checks: exit code 0,
      the contract ok with 0 cholesky / eigh; every warm request's
      launches exactly ``SERVE_RUNS``' counts, the profiler's hand-written
      kernels of one warm request the same, family by family, and one warm
      predict under ``torch.cuda.set_sync_debug_mode("error")``; the served
      answers against the same checkpoint served on the CPU; the ledgers
      the accounting formulas and ``rows_demoted`` the CRC failures
      recomputed from the flip masks, as integers; the fleet one
      ``epilogue_fleet`` per fused flush, no stacked tensor reallocated,
      and a four-tenant flush against each tenant served on the CPU; the
      examples' SMSE finite and the quickstart's orderings.  Phase 3 holds
      the kernels at these requests' shapes (gram 128 x 50 and 128 x 2000,
      the epilogue and a four-tenant flush at K = 50).
   l. ``impl="mesh"`` (``mesh_phase``): 40 spawned processes, one per
      machine, each on the card (gloo between them), fit broadcast (KL),
      poe-rBCM and center at the Fig. 6 setting (``xla``: the mesh runs no
      hand-written kernel, as the reference's runs no Pallas one), serve
      the 35 requests, save, and stream one 16-row batch; each held
      against a batched ``xla`` fit on the card on the same parts:
      ledgers equal and the formulas, mu and var within MESH_OUT_TOL of
      scale, the same bits on every rank, one ``c10d.allreduce_`` and no
      cholesky / eigh a warm broadcast / poe request (center: none), the
      update's increments the formulas', the checkpoint reloaded
      single-process within 1e-4, no kernel launched; then ``serve_gp
      --mesh`` at ``--m 4 --bits 24 --n 400 --steps 10 --queries 8``.
      Prints the ranks' start-up seconds, their contexts' memory, fit
      seconds and request p50 / p99 (``[mesh]`` lines).
   m. LLM decode serving (``decode_phase``): ``repro_torch.launch.serve.
      main`` for the ten reduced architectures on the card (B = 4, prompt
      32, gen 16), ``decode_attn`` launches from zero exactly 47 x the
      family's count (``models.attn_launches_per_step``: one a self or
      cross attention layer, none for xLSTM), one more step's first kernel
      call held against ``decode_attn_plain`` on its own q / K / V within
      1e-5 max|V|, each run teacher-forced again through the card and the
      CPU from the card's weights (``repro_torch.analysis.lockstep``: logits
      and state within 16 bf16 ulps of scale, kpos equal, greedy tokens
      equal at a clear margin, router flips only at MoE near-ties; the
      hybrid family's bf16 numbers reported only, and held in a float32 run
      of both devices to ``HYBRID_F32_TOL``); then
      gemma2-2b at full width (B = 4, prompt 32, gen 16, twice: ms/step,
      tokens/s, peak card memory) and three warm steps under
      ``torch.profiler`` (device time by kernel group against the host
      clock); then a full-width state of max_len 8192 filled to 5999 (the
      local rings wrapped), four steps, and at the last one a local and a
      global layer's kernel call held against ``decode_attn_plain`` on the
      step's own q / K / V within 1e-5 max|V| (``[decode]`` lines).
   n. LLM training (``train_phase``): one float32 train step of each of the
      ten reduced architectures on the card and on the CPU
      (``repro_torch.analysis.trainstep``: logits, loss, aux, every
      gradient leaf within ``trainstep.limits`` of scale, each update its
      own AdamW step in float64; bf16 reported); gemma2-2b at full width
      and depth 2 the same, then its params saved and restored onto the
      card bitwise; gemma2-2b at full width and depth (2.61 B params) 8
      steps at batch 8 x seq 256 (s/step, tokens/s, peak card memory; the
      losses finite and falling by ``TRAIN_FALL``; one step under
      ``set_sync_debug_mode("error")``); the trained weights served through
      ``decode_attn`` (26 launches a step, the last step's local and global
      calls held against ``decode_attn_plain``); ``qcomm_bits=8`` on 2 gloo
      ranks against exact training (tests/test_qcomm.py's criteria); the
      training CLI and the LM-to-GP-head example (``[train]`` lines).
   o. the dry run (``dryrun_phase``), each in a child process on a fake
      process group: gemma2-2b at 4n-c's batch on a 1 x 1 mesh on fake
      ``cuda`` tensors against one real step under the same cost counter
      (matmul FLOPs equal, the predicted peak within ``DRY_PEAK_BAND`` of
      the card's); one full-width decode step the same way (26
      ``decode_attn`` custom-op calls traced and none launched, 26 launched
      on the card, FLOPs equal); ``python -m repro_torch.launch.dryrun`` on
      the reference's CLI test combo and gemma2-2b train_4k on both
      production meshes (``[dryrun]`` lines).
   p. the autotune cache (``autotune_phase``).  ``REPRO_TUNE_CACHE`` is
      set at the start to a new ``build/chip_smoke_autotune.json``, so every
      run sweeps cold and the phases above run the tuned plans.  At
      ``TUNE_QGRAM``'s three ``qgram_packed`` calls and ``TUNE_FLEET``'s
      three fleet launches, every feasible candidate held against the plain
      version (``TOL`` of scale; ``epilogue_fleet_error_bound``) and timed,
      the winner and the pure plan printed beside them; then a child
      process on the same file: zero sweeps and the same winners; on an
      empty file one sweep a key, and launch counts that hold only its
      calls (``[autotune]`` lines).
5. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the repository's ``src/repro_torch`` beside it,
the script fails before printing any result.  It imports nothing of JAX.
"""
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores (data sheet)
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
TOL = 1e-5  # of max(|A| |B|^T): fp32 sums in different orders, no TF32
U32 = 2.0 ** -24  # fp32 unit roundoff


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# phase g: the Fig. 6 experiment at the paper's full setting
FIG6_RATES = (5, 16, 40)
FIG6_COMPARE_RATE = 16  # save -> load and card-vs-CPU for the new modes
FIG6_NEW = ("center_direct", "center_nystrom_fitc", "broadcast_direct")
# the launches each model's fit and each request must make, from zero:
# {kernel: count}, every other kernel 0; None = at least one (the full GP's
# fit: one gram launch per Adam step and one for its factors)
FIG6_LAUNCHES = {
    "full": ({"gram": None}, {"gram": 1}),
    "bcm": ({"gram": 1}, {"gram": 1}),
    "rbcm": ({"gram": 1}, {"gram": 1}),
    "center_nystrom": ({"gram": 1, "qgram_packed": 1}, {"gram": 1}),
    "center_direct": ({"gram": 1, "qgram_packed": 1}, {"gram": 1, "qgram_packed": 1}),
    "center_nystrom_fitc": ({"gram": 1, "qgram_packed": 1}, {"gram": 1}),
    "broadcast_nystrom": ({"gram": 1, "qgram_packed": 1}, {"gram": 1, "epilogue": 1}),
    "broadcast_direct": ({"gram": 1, "qgram_packed": 2}, {"gram": 1, "qgram_packed": 1}),
}
# the card's fit against the same fit on the CPU (same parts, same starting
# hyperparameters, 150 Adam steps each), for the new modes at R = 16: the
# two devices round their fp32 sums differently and 150 steps carry that
# into the trained hyperparameters.  Limits, from the H100 readings of the
# first two runs of this phase (the same on both) and a CPU rehearsal:
# - trained log-params, max |diff|: read 1.30e-6 to 1.67e-6;
FIG6_PARAM_TOL = 1e-4
# - mu and var, max |diff| over the 1000 test points, as a fraction of
#   max(1, max |CPU value|) (mu's scale ~4.6, var's ~0.8-1.8): a CPU fit
#   started 1e-6 off in every log-param moves them by up to 1.3e-5 of scale;
FIG6_OUT_TOL = 1e-4
# - SMSE (~0.086-0.116), |diff|: read 1.34e-7 to 1.94e-7.
FIG6_SMSE_TOL = 1e-5
# the v1 fixture served on the card against the CPU, max |diff| as a fraction
# of max(1, max |CPU value|): read 1.7e-6 (mu) and 8.2e-6 (var) of scale on
# the H100, the same in both runs; the limit keeps a margin of six
LEGACY_TOL = 5e-5


def _launch_check(tag, got, want):
    """``got`` (launches read from zero) against ``want`` (see FIG6_LAUNCHES)."""
    for k, v in got.items():
        w = want.get(k, 0)
        ok = v > 0 if w is None else v == w
        check(ok, f"{tag}: launched {k} {v} times, expected {'some' if w is None else w} "
                  f"(all: {got})")


def fig6_phase(dev, n_train=None, n_test=1000, m=40, steps=150, rates=FIG6_RATES,
               compare_rate=FIG6_COMPARE_RATE, passes=4, batch=128):
    """The paper's Fig. 6 on one dataset (SARCOS-shaped, SE kernel) through
    ``repro_torch.launch.fig56_regression`` with ``gram_backend="pallas"``:
    every model at every rate fitted on ``dev``, the first ``n_test`` test
    points served ``passes`` times in requests of ``batch``, launch counts
    read from zero per fit and per request.  For the new gram modes at
    ``compare_rate``: save -> load -> the same answers bitwise, and the same
    fit on the CPU within FIG6_PARAM_TOL / FIG6_OUT_TOL / FIG6_SMSE_TOL.
    Then the committed legacy checkpoint served on ``dev`` against the CPU
    within LEGACY_TOL.  Returns
    {path: launches} for the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core import DistributedGP
    from repro_torch.core.gp import init_params
    from repro_torch.data.synthetic import regression_dataset
    from repro_torch.kernels import runtime
    from repro_torch.launch import fig56_regression as fig56

    X, y, Xt, yt = regression_dataset("sarcos", seed=0)
    if n_train:
        X, y = X[:n_train], y[:n_train]
    Xt, yt = Xt[:n_test], yt[:n_test]
    parts = fig56.machine_parts(X, y, m, seed=0)
    runtime.families()  # every family registered, so every count reads from zero
    start = init_params()  # the same starting hyperparameters on both devices
    reqs = [Xt[i:i + batch] for i in range(0, n_test, batch)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    print(f"[fig6] SARCOS-shaped, SE kernel, {X.shape[0]} training points over {m} "
          f"machines, {steps} Adam steps, {n_test} test points in {len(reqs)} requests "
          f"of <= {batch}, served {passes} times; rates {rates}; gram_backend=pallas",
          flush=True)
    path_launches, table = {}, {}
    for model in fig56.MODELS:
        want_fit, want_req = FIG6_LAUNCHES[model]
        for R in ((0,) if model in fig56.ZERO_RATE else rates):
            tag = f"{model} R={R}"
            runtime.reset_launches()
            sync()
            t0 = time.perf_counter()
            predict, fitted = fig56.fit_model(model, parts, "se", R, steps, "pallas", dev,
                                              params=start)
            sync()
            fit_s = time.perf_counter() - t0
            fit_launches = runtime.launches()
            _launch_check(f"fig6 {tag} fit", fit_launches, want_fit)
            runtime.reset_launches()
            times, answers = [], []
            for _ in range(passes):
                out = []
                for xb in reqs:
                    before = runtime.launches()
                    sync()
                    t = time.perf_counter()
                    out.append(predict(xb))
                    sync()
                    times.append((time.perf_counter() - t) * 1e3)
                    after = runtime.launches()
                    _launch_check(f"fig6 {tag} request",
                                  {k: after[k] - before[k] for k in after}, want_req)
                answers.append(out)
            req_launches = runtime.launches()
            path_launches[f"fig6 {tag}"] = {k: fit_launches[k] + req_launches[k]
                                            for k in fit_launches}
            mu = torch.cat([a[0] for a in answers[0]])
            var = torch.cat([a[1] for a in answers[0]])
            check(all(torch.equal(torch.cat([a[0] for a in o]), mu) for o in answers),
                  f"fig6 {tag}: a later pass answered differently")
            check(bool(torch.isfinite(var).all()) and bool((var > 0).all()),
                  f"fig6 {tag}: non-finite or non-positive predictive variances")
            e = fig56.smse(yt, mu.cpu().numpy())
            check(np.isfinite(e), f"fig6 {tag}: SMSE {e} is not finite")
            table[model, R] = e
            t_ms = np.array(times)
            print(f"[fig6] {model:20s} R={R:3d}  SMSE {e:.4f}  fit {fit_s:.3f} s  request "
                  f"p50 {np.percentile(t_ms, 50):.3f} ms  p99 {np.percentile(t_ms, 99):.3f} ms "
                  f"({len(t_ms)} requests, host clock)  wire "
                  f"{getattr(fitted, 'wire_bits', 0)} bits  fit launches "
                  f"{ {k: v for k, v in fit_launches.items() if v} }  per request "
                  f"{ {k: v // len(t_ms) for k, v in req_launches.items() if v} }", flush=True)
            if model not in FIG6_NEW or R != compare_rate:
                continue
            # save -> load -> the same answers, bit for bit
            est = DistributedGP(fitted.config, device=dev)
            ckpt = ROOT / "build" / f"chip_smoke_fig6_{model}"
            shutil.rmtree(ckpt, ignore_errors=True)
            est.save(fitted, str(ckpt))
            back = est.load(str(ckpt))
            shutil.rmtree(ckpt, ignore_errors=True)
            again = [est.predict(back, xb) for xb in reqs]
            check(torch.equal(torch.cat([a[0] for a in again]), mu)
                  and torch.equal(torch.cat([a[1] for a in again]), var),
                  f"fig6 {tag}: the loaded artifact's answers differ from the pre-save answers")
            # the same fit on the CPU
            t0 = time.perf_counter()
            predict_c, fitted_c = fig56.fit_model(model, parts, "se", R, steps, "pallas",
                                                  "cpu", params=start)
            out_c = [predict_c(xb) for xb in reqs]
            mu_c = torch.cat([o[0] for o in out_c])
            var_c = torch.cat([o[1] for o in out_c])
            e_c = fig56.smse(yt, mu_c.numpy())
            d_p = max(abs(float(a) - float(b)) for a, b in zip(fitted.params, fitted_c.params))
            ledgers = (fitted.wire_bits, fitted.payload_bits, fitted.integrity_bits)
            ledgers_c = (fitted_c.wire_bits, fitted_c.payload_bits, fitted_c.integrity_bits)
            print(f"[fig6] {model} R={R}: loaded == pre-save (bitwise); CPU fit + serve "
                  f"{time.perf_counter() - t0:.1f} s: SMSE {e_c:.6f} vs card {e:.6f} "
                  f"(|diff| {abs(e - e_c):.2e}, tol {FIG6_SMSE_TOL:.0e}); trained log-params "
                  f"max |diff| {d_p:.2e} (tol {FIG6_PARAM_TOL:.0e}); ledgers (wire, payload, "
                  f"integrity) card {ledgers} CPU {ledgers_c}", flush=True)
            check(abs(e - e_c) <= FIG6_SMSE_TOL,
                  f"fig6 {tag}: card SMSE {e} and CPU SMSE {e_c} differ by more than "
                  f"{FIG6_SMSE_TOL}")
            check(d_p <= FIG6_PARAM_TOL,
                  f"fig6 {tag}: the card's trained log-params differ from the CPU's by {d_p}")
            for name, a, b in (("mu", mu, mu_c), ("var", var, var_c)):
                err = float((a.cpu() - b).abs().max())
                tol = FIG6_OUT_TOL * max(1.0, float(b.abs().max()))
                print(f"[fig6] {model} R={R}: card vs CPU {name} max |diff| {err:.3e} "
                      f"(tol {tol:.2e})", flush=True)
                check(err <= tol, f"fig6 {tag}: the card's {name} differs from the CPU's "
                                  f"by {err}, more than {tol}")
            check(ledgers == ledgers_c, f"fig6 {tag}: the card's ledgers differ from the CPU's")
    print("[fig6] SMSE table (rows: model; columns: R = " + ", ".join(map(str, rates))
          + "; zero-rate models in every column):", flush=True)
    for model in fig56.MODELS:
        row = [table[model, 0 if model in fig56.ZERO_RATE else R] for R in rates]
        print(f"[fig6]   {model:20s} " + "  ".join(f"{v:.4f}" for v in row), flush=True)
    # the committed format-v1 checkpoint (no config, unpacked codes) served,
    # against the CPU within LEGACY_TOL of the output's scale: its unfused
    # serve runs triangular solves against a 12 x 12 L_KK, whose conditioning
    # amplifies the devices' different fp32 rounding
    fixture = ROOT / "tests" / "fixtures" / "legacy_artifact"
    Xf = np.load(fixture / "expected.npz")["Xt"]
    dev_est, cpu_est = DistributedGP(device=dev), DistributedGP(device="cpu")
    runtime.reset_launches()
    art = dev_est.load(str(fixture))
    mu, var = dev_est.predict(art, Xf)
    path_launches["legacy fixture"] = runtime.launches()
    mu_c, var_c = cpu_est.predict(cpu_est.load(str(fixture)), Xf)
    for name, a, b in (("mu", mu, mu_c), ("var", var, var_c)):
        err = float((a.cpu() - b).abs().max())
        tol = LEGACY_TOL * max(1.0, float(b.abs().max()))
        print(f"[fig6] legacy v1 fixture ({art.config.protocol}, R={art.bits_per_sample}, "
              f"{len(art.fit_lengths)} machines) on {dev.type} vs CPU: {name} max |diff| "
              f"{err:.3e} (tol {tol:.1e})", flush=True)
        check(bool(torch.isfinite(a).all()) and err <= tol,
              f"legacy fixture: the {dev.type} serve disagrees with the CPU's on {name}")
    return path_launches


# phase h: streaming update() on a.'s, b.'s and c.'s artifacts
# (machine, rows) of each batch: machines 1-7 in turn, then the center
STREAM_BATCHES = tuple((j, 16) for j in (1, 2, 3, 4, 5, 6, 7, 0))
# the launches of one update and of one request after it, from zero:
# {kernel: count}, every other kernel 0.  The center's new cross-gram
# k(Xc, X̂_new) is one gram launch; broadcast's products against the shard
# bases stay a batched matmul (the reference's einsum) and poe's gram is
# the plain one, as the reference's updates run outside any kernel
STREAM_LAUNCHES = {
    "center": ({"gram": 1}, {"gram": 1}),
    "broadcast": ({}, {"gram": 1, "epilogue": 1}),
    "poe-rbcm": ({}, {"gram": 1}),
}
# the card's streamed answers against the CPU's (the same checkpoint, the
# same stream, plain versions), max |diff| per output as a fraction of
# max(1, max |CPU value|).  Both devices recompute the factors in float32:
# alpha's woodbury solve divides a cancelling difference by s2 and the
# serve's projector P = (U - U M^{-1} U) / s2 cancels again, so the two
# devices' rounding of the new W columns (another matmul and triangular
# solve; W 5e-7 to 1.4e-6 apart) reaches walpha at up to 4.7e-4.  Read on
# the H100: center mu 1.08e-4, var 6.93e-4; broadcast 9.3e-5, 2.4e-4; rBCM
# 9.7e-7, 8.9e-8 (before the stream the same checkpoint's answers: up to
# 2.7e-4, the serve alone); the limit keeps a margin of seven
STREAM_TOL = 5e-3
STREAM_STEADY = 32  # repeated in-bucket updates of the last state, timed


def _op_counts(fn):
    """(aten ops dispatched, device kernels run, leading sentinel records
    the profiler dropped) by one call of ``fn`` each: ``repro_torch.
    analysis.op_walk``'s TorchDispatchMode count (without its
    ``copy_to_host`` tally) and its ``kernel_trace`` (none off the card)."""
    from repro_torch.analysis.op_walk import kernel_trace, record_ops

    ops = record_ops(fn)
    names, lost = kernel_trace(fn)
    return sum(n for k, n in ops.items() if k != "copy_to_host"), len(names), lost


def stream_phase(dev, arts, X_new, y_new, X_q, batch=128):
    """Streaming ``update`` on each fitted artifact of ``arts`` ({name: art
    on ``dev``}): the batches of STREAM_BATCHES (rows of ``X_new``/``y_new``
    in turn), each update's and each following request's launches read
    from zero and held to STREAM_LAUNCHES, the ledgers' increments to the
    accounting formulas, ``counts``/``cols``, the growth counter to the
    bucket crossings; the same stream applied on the CPU to the same
    checkpoint, its answers at ``X_q`` against the card's (STREAM_TOL);
    save -> load -> the same answers bitwise, and one more
    update of the loaded artifact equal to that of the unsaved one.
    Prints update p50 / p99 (host clock, synchronized) over the stream and
    over STREAM_STEADY in-bucket repeats, and the aten ops and device
    kernels of one in-bucket update.  Returns {path: launches}."""
    import numpy as np
    import torch

    from repro_torch.comm.accounting import CRC_BITS, payload_row_bits
    from repro_torch.core import DistributedGP
    from repro_torch.core.protocols.base import update_growth_count
    from repro_torch.kernels import runtime

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    runtime.families()
    reqs = [X_q[i:i + batch] for i in range(0, X_q.shape[0], batch)]
    path_launches = {}

    def serve(est, art):
        out = [est.predict(art, xb) for xb in reqs]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    def counters(art):
        return (art.lengths, int(art.stream.cols), art.wire_bits, art.payload_bits,
                art.integrity_bits)

    for name, art in arts.items():
        est, cpu = DistributedGP(art.config, device=dev), DistributedGP(art.config, device="cpu")
        want_update, want_request = STREAM_LAUNCHES[name]
        ckpt = ROOT / "build" / f"chip_smoke_stream_{name.split('-')[0]}"
        shutil.rmtree(ckpt, ignore_errors=True)
        est.save(art, str(ckpt))
        art_c = cpu.load(str(ckpt))
        base = [(a.cpu() - b).abs().max() for a, b in zip(serve(est, art), serve(cpu, art_c))]
        d = art.data["Xs" if "Xs" in art.data else "X_recon"].shape[-1]
        rates = None if art.wire is None else art.wire.rates.cpu()
        center = art.block_order[0] if art.block_order else None
        runtime.reset_launches()
        times, row = [], 0
        for j, n in STREAM_BATCHES:
            Xb, yb = X_new[row:row + n], y_new[row:row + n]
            row += n
            before, g0 = counters(art), update_growth_count(art.protocol)
            crossing = before[1] + n > int(art.y.shape[-1])
            l0 = runtime.launches()
            sync()
            t = time.perf_counter()
            art = est.update(art, Xb, yb, machine=j)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            grew = update_growth_count(art.protocol) - g0
            l1 = runtime.launches()
            _launch_check(f"stream {name} update (machine {j})",
                          {k: l1[k] - l0[k] for k in l1}, want_update)
            est.predict(art, reqs[0])
            sync()
            l2 = runtime.launches()
            _launch_check(f"stream {name} request after an update",
                          {k: l2[k] - l1[k] for k in l2}, want_request)
            art_c = cpu.update(art_c, Xb, yb, machine=j)
            after = counters(art)
            sends = rates is not None and j != center
            wire = int(rates[j].sum()) * n if sends else 0
            payload = payload_row_bits(art.bits_per_sample, d, art.max_bits) * n if sends else 0
            check(tuple(a - b for a, b in zip(after[2:], before[2:]))
                  == (wire, payload, CRC_BITS * n if sends else 0),
                  f"stream {name}: ledger increments {after[2:]} - {before[2:]} are not the "
                  f"accounting formulas' ({wire}, {payload}, ...)")
            check(after[1] == before[1] + n and after[0][j] == before[0][j] + n
                  and all(a == b for q, (a, b) in enumerate(zip(after[0], before[0])) if q != j),
                  f"stream {name}: counts/cols {after[:2]} after {before[:2]} + {n} at {j}")
            check(grew == int(crossing),
                  f"stream {name}: the growth counter moved {grew} at a batch that "
                  f"{'crossed' if crossing else 'did not cross'} a bucket edge")
            check(counters(art_c) == after, f"stream {name}: the CPU's counters differ")
        path_launches[f"stream {name}"] = runtime.launches()
        mu, var = serve(est, art)
        mu_c, var_c = serve(cpu, art_c)
        rel = {k: float((v.cpu() - art_c.factors[k]).abs().max()
                        / max(1.0, float(art_c.factors[k].abs().max())))
               for k, v in art.factors.items()}
        print(f"[stream] {name}: card vs CPU factors after the stream, max |diff| / max(1, "
              f"max |CPU|): " + "  ".join(f"{k} {v:.2e}" for k, v in sorted(rel.items())),
              flush=True)
        errs = []
        for label, a, b, b0 in (("mu", mu, mu_c, base[0]), ("var", var, var_c, base[1])):
            scale = max(1.0, float(b.abs().max()))
            err = float((a.cpu() - b).abs().max())
            errs.append((label, err, scale, bool(torch.isfinite(a).all())))
            print(f"[stream] {name}: card vs CPU after {len(STREAM_BATCHES)} updates: {label} "
                  f"max |diff| {err:.3e} = {err / scale:.2e} of scale {scale:.3f} (before the "
                  f"stream {float(b0):.3e}; tol {STREAM_TOL:.0e} of scale)", flush=True)
        for label, err, scale, finite in errs:
            check(finite and err <= STREAM_TOL * scale,
                  f"stream {name}: the card's streamed {label} differs from the CPU's by {err}")
        shutil.rmtree(ckpt, ignore_errors=True)
        est.save(art, str(ckpt))
        back = est.load(str(ckpt))
        shutil.rmtree(ckpt, ignore_errors=True)
        got = serve(est, back)
        check(torch.equal(got[0], mu) and torch.equal(got[1], var),
              f"stream {name}: the loaded streamed artifact answers differently")
        j, n = STREAM_BATCHES[0]
        Xb, yb = X_new[row:row + n], y_new[row:row + n]
        more, more_back = est.update(art, Xb, yb, machine=j), est.update(back, Xb, yb, machine=j)
        check(counters(more_back) == counters(more)
              and counters(more_back)[1] == counters(art)[1] + n
              and all(torch.equal(a, b) for a, b in zip(serve(est, more_back), serve(est, more))),
              f"stream {name}: an update after the load does not continue the stream")
        steady = []
        for _ in range(STREAM_STEADY):
            sync()
            t = time.perf_counter()
            est.update(art, Xb, yb, machine=j)
            sync()
            steady.append((time.perf_counter() - t) * 1e3)
        ops, kernels, lost = _op_counts(lambda: est.update(art, Xb, yb, machine=j))
        K = art.factors["L_M" if "L_M" in art.factors else "L"].shape[-1]
        print(f"[stream] {name}: {len(STREAM_BATCHES)} updates of {n} rows, cols "
              f"{int(arts[name].stream.cols)} -> {int(art.stream.cols)} (capacity "
              f"{int(art.y.shape[-1])}), ledgers wire {art.wire_bits} payload "
              f"{art.payload_bits} integrity {art.integrity_bits}; update p50 "
              f"{np.percentile(times, 50):.3f} ms p99 {np.percentile(times, 99):.3f} ms over "
              f"the stream, in-bucket p50 {np.percentile(steady, 50):.3f} ms p99 "
              f"{np.percentile(steady, 99):.3f} ms over {STREAM_STEADY} (host clock, "
              f"synchronized); one in-bucket update: {ops} aten ops, {kernels} device "
              f"kernels (the profiler dropped {lost} leading sentinel records) (factor side "
              f"{K}); loaded == saved (bitwise), a further update "
              f"continues the stream; launches {path_launches[f'stream {name}']}", flush=True)
    return path_launches


# phase i: fault injection, CRC demotion, degraded serving and the vq channel
# drop machine 3, NaN-poison half of machine 5, flip each wire bit with 1e-3
FAULT_DROP, FAULT_NAN, FAULT_FLIP, FAULT_SEED = 3, 5, 1e-3, 7
# the launches each faulted fit and each request must make, from zero:
# {kernel: count}, every other kernel 0.  A corrupted fit reads the
# survivors' compacted words through one qgram_packed launch; the vq paths
# run gram_backend="xla" (the config's rule: no int codes), so no kernel
FAULT_LAUNCHES = {
    "center": ({"gram": 1, "qgram_packed": 1}, {"gram": 1}),
    "broadcast": ({"gram": 1, "qgram_packed": 1}, {"gram": 1, "epilogue": 1}),
    "poe-rbcm": ({"gram": 1}, {"gram": 1}),
    "vq center": ({}, {}),
    "vq broadcast": ({}, {}),
}
# the card's fits against the same fits on the CPU (same parts, same plan,
# 150 Adam steps each), max |diff| of mu and var as a fraction of max(1,
# max |CPU value|).  Every wire path of this phase serves Nyström views
# whose variance cancels (the fused serve's P = (U - U M^{-1} U) / s2), so
# FIG6_OUT_TOL, set from the direct and fitc modes, does not hold here:
# phase 4a's CPU serve of the card's own healthy checkpoint already reads
# var 9.9e-4 (2.7e-4 of scale).  Read on the H100 in this phase: center mu
# 2.3e-4, var 2.7e-4; broadcast 1.7e-4, 1.9e-4; vq center 1.5e-4, 2.9e-4;
# vq broadcast 9.6e-5, 1.8e-4; rBCM 1.5e-6, 4.1e-6.  The limit keeps a
# margin of seven over the largest; the trained log-params are held to
# FIG6_PARAM_TOL besides (read 6.6e-7 to 5.0e-5)
FAULT_OUT_TOL = 2e-3
FAULT_MASKED = (7, 11, 19, 23)  # the degraded request masks these besides machine 3
FAULT_STREAM = (1, 2, 4, 6)  # the machines of the four corrupted 16-row batches


def fault_phase(dev, parts, X_q, y_q, per_symbol, X_new, y_new, steps=150, batch=128):
    """Phase i on ``dev``: center, broadcast (KL) and poe-rBCM fitted under
    a fault plan (drop, NaN shard and, for the two wire protocols, bit
    flips), with ``gram_backend="pallas"``; then corrupted streaming into
    the center and broadcast artifacts; then center and broadcast fitted
    with ``scheme="vq"``.  ``parts``: the machines' shards; ``X_q``/``y_q``:
    the test points, served in requests of ``batch``; ``per_symbol``:
    {path: (SMSE, wire_bits)} of the healthy per-symbol fits, printed
    beside; ``X_new``/``y_new``: the streamed rows.  Every check is a
    ``check``; returns {path: launches} for the kernels line."""
    import numpy as np
    import torch

    from repro_torch import faults
    from repro_torch.comm.accounting import (
        CRC_BITS, integrity_bits_formula, payload_bits_formula, payload_row_bits,
        row_bits, side_info_bits, wire_bits_formula,
    )
    from repro_torch.core import DGPConfig, DistributedGP
    from repro_torch.core import torch_scheme as TS
    from repro_torch.core.rate_distortion import distortion_for_rate, make_test_channel
    from repro_torch.kernels import runtime

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    runtime.families()
    m, d = len(parts), parts[0][0].shape[1]
    reqs = [X_q[i:i + batch] for i in range(0, X_q.shape[0], batch)]
    y_true = torch.as_tensor(y_q)
    smse = lambda mu: float(((mu.cpu() - y_true) ** 2).mean() / y_true.var(unbiased=False))
    data_plan = faults.drop_machine(FAULT_DROP) | faults.nan_shard(FAULT_NAN)
    wire_plan = data_plan | faults.corrupt_words(FAULT_FLIP, seed=FAULT_SEED)
    path_launches, summary = {}, []

    def crc_failures(shape, stream):
        """Rows of one transmission whose CRC the flip mask breaks: CRC-16 is
        affine over XOR, so crc(w ^ e) != crc(w) exactly when
        crc(e) != crc(0), whatever the words."""
        e = faults.flip_mask(shape, FAULT_FLIP, FAULT_SEED, stream)
        return int((TS.crc_words(e) != TS.crc_words(torch.zeros_like(e))).sum())

    def serve(est, art, name, want_request, available=None):
        """The requests on ``art``, each one's launches held to
        ``want_request``; returns (mu, var, request ms)."""
        mus, vars_, times = [], [], []
        for xb in reqs:
            before = runtime.launches()
            sync()
            t = time.perf_counter()
            mu, var = est.predict(art, xb, available=available)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            after = runtime.launches()
            _launch_check(f"fault {name} request", {k: after[k] - before[k] for k in after},
                          want_request)
            mus.append(mu)
            vars_.append(var)
        return torch.cat(mus), torch.cat(vars_), np.array(times)

    def fit(cfg, on=None):
        est = DistributedGP(cfg, device=on or dev)
        runtime.reset_launches()
        sync()
        t0 = time.perf_counter()
        art = est.fit(parts=parts)
        sync()
        return est, art, time.perf_counter() - t0, runtime.launches()

    def roundtrip(est, art, name, mu, var, plan):
        ckpt = ROOT / "build" / f"chip_smoke_fault_{name.replace(' ', '_')}"
        shutil.rmtree(ckpt, ignore_errors=True)
        est.save(art, str(ckpt))
        meta = json.loads(next(ckpt.glob("meta*.json")).read_text())
        back = est.load(str(ckpt))
        shutil.rmtree(ckpt, ignore_errors=True)
        want = None if plan is None else json.loads(json.dumps(plan.asdict()))
        check(meta["config"]["faults"] == want,
              f"fault {name}: meta.json carries {meta['config']['faults']}, not the plan")
        check(back.config == art.config and back.rows_demoted == art.rows_demoted,
              f"fault {name}: the loaded artifact's config or demotions differ")
        runtime.reset_launches()
        mu2, var2, _ = serve(est, back, name, FAULT_LAUNCHES[name][1])
        check(torch.equal(mu2, mu) and torch.equal(var2, var),
              f"fault {name}: the loaded artifact's answers differ from the pre-save answers")

    def against_cpu(cfg, name, art, mu, var):
        _, art_c, fit_c, _ = fit(cfg, on="cpu")
        d_p = max(abs(float(a) - float(b)) for a, b in zip(art.params, art_c.params))
        check(d_p <= FIG6_PARAM_TOL,
              f"fault {name}: the card's trained log-params differ from the CPU's by {d_p}")
        est_c = DistributedGP(cfg, device="cpu")
        out = [est_c.predict(art_c, xb) for xb in reqs]
        mu_c, var_c = torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
        ints = lambda a: (a.rows_demoted, a.lengths, a.wire_bits, a.payload_bits,
                          a.integrity_bits)
        check(ints(art_c) == ints(art),
              f"fault {name}: the CPU fit's demotions, lengths or ledgers {ints(art_c)} "
              f"differ from the card's {ints(art)}")
        errs = []
        for label, a, b in (("mu", mu, mu_c), ("var", var, var_c)):
            err = float((a.cpu() - b).abs().max())
            tol = FAULT_OUT_TOL * max(1.0, float(b.abs().max()))
            errs.append(f"{label} max |diff| {err:.3e} (tol {tol:.2e})")
            check(err <= tol, f"fault {name}: the card's {label} differs from the CPU's by "
                              f"{err}, more than {tol}")
        print(f"[fault] {name}: the same fit on the CPU ({fit_c:.1f} s): equal demotions, "
              f"lengths and ledgers; trained log-params max |diff| {d_p:.2e} (tol "
              f"{FIG6_PARAM_TOL:.0e}); {'; '.join(errs)}", flush=True)

    # -- faulted fits -------------------------------------------------------
    sent, _ = faults.apply_to_parts([(np.asarray(X), np.asarray(y)) for X, y in parts],
                                    data_plan)
    L_tx = [X.shape[0] for X, _ in sent]
    W = TS.row_words(row_bits(24, d, 12))
    arts = {}
    for name, proto in (("center", {}), ("broadcast", {"protocol": "broadcast", "fusion": "kl"}),
                        ("poe-rbcm", {"protocol": "poe", "fusion": "rbcm"})):
        plan = data_plan if name == "poe-rbcm" else wire_plan
        cfg = DGPConfig(gram_backend="pallas", steps=steps, bits_per_sample=24, faults=plan,
                        **proto)
        est, art, fit_s, fit_launches = fit(cfg)
        _launch_check(f"fault {name} fit", fit_launches, FAULT_LAUNCHES[name][0])
        skip = 0 if name == "center" else None
        tx = [j for j in range(m) if j != skip and L_tx[j] > 0]
        if name == "poe-rbcm":
            want_demoted, per_machine = 0, [0] * m
            ledgers = (0, 0, 0)
        else:
            per_machine = [crc_failures((L_tx[j], W), j) if j in tx else 0 for j in range(m)]
            want_demoted = sum(per_machine)
            rates = art.wire.rates.cpu().numpy()
            ledgers = (wire_bits_formula(rates, L_tx, d, skip=skip),
                       payload_bits_formula(L_tx, d, 24, 12, skip=skip),
                       integrity_bits_formula(L_tx, skip=skip))
        check(art.rows_demoted == want_demoted,
              f"fault {name}: {art.rows_demoted} rows demoted, the masks' CRCs say "
              f"{want_demoted}")
        check(art.fit_lengths[FAULT_DROP] == 0 and list(art.fit_lengths)
              == [L_tx[j] - per_machine[j] for j in range(m)],
              f"fault {name}: fit lengths {art.fit_lengths} are not the transmitted "
              f"{L_tx} less the demotions")
        check((art.wire_bits, art.payload_bits, art.integrity_bits) == ledgers,
              f"fault {name}: ledgers {(art.wire_bits, art.payload_bits, art.integrity_bits)} "
              f"are not the formulas on the transmitted lengths {ledgers}")
        runtime.reset_launches()
        mu, var, t_ms = serve(est, art, name, FAULT_LAUNCHES[name][1])
        path_launches[f"fault {name}"] = {k: fit_launches[k] + v
                                          for k, v in runtime.launches().items()}
        e = smse(mu)
        check(bool(torch.isfinite(mu).all()) and bool((var > 0).all()) and np.isfinite(e)
              and e < 1.0, f"fault {name}: SMSE {e} or the variances are not sane")
        h = est.health(art)
        inflation = m / (m - 1) if name == "broadcast" else 1.0
        check(h.status == "degraded" and h.machines == m and h.machines_lost == (FAULT_DROP,)
              and h.rows_demoted == want_demoted and h.variance_inflation == inflation,
              f"fault {name}: health() reports {h}")
        print(f"[fault] {name}: fit {fit_s:.3f} s, {sum(L_tx)} rows after the data faults, "
              f"{sum(L_tx[j] for j in tx) if name != 'poe-rbcm' else 0} transmitted, "
              f"{art.rows_demoted} demoted (the masks' CRCs: {want_demoted}); ledgers "
              f"wire {art.wire_bits} payload {art.payload_bits} integrity "
              f"{art.integrity_bits}; request p50 {np.percentile(t_ms, 50):.3f} ms p99 "
              f"{np.percentile(t_ms, 99):.3f} ms ({len(t_ms)} requests, host clock); SMSE "
              f"{e:.4f} (healthy per-symbol {per_symbol[name][0]:.4f}); {h}", flush=True)
        summary.append((name, fit_s, np.percentile(t_ms, 50), np.percentile(t_ms, 99), e))
        if name != "center":  # the fusing protocols under 4 more machines masked
            avail = np.ones(m, np.float32)
            avail[[FAULT_DROP, *FAULT_MASKED]] = 0.0
            hd = est.health(art, avail)
            n_alive = m - 1 - len(FAULT_MASKED)
            check(hd.machines_lost == tuple(sorted((FAULT_DROP, *FAULT_MASKED)))
                  and hd.variance_inflation == (m / n_alive if name == "broadcast" else 1.0),
                  f"fault {name}: health() under the degraded mask reports {hd}")
            runtime.reset_launches()
            mu_d, var_d, _ = serve(est, art, name, FAULT_LAUNCHES[name][1], avail)
            shrunk = float((var - var_d).max())
            check(bool(torch.isfinite(mu_d).all()) and bool((var_d > 0).all()),
                  f"fault {name}: the degraded request is not finite")
            if name == "broadcast":
                check(shrunk <= 1e-6 * max(1.0, float(var.abs().max())),
                      f"fault {name}: a degraded variance fell {shrunk} below the healthy one")
            print(f"[fault] {name}: {len(FAULT_MASKED)} more machines masked: {hd}; SMSE "
                  f"{smse(mu_d):.4f}; largest fall of a variance below the healthy request's "
                  f"{shrunk:.3e}", flush=True)
        roundtrip(est, art, name, mu, var, plan)
        against_cpu(cfg, name, art, mu, var)
        arts[name] = (est, art)

    # -- corrupted streaming ------------------------------------------------
    for name in ("center", "broadcast"):
        est, art = arts[name]
        try:
            est.update(art, X_new[:4], y_new[:4], machine=FAULT_DROP)
            fail(f"fault {name}: an update to the dropped machine was accepted")
        except ValueError:
            pass
        runtime.reset_launches()
        row, demoted, times = 0, [], []
        for j in FAULT_STREAM:
            Xb, yb = X_new[row:row + 16], y_new[row:row + 16]
            row += 16
            before = art
            want_demoted = crc_failures((16, W), art.wire_bits + j)
            l0 = runtime.launches()
            sync()
            t = time.perf_counter()
            art = est.update(art, Xb, yb, machine=j)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            l1 = runtime.launches()
            got = art.rows_demoted - before.rows_demoted
            kept = art.lengths[j] - before.lengths[j]
            rate = int(before.wire.rates[j].sum())
            check(got == want_demoted and kept == 16 - got,
                  f"fault {name} stream: {got} demoted and {kept} kept of 16, the mask's CRCs "
                  f"say {want_demoted}")
            check((art.wire_bits - before.wire_bits, art.payload_bits - before.payload_bits,
                   art.integrity_bits - before.integrity_bits)
                  == (rate * 16, payload_row_bits(24, d, 12) * 16, CRC_BITS * 16),
                  f"fault {name} stream: the ledgers were not charged the whole batch")
            _launch_check(f"fault {name} corrupted update", {k: l1[k] - l0[k] for k in l1},
                          STREAM_LAUNCHES[name][0] if kept else {})
            est.predict(art, reqs[0])
            sync()
            l2 = runtime.launches()
            _launch_check(f"fault {name} request after a corrupted update",
                          {k: l2[k] - l1[k] for k in l2}, STREAM_LAUNCHES[name][1])
            demoted.append(got)
        path_launches[f"fault stream {name}"] = runtime.launches()
        print(f"[fault] {name}: four corrupted 16-row batches (machines {FAULT_STREAM}): "
              f"demoted {demoted}, ledgers charged every transmitted row; update p50 "
              f"{np.percentile(times, 50):.3f} ms (host clock); launches "
              f"{path_launches[f'fault stream {name}']}", flush=True)

    # -- the vq channel -------------------------------------------------------
    S = [np.asarray(X, np.float64).T @ np.asarray(X, np.float64) / max(len(X), 1)
         for X, _ in parts]
    for name, proto in (("vq center", {}), ("vq broadcast", {"protocol": "broadcast"})):
        cfg = DGPConfig(scheme="vq", steps=steps, bits_per_sample=24, **proto)
        est, art, fit_s, fit_launches = fit(cfg)
        _launch_check(f"fault {name} fit", fit_launches, FAULT_LAUNCHES[name][0])
        center = name == "vq center"
        want = 0
        for j, (X, _) in enumerate(parts):
            if center and j == 0:
                continue
            Qy = S[0] if center else sum(S) - S[j]
            ch = make_test_channel(S[j], Qy, distortion_for_rate(S[j], Qy, 24.0))
            want += math.ceil(len(X) * ch.rate_bits) + side_info_bits(d)
        ps_wire = per_symbol[name.split()[1]][1]
        check(art.wire_bits == want and art.payload_bits == art.wire_bits
              and art.integrity_bits == 0,
              f"fault {name}: ledgers {(art.wire_bits, art.payload_bits, art.integrity_bits)}, "
              f"the channels' sum {want}")
        check(abs(art.wire_bits - ps_wire) <= 0.05 * ps_wire,
              f"fault {name}: ledger {art.wire_bits} not within 5 % of per-symbol's {ps_wire}")
        runtime.reset_launches()
        mu, var, t_ms = serve(est, art, name, FAULT_LAUNCHES[name][1])
        e = smse(mu)
        check(bool(torch.isfinite(mu).all()) and bool((var > 0).all()) and e < 1.0,
              f"fault {name}: SMSE {e} or the variances are not sane")
        more = est.update(art, X_new[:16], y_new[:16], machine=1)
        charge = math.ceil(16 * float(art.data["vq_rate_bits"][1]))
        check((more.wire_bits - art.wire_bits, more.payload_bits - art.payload_bits,
               more.integrity_bits - art.integrity_bits) == (charge, charge, 0),
              f"fault {name}: an update of 16 rows was not charged ceil(16 R) = {charge}")
        path_launches[f"fault {name}"] = {k: fit_launches[k] + v
                                          for k, v in runtime.launches().items()}
        print(f"[fault] {name}: fit {fit_s:.3f} s; ledger {art.wire_bits} (per-symbol "
              f"{ps_wire}, {100 * (art.wire_bits / ps_wire - 1):+.2f} %), payload == ledger, "
              f"integrity 0; an update of 16 rows charged {charge}; request p50 "
              f"{np.percentile(t_ms, 50):.3f} ms p99 {np.percentile(t_ms, 99):.3f} ms; SMSE "
              f"{e:.4f} (per-symbol {per_symbol[name.split()[1]][0]:.4f})", flush=True)
        summary.append((name, fit_s, np.percentile(t_ms, 50), np.percentile(t_ms, 99), e))
        roundtrip(est, art, name, mu, var, None)
        against_cpu(cfg, name, art, mu, var)
    print("[fault] path  fit s  request p50 / p99 ms  SMSE:  " + "  ".join(
        f"{n} {f:.3f} {p50:.3f}/{p99:.3f} {e:.4f}" for n, f, p50, p99, e in summary),
        flush=True)
    return path_launches


# phase j: the paper's §4 figures (Figs. 2, 3, 4, 7 and the bit ablation) at
# their full settings, each on the card and again on the CPU (same code, same
# seeds; the devices round their fp32 sums differently).  Limits, from the
# H100 readings of this phase's first run with a margin of about ten:
# - distortions of Figs. 2-3 and the ablation, |diff| as a fraction of the
#   column's largest value in the same setting (a distortion near 0 at a
#   large m or R is a difference of nearly equal sums): read 1.3e-7 (Fig.
#   2), 2.2e-7 (Fig. 3), 1.0e-7 (ablation);
PAPER_TOL = 2e-6
# - Fig. 4's mean and sd MSE against the true GP and the correlation of the
#   means, |diff| (nine GPs, 300 Adam steps each, on each device): read 3.3e-6;
FIG4_TOL = 3e-5
# - Fig. 7's SMSE, |diff| (40 local SGPRs, 250 Adam steps each, and rBCM):
#   read 5.2e-5 (R = 2), the rest below;
FIG7_SMSE_TOL = 5e-4
# - Fig. 7's per-symbol allocations follow the trained inducing inputs, which
#   the devices round apart, so a near-tie in Algorithm 1's greedy gains may
#   go the other way: at most this many of the 39 x 7 (machine, R)
#   allocations may differ (read: 0), each still summing to R, so the wire
#   ledgers stay equal;
FIG7_RATE_FLIPS = 3
# - codes (Fig. 2's per-symbol roundtrips, the ablation's three
#   allocations): equal except for symbols within CODE_ULPS ulp of a bin
#   edge (read: 0 of 24 x 80000 and 0 of 24 x 80000 differ).
CODE_ULPS = 2


def _rows_close(tag, rows, rows_c, keys):
    """Card rows against CPU rows: ``|a - b| <= PAPER_TOL x the column's
    largest |b| in the same setting``; returns the largest gap as a
    fraction of that scale."""
    worst = 0.0
    check([r["name"] for r in rows] == [r["name"] for r in rows_c],
          f"paper {tag}: the card's rows differ from the CPU's in kind")
    for k in keys:
        scale = {}
        for r in rows_c:
            scale[r["name"]] = max(scale.get(r["name"], 0.0), abs(r["derived"][k]))
        for g, w in zip(rows, rows_c):
            a, b = g["derived"][k], w["derived"][k]
            s = max(scale[w["name"]], 1e-30)
            worst = max(worst, abs(a - b) / s)
            check(abs(a - b) <= PAPER_TOL * s,
                  f"paper {tag} {w['name']} {k}: card {a} vs CPU {b} "
                  f"(limit {PAPER_TOL} x {s})")
    return worst


def _ordering(tag, holds, holds_c, what):
    """An ordering that only the card breaks fails the phase; one that the
    CPU breaks too is a finding about the paper's claim on this data."""
    for key in holds:
        if holds[key]:
            continue
        check(not holds_c[key], f"paper {tag}: {what} fails at {key} on the card only")
        print(f"[paper] {tag}: FINDING {what} does not hold at {key} on the card nor "
              "on the CPU", flush=True)


def _code_flips(X, Xc, encode, edges_of):
    """(flips, symbols near an edge) of one encode on the card against the
    CPU; fails on a flip away from every edge.  ``edges_of`` gives the
    (d, E) scaled edges, ``encode(X)`` the codes."""
    import torch

    codes, want = encode(X).cpu(), encode(Xc)
    xs, edges = edges_of()
    fin = torch.isfinite(edges)
    e = torch.where(fin, edges, torch.zeros_like(edges))
    ulp = torch.nextafter(e.abs(), torch.full_like(e, float("inf"))) - e.abs()
    near = (((xs[:, :, None] - e[None]).abs() <= CODE_ULPS * ulp[None]) & fin[None]).any(-1)
    flips = codes != want
    check(not bool((flips & ~near).any()), "paper: a code differs from the CPU's away from "
                                           "any bin edge")
    return int(flips.sum()), int(near.sum())


def paper_phase(dev):
    """The paper's §4 experiments through ``repro_torch.launch``'s figure
    scripts at ``--full``, on ``dev`` and on the CPU: integers equal,
    floats within the limits above, the paper's orderings at the reference
    tests' margins, and launches from zero exactly (``gram``: per Fig. 4
    fit steps + 1 and one a grid request; Fig. 7 the rBCM's fit and
    request, five an SGPR Adam step over all machines, two for their q(u),
    and per R one for the pseudo-point gram and one for its serve; Figs. 2,
    3 and the ablation none).  Returns {path: launches}."""
    import numpy as np
    import torch

    from repro_torch.configs.gp_paper import FIG2, FIG4, FIG7
    from repro_torch.core import quantizers as Q
    from repro_torch.core.schemes import PerSymbolScheme
    from repro_torch.core.transforms import make_decorrelating_transform
    from repro_torch.kernels import runtime
    from repro_torch.launch import (
        ablation_bits, fig2_distortion, fig3_pca, fig4_gp1d, fig7_sparse,
    )

    runtime.families()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fig4_steps, fig7_steps = 300, 250
    want = {
        "fig2": 0, "fig3": 0, "ablation": 0,
        "fig4": (1 + len(FIG4.rates)) * (fig4_steps + 2),
        "fig7": 2 + 5 * fig7_steps + 2 + 2 * len(FIG7.rates),
    }
    # (tag, script, its options, torch threads of its CPU run: the Adam
    # loops of Figs. 4 and 7 run their small matrices about twice as fast
    # on one thread as on a pool, Fig. 4 9.5 s against 21.4 s on the
    # builder's 8-core CPU, while Fig. 2's (n, d, E) comparisons want the pool)
    runs = (("fig2", fig2_distortion, {}, None), ("fig3", fig3_pca, {}, None),
            ("ablation", ablation_bits, {}, None),
            ("fig4", fig4_gp1d, {"gram_backend": "pallas"}, 1),
            ("fig7", fig7_sparse, {"gram_backend": "pallas"}, 1))
    path_launches, out = {}, {}
    for tag, mod, kw, cpu_threads in runs:
        runtime.reset_launches()
        sync()
        t0 = time.perf_counter()
        rows = mod.main(quick=False, device=dev, **kw)
        sync()
        secs = time.perf_counter() - t0
        launches = runtime.launches()
        path_launches[f"paper {tag}"] = launches
        n_threads = torch.get_num_threads()
        torch.set_num_threads(cpu_threads or n_threads)
        t0 = time.perf_counter()
        try:
            rows_c = mod.main(quick=False, device="cpu", **kw)
        finally:
            torch.set_num_threads(n_threads)
        secs_c = time.perf_counter() - t0
        out[tag] = (rows, rows_c)
        print(f"[paper] {tag}: {len(rows)} rows, {secs:.2f} s on {dev.type} (host clock), "
              f"{secs_c:.2f} s on the CPU; launches {launches}", flush=True)
        check(all(v == (want[tag] if k == "gram" else 0) for k, v in launches.items()),
              f"paper {tag}: launches {launches}, expected gram {want[tag]} and no other")

    # integers: rates, allocations, wire and side-info bits (Fig. 7 apart)
    for tag in ("fig2", "fig3", "ablation", "fig4"):
        rows, rows_c = out[tag]
        check([r.get("ledger") for r in rows] == [r.get("ledger") for r in rows_c],
              f"paper {tag}: the card's integers differ from the CPU's")
    print("[paper] rates, allocations, wire_bits, side_info_bits: card == CPU (Figs. 2, 3, "
          "4, ablation)", flush=True)

    # Fig. 2: distortions, the ordering, the per-symbol codes
    rows, rows_c = out["fig2"]
    g2 = _rows_close("fig2", rows, rows_c, ("lb", "opt", "per_symbol", "dim_red"))
    for r in rows:
        e = r["derived"]
        print(f"[paper] fig2 R={e['bits']:3d}  lb {e['lb']:.6g}  opt {e['opt']:.6g}  "
              f"per_symbol {e['per_symbol']:.6g}  dim_red {e['dim_red']:.6g}", flush=True)
    for what, f in (("e_opt <= 1.05 e_ps", lambda e: e["opt"] <= 1.05 * e["per_symbol"]),
                    ("e_ps < e_dr", lambda e: e["per_symbol"] < e["dim_red"])):
        _ordering("fig2", {r["derived"]["bits"]: f(r["derived"]) for r in rows},
                  {r["derived"]["bits"]: f(r["derived"]) for r in rows_c}, what)
    Qx, Qy, X_np = fig2_distortion.gaussian_setting(np.random.default_rng(0), 20, FIG2.n_train)
    Xc = torch.from_numpy(X_np)
    X = Xc.to(dev)
    flips = near = 0
    for R in FIG2.rates:
        ps = PerSymbolScheme(R).fit(Qx, Qy)
        T = torch.from_numpy(ps._tr.T.astype(np.float32))
        edges = (Q.build_codebook_tables(int(ps.rates.max()))[0][ps.rates]
                 * torch.from_numpy(ps.sigma)[:, None])
        f, nr = _code_flips(X, Xc, ps.encode, lambda: (Xc @ T.T, edges))
        flips, near = flips + f, near + nr
    print(f"[paper] fig2 distortions card vs CPU: largest gap {g2:.2e} of the column's scale "
          f"(limit {PAPER_TOL:.0e}); per-symbol codes over "
          f"{len(FIG2.rates)} rates x {X_np.size} symbols: {flips} differ, all within "
          f"{CODE_ULPS} ulp of an edge ({near} symbols lie that close)", flush=True)

    # Fig. 3: distortions and Theorem 3's ordering
    rows, rows_c = out["fig3"]
    g3 = _rows_close("fig3", rows, rows_c, ("proposed", "pca"))
    _ordering("fig3", {(r["name"], r["derived"]["m"]): r["derived"]["proposed"]
                       <= 1.01 * r["derived"]["pca"] for r in rows},
              {(r["name"], r["derived"]["m"]): r["derived"]["proposed"]
               <= 1.01 * r["derived"]["pca"] for r in rows_c}, "e_dr <= 1.01 e_pca")
    ratio = {}
    for r in rows:
        ratio.setdefault(r["name"], []).append(r["derived"]["ratio"])
    print(f"[paper] fig3 card vs CPU: largest gap {g3:.2e} of the column's scale; "
          "proposed / PCA from the smallest m to the largest: "
          + "; ".join(f"{k[4:]} {v[0]:.4f} -> {v[-1]:.4f}" for k, v in ratio.items()),
          flush=True)

    # the ablation: distortions and the codes of each allocation
    rows, rows_c = out["ablation"]
    ga = _rows_close("ablation", rows, rows_c, ("greedy", "uniform", "waterfill_rounded"))
    tr = make_decorrelating_transform(Qx, Qy)
    T = torch.from_numpy(tr.T.astype(np.float32))
    sigma = torch.from_numpy(np.sqrt(np.maximum(tr.variances, 0)).astype(np.float32))
    flips = near = 0
    for r in rows:
        for rates in map(np.asarray, r["ledger"].values()):
            edges = (Q.build_codebook_tables(int(max(rates.max(), 1)))[0][rates]
                     * sigma[:, None])
            f, nr = _code_flips(X, Xc, lambda x: ablation_bits.codes(x, tr, rates),
                                lambda: (Xc @ T.T, edges))
            flips, near = flips + f, near + nr
    for r in rows:
        e = r["derived"]
        print(f"[paper] ablation R={e['R']:3d}  greedy {e['greedy']:.6g}  uniform x"
              f"{e['uniform_penalty']:.3f}  waterfill_rounded x{e['wf_penalty']:.3f}",
              flush=True)
    print(f"[paper] ablation card vs CPU: largest gap {ga:.2e} of the column's scale; codes "
          f"over {3 * len(rows)} allocations: {flips} differ, all within {CODE_ULPS} ulp of "
          f"an edge ({near} symbols lie that close)", flush=True)

    # Fig. 4: the posterior's distance to the true GP's, card vs CPU
    rows, rows_c = out["fig4"]
    worst = 0.0
    for g, w in zip(rows, rows_c):
        for k in ("mean_mse", "sd_mse", "corr_with_true"):
            gap = abs(g["derived"][k] - w["derived"][k])
            worst = max(worst, gap)
            check(gap <= FIG4_TOL, f"paper fig4 R={w['derived']['R']} {k}: card "
                                   f"{g['derived'][k]} vs CPU {w['derived'][k]}")
        e = g["derived"]
        print(f"[paper] fig4 R={e['R']}  mean_mse {e['mean_mse']:.4g}  sd_mse "
              f"{e['sd_mse']:.4g}  corr {e['corr_with_true']:.4f}  fit {g['us_per_call'] / 1e6:.3f}"
              f" s (CPU {w['derived']['mean_mse']:.4g} / {w['derived']['sd_mse']:.4g} / "
              f"{w['derived']['corr_with_true']:.4f})", flush=True)
    print(f"[paper] fig4 card vs CPU: largest |diff| {worst:.2e} (limit {FIG4_TOL:.0e})",
          flush=True)

    # Fig. 7: SMSE, ledgers, allocations
    rows, rows_c = out["fig7"]
    worst, rate_flips = 0.0, 0
    for g, w in zip(rows, rows_c):
        gap = abs(g["derived"]["smse"] - w["derived"]["smse"])
        worst = max(worst, gap)
        check(np.isfinite(g["derived"]["smse"]) and gap <= FIG7_SMSE_TOL,
              f"paper fig7 {w['derived']['model']} R={w['derived']['R']}: SMSE card "
              f"{g['derived']['smse']} vs CPU {w['derived']['smse']}")
        if "ledger" in g:
            R = g["derived"]["R"]
            check(g["ledger"]["wire_bits"] == w["ledger"]["wire_bits"],
                  f"paper fig7 R={R}: wire bits differ from the CPU's")
            check(all(sum(v) == R for v in g["ledger"]["rates"]),
                  f"paper fig7 R={R}: an allocation does not sum to R")
            diff = [j + 1 for j, (a, b) in enumerate(zip(g["ledger"]["rates"],
                                                          w["ledger"]["rates"])) if a != b]
            rate_flips += len(diff)
            if diff:
                print(f"[paper] fig7 R={R}: machines {diff} allocate differently on the "
                      "card and the CPU", flush=True)
        e = g["derived"]
        print(f"[paper] fig7 {e['model']:17s} R={e['R']:3d}  SMSE {e['smse']:.4f} (CPU "
              f"{w['derived']['smse']:.4f})  wire {e.get('wire_kbits', 0.0):.3f} kbit", flush=True)
    check(rate_flips <= FIG7_RATE_FLIPS, f"paper fig7: {rate_flips} allocations differ from "
                                         f"the CPU's (limit {FIG7_RATE_FLIPS})")
    rbcm = rows[0]["derived"]["smse"]
    beats = [r["derived"]["R"] for r in rows[1:] if r["derived"]["smse"] < rbcm]
    print(f"[paper] fig7 card vs CPU: SMSE largest |diff| {worst:.2e} (limit "
          f"{FIG7_SMSE_TOL:.0e}); {rate_flips} of {39 * len(FIG7.rates)} allocations differ "
          f"(limit {FIG7_RATE_FLIPS}); the sparse model beats rBCM ({rbcm:.4f}) at R = "
          f"{beats or 'none'}", flush=True)
    return path_launches


# phase k: the serving CLI (repro_torch.launch.serve_gp) in-process, at the
# paper's §6 widths, each run checked: the contract, the kernel launches of
# every warm request (the runtime's counts and the profiler's device
# kernels), a warm predict under torch.cuda.set_sync_debug_mode("error"),
# the ledgers against the accounting formulas
SERVE_ARGS = ("--m", "40", "--bits", "24", "--n", "2000", "--d", "21", "--steps", "60",
              "--queries", "50", "--batch", "128", "--gram-backend", "pallas")
SERVE_CHAOS = "drop:1,flip:0.01,straggle:3@0.05"
# tag: (flags beside SERVE_ARGS, kernel launches of each warm request)
SERVE_RUNS = {
    "center": (("--protocol", "center", "--stream-every", "20", "--stream-size", "16"),
               {"gram": 1}),
    "broadcast": (("--protocol", "broadcast", "--chaos", SERVE_CHAOS, "--timeout-ms", "50"),
                  {"gram": 1, "epilogue": 1}),
    "poe-rbcm": (("--protocol", "poe"), {"gram": 1}),
    "fleet": (("--protocol", "broadcast", "--fleet", "--fleet-tenants", "16",
               "--fleet-cache", "8", "--fleet-slots", "4"), None),
}


def _serve_data(args):
    """The parts a serve_gp run fits, rebuilt as ``serve_gp.main`` makes
    them (numpy rng 0, the estimator's seeded split) from its parsed flags."""
    import numpy as np
    import torch

    from repro_torch.core.protocols.base import split_machines

    rng = np.random.default_rng(0)
    W = rng.normal(size=(args["d"], 2))
    X = rng.normal(size=(args["n"], args["d"])).astype(np.float32)
    y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1])
         + 0.05 * rng.normal(size=args["n"])).astype(np.float32)
    return split_machines(X, y, args["m"], torch.Generator().manual_seed(0))


def serve_phase(dev, base_args=SERVE_ARGS, examples=True):
    """Phase k on ``dev``: ``repro_torch.launch.serve_gp.main`` driven
    in-process for each of SERVE_RUNS (``base_args`` beside each run's
    flags; the center run saves, reloads and serves the loaded copy and
    streams 16 rows every 20 requests, broadcast runs under SERVE_CHAOS
    with a 50 ms budget and every 7th request degraded, poe is rBCM, the
    fleet serves 16 y-scaled tenants through an 8-artifact cache in
    flushes of 4), then the two examples.  Checks per run: exit code 0
    (a SystemExit is caught only to read its code), the contract ok with
    0 cholesky and 0 eigh; on the card, every warm request's launches
    exactly SERVE_RUNS' counts, one warm request traced by
    ``torch.profiler`` (``op_walk.kernel_trace``) with the same
    hand-written kernels family by family, and one warm predict under
    ``torch.cuda.set_sync_debug_mode("error")``; the served answers (and
    broadcast's under its degraded mask) against the same checkpoint
    served on the CPU, within FAULT_OUT_TOL; the ledgers the
    ``comm/accounting.py`` formulas on the transmitted (after the
    streamed) lengths and ``rows_demoted`` the CRC failures recomputed
    from the flip masks, as integers; the fleet's ``epilogue_fleet``
    launches one per fused flush, no stacked tensor reallocated, and one
    flush of four of its tenants (one degraded) against each served
    alone on the CPU.  Returns
    {path: launches} for the kernels line, each run read from zero."""
    import numpy as np
    import torch

    from repro_torch import faults
    from repro_torch.analysis.op_walk import KERNEL_SYMBOLS, hand_written_kernels, kernel_trace
    from repro_torch.comm.accounting import (
        integrity_bits_formula, payload_bits_formula, row_bits, wire_bits_formula,
    )
    from repro_torch.core import torch_scheme as TS
    from repro_torch.core.fleet import FleetStack, scale_targets
    from repro_torch.core.protocols.base import load_artifact
    from repro_torch.examples import distributed_gp_sarcos, quickstart
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve_gp

    cuda = dev.type == "cuda"
    runtime.families()
    path_launches, rows = {}, []

    def flag(argv, name, cast=int):
        return cast(argv[len(argv) - 1 - argv[::-1].index(name) + 1])

    def drive(tag, argv):
        runtime.reset_launches()
        t0 = time.perf_counter()
        try:
            res = serve_gp.main(argv)
        except SystemExit as e:  # only to read the code: 0 is a pass
            check(e.code in (0, None), f"serve {tag}: serve_gp exited with code {e.code}")
            res = None
        if cuda:
            torch.cuda.synchronize()
        path_launches[f"serve {tag}"] = runtime.launches()
        check(res is not None, f"serve {tag}: serve_gp.main returned no result")
        return res, time.perf_counter() - t0

    def on_cpu(tag, est, art):
        """``art`` saved and loaded onto the CPU."""
        saved = str(ROOT / "build" / "chip_smoke_serve_ckpt" / tag)
        shutil.rmtree(saved, ignore_errors=True)
        est.save(art, saved)
        out = load_artifact(saved, device="cpu")
        shutil.rmtree(saved, ignore_errors=True)
        return out

    def against_cpu(tag, pairs):
        """max |card - CPU| of mu and var over ``pairs`` ((mu, var, mu_c,
        var_c) each) as fractions of max(1, max |CPU value|)."""
        errs = [0.0, 0.0]
        for got in pairs:
            for i in (0, 1):
                c = got[2 + i]
                errs[i] = max(errs[i], float((got[i].cpu() - c).abs().max())
                              / max(1.0, float(c.abs().max())))
        check(all(np.isfinite(errs)) and max(errs) <= FAULT_OUT_TOL,
              f"serve {tag}: the card's answers differ from the same checkpoint served "
              f"on the CPU by mu {errs[0]:.3e}, var {errs[1]:.3e} of scale (limit "
              f"{FAULT_OUT_TOL:g})")
        return errs

    for tag, (extra, per_request) in SERVE_RUNS.items():
        argv = list(base_args) + list(extra) + ["--device", dev.type]
        ckpt = ROOT / "build" / f"chip_smoke_serve_{tag}"
        if tag == "center":
            shutil.rmtree(ckpt, ignore_errors=True)
            argv += ["--artifact-dir", str(ckpt)]
        res, wall = drive(tag, argv)
        shutil.rmtree(ckpt, ignore_errors=True)
        art, est = res["art"], res["est"]
        a = {k: flag(argv, f"--{k}") for k in ("m", "n", "d", "bits", "batch")}
        if tag == "fleet":
            stats, launches = res["stats"], res["launches"]
            want = stats["fused_dispatches"] if cuda else 0
            check(res["reallocated"] == 0, "serve fleet: a stacked tensor was reallocated")
            check(launches.get("epilogue_fleet", 0) == want and not launches.get("epilogue"),
                  f"serve fleet: launches {launches} in {stats['flushes']} flushes "
                  f"({stats['fused_dispatches']} fused), not one epilogue_fleet a fused flush")
            check(stats["completed"] == max(flag(argv, "--queries"), 16),
                  f"serve fleet: {stats['completed']} requests completed")
            # one flush of four y-scaled tenants, the third degraded, on the
            # card against each tenant served alone on the CPU
            scales = (0.25, 0.7, 1.3, 1.75)
            stack = FleetStack({i: scale_targets(art, c) for i, c in enumerate(scales)})
            Xf = torch.randn(4, a["batch"], a["d"], generator=torch.Generator().manual_seed(11))
            av = np.ones((4, a["m"]), np.float32)
            av[2, 5 % a["m"]] = 0.0
            before = runtime.launches()
            mu_f, var_f = stack.predict(list(range(4)), Xf.to(dev), av)
            if cuda:
                torch.cuda.synchronize()
            flush = {k: v - before.get(k, 0) for k, v in runtime.launches().items()
                     if v != before.get(k, 0)}
            check(flush == ({"gram": 4, "epilogue_fleet": 1} if cuda else {}),
                  f"serve fleet: a four-tenant flush launched {flush}")
            art_c = on_cpu(tag, est, art)
            err = against_cpu(tag, [(mu_f[i], var_f[i], *scale_targets(art_c, c).predict(
                Xf[i], available=av[i])) for i, c in enumerate(scales)])
            c = stats["cache"]
            print(f"[serve] fleet: 16 tenants, {stats['completed']} requests x {a['batch']} "
                  f"points in {res['wall_s']:.3f} s -> {res['qps']:.0f} q/s; p50 "
                  f"{stats['p50_ms']:.3f} ms p99 {stats['p99_ms']:.3f} ms from submit; hit "
                  f"rate {c['hit_rate']:.3f} ({c['hits']}h/{c['misses']}m); flushes "
                  f"{stats['flushes']} (fused {stats['fused_dispatches']}), launches "
                  f"{launches}; stacks reallocated {res['reallocated']}; a four-tenant flush "
                  f"{flush}, card vs CPU mu {err[0]:.3e} var {err[1]:.3e} of scale; fit "
                  f"{res['fit_s']:.3f} s; run {wall:.1f} s", flush=True)
            rows.append(("fleet", res["fit_s"], stats["p50_ms"], stats["p99_ms"]))
        report = res.get("report")
        if report is None:  # the fleet mode ends before serve_gp's own check
            from repro_torch.analysis import check_contracts

            report = check_contracts(art, raise_on_violation=False)
        check(report.ok and report.op_counts["cholesky"] == 0 and report.op_counts["eigh"] == 0
              and not report.collectives and not report.leaks,
              f"serve {tag}: contract {report.contract} findings {report.findings}, "
              f"op counts {report.op_counts}")
        # the ledgers, as integers, against the formulas
        parts = _serve_data(a)
        plan = art.config.faults
        L = [int(p[0].shape[0]) for p in parts]
        if plan is not None:
            L = [int(p[0].shape[0]) for p in faults.apply_to_parts(
                [(np.asarray(X), np.asarray(y)) for X, y in parts], plan)[0]]
        if art.protocol == "poe":
            want_ledgers, want_demoted = (0, 0, 0), 0
        else:
            skip = 0 if art.protocol == "center" else None
            W = TS.row_words(row_bits(a["bits"], a["d"], art.max_bits))
            demoted = [0] * a["m"]
            if plan is not None and plan.flip_rate > 0:
                for j in range(a["m"]):
                    if j != skip and L[j] > 0:
                        e = faults.flip_mask((L[j], W), plan.flip_rate, plan.seed, j)
                        demoted[j] = int((TS.crc_words(e)
                                          != TS.crc_words(torch.zeros_like(e))).sum())
            want_demoted = sum(demoted)
            check(list(art.fit_lengths) == [L[j] - demoted[j] for j in range(a["m"])],
                  f"serve {tag}: fit lengths {art.fit_lengths} are not the transmitted "
                  f"{L} less the demotions {demoted}")
            L = list(art.lengths) if plan is None else L  # a stream grows the counts
            rates = art.wire.rates.cpu().numpy()
            want_ledgers = (wire_bits_formula(rates, L, a["d"], skip=skip),
                            payload_bits_formula(L, a["d"], a["bits"], art.max_bits, skip=skip),
                            integrity_bits_formula(L, skip=skip))
        got = (art.wire_bits, art.payload_bits, art.integrity_bits)
        check(got == want_ledgers and art.rows_demoted == want_demoted,
              f"serve {tag}: ledgers {got} / {art.rows_demoted} demoted, the formulas say "
              f"{want_ledgers} / {want_demoted}")
        if tag == "fleet":
            continue
        # launches of every warm request, the profiler's kernels, syncs
        want = per_request if cuda else {}
        bad = [r for r in res["request_launches"] if r != want]
        check(not bad and len(res["request_launches"]) == flag(argv, "--queries") - 1,
              f"serve {tag}: warm requests launched {bad[:3]}, expected {want} each")
        Xq = torch.randn(a["batch"], a["d"], generator=torch.Generator().manual_seed(7))
        Xq_d = Xq.to(dev)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                mu, var = est.predict(art, Xq_d)
            except RuntimeError as e:
                import traceback

                fail(f"serve {tag}: a warm predict synchronizes with the host: {e}\n"
                     + "".join(traceback.format_exc(limit=-6)))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            names, lost = kernel_trace(est.predict, art, Xq_d)
            hw = hand_written_kernels(names)
            fams = {k: sum(hw[s] for s in KERNEL_SYMBOLS[k]) for k in want}
            check(fams == want and sum(hw.values()) == sum(want.values()),
                  f"serve {tag}: the profiler saw hand-written kernels {dict(hw)} in a warm "
                  f"request, expected {want}; its {len(names)} device kernels include "
                  f"{sorted({n[:90] for n in names})[:12]}")
            traced = f"{dict(hw)} of {len(names)} device kernels ({lost} of the leading " \
                     "sentinel records dropped)"
        else:
            mu, var = est.predict(art, Xq)
            traced = "none (no card)"
        # the same checkpoint served on the CPU, under broadcast's degraded
        # mask too (every 7th request of its run)
        art_c = on_cpu(tag, est, art)
        pairs = [(mu, var, *art_c.predict(Xq))]
        if res["health"] is not None:
            av = np.asarray([0.0 if j in res["health"].machines_lost else 1.0
                             for j in range(a["m"])], np.float32)
            pairs.append((*est.predict(art, Xq_d, available=av),
                          *art_c.predict(Xq, available=av)))
        err = against_cpu(tag, pairs)
        check(all(bool((p[1] > 0).all()) for p in pairs),
              f"serve {tag}: a served variance is not positive")
        h = res["health"]
        if tag == "broadcast":
            check(h is not None and h.status == "degraded" and 1 in h.machines_lost
                  and h.rows_demoted == want_demoted,
                  f"serve broadcast: health {h}")
        lat = res["lat_ms"]
        print(f"[serve] {tag}: fit {res['fit_s']:.3f} s; warm p50 {res['p50_ms']:.3f} ms p99 "
              f"{res['p99_ms']:.3f} ms ({len(lat)} requests of {a['batch']}, host clock, "
              f"synchronized; {res['n_over']} over the budget); launches per warm request "
              f"{want}, the profiler's {traced}; card vs CPU mu {err[0]:.3e} var "
              f"{err[1]:.3e} of scale; growths "
              f"{res['growths']} in {res['n_updates']} updates; ledgers {got}, "
              f"{art.rows_demoted} demoted; contract {report.contract} ok; run {wall:.1f} s",
              flush=True)
        rows.append((tag, res["fit_s"], res["p50_ms"], res["p99_ms"]))
    if examples:
        for name, mod in (("quickstart", quickstart), ("sarcos", distributed_gp_sarcos)):
            runtime.reset_launches()
            t0 = time.perf_counter()
            out = mod.main(["--device", dev.type])
            path_launches[f"example {name}"] = runtime.launches()
            smse = out["smse"]
            check(all(np.isfinite(v) and 0 <= v < 1.5 for v in smse.values()),
                  f"example {name}: SMSE {smse}")
            if name == "quickstart":
                dist = out["distortion"]
                check(smse["loaded"] == smse["R64"] and dist["optimum"] <= dist["per_symbol"]
                      < dist["dim_reduction"] < dist["zero_rate"],
                      f"example quickstart: the loaded serve or the distortions' order "
                      f"broke: {out}")
            print(f"[serve] example {name}: {time.perf_counter() - t0:.1f} s; SMSE "
                  + ", ".join(f"{k} {v:.4f}" for k, v in smse.items()), flush=True)
    print("[serve] path  fit s  warm p50 / p99 ms:  " + "  ".join(
        f"{t} {f:.3f} {p:.3f}/{q:.3f}" for t, f, p, q in rows), flush=True)
    return path_launches


# ---------------------------------------------------------------------------
# phase l: impl="mesh" — one process per machine, all on the one card
# ---------------------------------------------------------------------------
MESH_M = 40  # machines = ranks (the Fig. 6 setting)
MESH_RUNS = {  # DGPConfig fields of each path; the mesh assembles with "xla"
    "broadcast": dict(protocol="broadcast", fusion="kl", bits_per_sample=24),
    "poe-rbcm": dict(protocol="poe", fusion="rbcm", bits_per_sample=0),
    "center": dict(protocol="center", bits_per_sample=24),
}
MESH_UPDATE_MACHINE = 1  # the 16-row batch arrives here: a transmitter in every protocol
MESH_COLLECTIVES = {"broadcast": {"c10d.allreduce_": 1}, "poe-rbcm": {"c10d.allreduce_": 1},
                    "center": {}}  # per warm request
# a checkpoint reloaded single-process against the mesh's answers, of the
# output's scale.  The reload fuses the stacked experts (mean of s2 + (mu -
# mu_i)^2) where the mesh sums moment rows (s2 = S1 / m - mu^2, which
# cancels), so var parts most.  Read on the H100 at the Fig. 6 setting
# (PERF.md §6, PR 26): mu broadcast 3.0e-7, poe 4.7e-7, center 0 of scale
# (1.4e-6 and 2.6e-6 absolute); var broadcast 3.2e-5 of scale (1.4e-4
# absolute), poe 3.7e-8, center 0.  The var limit is about ten times its
# largest reading, the mu limit the same as a share of the var's
MESH_RELOAD_MU_TOL = 3e-5
MESH_RELOAD_VAR_TOL = 3e-4
# mesh against the batched fit on the card, of the output's scale: each rank
# fits its scheme alone (cuSOLVER's one-matrix eigensolver) where the batched
# fit solves the 40 machines' eigenproblems as one batch; the transforms round
# apart (the reconstructions up to 1.3e-4 apart, no symbol across a bin
# edge), and 150 Adam steps and the Nyström serve's cancellation carry that
# on.  Read on the H100 at the Fig. 6 setting: center 1.2e-3 (1.7e-3 after
# the update), broadcast 1.5e-4 (3.6e-4), poe 6e-7 (no wire) (PERF.md §6,
# PR 26); the [mesh] line counts the reconstructed symbols that moved
MESH_OUT_TOL = 5e-3
MESH_SERVE_ARGS = ("--m", "4", "--bits", "24", "--n", "400", "--steps", "10", "--queries", "8")


def mesh_rank(cfg, parts, batches, X_new, y_new, ckpt, device):
    """One rank (machine) of phase l, every rank running it with the same
    arguments: fit ``impl="mesh"`` (timed between barriers), one cold then
    the timed warm requests, the contract and the ops of a warm request,
    a save, one streamed batch.  Returns this rank's numbers (numpy)."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import check_contracts
    from repro_torch.analysis.contracts import predict_ops
    from repro_torch.analysis.op_walk import collective_stats, primitive_counts
    from repro_torch.core import DGPConfig, DistributedGP
    from repro_torch.kernels import runtime

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    est = DistributedGP(DGPConfig(impl="mesh", **cfg), device=device)
    runtime.reset_launches()
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    art = est.fit(parts=parts)
    sync()
    dist.barrier()
    fit_s = time.perf_counter() - t0
    est.predict(art, batches[0])  # cold
    mus, vars_, times = [], [], []
    for xb in batches:
        sync()
        t = time.perf_counter()
        mu, var = est.predict(art, xb)
        sync()
        times.append(time.perf_counter() - t)
        mus.append(mu)
        vars_.append(var)
    report = check_contracts(art, batches[0], raise_on_violation=False)
    ops = predict_ops(art, batches[0])
    path = est.save(art, ckpt)
    sync()
    t = time.perf_counter()
    grown = est.update(art, X_new, y_new, machine=MESH_UPDATE_MACHINE)
    sync()
    update_s = time.perf_counter() - t
    mu_u, var_u = est.predict(grown, batches[0])
    ledgers = lambda a: (a.wire_bits, a.payload_bits, a.integrity_bits)
    return {"fit_s": fit_s, "times": times, "mu": torch.cat(mus), "var": torch.cat(vars_),
            "ledgers": ledgers(art), "lengths": art.lengths, "ledgers_after": ledgers(grown),
            "lengths_after": grown.lengths, "update_s": update_s, "mu_u": mu_u, "var_u": var_u,
            "contract_ok": report.ok, "findings": [str(f) for f in report.findings],
            "collectives": {k: v["count"] for k, v in collective_stats(ops).items()},
            "factorizations": dict(primitive_counts(ops, names=("cholesky", "eigh"))),
            "launches": runtime.launches(), "path": path,
            "decoded": None if art.wire is None else art.wire.decoded}


def mesh_phase(dev, parts, batches, X_new, y_new, m=MESH_M, steps=150,
               serve_args=MESH_SERVE_ARGS):
    """Phase l on ``dev``: ``m`` spawned ranks (one per machine, gloo over
    the one card) fit broadcast (KL), poe-rBCM and center with
    ``impl="mesh"`` at the Fig. 6 setting, serve the requests, save and
    stream one 16-row batch; each path is held against a batched ``xla``
    fit in this process on the same parts: the ledgers as integers and the
    accounting formulas, mu and var within MESH_OUT_TOL of scale, every
    rank's answer the same bits, a warm request's collectives exactly
    MESH_COLLECTIVES and no cholesky or eigh, the update's increments the
    formulas and the batched update's, the checkpoint reloaded
    single-process with mu within MESH_RELOAD_MU_TOL and var within
    MESH_RELOAD_VAR_TOL of scale, and no hand-written kernel
    launched on any rank (the mesh runs ``xla``).  Then ``serve_gp --mesh``
    at MESH_SERVE_ARGS (its own 4 ranks).  Prints the ranks' start-up
    seconds, their contexts' memory, fit seconds and request p50 / p99."""
    import numpy as np
    import torch

    from repro_torch.comm.accounting import (
        integrity_bits_formula, payload_bits_formula, wire_bits_formula,
    )
    from repro_torch.core import DGPConfig, DistributedGP
    from repro_torch.launch import serve_gp
    from repro_torch.launch.ranks import RankPool

    cuda = dev.type == "cuda"
    d = parts[0][0].shape[1]
    free0 = torch.cuda.mem_get_info()[0] if cuda else 0
    t0 = time.perf_counter()
    pool = RankPool(m, device=dev.type, timeout=900)
    up_s = time.perf_counter() - t0
    ctx_gb = (free0 - torch.cuda.mem_get_info()[0]) / 1e9 if cuda else float("nan")
    start = np.array(pool.startup_s)
    print(f"[mesh] {m} ranks up in {up_s:.1f} s (each from spawn to ready: median "
          f"{np.median(start):.1f} s, max {start.max():.1f} s); their contexts "
          f"{ctx_gb:.2f} GB of the card ({ctx_gb / m:.3f} GB a rank)", flush=True)
    launches = {}
    X_new_t = torch.from_numpy(np.asarray(X_new))
    try:
        for tag, cfg in MESH_RUNS.items():
            cfg = dict(steps=steps, **cfg)
            ckpt = ROOT / "build" / f"chip_smoke_mesh_{tag}"
            shutil.rmtree(ckpt, ignore_errors=True)
            t_run = time.perf_counter()
            outs = pool.run(mesh_rank, cfg, parts, batches, X_new, y_new, str(ckpt), dev.type)
            run_s = time.perf_counter() - t_run
            o = outs[0]
            for r, x in enumerate(outs):
                check(all(np.array_equal(x[k], o[k]) for k in ("mu", "var", "mu_u", "var_u")),
                      f"mesh {tag}: rank {r} answered other bits than rank 0")
                check(x["ledgers"] == o["ledgers"] and x["ledgers_after"] == o["ledgers_after"],
                      f"mesh {tag}: rank {r} holds other ledgers")
                check(x["contract_ok"], f"mesh {tag}: rank {r} contract: {x['findings']}")
                check(x["collectives"] == MESH_COLLECTIVES[tag],
                      f"mesh {tag}: a warm request ran {x['collectives']}, not "
                      f"{MESH_COLLECTIVES[tag]}")
                check(x["factorizations"] == {"cholesky": 0, "eigh": 0},
                      f"mesh {tag}: a warm request factorized: {x['factorizations']}")
                check(not any(x["launches"].values()),
                      f"mesh {tag}: rank {r} launched a hand-written kernel: {x['launches']}")
            launches[f"mesh {tag}"] = {k: sum(x["launches"][k] for x in outs)
                                       for k in o["launches"]}
            # the batched fit on this device, on the same parts
            est = DistributedGP(DGPConfig(gram_backend="xla", **cfg), device=dev)
            art = est.fit(parts=parts)
            answers = [est.predict(art, xb) for xb in batches]
            mu = torch.cat([a[0] for a in answers]).cpu().numpy()
            var = torch.cat([a[1] for a in answers]).cpu().numpy()
            got = tuple(o["ledgers"])
            want = (art.wire_bits, art.payload_bits, art.integrity_bits)
            check(got == want and tuple(o["lengths"]) == art.lengths,
                  f"mesh {tag}: ledgers {got} / lengths {o['lengths']} against the batched "
                  f"{want} / {art.lengths}")
            L = art.lengths
            skip = art.block_order[0] if art.protocol == "center" else None
            if art.wire is not None:
                rates = art.wire.rates.cpu().numpy()
                formulas = (wire_bits_formula(rates, L, d, skip=skip),
                            payload_bits_formula(L, d, art.bits_per_sample, art.max_bits,
                                                 skip=skip),
                            integrity_bits_formula(L, skip=skip))
                check(got == formulas, f"mesh {tag}: ledgers {got} against the formulas "
                      f"{formulas}")
            err = [float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                   for a, b in ((o["mu"], mu), (o["var"], var))]
            moved = "no wire"
            if art.wire is not None:  # the reconstructions the two fits decoded
                dx = np.abs(o["decoded"] - art.wire.decoded.cpu().numpy())
                scale = max(1.0, float(np.abs(o["decoded"]).max()))
                moved = (f"{int((dx > 1e-4 * scale).sum())} of {dx.size} reconstructed "
                         f"symbols moved (max {float(dx.max()):.3e})")
            # the streamed batch: the batched update's increments, the formulas'
            grown = est.update(art, X_new_t, y_new, machine=MESH_UPDATE_MACHINE)
            inc = tuple(a - b for a, b in zip(o["ledgers_after"], o["ledgers"]))
            inc_b = (grown.wire_bits - art.wire_bits, grown.payload_bits - art.payload_bits,
                     grown.integrity_bits - art.integrity_bits)
            n_new = X_new_t.shape[0]
            if art.wire is None:
                inc_f = (0, 0, 0)
            else:
                j = MESH_UPDATE_MACHINE
                Lj = [n_new if q == j else 0 for q in range(len(L))]
                side = 2 * d * d * 32  # a streamed batch carries no side info
                inc_f = (wire_bits_formula(rates, Lj, d) - side,
                         payload_bits_formula(Lj, d, art.bits_per_sample, art.max_bits) - side,
                         integrity_bits_formula(Lj))
            mu_u, var_u = (a.cpu().numpy() for a in est.predict(grown, batches[0]))
            err_u = [float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                     for a, b in ((o["mu_u"], mu_u), (o["var_u"], var_u))]
            # the checkpoint, written by rank 0, served single-process
            loaded = DistributedGP(device=dev).load(str(ckpt))
            back = [loaded.predict(xb) for xb in batches]
            d_mu = float(np.abs(torch.cat([a[0] for a in back]).cpu().numpy() - o["mu"]).max()
                         / max(1.0, np.abs(o["mu"]).max()))
            d_var = float(np.abs(torch.cat([a[1] for a in back]).cpu().numpy() - o["var"]).max()
                          / max(1.0, np.abs(o["var"]).max()))
            shutil.rmtree(ckpt, ignore_errors=True)
            t_ms = np.array(o["times"]) * 1e3
            fit_s = np.array([x["fit_s"] for x in outs])
            print(f"[mesh] {tag}: fit {fit_s.max():.3f} s (the slowest rank); request p50 "
                  f"{np.percentile(t_ms, 50):.3f} ms p99 {np.percentile(t_ms, 99):.3f} ms "
                  f"({len(t_ms)} x {batches[0].shape[0]} queries, rank 0, host clock, "
                  f"synchronized); collectives a request {o['collectives']}; ledgers {got}; "
                  f"mu / var {err[0]:.3e} / {err[1]:.3e} of scale from the batched fit, "
                  f"{moved}; "
                  f"update {o['update_s']:.3f} s, +{inc} (batched +{inc_b}, formulas "
                  f"+{inc_f}), then mu / var {err_u[0]:.3e} / {err_u[1]:.3e}; reload mu "
                  f"{d_mu:.1e}, var {d_var:.1e} of scale; same bits on {m} ranks; run "
                  f"{run_s:.1f} s", flush=True)
            check(max(err) <= MESH_OUT_TOL,
                  f"mesh {tag}: mu / var {err} of scale from the batched fit (> {MESH_OUT_TOL})")
            check(inc == inc_b == inc_f and tuple(o["lengths_after"]) == grown.lengths,
                  f"mesh {tag}: update increments {inc}, batched {inc_b}, formulas {inc_f}")
            check(max(err_u) <= MESH_OUT_TOL, f"mesh {tag}: after the update {err_u} of scale")
            check(loaded.impl == "batched" and d_mu <= MESH_RELOAD_MU_TOL
                  and d_var <= MESH_RELOAD_VAR_TOL,
                  f"mesh {tag}: the reloaded checkpoint answers mu {d_mu:.3e}, var "
                  f"{d_var:.3e} of scale away (> {MESH_RELOAD_MU_TOL}, {MESH_RELOAD_VAR_TOL})")
    finally:
        pool.close()
    t0 = time.perf_counter()
    res = serve_gp.main(list(serve_args) + ["--device", dev.type, "--mesh"])
    check(res["contract_ok"] and res["impl"] == "mesh"
          and res["op_counts"]["cholesky"] == res["op_counts"]["eigh"] == 0,
          f"mesh serve_gp: {res}")
    print(f"[mesh] serve_gp {' '.join(serve_args)} --mesh: contract {res['contract']} ok, "
          f"fit {res['fit_s']:.3f} s, warm p50 {res['p50_ms']:.3f} ms p99 "
          f"{res['p99_ms']:.3f} ms; run {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


DECODE_ARGS = ("--batch", "4", "--prompt-len", "32", "--gen", "16")
DECODE_FULL_LEN = 8192  # (c): the full-width state's max_len
DECODE_FULL_POS = 6000  # (c): the first position stepped: the local rings (4096) have wrapped
DECODE_FULL_STEPS = 4


class _RecordedCalls:
    """The first ``n`` ``decode_attn`` calls the decode step makes while
    entered: operands, keywords and output, kept as clones (no host sync)."""

    def __init__(self, n):
        import repro_torch.models.decode as decode_mod

        self.mod, self.real, self.n, self.seen = decode_mod, decode_mod.decode_attn, n, []

    def __call__(self, q, K, V, kpos, pos, **kw):
        import torch

        out = self.real(q, K, V, kpos, pos, **kw)
        if len(self.seen) < self.n:
            self.seen.append((q.clone(), K.clone(), V.clone(), kpos.clone(),
                              torch.as_tensor(pos).clone(), kw, out.clone()))
        return out

    def __enter__(self):
        self.mod.decode_attn = self
        return self.seen

    def __exit__(self, *exc):
        self.mod.decode_attn = self.real


def _hold_recorded(tag, call):
    """A recorded kernel call against ``decode_attn_plain`` on its own
    operands, within 1e-5 max|V|."""
    from repro_torch.kernels.decode_attn.ops import decode_attn_plain

    q, K, V, kpos, pos, kw, got = call
    want = decode_attn_plain(q, K, V, kpos, pos.to(K.device), **kw)
    err, tol = float((got - want).abs().max()), 1e-5 * float(V.float().abs().max())
    valid = int(((kpos >= 0) & (kpos <= pos.to(kpos.device))).sum(1).max())
    print(f"[decode] {tag} at pos {int(pos)} (S {K.shape[1]}, {valid} valid slots a row, "
          f"window {kw.get('window')}, softcap {kw.get('softcap')}): kernel vs plain "
          f"max_abs_err {err:.3e} tol {tol:.3e}", flush=True)
    check(err <= tol, f"decode {tag}: kernel and plain apart {err:.3e} > {tol:.3e}")


def _sentinel_trace(tag, run, attempts=3):
    """(the device events of ``run()`` in start order, its host seconds)
    under ``torch.profiler``.  256 sentinel kernels lead the trace: the
    profiler drops a trace's first records, more of them the longer the
    process has run (``op_walk.kernel_trace``).  A trace that lost every
    sentinel may have lost ``run``'s own records too: it is taken again, up
    to ``attempts`` traces, and then the run fails."""
    import torch

    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(256):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        lead = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        print(f"[{tag}] the profiler dropped {256 - len(lead)} of the 256 leading sentinel "
              "records", flush=True)
        if lead:
            return events[lead[-1] + 1:], wall
    fail(f"{tag}: the profiler dropped every sentinel in {attempts} traces")


def _decode_launch_check(tag, counts, want):
    """Launches from zero of one decode run: ``decode_attn`` exactly ``want``,
    every other kernel none."""
    others = {k: v for k, v in counts.items() if k != "decode_attn" and v}
    check(counts.get("decode_attn", 0) == want and not others,
          f"decode {tag}: launches {counts}, want decode_attn {want} and nothing else")


def decode_phase(dev, smi):
    """4m: LLM decode serving, ``repro_torch.launch.serve``, every attention
    layer through ``decode_attn`` (gemma2 with its softcap).

    (a) ``serve.main`` for each of the ten reduced architectures on the card
        (B = 4, prompt 32, gen 16: 47 steps), launches from zero exactly
        47 x ``attn_launches_per_step``; one more step under
        ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), its first
        kernel call held against ``decode_attn_plain`` on its own operands
        within 1e-5 max|V|; then the same 47 tokens teacher-forced through
        the card and the CPU from the card's weights
        (``repro_torch.analysis.lockstep``, bf16): no ``faults`` (logits and
        state leaves within ``BF16_TOL`` of scale at every step, kpos equal,
        greedy tokens equal at a clear margin; the hybrid family's numbers
        reported, not held), router flips only at MoE near-ties; for the
        hybrid family also a float32 run of both devices from the fp32
        weights, held to ``HYBRID_F32_TOL``.
    (b) gemma2-2b at full width (26 layers, d 2304, vocab 256000), B = 4,
        prompt 32, gen 16, twice (the second timed warm): ms/step, tokens/s,
        peak card memory, launches 47 x 26; three warm steps under
        ``torch.profiler`` and one under the sync check.
    (c) a full-width gemma2-2b state of max_len 8192 filled to position 5999
        (random K/V, the local rings wrapped), four steps from position 6000;
        at the last step, one local and one global layer's kernel call held
        against ``decode_attn_plain`` on the step's own q/K/V within
        1e-5 max|V|, launches 4 x 26.
    Returns the path launches {tag: counts}."""
    import numpy as np
    import torch

    from repro_torch.analysis import lockstep as LS
    from repro_torch.configs import get_config, list_archs
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    from repro_torch.models import (
        attn_launches_per_step, cast_compute, decode_step, init_decode_state, init_model,
    )

    def card_vs_cpu(cfg, params, toks):
        """``toks`` ((steps, B, 1)) through the CPU (ref) and the card from
        ``params``: the report and the card's launches."""
        B, steps = toks.shape[1], toks.shape[0]
        ref = LS.PortSide(cfg, params, "cpu", B, steps)
        got = LS.PortSide(cfg, params, dev, B, steps)
        dtype = got.dtype
        before = runtime.family("decode_attn").launches
        rep = LS.lockstep(ref, got, toks, LS.tolerance(cfg, dtype),
                          hold=LS.holds_numbers(cfg, dtype),
                          route_tol=LS.ROUTE_TOL if dtype == torch.bfloat16 else None)
        return rep, runtime.family("decode_attn").launches - before

    path = {}
    print(f"[decode] {smi}", flush=True)
    # (a) the ten reduced architectures
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        torch.cuda.synchronize()
        runtime.reset_launches()
        out = serve.main(["--arch", arch, "--reduce", *DECODE_ARGS])
        torch.cuda.synchronize()
        counts = runtime.launches()
        per_step = attn_launches_per_step(cfg)
        _decode_launch_check(arch, counts, out["steps"] * per_step)
        path[f"decode {arch}"] = counts
        # one more step (position 47, the state's last) may not wait on the card
        last_tok = torch.from_numpy(out["tokens"][:, -1:]).to(dev)
        last_pos = torch.tensor(out["steps"], dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        with _RecordedCalls(1) as seen:
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.no_grad():
                    decode_step(out["params"], cfg, out["state"], last_tok, last_pos)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(len(seen) == min(1, per_step), f"decode {arch}: recorded {len(seen)} kernel calls")
        for call in seen:
            _hold_recorded(f"{arch} reduced, the step's first attention layer", call)
        toks = np.concatenate([out["prompt"], out["tokens"][:, :-1]], axis=1)  # (B, 47)
        check(toks.shape[1] == out["steps"], f"decode {arch}: token count")
        toks = np.ascontiguousarray(toks.T[:, :, None])
        runs = [("bf16", out["params"])]
        if cfg.family == "hybrid":  # its bf16 numbers are not held: hold a float32 run
            runs.append(("fp32", cast_compute(init_model(cfg, seed=0, device=dev),
                                              torch.float32)))
        for name, params in runs:
            rep, launched = card_vs_cpu(cfg, params, toks)
            print(f"[decode] {arch:20s} {cfg.family:6s} {name} {out['ms_per_step']:8.3f} ms/step"
                  f"  decode_attn {per_step}/step  card vs CPU: logits "
                  f"{max(rep['logit_err']):.3e} state {max(rep['state_err']):.3e} of scale "
                  f"(worst {rep['worst_leaf'][0]}; tol {rep['tol']:.3e}, "
                  f"{'held' if rep['hold'] else 'reported'})  flipped {rep['flipped']}  greedy "
                  f"{rep['greedy_equal']}/{rep['greedy_clear']} at a clear margin", flush=True)
            check(not LS.faults(rep), f"decode {arch} {name}: {LS.faults(rep)}")
            check(launched == out["steps"] * per_step, f"decode {arch} {name}: lockstep launches")
            check(not rep["flipped"] or cfg.family == "moe", f"decode {arch}: a flip outside MoE")
            check(not rep["hold"] or rep["greedy_clear"] > 0,
                  f"decode {arch} {name}: no greedy token at a clear margin")

    # (b) gemma2-2b at full width
    cfg = get_config("gemma2-2b")
    full = None
    for turn in ("cold", "warm"):
        full = None  # free the previous turn's weights and state first
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9  # the earlier phases' tensors still alive
        runtime.reset_launches()
        full = serve.main(["--arch", "gemma2-2b", *DECODE_ARGS])
        torch.cuda.synchronize()
        counts = runtime.launches()
        _decode_launch_check(f"gemma2-2b full {turn}", counts, full["steps"] * cfg.num_layers)
        path[f"decode gemma2-2b full {turn}"] = counts
        peak = torch.cuda.max_memory_allocated() / 1e9
        B, steps = full["tokens"].shape[0], full["steps"]
        print(f"[decode] gemma2-2b full width ({turn}): {full['ms_per_step']:.3f} ms/step, "
              f"{B * steps / full['seconds']:.1f} tokens/s (B {B} x {steps} steps), peak "
              f"{peak:.2f} GB ({peak - held:.2f} GB above the {held:.2f} GB held before the "
              f"run), decode_attn {counts['decode_attn']}  [{smi}]", flush=True)
        check(((full["tokens"] >= 0) & (full["tokens"] < cfg.vocab_size)).all(),
              "decode gemma2-2b full: token ids out of range")

    # where a full-width step's time goes: three warm steps under
    # torch.profiler (CUDA activity, behind sentinel kernels that absorb the
    # records it drops), device time by kernel group against the host clock
    params = full["params"]
    full = None
    B = 4
    state = init_decode_state(cfg, B, 64, dev)
    positions = torch.arange(64, dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        decode_step(params, cfg, state, tok, positions[0])
        torch.cuda.synchronize()
        events, wall = _sentinel_trace("decode profile", lambda: [
            decode_step(params, cfg, state, tok, positions[p]) for p in range(1, 4)])
        wall = wall / 3 * 1e3
        torch.cuda.set_sync_debug_mode("error")  # a full-width step never waits on the card
        try:
            decode_step(params, cfg, state, tok, positions[4])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    groups, names = {}, {}
    for e in events:
        low = e.name.lower()
        g = ("decode_attn" if "decode_attn" in low else
             "matmul" if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma"))
             else "other")
        for table, key in ((groups, g), (names, e.name[:60])):
            n, us = table.get(key, (0, 0.0))
            table[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in groups.values()) / 3 / 1e3
    print(f"[decode] gemma2-2b full-width step (B {B}), profiled: host {wall:.3f} ms a step, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %); per step by group: "
          + ", ".join(f"{g} {n / 3:.0f} kernels {us / 3 / 1e3:.3f} ms"
                      for g, (n, us) in sorted(groups.items())), flush=True)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:8]
    print("[decode]   the step's top kernels by device time: " + "; ".join(
        f"{k} x{n / 3:.0f} {us / 3 / 1e3:.3f} ms" for k, (n, us) in top), flush=True)

    # (c) a wrapped full-width state: the kernel on the step's own q / K / V
    state = init_decode_state(cfg, B, DECODE_FULL_LEN, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    filled = torch.arange(DECODE_FULL_POS, dtype=torch.int32, device=dev)
    for kind, size in (("local", cfg.sliding_window), ("global", DECODE_FULL_LEN)):
        c = state["pairs"][kind]
        held_pos = filled[-size:] if size < DECODE_FULL_POS else filled
        c["kpos"][:, :, held_pos.long() % size] = held_pos
        for name in ("k", "v"):
            c[name].copy_(torch.randn(c[name].shape, generator=gen, device=dev))
    check(int(state["pairs"]["local"]["kpos"].min()) == DECODE_FULL_POS - cfg.sliding_window,
          "decode full state: the local rings are not wrapped")
    seen = []
    positions = torch.arange(DECODE_FULL_LEN, dtype=torch.int32, device=dev)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 1), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    runtime.reset_launches()
    with torch.no_grad():
        for p in range(DECODE_FULL_POS, DECODE_FULL_POS + DECODE_FULL_STEPS):
            if p == DECODE_FULL_POS + DECODE_FULL_STEPS - 1:  # the step's first two calls
                with _RecordedCalls(2) as seen:
                    logits, state = decode_step(params, cfg, state, tok, positions[p])
            else:
                logits, state = decode_step(params, cfg, state, tok, positions[p])
            tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    counts = runtime.launches()
    path["decode gemma2-2b wrapped state"] = counts
    # the recording's own launches are the step's: 26 a step
    _decode_launch_check("gemma2-2b wrapped state", counts, DECODE_FULL_STEPS * cfg.num_layers)
    check(bool(torch.isfinite(logits.float()).all()), "decode full state: non-finite logits")
    check(len(seen) == 2, f"decode full state: recorded {len(seen)} kernel calls")
    for call, kind in zip(seen, ("local", "global")):  # pair 0: local then global
        kw = call[5]
        check(kw.get("softcap") == 50.0 and kw.get("window") == (
            cfg.sliding_window if kind == "local" else None), f"decode full {kind}: {kw}")
        _hold_recorded(f"full-width gemma2-2b {kind} layer", call)
    return path


TRAIN_CMP = (2, 64)  # (a), (b): batch and sequence of the card-vs-CPU step
TRAIN_FULL = dict(batch=8, seq=256, steps=8)  # (c): launch/train.py's batch and seq
TRAIN_LR = dict(peak_lr=1e-3, warmup=2, total_steps=8)
TRAIN_SYNC_STEP = 3  # (c): the step run under set_sync_debug_mode("error")
# (c): the full-width losses must fall by this much over the 8 steps (the H100
# read 12.915 -> 7.064, a fall of 5.85; PERF.md §6 PR 28)
TRAIN_FALL = 2.0
TRAIN_SERVE = dict(batch=4, prompt_len=8, gen=8)  # (d)
QCOMM_SHAPE = (8, 32)  # (e): tests/test_qcomm.py's batch
TRAIN_CLI = ("--arch", "xlstm-125m", "--reduce", "--steps", "6", "--batch", "2", "--seq", "32",
             "--ckpt-every", "6", "--log-every", "2")
TRAIN_EXAMPLE = ("--steps", "20", "--batch", "4", "--seq", "64", "--feature-batches", "20",
                 "--gp-steps", "30")


def train_qcomm_rank(arch, bits, device, steps=8):
    """(e) on one rank: ``arch`` (reduced) trained ``steps`` steps with
    ``qcomm_bits=bits`` over the default group (bits 0: the plain step in
    this process), on tests/test_qcomm.py's batch (seeded token ids, labels
    the tokens); the losses and a digest of the final params."""
    import numpy as np
    import torch

    from repro_torch.analysis.lockstep import flat
    from repro_torch.configs import get_config
    from repro_torch.models import init_train_state, make_train_step

    cfg = get_config(arch).reduced()
    params, opt = init_train_state(cfg, seed=0, device=device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, QCOMM_SHAPE).astype(np.int32)).to(device)
    step = make_train_step(cfg, qcomm_bits=bits, **{**TRAIN_LR, "total_steps": 12})
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, {"tokens": toks, "labels": toks})
        losses.append(m["loss"])
    return {"losses": [float(v) for v in losses],
            "digest": torch.stack([p.double().sum() for _, p in sorted(flat(params).items())])}


def train_phase(dev, smi, full=None, archs=None, cli=True, fall=TRAIN_FALL):
    """4n: LLM training, ``repro_torch.models.make_train_step`` (AdamW in
    place, remat per layer), on the card.  No hand-written kernel runs in
    training (the reference's training path reaches no Pallas kernel);
    the trained weights are served through ``decode_attn``.

    (a) each reduced architecture (``archs``: all ten), one step from the
        port's seed-0 weights on a seeded batch (B 2, S 64: the reduced
        window of 32 bites) on the card and on the CPU in float32, TF32 off
        (``analysis.trainstep``): logits, loss, MoE aux and every gradient
        leaf within ``trainstep.limits`` of scale, each device's update its
        own AdamW step (float64 from its gradients) within ``adamw_err``,
        the two updates no more than one AdamW step apart; the same in
        bf16, reported.  No kernel launched.
    (b) ``full`` (gemma2-2b at full width) at depth 2 (train.py's
        ``--layers 2``): (a)'s float32 step, card against CPU; then the
        card's updated params ``save_checkpoint`` -> ``restore_checkpoint``
        onto the card, bitwise.
    (c) ``full`` at full depth: ``TRAIN_FULL`` (launch/train.py's batch 8,
        seq 256; remat on, as the config has it), 8 steps of
        ``make_train_step(peak_lr=1e-3, warmup=2, total_steps=8)`` on one
        batch of ``lm_batch_stream`` repeated (its fresh batches are near
        uniform over the vocabulary: 8 steps of them do not lower the loss):
        s/step (synchronized), tokens/s, peak card memory; every loss and
        gnorm finite, the losses falling by ``fall``; step
        ``TRAIN_SYNC_STEP`` under ``set_sync_debug_mode("error")``; one
        more warm step under ``torch.profiler`` (device time by kernel
        group against the host clock).
    (d) the trained weights cast and served by ``launch.serve.serve``
        (``TRAIN_SERVE``): ``decode_attn`` launches exactly steps x the
        layer count and nothing else; one more step's local and global
        kernel calls held against ``decode_attn_plain`` within 1e-5 max|V|.
    (e) ``qcomm_bits = 8`` on 2 gloo ranks on the card (reduced gemma2-2b,
        batch (8, 32), 8 steps) against exact training: tests/test_qcomm.py's
        criteria (first loss within rel 1e-3, last within 0.15, the exact
        run falling by 0.5); both ranks the same params.
    (f) ``python -m repro_torch.launch.train`` (``TRAIN_CLI``) and the
        LM-to-GP-head example (``TRAIN_EXAMPLE``) on the card: exit 0,
        ``metrics.csv`` and the checkpoint written, the example's SMSE
        finite.
    Returns the path launches {tag: counts}."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from repro_torch.analysis import trainstep as TS
    from repro_torch.analysis.lockstep import flat
    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, list_archs
    from repro_torch.data import lm_batch_stream
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    from repro_torch.launch.ranks import RankPool
    from repro_torch.models import (
        cast_compute, decode_step, init_model, init_train_state, make_train_step, param_count,
    )
    from repro_torch.models.weights import _map

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    full = get_config("gemma2-2b") if full is None else full
    archs = list_archs() if archs is None else archs
    path = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def numpy_init(cfg):
        return _map(lambda _, t: t.numpy(), init_model(cfg, seed=0, device="cpu"))

    def card_vs_cpu(cfg, dtype):
        p_np, b_np = numpy_init(cfg), TS.batch_arrays(cfg, *TRAIN_CMP, seed=0)
        t0 = time.perf_counter()
        ref = TS.run_step(cfg, p_np, b_np, cpu, dtype)
        t1 = time.perf_counter()
        got = TS.run_step(cfg, p_np, b_np, dev, dtype)
        sync()
        return TS.compare(ref, got), got, (t1 - t0, time.perf_counter() - t1)

    def line(rep):
        return (f"logits {rep['logits']:.3e} loss {rep['loss']:.3e} aux {rep['aux']:.3e} grads "
                f"{rep['grads']:.3e} ({rep['worst_leaf']}); each update its own AdamW step "
                f"within {rep['adamw_err']:.2e} lr; the two {rep['update_lr']:.3f} lr apart at "
                f"most, {rep['update_moved']:.2e} of elements > 1e-3 lr apart")

    print(f"[train] {smi}", flush=True)
    # (a) the ten reduced architectures, card against CPU
    for arch in archs:
        cfg = get_config(arch).reduced()
        sync()
        runtime.reset_launches()
        rep, got, (t_cpu, t_dev) = card_vs_cpu(cfg, torch.float32)
        rep16, _, _ = card_vs_cpu(cfg, torch.bfloat16)
        sync()
        counts = runtime.launches()
        print(f"[train] {arch:20s} {cfg.family:6s} fp32 card vs CPU: {line(rep)}; loss "
              f"{got['metrics']['loss']:.4f}; step + grads {t_dev:.2f} s card, {t_cpu:.2f} s "
              f"CPU", flush=True)
        print(f"[train] {arch:20s} {cfg.family:6s} bf16 card vs CPU (reported): {line(rep16)}",
              flush=True)
        check(not TS.faults(rep, cfg), f"train {arch}: {TS.faults(rep, cfg)}")
        check(not any(counts.values()), f"train {arch}: a kernel launched: {counts}")

    # (b) full width at depth 2: card against CPU, then the checkpoint on the card
    cfg2 = dataclasses.replace(full, num_layers=2)
    rep, got, (t_cpu, t_dev) = card_vs_cpu(cfg2, torch.float32)
    n2 = sum(a.numel() for a in got["params"].values())
    print(f"[train] {cfg2.name} full width, depth 2 ({n2 / 1e9:.3f} B "
          f"params) fp32 card vs CPU: {line(rep)}; loss {got['metrics']['loss']:.4f}; "
          f"{t_dev:.2f} s card, {t_cpu:.2f} s CPU", flush=True)
    check(not TS.faults(rep, cfg2), f"train full depth 2: {TS.faults(rep, cfg2)}")
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    params = got["params"]  # the card's params after its step
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt), 1, params)
    t1 = time.perf_counter()
    back = restore_checkpoint(str(ckpt), 1, params)
    sync()
    t2 = time.perf_counter()
    check(latest_step(str(ckpt)) == 1 and all(
        back[k].device == a.device and torch.equal(a, back[k]) for k, a in params.items()),
        "train checkpoint: not bitwise on the card")
    size = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9
    print(f"[train] checkpoint of the depth-2 params after the card's step ({size:.2f} GB): "
          f"save {t1 - t0:.2f} s, restore onto the card {t2 - t1:.2f} s, {len(params)} leaves "
          f"bitwise", flush=True)
    params = back = got = None
    shutil.rmtree(ckpt, ignore_errors=True)

    # (c) full width, full depth: 8 steps at launch/train.py's batch and seq
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    params, opt = init_train_state(full, seed=0, device=dev)
    n_params = param_count(params)
    step = make_train_step(full, **TRAIN_LR)
    # one batch of launch/train.py's stream, repeated: its fresh batches draw
    # tokens near uniformly over the 256000-token vocabulary (each token's
    # bigram successor is random), which 8 steps cannot fit
    batch = next(lm_batch_stream(full.vocab_size, TRAIN_FULL["batch"], TRAIN_FULL["seq"],
                                 seed=0, device=dev))
    batches = [batch] * TRAIN_FULL["steps"]
    state_gb = 16 * n_params / 1e9  # fp32 params, m, v and the grads
    metrics, secs = [], []
    for i, batch in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        if i == TRAIN_SYNC_STEP and cuda:  # a step never waits on the card
            torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt, m = step(params, opt, batch)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        secs.append(time.perf_counter() - t0)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    warm = float(np.median(secs[1:]))
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
    print(f"[train] {full.name} full width, {full.num_layers} layers ({n_params / 1e9:.3f} B "
          f"params, remat {full.remat}), batch {TRAIN_FULL['batch']} x seq "
          f"{TRAIN_FULL['seq']}: s/step " + " ".join(f"{s:.3f}" for s in secs)
          + f" (median of 2-8 {warm:.3f} s, {tokens / warm:.1f} tokens/s); peak card memory "
          f"{peak:.2f} GB ({peak - held:.2f} GB above the {held:.2f} GB held before; the fp32 "
          f"params, grads, m and v are {state_gb:.2f} GB)  [{smi}]", flush=True)
    print("[train]   losses " + " ".join(f"{v:.4f}" for v in losses) + "; gnorm "
          + " ".join(f"{v:.3f}" for v in gnorms), flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          "train full: a non-finite loss or gnorm")
    check(losses[-1] < losses[0] - fall,
          f"train full: the loss fell {losses[0] - losses[-1]:.4f} < {fall}")
    if cuda:  # where a warm step's time goes: one more step under torch.profiler
        def one_step():
            nonlocal params, opt
            params, opt, _ = step(params, opt, batch)

        events, wall = _sentinel_trace("train profile", one_step)
        groups, names = {}, {}
        for e in events:
            low = e.name.lower()
            g = ("matmul" if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma"))
                 else "reduce" if "reduce" in low else "elementwise" if "elementwise" in low
                 else "other")
            for table, key in ((groups, g), (names, e.name[:60])):
                n, us = table.get(key, (0, 0.0))
                table[key] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in groups.values()) / 1e6
        print(f"[train] a warm full-width step, profiled: host {wall:.3f} s, device busy "
              f"{busy:.3f} s ({100 * busy / wall:.1f} %); by group: " + ", ".join(
                  f"{g} {n} kernels {us / 1e3:.1f} ms" for g, (n, us) in sorted(groups.items())),
              flush=True)
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:6]
        print("[train]   top kernels by device time: " + "; ".join(
            f"{k} x{n} {us / 1e3:.1f} ms" for k, (n, us) in top), flush=True)

    # (d) the trained weights, served: every attention layer through decode_attn
    served = cast_compute(params)
    params = opt = metrics = batches = None
    if cuda:
        torch.cuda.empty_cache()
    sync()
    runtime.reset_launches()
    out = serve.serve(full, device=dev, params=served, **TRAIN_SERVE)
    sync()
    counts = runtime.launches()
    _decode_launch_check("trained gemma2-2b", counts, out["steps"] * full.num_layers)
    check(((out["tokens"] >= 0) & (out["tokens"] < full.vocab_size)).all(),
          "train serve: token ids out of range")
    last_tok = torch.from_numpy(out["tokens"][:, -1:]).to(dev)
    last_pos = torch.tensor(out["steps"], dtype=torch.int32, device=dev)
    with _RecordedCalls(2) as seen, torch.no_grad():
        decode_step(served, full, out["state"], last_tok, last_pos)
    sync()
    counts = runtime.launches()
    path["train serve gemma2-2b full"] = counts
    check(counts.get("decode_attn", 0) == (out["steps"] + 1) * full.num_layers,
          f"train serve: launches {counts}")
    check(len(seen) == 2, f"train serve: recorded {len(seen)} kernel calls")
    for call, kind in zip(seen, ("local", "global")):
        _hold_recorded(f"trained full-width gemma2-2b, last step, {kind} layer", call)
    print(f"[train] trained weights served (B {TRAIN_SERVE['batch']}, prompt "
          f"{TRAIN_SERVE['prompt_len']}, gen {TRAIN_SERVE['gen']}): "
          f"{1e3 * out['seconds'] / out['steps']:.3f} ms/step, decode_attn "
          f"{counts.get('decode_attn', 0)} = {out['steps'] + 1} steps x {full.num_layers}",
          flush=True)
    served = out = None
    if cuda:
        torch.cuda.empty_cache()

    # (e) the quantized gradient reduce on 2 gloo ranks, against exact training
    t0 = time.perf_counter()
    exact = train_qcomm_rank("gemma2-2b", 0, dev.type)
    with RankPool(2, device=dev.type) as pool:
        q8 = pool.run(train_qcomm_rank, "gemma2-2b", 8, dev.type, world=2)
    e, q = exact["losses"], q8[0]["losses"]
    print(f"[train] qcomm_bits 8 on 2 gloo ranks vs exact (reduced gemma2-2b, batch "
          f"{QCOMM_SHAPE}): first {q[0]:.5f} / {e[0]:.5f}, last {q[-1]:.5f} / {e[-1]:.5f}; "
          f"exact fell {e[0] - e[-1]:.4f}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(e[-1] < e[0] - 0.5, f"train qcomm: exact training fell {e[0] - e[-1]:.4f}")
    check(abs(q[0] - e[0]) <= 1e-3 * abs(e[0]) and abs(q[-1] - e[-1]) < 0.15,
          f"train qcomm: {q} against {e}")
    check(q8[0]["losses"] == q8[1]["losses"]
          and np.array_equal(q8[0]["digest"], q8[1]["digest"]),
          "train qcomm: the ranks' params differ")

    # (f) the training CLI and the LM-to-GP-head example, on the card
    if cli:
        work = ROOT / "build" / "chip_smoke_train_cli"
        shutil.rmtree(work, ignore_errors=True)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        dev_args = ("--device", dev.type)
        for tag, argv in (("launch.train", ("-m", "repro_torch.launch.train", *TRAIN_CLI,
                                            "--workdir", str(work), *dev_args)),
                          ("train_lm_gp_head", ("-m", "repro_torch.examples.train_lm_gp_head",
                                                *TRAIN_EXAMPLE, *dev_args))):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                                 env=env, cwd=str(ROOT), timeout=600)
            check(res.returncode == 0, f"train {tag}: exit {res.returncode}\n{res.stderr[-3000:]}")
            tail = [ln for ln in res.stdout.splitlines() if ln.strip()][-3:]
            print(f"[train] {tag}: exit 0 in {time.perf_counter() - t0:.1f} s; "
                  + " | ".join(ln.strip() for ln in tail), flush=True)
            if tag == "launch.train":
                check((work / "metrics.csv").is_file() and latest_step(str(work)) == 6,
                      "train CLI: no metrics.csv or checkpoint")
            else:
                smse = [float(ln.split("smse=")[1].split()[0]) for ln in res.stdout.splitlines()
                        if "smse=" in ln]
                check(len(smse) == 4 and all(np.isfinite(smse)), f"train example: {smse}")
        shutil.rmtree(work, ignore_errors=True)
    return path


# phase o: the dry run (repro_torch.launch.dryrun) against real steps ---------
DRY_TRAIN = dict(batch=8, seq=256)  # 4n-c's setting (launch/train.py's batch and seq)
DRY_DECODE = dict(batch=4, max_len=8192)  # 4m's full-width state
# predicted peak / the card's max_memory_allocated above the memory held
# before the step's tensors were made: read 0.999 (49.352 / 49.411 GB) on an
# H100 80GB HBM3 at 700 W; the band leaves the caching allocator's rounding
# and cuBLAS's workspace room
DRY_PEAK_BAND = (0.95, 1.05)
# the reference's CLI test, then gemma2-2b train_4k on both production meshes:
# the two combos of --both-meshes as two processes side by side (~100 and
# ~60 s of tracing on the card's host), so that the phase stays near 150 s
DRY_CLI = (("--arch", "xlstm-125m", "--shape", "long_500k"),
           ("--arch", "gemma2-2b", "--shape", "train_4k"),
           ("--arch", "gemma2-2b", "--shape", "train_4k", "--multi-pod"))
DRY_TIMEOUT = 900  # s, each child


def _dry_child(shape, dev_type, reduced):
    """The argv of a child process that runs one 1 x 1-mesh dry run
    (``launch.dryrun.run_one``) of gemma2-2b (``.reduced()`` with
    ``reduced``) at ``shape`` (name, seq, batch, kind) on fake ``dev_type``
    tensors and prints its result as JSON, with the kernel launches the
    trace made (none is expected)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.kernels import runtime\n"
        "from repro_torch.launch.dryrun import run_one\n"
        "from repro_torch.models.config import ShapeConfig\n"
        "runtime.reset_launches()\n"
        "cfg = get_config('gemma2-2b')\n"
        f"cfg = cfg.reduced() if {reduced!r} else cfg\n"
        f"res = run_one('gemma2-2b', {shape[0]!r}, False, verbose=False, cfg=cfg, "
        f"shape=ShapeConfig(*{tuple(shape)!r}), mesh_shape=(1, 1), device={dev_type!r})\n"
        "res['launches'] = runtime.launches()\n"
        "print(json.dumps(res))\n")
    return [sys.executable, "-c", code]


def dryrun_phase(dev, smi, cli=DRY_CLI, reduced=False):
    """4o: ``repro_torch.launch.dryrun`` — the production mesh on a fake
    process group, DTensors of fake local shards, the dispatch-level cost
    counter (``repro_torch.roofline``), ``decode_attn`` as a custom op —
    held against real steps on the card.  Every dry run runs in a child
    process of its own: a fake default group never meets this process (or
    4l's and 4n-e's gloo ranks).

    (a) gemma2-2b at full width and depth, 4n-c's batch 8 x seq 256 (remat
        as configured), a dry run on a 1 x 1 mesh on fake ``cuda`` tensors,
        then one real step on the card under the same counter: per-device
        matmul FLOPs equal; the predicted peak (``MemTracker``) against
        ``max_memory_allocated`` above the memory held before the step's
        tensors, within ``DRY_PEAK_BAND``; the roofline's compute, memory
        and collective seconds beside the measured s/step (reported).  No
        kernel launched by either.
    (b) one full-width gemma2-2b decode step at batch 4 (max_len 8192) the
        same two ways: the fake trace makes exactly 26 ``decode_attn``
        custom-op calls and launches nothing; the real step launches 26;
        FLOPs equal.
    (c) ``python -m repro_torch.launch.dryrun`` for each of ``cli`` (the
        reference's CLI test combo, and gemma2-2b train_4k on each
        production mesh), started first, alongside (a) and (b): exit 0
        and ``dom=`` on every combo line, which is printed with per-device
        GB, the three roofline terms and the trace seconds (``[dryrun]``
        lines).
    ``reduced`` runs (a) and (b) on gemma2-2b ``.reduced()`` (a rehearsal on
    the CPU: ``dryrun_phase(torch.device("cpu"), "", cli=(), reduced=True)``,
    where the peak band is not read).  Returns the path launches {tag:
    counts}."""
    import os

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch_stream
    from repro_torch.kernels import runtime
    from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
    from repro_torch.models import (attn_launches_per_step, cast_compute, init_decode_state,
                                    init_model, init_train_state, make_decode_step,
                                    make_train_step)
    from repro_torch.roofline import CostCounter

    cuda = dev.type == "cuda"
    full = get_config("gemma2-2b")
    full = full.reduced() if reduced else full
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_MB_TOKENS", None)
    t_start = time.perf_counter()
    clis = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for args in cli]
    train_shape = ("train_4k", DRY_TRAIN["seq"], DRY_TRAIN["batch"], "train")
    decode_shape = ("decode_32k", DRY_DECODE["max_len"], DRY_DECODE["batch"], "decode")
    kids = [subprocess.Popen(_dry_child(sh, dev.type, reduced), cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for sh in (train_shape, decode_shape)]

    def finish(p, tag):
        try:
            out, err = p.communicate(timeout=DRY_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"dryrun {tag}: no result in {DRY_TIMEOUT} s")
        said = [ln for ln in err.splitlines() if not re.search(r"\]:W\d{4}|Warning", ln)]
        check(p.returncode == 0, f"dryrun {tag}: exit {p.returncode}: " + "\n".join(said[-40:]))
        return out

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def release():
        if cuda:
            torch.cuda.empty_cache()

    path = {}
    try:
        print(f"[dryrun] {smi}", flush=True)
        # (a) one full-width train step: the card's, under the counter
        sync()
        release()
        held = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params, opt = init_train_state(full, seed=0, device=dev)
        step = make_train_step(full, **TRAIN_LR)
        batch = next(lm_batch_stream(full.vocab_size, DRY_TRAIN["batch"], DRY_TRAIN["seq"],
                                     seed=0, device=dev))
        runtime.reset_launches()
        with CostCounter() as counter:
            params, opt, m = step(params, opt, batch)
        sync()
        real_peak = torch.cuda.max_memory_allocated() - held if cuda else 0
        real = counter.cost
        secs = []
        for _ in range(2):  # s/step outside the counter (its Python costs a step ~x10)
            sync()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            sync()
            secs.append(time.perf_counter() - t0)
        check(not any(runtime.launches().values()),
              f"dryrun train: a kernel launched: {runtime.launches()}")
        params = opt = batch = m = step = None
        release()

        # (b) one full-width decode step: the card's, under the counter
        dparams = cast_compute(init_model(full, seed=0, device=dev))
        state = init_decode_state(full, DRY_DECODE["batch"], DRY_DECODE["max_len"], device=dev)
        tok = torch.zeros((DRY_DECODE["batch"], 1), dtype=torch.int32, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        dstep = make_decode_step(full)
        sync()
        runtime.reset_launches()
        with CostCounter() as dcounter:
            nxt, state = dstep(dparams, state, tok, pos)
        sync()
        dlaunch = runtime.launches()
        path["dryrun: a real gemma2-2b decode step"] = dlaunch
        dparams = state = nxt = None
        release()

        dry = [json.loads(finish(p, tag).strip().splitlines()[-1])
               for p, tag in zip(kids, ("train", "decode"))]
        t_kids = time.perf_counter() - t_start
        dt, dd = dry
        # gemma2-2b: 13 local + 13 global attention layers a step, through the
        # kernel on the card (the plain version on the CPU, no custom op)
        want = attn_launches_per_step(full) if cuda else 0
        pt, pd = dt["per_device"], dd["per_device"]
        pred_peak = dt["memory"]["peak_bytes"]
        r = dt["roofline"]
        print(f"[dryrun] (a) gemma2-2b train, batch {DRY_TRAIN['batch']} x seq "
              f"{DRY_TRAIN['seq']}, remat {full.remat}, {full.num_layers} layers, 1 x 1 mesh: "
              f"matmul FLOPs dry "
              f"{pt['hlo_flops']:.6e} / real {real.flops:.6e}; bytes dry {pt['hlo_bytes']:.6e} / "
              f"real {real.bytes:.6e}; peak predicted {pred_peak / 1e9:.3f} GB / the card's "
              f"{real_peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held (ratio "
              f"{pred_peak / max(real_peak, 1):.3f}, band {DRY_PEAK_BAND}); roofline compute "
              f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, collective "
              f"{r['collective_s']:.4f} s (dom {r['dominant']}; H100 peaks {PEAK_FLOPS_BF16:.3g}"
              f" FLOP/s, {HBM_BW:.3g} B/s, {ICI_BW:.3g} B/s) against the measured "
              + " / ".join(f"{v:.3f}" for v in secs) + f" s/step; trace {dt['trace_s']} s  "
              f"[{smi}]", flush=True)
        check(pt["hlo_flops"] == real.flops,
              f"dryrun train: FLOPs dry {pt['hlo_flops']} != real {real.flops}")
        lo, hi = DRY_PEAK_BAND
        check(not cuda or lo <= pred_peak / real_peak <= hi,
              f"dryrun train: predicted peak {pred_peak} / real {real_peak} outside "
              f"{DRY_PEAK_BAND}")
        check(not any(dt["launches"].values()), f"dryrun train trace launched {dt['launches']}")
        calls_dry = pd["calls"].get("repro_torch::decode_attn", 0)
        calls_real = dcounter.calls.get("repro_torch::decode_attn", 0)
        print(f"[dryrun] (b) gemma2-2b decode step, batch {DRY_DECODE['batch']}, max_len "
              f"{DRY_DECODE['max_len']}: decode_attn custom-op calls dry {calls_dry} (launches "
              f"{dd['launches'].get('decode_attn', 0)}) / real {calls_real} (launches "
              f"{dlaunch.get('decode_attn', 0)}); matmul FLOPs dry {pd['hlo_flops']:.6e} / real "
              f"{dcounter.cost.flops:.6e}; bytes dry {pd['hlo_bytes']:.6e} / real "
              f"{dcounter.cost.bytes:.6e}; peak predicted {dd['memory']['peak_bytes'] / 1e9:.3f}"
              f" GB; trace {dd['trace_s']} s", flush=True)
        check(calls_dry == want and not any(dd["launches"].values()),
              f"dryrun decode trace: {calls_dry} custom-op calls, launches {dd['launches']}")
        check(calls_real == want and dlaunch.get("decode_attn", 0) == want
              and sum(dlaunch.values()) == want,
              f"dryrun decode real: {calls_real} calls, launches {dlaunch}")
        check(pd["hlo_flops"] == dcounter.cost.flops,
              f"dryrun decode: FLOPs dry {pd['hlo_flops']} != real {dcounter.cost.flops}")
        print(f"[dryrun] (a) and (b) children done at {t_kids:.1f} s", flush=True)

        # (c) the CLI
        for p, args in zip(clis, cli):
            out = finish(p, " ".join(args))
            lines = [ln for ln in out.splitlines() if " pods=" in ln or "FAILED" in ln]
            for ln in lines:
                print(f"[dryrun] (c) {ln}", flush=True)
            check(lines and all("dom=" in ln for ln in lines),
                  f"dryrun CLI {' '.join(args)}: a combo without dom=: {out[-1500:]}")
            print(f"[dryrun] (c) {' '.join(args)}: exit 0, {len(lines)} combos, "
                  f"{out.strip().splitlines()[-1]}", flush=True)
    finally:
        for p in clis + kids:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return path


# phase p: the autotune cache at the paths' shapes (R = 24 over d = 21, 12 bits
# a dimension at most: one word a row, 4096-entry tables)
TUNE_QGRAM = (  # (tag, m, n, p, d, R): qgram_packed's calls
    ("Fig. 6 center fit 39 x 25 x 25", 39, 25, 25, 21, 24),
    ("broadcast fit 40 x 25 x 1000", 40, 25, 1000, 21, 24),
    ("40 x 1000 x 4449", 40, 1000, 4449, 21, 24),
)
TUNE_FLEET = (  # (tag, T, m, t, K): epilogue_fleet's launches
    ("serve_gp flush T 4, t 128, K 50", 4, 40, 128, 50),
    ("smoke flush T 16, t 16, K 25", 16, 40, 16, 25),
    ("serve-sized T 8, t 128, K 25", 8, 40, 128, 25),
)


def _tune_operands(dev, m, n, p, d, R, seed):
    """``qgram_packed`` operands of one call from a seed: R bits given one
    at a time to random dimensions (12 at most), codes, 4096-entry tables,
    a projection per machine and every row valid."""
    import torch

    from repro_torch.core import torch_scheme as TS

    g = torch.Generator().manual_seed(seed)
    rates = torch.zeros(m, d, dtype=torch.int64)
    for _ in range(R):
        j = torch.randint(d, (m,), generator=g)
        rates[torch.arange(m), j] = torch.clamp(rates[torch.arange(m), j] + 1, max=12)
    codes = (torch.rand(m, n, d, generator=g) * (2.0 ** rates[:, None, :])).long()
    words = TS.pack_codes(codes, rates, total_bits=R)
    cents = torch.randn(m, d, 4096, generator=g)
    proj = torch.randn(m, p, d, generator=g)
    return [t.to(dev) for t in (words, rates.int(), cents, proj, torch.ones(m, n))]


def autotune_winners(dev):
    """The plan of each ``TUNE_QGRAM`` and ``TUNE_FLEET`` shape as the paths
    resolve it (a ``qgram_packed_cuda`` call, then its ``tuned_plan``; a
    ``fleet_epilogue_plan``), with this process's sweeps and launches."""
    import torch

    from repro_torch.kernels import runtime
    from repro_torch.kernels.epilogue.ops import fleet_epilogue_plan
    from repro_torch.kernels.qgram.ops import qgram_packed_cuda, tuned_plan

    wins = []
    for _, m, n, p, d, R in TUNE_QGRAM:
        ops = _tune_operands(dev, m, n, p, d, R, seed=m + n + p)
        qgram_packed_cuda(*ops[:4], total_bits=R, mask=ops[4])
        wins.append(list(tuned_plan(*ops[:4], total_bits=R, mask=ops[4])))
    for _, T, m, t, K in TUNE_FLEET:
        wins.append(list(fleet_epilogue_plan(T, m, t, K, fuse="kl", device=dev)))
    torch.cuda.synchronize()
    return {"wins": wins, "sweeps": runtime.sweep_count(), "launches": runtime.launches()}


def autotune_child(fresh: str):
    """Phase p's second process: the winners on the parent's cache file
    (``REPRO_TUNE_CACHE``), then on the empty file ``fresh``, each with its
    sweeps and launches; one JSON line."""
    import torch

    from repro_torch.kernels import runtime

    dev = torch.device("cuda")
    warm = autotune_winners(dev)
    os.environ["REPRO_TUNE_CACHE"] = fresh
    runtime.clear_cache_memory()
    runtime.reset_launches()
    swept = runtime.sweep_count()
    cold = autotune_winners(dev)
    cold["sweeps"] -= swept
    print(json.dumps({"warm": warm, "cold": cold}), flush=True)


def autotune_phase(dev, smi, device_ms):
    """4p: the autotune cache.  At each ``TUNE_QGRAM`` / ``TUNE_FLEET``
    shape every feasible candidate on the card, held against the plain
    version (``qgram_packed`` within ``TOL`` of scale, ``epilogue_fleet``
    within ``epilogue_fleet_error_bound``) and timed (``device_ms``); the
    winner and the pure plan beside it.  Then a child process on the same
    cache file: zero sweeps, the same winners; and on an empty file, one
    sweep a key while the launch counts hold only its calls."""
    import torch

    from repro_torch.core import torch_scheme as TS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.epilogue.cases import epilogue_fleet_operands
    from repro_torch.kernels.epilogue.ops import epilogue_fleet_cuda, plan_fleet
    from repro_torch.kernels.epilogue.ref import (
        epilogue_fleet_error_bound, epilogue_moments_fleet_plain,
    )
    from repro_torch.kernels.qgram.ops import plan, qgram_packed_cuda, qgram_packed_plain
    from repro_torch.kernels.qgram.ref import decode_gathered

    print(f"[autotune] {smi}; cache {os.environ['REPRO_TUNE_CACHE']}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sweeps = runtime.sweep_count()
    parent = autotune_winners(dev)
    rows = []
    for (tag, m, n, p, d, R), win in zip(TUNE_QGRAM, parent["wins"]):
        words, rates, cents, proj, mask = _tune_operands(dev, m, n, p, d, R, seed=m + n + p)
        want = qgram_packed_plain(words, rates, cents, proj, total_bits=R, mask=mask)
        xhat = decode_gathered(TS.unpack_codes(words, rates, total_bits=R), cents)
        scale = max(1.0, float((xhat.abs() @ proj.abs().transpose(-1, -2)).max()))
        times = {}
        for (v,) in runtime.tune_candidates("qgram_packed"):
            try:
                pl = plan(m, n, p, d, words.shape[-1], cents.shape[-1], sms, variant=v)
            except ValueError:
                continue
            run = lambda pl=pl: qgram_packed_cuda(words, rates, cents, proj, total_bits=R,
                                                  mask=mask, plan=pl)
            err = float((run() - want).abs().max())
            check(err <= TOL * scale, f"autotune qgram_packed {tag} {v}: error {err:.3e} "
                  f"above {TOL * scale:.3e}")
            times[f"{v}/{pl.walk}"] = device_ms(run, 5 if n * p > 100_000 else 100)
        pure = plan(m, n, p, d, words.shape[-1], cents.shape[-1], sms)
        rows.append(("qgram_packed", tag, times, f"{win[0]}/{win[1]}",
                     f"{pure.variant}/{pure.walk}"))
    for (tag, T, m, t, K), win in zip(TUNE_FLEET, parent["wins"][len(TUNE_QGRAM):]):
        ops = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, device=dev)
        want = epilogue_moments_fleet_plain(*ops, fuse="kl")
        bound = epilogue_fleet_error_bound(*ops, fuse="kl")
        times = {}
        for tile in runtime.tune_candidates("epilogue_fleet"):
            try:
                pl = plan_fleet(T, m, t, K, sms, tile=tile)
            except ValueError:
                continue
            run = lambda pl=pl: epilogue_fleet_cuda(*ops, fuse="kl", plan=pl)
            got = run()
            worst = float(((got - want).abs() / bound).max())
            check(bool(torch.isfinite(got).all()) and worst <= 1.0,
                  f"autotune epilogue_fleet {tag} {tile}: worst err/bound {worst:.3e}")
            times[f"{pl.variant}/{pl.tt}/{pl.groups}"] = device_ms(run, 100)
        pure = plan_fleet(T, m, t, K, sms)
        rows.append(("epilogue_fleet", tag, times, "/".join(map(str, win)),
                     f"{pure.variant}/{pure.tt}/{pure.groups}"))
    for family, tag, times, win, pure in rows:
        check(win in times and pure in times,
              f"autotune {family} {tag}: winner {win} / plan {pure} not among {list(times)}")
        print(f"[autotune] {family:14s} {tag:32s} "
              + "  ".join(f"{c} {ms:.4f}" for c, ms in times.items())
              + f" ms; winner {win} {times[win]:.4f} ms, pure plan {pure} {times[pure]:.4f} ms "
              f"({times[win] / times[pure]:.3f}x)", flush=True)
    print(f"[autotune] this process: {runtime.sweep_count()} sweeps in all, "
          f"{runtime.sweep_count() - sweeps} in this phase", flush=True)
    # a second process: the same file (warm), then an empty one (cold)
    fresh = ROOT / "build" / "chip_smoke_autotune_cold.json"
    fresh.unlink(missing_ok=True)
    code = (f"import sys\nsys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            f"import chip_smoke\nchip_smoke.autotune_child({str(fresh)!r})\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, f"autotune child exited {r.returncode}: {r.stderr[-3000:]}")
    child = json.loads(r.stdout.strip().splitlines()[-1])
    warm, cold = child["warm"], child["cold"]
    keys = len(TUNE_QGRAM) + len(TUNE_FLEET)
    print(f"[autotune] child ({time.perf_counter() - t0:.1f} s): on this run's file "
          f"{warm['sweeps']} sweeps, winners {'the same' if warm['wins'] == parent['wins'] else warm['wins']}; "
          f"on an empty file {cold['sweeps']} sweeps for {keys} keys, launches "
          f"qgram_packed {cold['launches']['qgram_packed']} epilogue_fleet "
          f"{cold['launches']['epilogue_fleet']}, winners {cold['wins']}", flush=True)
    check(warm["sweeps"] == 0 and warm["wins"] == parent["wins"],
          f"autotune: the warm child swept {warm['sweeps']} times, winners {warm['wins']} "
          f"against {parent['wins']}")
    check(cold["sweeps"] == keys, f"autotune: the cold child swept {cold['sweeps']} times "
          f"for {keys} keys")
    for got in (warm, cold):
        check(got["launches"]["qgram_packed"] == len(TUNE_QGRAM)
              and got["launches"]["epilogue_fleet"] == 0,
              f"autotune: the child's launches {got['launches']} count its sweeps")
    fresh.unlink(missing_ok=True)


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    # a fresh autotune cache under the ignored build/: every run sweeps cold
    # and reads nothing of an earlier run's (its child processes inherit it)
    tune_cache = ROOT / "build" / "chip_smoke_autotune.json"
    tune_cache.parent.mkdir(exist_ok=True)
    tune_cache.unlink(missing_ok=True)
    os.environ["REPRO_TUNE_CACHE"] = str(tune_cache)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from repro_torch.comm.accounting import row_bits
    from repro_torch.core import DGPConfig, DistributedGP
    from repro_torch.core import torch_scheme as TS
    from repro_torch.core.fleet import artifact_nbytes
    from repro_torch.core.gp import kernel_from_inner, prior_diag
    from repro_torch.core.protocols.base import pad_parts, split_machines
    from repro_torch.core.protocols.broadcast import (
        _epilogue_projector, _expert_cross_gram, _fused_epilogue_operands,
    )
    from repro_torch.core.registry import FUSIONS
    from repro_torch.data.synthetic import regression_dataset
    from repro_torch.kernels import build, runtime
    from repro_torch.kernels.gram.ops import TILES as GRAM_TILES
    from repro_torch.kernels.gram.ops import gram, gram_cuda, gram_plain
    from repro_torch.kernels.gram.ops import plan as gram_plan
    from repro_torch.kernels.gram.ops import residency as gram_residency
    from repro_torch.kernels.qgram.ops import (
        qgram_batched, qgram_cuda, qgram_packed_batched, qgram_packed_cuda,
        qgram_packed_plain, qgram_plain,
    )
    from repro_torch.kernels.qgram.ops import plan as qgram_plan
    from repro_torch.kernels.qgram.ops import tuned_plan as qgram_tuned_plan
    from repro_torch.kernels.qgram.ref import decode_gathered
    from repro_torch.kernels.quant.cases import (
        ENCODE_TABLE_KINDS, encode_operands, qgram_operands, quant_operands,
    )
    from repro_torch.kernels.quant.ops import (
        build_scaled_tables, decode, decode_cuda, decode_plain, decode_plan, encode,
        encode_cuda, encode_plain,
    )
    from repro_torch.kernels.decode_attn.cases import decode_attn_operands
    from repro_torch.kernels.decode_attn.ops import decode_attn_cuda, decode_attn_plain
    from repro_torch.kernels.decode_attn.ops import plan as attn_plan
    from repro_torch.kernels.epilogue.cases import epilogue_fleet_operands, epilogue_operands
    from repro_torch.kernels.epilogue.ops import (
        epilogue_cuda, epilogue_fleet_cuda, epilogue_moments, fleet_epilogue_plan, plan,
        plan_fleet,
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
    results = {name: [] for name in ("gram", "qgram_packed", "epilogue", "epilogue_fleet",
                                     "quant_encode", "quant_decode", "qgram", "decode_attn")}

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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_str = lambda pl: f"{pl.tile}/{pl.splits}"  # tile configuration / splits of K
    one = torch.zeros(1, device=dev)
    launch_floor = device_ms(lambda: one.add_(1.0), 200)
    print(f"[time] launch floor {launch_floor:.4f} ms (a one-element in-place add, timed as "
          "the kernels are)", flush=True)

    def gram_case(tag, n, p, d, reps, timed=True, backward=True, same_bits=False):
        x = torch.randn(n, d, generator=gen).to(dev)
        y = torch.randn(p, d, generator=gen).to(dev)
        scale = float((x.abs() @ y.abs().T).max())
        got = gram_cuda(x, y)
        err = compare("gram", tag, got, gram_plain(x, y), scale)
        row = {"tag": tag, "err": err}
        fwd_plan = gram_plan(n, p, d, sms)
        if same_bits:
            check(torch.equal(got, gram_cuda(x, y)), f"gram {tag}: two launches differ")
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
            bwd_plans = gram_plan(n, d, p, sms), gram_plan(p, d, n, sms)  # dX = g Y, dY = g^T X
            if same_bits:
                xr2, yr2 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
                gram(xr2, yr2).backward(g)
                check(torch.equal(xr.grad, xr2.grad) and torch.equal(yr.grad, yr2.grad),
                      f"gram {tag}: two backward launches differ")
        if same_bits:
            print(f"[kernel] gram          {tag:44s} two launches give the same bits: forward "
                  f"({plan_str(fwd_plan)})" + (f", backward dX ({plan_str(bwd_plans[0])}) and dY "
                                              f"({plan_str(bwd_plans[1])})" if backward else ""),
                  flush=True)
        if timed:
            row["ms"] = device_ms(lambda: gram_cuda(x, y), reps)
            row["plain_ms"] = device_ms(lambda: gram_plain(x, y), reps)
            row["library_ms"] = device_ms(lambda: torch.matmul(x, y.T), reps)
            row["bound_ms"], row["bound_by"] = bound(4 * (n * d + p * d + n * p),
                                                     2 * n * p * d)
            row["plan"] = plan_str(fwd_plan)
            msg = (f"[time]   gram          {tag:44s} plan {row['plan']}  kernel {row['ms']:.4f} ms  "
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
                msg += (f"  | bwd plans dX {plan_str(bwd_plans[0])} dY {plan_str(bwd_plans[1])}  "
                        f"kernel {row['bwd_ms']:.4f} ms  torch.matmul "
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

    def qgram_case(tag, m, n, d, p, R, reps, timed=True, variant=None, **kw):
        words, rates, cents, proj, mask = packed_inputs(m, n, d, p, R, **kw)
        pl = qgram_plan(m, n, p, d, words.shape[-1], cents.shape[-1], sms)
        check(variant is None or pl.variant == variant,
              f"qgram_packed {tag}: plan {pl}, not the {variant} variant")
        # the plan's variant checked; the tuned plan, the paths' call, timed
        got = qgram_packed_cuda(words, rates, cents, proj, total_bits=R, mask=mask, plan=pl)
        again = qgram_packed_cuda(words, rates, cents, proj, total_bits=R, mask=mask, plan=pl)
        want = qgram_packed_plain(words, rates, cents, proj, total_bits=R, mask=mask)
        codes = TS.unpack_codes(words, rates, total_bits=R)
        xhat = decode_gathered(codes, cents) * mask[..., None]
        scale = float((xhat.abs() @ proj.abs().transpose(-1, -2)).max())
        row = {"tag": tag, "err": compare("qgram_packed", tag, got, want, scale),
               "plan": f"{pl.variant}/{pl.walk}"}
        check(torch.equal(got, again), f"qgram_packed {tag}: two launches differ")
        print(f"[kernel] qgram_packed  {tag:44s} plan {row['plan']} (variant/walk): two "
              "launches give the same bits", flush=True)
        if timed:
            tuned = qgram_tuned_plan(words, rates, cents, proj, total_bits=R, mask=mask)
            row["tuned"] = f"{tuned.variant}/{tuned.walk}"
            row["err"] = max(row["err"], compare(
                "qgram_packed", f"{tag} tuned {row['tuned']}", qgram_packed_cuda(
                    words, rates, cents, proj, total_bits=R, mask=mask), want, scale))
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
            print(f"[time]   qgram_packed  {tag:44s} tuned {row['tuned']}  kernel {row['ms']:.4f} ms  "
                  f"plain {row['plain_ms']:.4f} ms  torch.matmul(x̂, proj) "
                  f"{row['matmul_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                  f"({row['bound_by']})", flush=True)
        results["qgram_packed"].append(row)
        return row

    # the tile configurations' residency that gram.plan assumes, against the card's
    held = {tile: gram_residency(tile) for tile in GRAM_TILES}
    print(f"[kernel] gram          blocks an SM holds, by tile: {held} (gram.TILES assumes "
          f"{ {t: v[3] for t, v in GRAM_TILES.items()} })", flush=True)
    check(all(held[t] == GRAM_TILES[t][3] for t in GRAM_TILES),
          "gram: the card's residency differs from gram.TILES")
    main_gram = gram_case("serve: X* (128x21) . Xc (25x21)", 128, 25, 21, 200)
    gram_case("fit: Xc (25x21) . Xc (25x21)", 25, 25, 21, 200)
    # the serving CLI's requests (phase 4k: n = 2000 over 40 machines)
    gram_case("serve_gp center: X* (128x21) . Xc (50x21)", 128, 50, 21, 50, backward=False)
    gram_case("serve_gp broadcast, poe: X* . 40 x 50 rows", 128, 2000, 21, 50, backward=False)
    gram_case("center direct fit: Xc (25x21) . X_recon (1000x21)", 25, 1000, 21, 50,
              backward=False, same_bits=True)
    gram_case("larger: 4449 queries . 40000 rows, d=21", 4449, 40000, 21, 3, same_bits=True)
    gram_case("ragged: 130x70, d=50", 130, 70, 50, 50, timed=False)
    gram_case("ragged: 1x1, d=1", 1, 1, 1, 50, timed=False)
    gram_case("ragged long K: 130x21, K=20000 (split)", 130, 21, 20000, 50, timed=False,
              same_bits=True)
    check(gram_plan(130, 21, 20000, sms).splits > 1, "gram: the long-K case did not split")
    main_qgram = qgram_case("fit: 39 machines x 25 rows, p=25, R=24 (W=1)",
                            39, 25, 21, 25, 24, 200, variant="small")
    qgram_case("broadcast fit: 40 x 25 rows, p=1000, R=24", 40, 25, 21, 1000, 24, 50,
               variant="flat")
    qgram_case("larger: 40 x 1000 rows, p=4449, R=24", 40, 1000, 21, 4449, 24, 3,
               variant="wide")
    # the gram modes' call sites: center direct's fit (Y = X_recon) and
    # request, broadcast direct's decoded products D and request E (R = 40)
    qgram_case("center direct fit: 39 x 25 rows, p=1000, R=16", 39, 25, 21, 1000, 16, 50,
               variant="flat")
    qgram_case("center direct request: 39 x 25 rows, p=128", 39, 25, 21, 128, 16, 50,
               variant="small")
    qgram_case("broadcast direct D: 40 x 25 x 1000, R=40", 40, 25, 21, 1000, 40, 50,
               variant="flat")
    qgram_case("broadcast direct E: 40 x 25 x 128, R=40", 40, 25, 21, 128, 40, 50,
               variant="small")
    qgram_case("R=100 (W=4, straddling codes)", 39, 25, 21, 25, 100, 50)
    # each plan variant's tile whole and one row or column past it
    for tag, m_, n_, p_, d_, R_, cap_, variant in (
        ("small tile whole: 2 x 32 x 32", 2, 32, 32, 21, 24, 12, "small"),
        ("small tile + 1: 2 x 33 x 33", 2, 33, 33, 21, 24, 12, "small"),
        ("flat tile whole: 300 x 32 x 64", 300, 32, 64, 21, 24, 12, "flat"),
        ("flat tile + 1 column: 300 x 32 x 65", 300, 32, 65, 21, 24, 12, "flat"),
        ("wide tile whole: 200 x 64 x 128", 200, 64, 128, 21, 24, 12, "wide"),
        ("wide tile + 1: 200 x 65 x 129", 200, 65, 129, 21, 24, 12, "wide"),
        ("long tile whole: 2 x 1024 x 1024, d=64, C=256", 2, 1024, 1024, 64, 100, 8, "long"),
        ("long tile + 1: 2 x 1025 x 1025, d=40, C=256", 2, 1025, 1025, 40, 100, 8, "long"),
    ):
        qgram_case(tag, m_, n_, d_, p_, R_, 0, timed=False, variant=variant, cap=cap_)
    qgram_case("wide: p=1001 odd, W=4, width-0 dims, masked", 3, 200, 21, 1001, 100, 0,
               timed=False, variant="wide", zero_dims=(0, 5, 20), mask_frac=0.3)
    qgram_case("width-0 dims + masked rows, R=24", 3, 70, 21, 45, 24, 50,
               timed=False, zero_dims=(0, 5, 20), mask_frac=0.3)
    qgram_case("ragged tiles n=37 p=11 d=8, R=100, masked", 2, 37, 8, 11, 100, 50,
               timed=False, zero_dims=(7,), mask_frac=0.2)
    qgram_case("R=7, width-0 dim", 4, 33, 21, 17, 7, 50, timed=False, zero_dims=(2,))

    def epi_bound(T, m, t, K, pl):
        """Each operand read once, the rows written once; the products' 4 K^2
        flops a point and expert at the rate of the path the plan takes (the
        mma variant's 3xTF32: three TF32 products each on the tensor cores),
        the rest's 4 K + 6 in fp32."""
        nbytes = 4 * T * (m * t * K + 2 * m * K * K + m * K + 2 * t + m + 3 * t)
        prod, rest = T * m * t * 4 * K * K, T * m * t * (4 * K + 6)
        rate = TF32_FLOPS / 3 if pl.variant == "mma" else FP32_FLOPS
        t_b, t_f = nbytes / HBM_BYTES * 1e3, (prod / rate + rest / FP32_FLOPS) * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    def epilogue_case(tag, m, t, K, fuses, reps, timed=True, **kw):
        ops = epilogue_operands(m, t, K, seed=m + t + K, device=dev, **kw)
        pl = plan(m, t, K, sms)
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
                  f"worst err/bound {worst:.3e}  plan {pl.variant}/{pl.tt}/{pl.groups}",
                  flush=True)
            check(bool(torch.isfinite(got).all()), f"epilogue {tag} {fuse}: non-finite output")
            check(torch.equal(got, again), f"epilogue {tag} {fuse}: two launches differ")
            check(worst <= 1.0, f"epilogue {tag} {fuse}: error above epilogue_error_bound")
            row = {"tag": f"{tag} {fuse}", "err": err}
            if timed:
                row["ms"] = device_ms(lambda: epilogue_cuda(*ops, fuse=fuse), reps)
                row["plain_ms"] = device_ms(lambda: epilogue_moments_plain(*ops, fuse=fuse),
                                            reps)
                row["library_ms"] = None  # no single PyTorch call computes it
                row["bound_ms"], row["bound_by"] = epi_bound(1, m, t, K, pl)
                print(f"[time]   epilogue      {tag + ' ' + fuse:44s} kernel {row['ms']:.4f} ms  "
                      f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                      f"({row['bound_by']}, {pl.variant} path)", flush=True)
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
    epilogue_case("serve_gp: m=40 t=128 K=50", 40, 128, 50, ("kl", "rbcm"), 50)
    epilogue_case("serve_gp degraded: m=40 t=128 K=50, lost 1", 40, 128, 50, ("kl",), 50,
                  lost=(1,))
    # the variants' and tiles' edges: the small variant's largest K and one
    # past it, a point tile of each path whole and one point past it
    for tag, m_, t_, K_, kind in (
        ("small-K limit: m=40 t=32 K=32", 40, 32, 32, "serve_cache"),
        ("one past it (mma): m=40 t=32 K=33", 40, 32, 33, "serve_cache"),
        ("one past a small tile: m=40 t=33 K=25", 40, 33, 25, "serve_cache"),
        ("mma 128-point tiles whole: m=40 t=2048 K=25", 40, 2048, 25, "serve_cache"),
        ("one past: m=40 t=2049 K=25", 40, 2049, 25, "serve_cache"),
        ("large-K tiles whole: m=5 t=64 K=300", 5, 64, 300, "generic"),
        ("one past: m=5 t=65 K=300", 5, 65, 300, "generic"),
    ):
        epilogue_case(tag, m_, t_, K_, ("kl", "rbcm"), 0, timed=False, kind=kind)
    check(plan(40, 32, 32).variant == "small" and plan(40, 32, 33).variant == "mma"
          and plan(40, 2048, 25) == ("mma", 128, plan(40, 2048, 25).groups),
          "epilogue: the boundary cases did not take the variants they test")
    # a broadcast request is one kernel launch: the profiler's device events
    epi_ops = epilogue_operands(40, 128, 25, seed=193, device=dev)
    epilogue_cuda(*epi_ops, fuse="kl")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        epilogue_cuda(*epi_ops, fuse="kl")
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[kernel] epilogue      request shape: {len(on_card)} device activity in one call: "
          f"{[n[:60] for n in on_card]}", flush=True)
    check(len(on_card) == 1, f"epilogue: a request-shape call ran {len(on_card)} device "
          "activities, not one kernel launch")

    def fleet_case(tag, T, m, t, K, fuses, reps, **kw):
        ops = epilogue_fleet_operands(T, m, t, K, seed=T + m + t + K, device=dev, **kw)
        pl = plan_fleet(T, m, t, K, sms)
        same_plan = pl == plan(m, t, K, sms)
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
            # the tuned plan, as a FleetStack resolves it, within the bound and timed
            tuned = fleet_epilogue_plan(T, m, t, K, fuse=fuse, device=dev)
            worst_tuned = float(((epilogue_fleet_cuda(*ops, fuse=fuse, plan=tuned) - want).abs()
                                 / tol_rows).max())
            check(worst_tuned <= 1.0, f"epilogue_fleet {tag} {fuse}: tuned plan {tuned} above "
                  "the per-tenant bound")
            row = {"tag": f"{tag} {fuse}", "err": err}
            row["ms"] = device_ms(lambda: epilogue_fleet_cuda(*ops, fuse=fuse, plan=tuned), reps)
            row["plain_ms"] = device_ms(lambda: epilogue_moments_fleet_plain(*ops, fuse=fuse),
                                        reps)
            row["library_ms"] = None  # no single PyTorch call computes it
            row["bound_ms"], row["bound_by"] = epi_bound(T, m, t, K, tuned)
            print(f"[time]   epilogue_fleet {tag + ' ' + fuse:43s} kernel {row['ms']:.4f} ms  "
                  f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.7f} ms "
                  f"({row['bound_by']}; tuned {tuned.variant}/{tuned.tt}/{tuned.groups}, "
                  f"plan_fleet {pl.variant}/{pl.tt}/{pl.groups}; tuned worst err/bound "
                  f"{worst_tuned:.3e})", flush=True)
            results["epilogue_fleet"].append(row)
            rows.append(row)
        return rows

    main_fleet = fleet_case("flush: T=16 m=40 t=16 K=25", 16, 40, 16, 25, EPILOGUE_FUSES, 200)
    fleet_case("ragged + w zeros + floors: T=5 m=5 t=37 K=19", 5, 5, 37, 19, EPILOGUE_FUSES,
               50, floored=(0, 36), lost=(1,))
    fleet_case("serve-sized: T=8 m=40 t=128 K=25", 8, 40, 128, 25, ("kl", "rbcm"), 50)
    fleet_case("serve_gp flush: T=4 m=40 t=128 K=50", 4, 40, 128, 50, ("kl",), 50)

    # the quantizer kernels: bitwise against their plain versions
    def encode_bound(x, edges):
        """x, the codes and the finite edges once; a binary search's
        comparisons per symbol over its row's finite edges."""
        n, d = x.shape
        live = torch.isfinite(edges).sum(1).double()
        return bound(4 * (2 * n * d + int(live.sum())),
                     n * float(torch.ceil(torch.log2(live + 1)).sum()))

    def looked_up(codes, C):
        """Distinct table entries that in-range codes look up, over (..., n, d)."""
        d = codes.shape[-1]
        inside = (codes >= 0) & (codes < C)
        lead = torch.arange(codes.numel() // (codes.shape[-2] * d), device=codes.device)
        lead = lead.reshape(codes.shape[:-2] + (1, 1)) if codes.dim() > 2 else 0
        j = torch.arange(d, device=codes.device)
        key = ((lead * d + j) * C + codes.long())[inside]
        return int(torch.unique(key).numel()), inside

    def decode_plan_str(n, d, C):
        pl = decode_plan(n, d, C, sms)
        return pl.variant + (f" {pl.bn}x{pl.bd}" if pl.bn else "")

    def time_quant(tag, x, edges, codes, cents, reps):
        enc = {"ms": device_ms(lambda: encode_cuda(x, edges), reps),
               "plain_ms": device_ms(lambda: encode_plain(x, edges), reps),
               "library_ms": device_ms(lambda: torch.searchsorted(edges, x.T.contiguous()),
                                       reps)}
        enc["bound_ms"], enc["bound_by"] = encode_bound(x, edges)
        same = torch.equal(torch.searchsorted(edges, x.T.contiguous()).T.int(), codes)
        codes64 = codes.long()
        dec = {"ms": device_ms(lambda: decode_cuda(codes, cents), reps),
               "plain_ms": device_ms(lambda: decode_plain(codes, cents), reps),
               "library_ms": device_ms(lambda: torch.gather(cents, 1, codes64.T), reps)}
        n, d = codes.shape
        dec["bound_ms"], dec["bound_by"] = bound(
            4 * (2 * n * d + looked_up(codes, cents.shape[1])[0]), 0)
        dec["plan"] = decode_plan_str(n, d, cents.shape[1])
        for name, r, lib in (("quant_encode", enc, "torch.searchsorted"),
                             ("quant_decode", dec, "torch.gather")):
            print(f"[time]   {name:13s} {tag:44s} kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  {lib} {r['library_ms']:.4f} ms  bound "
                  f"{r['bound_ms']:.7f} ms ({r['bound_by']})"
                  + (f"  plan {r['plan']}" if "plan" in r else ""), flush=True)
        print(f"[time]   quant_encode  {tag:44s} torch.searchsorted gives the same codes: "
              f"{same}", flush=True)
        return enc, dec

    def quant_case(tag, n, d, bits, max_bits, reps=0, **kw):
        x, edges, cents, _ = quant_operands(n, d, bits, max_bits=max_bits, seed=n + d,
                                            device=dev, **kw)
        codes, again = encode_cuda(x, edges), encode_cuda(x, edges)
        want = encode_plain(x, edges)
        probe = codes.clone()  # and the -1 sentinel and codes past the table
        probe[0] = -1
        probe[-1] = cents.shape[1] + 3
        probe[n // 2, d // 2] = 2**31 - 1
        xhat, xhat2 = decode_cuda(probe, cents), decode_cuda(probe, cents)
        want_x = decode_plain(probe, cents)
        torch.cuda.synchronize()
        e_err = float((codes.long() - want.long()).abs().max())
        d_err = float((xhat - want_x).abs().max())
        print(f"[kernel] quant_encode  {tag:44s} bitwise {torch.equal(codes, want)}  "
              f"| quant_decode bitwise {torch.equal(xhat, want_x)} (incl. -1 and >= C; plan "
              f"{decode_plan_str(n, d, cents.shape[1])})", flush=True)
        check(torch.equal(codes, want), f"quant_encode {tag}: codes differ from the plain version")
        check(torch.equal(codes, again), f"quant_encode {tag}: two launches differ")
        check(torch.equal(xhat, want_x) and torch.equal(xhat, xhat2),
              f"quant_decode {tag}: differs from the plain version or between launches")
        check(not bool(xhat[0].any()) and not bool(xhat[-1].any())
              and not bool(xhat[n // 2, d // 2]),
              f"quant_decode {tag}: a code outside the table did not decode to 0")
        rows = {"tag": tag, "err": e_err}, {"tag": tag, "err": d_err}
        if reps:
            enc, dec = time_quant(tag, x, edges, codes, cents, reps)
            rows[0].update(enc)
            rows[1].update(dec)
        results["quant_encode"].append(rows[0])
        results["quant_decode"].append(rows[1])

    quant_case("bench: n=1024 d=128, 4d bits, max 8", 1024, 128, 512, 8, reps=200)
    quant_case("wide: n=25 d=21, R=48, max 12, a 4096-edge row", 25, 21, 48, 12, reps=200,
               dominant=True)
    quant_case("ragged n=37 d=13: NaN/+-inf/on-edge, rate-0", 37, 13, 30, 12,
               zero_dims=(2, 7), specials=True)
    quant_case("bits=0: n=9 d=5, E=128 of +inf", 9, 5, 0, 8, specials=True)
    quant_case("bench: n=1024 d=128, a 4096-edge row", 1024, 128, 512, 12, reps=200,
               dominant=True)
    # quant_decode at each plan's edges (flat up to 8192 symbols or d < 32;
    # 32-row tiles; 64-row tiles from 16 blocks an SM), through a storage-
    # offset view, a view 4 bytes past a 16-byte boundary (the scalar path)
    # and a table of NaN, +-inf and -0.0: bit for bit, the same bits twice
    def decode_case(tag, n, d, C, view=None, specials=False):
        """Random codes over [-2, C + 2) with -1 and INT32_MAX planted."""
        g = torch.Generator(device=dev).manual_seed(n + d + C)
        cents = torch.randn(d, C, device=dev, generator=g)
        if specials:
            cents[:, :4] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0],
                                        device=dev)
        rows = n + (view == "codes[1:]")
        codes = torch.randint(-2, C + 2, (rows, d), device=dev, generator=g,
                              dtype=torch.int32)
        if specials:
            codes = codes % 6
        codes.view(-1)[::7] = -1
        codes.view(-1)[3::11] = 2**31 - 1
        if view == "codes[1:]":
            codes = codes[1:]
        elif view == "codes+4B":
            buf = torch.empty(n * d + 1, dtype=torch.int32, device=dev)
            buf[1:] = codes.view(-1)
            codes = buf[1:].view(n, d)
        elif view == "cents+4B":
            buf = torch.empty(d * C + 1, device=dev)
            buf[1:] = cents.view(-1)
            cents = buf[1:].view(d, C)
        got, again = decode_cuda(codes, cents), decode_cuda(codes, cents)
        want = decode_plain(codes, cents)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        twice = torch.equal(got.view(torch.int32), again.view(torch.int32))
        plan_s = decode_plan_str(n, d, C)
        print(f"[kernel] quant_decode  {tag:44s} bitwise {same}  same bits twice {twice}  "
              f"plan {plan_s}", flush=True)
        check(same and twice, f"quant_decode {tag}: differs from the plain version or "
                              "between launches")
        results["quant_decode"].append({"tag": tag, "err": 0.0})

    def decode_timed(tag, n, d, bits, max_bits, reps, **kw):
        """The seeded bench operands' codes (an encode's: in range, as
        torch.gather needs them) timed; bitwise with -1 and >= C planted."""
        x, edges, cents, _ = quant_operands(n, d, bits, max_bits=max_bits, seed=n + d,
                                            device=dev, **kw)
        codes = encode_cuda(x, edges)
        C = cents.shape[1]
        probe = codes.clone()
        probe[0, 0], probe[-1, -1], probe[n // 2, d // 2] = -1, C, 2**31 - 1
        same = torch.equal(decode_cuda(probe, cents), decode_plain(probe, cents))
        check(same, f"quant_decode {tag}: differs from the plain version")
        inside = (codes >= 0) & (codes < C)
        looked = int(torch.unique((torch.arange(d, device=dev) * C + codes.long())[inside])
                     .numel())
        codes64 = codes.long().T.contiguous()
        row = {"tag": tag, "err": 0.0,
               "ms": device_ms(lambda: decode_cuda(codes, cents), reps),
               "plain_ms": device_ms(lambda: decode_plain(codes, cents), reps),
               "library_ms": device_ms(lambda: torch.gather(cents, 1, codes64), reps)}
        row["bound_ms"], row["bound_by"] = bound(4 * (2 * n * d + looked), 0)
        print(f"[time]   quant_decode  {tag + f' (C = {C})':44s} kernel {row['ms']:.4f} ms  "
              f"plain {row['plain_ms']:.4f} ms  torch.gather {row['library_ms']:.4f} ms  bound "
              f"{row['bound_ms']:.7f} ms ({row['bound_by']})  plan "
              f"{decode_plan_str(n, d, C)}  bitwise {same}", flush=True)
        results["quant_decode"].append(row)

    decode_timed("large: n=65536 d=128, 4d bits, max 8", 65536, 128, 512, 8, 50)
    decode_timed("bench: n=1024 d=128, a 256-entry row", 1024, 128, 512, 8, 200,
                 dominant=True)
    decode_case("flat's largest: n=64 d=128 C=256", 64, 128, 256)
    decode_case("tile's smallest: n=65 d=128 C=256", 65, 128, 256)
    decode_case("64-row tile, ragged: n=33761 d=33 C=4096", 33761, 33, 4096)
    decode_case("d=1 n=300 C=256", 300, 1, 256)
    decode_case("codes[1:]: n=301 d=129 C=256", 301, 129, 256, view="codes[1:]")
    decode_case("codes 4 B past 16: n=1024 d=128 C=256", 1024, 128, 256, view="codes+4B")
    decode_case("table 4 B past 16: n=1024 d=128 C=256", 1024, 128, 256, view="cents+4B")
    decode_case("NaN/+-inf/-0.0 table: n=1024 d=128 C=256", 1024, 128, 256, specials=True)
    decode_case("NaN/+-inf/-0.0 table: n=25 d=21 C=4096", 25, 21, 4096, specials=True)

    # tables the binary search may not take (a decreasing row, a NaN edge)
    # and ones it must count right (duplicates, -0.0 beside +0.0, +-inf),
    # at E = 128 and 4096 with n = 1024: bitwise, the same bits twice
    for kind in ENCODE_TABLE_KINDS:
        for n_, d_, E_ in ((37, 13, 128), (1024, 8, 4096)):
            x_, e_ = encode_operands(n_, d_, E_, kind, seed=n_ + E_, device=dev)
            got_, again_ = encode_cuda(x_, e_), encode_cuda(x_, e_)
            same_ = torch.equal(got_, encode_plain(x_, e_))
            print(f"[kernel] quant_encode  {kind + f' table: n={n_} d={d_} E={E_}':44s} "
                  f"bitwise {same_}  same bits twice {torch.equal(got_, again_)}", flush=True)
            check(same_ and torch.equal(got_, again_),
                  f"quant_encode {kind} n={n_} E={E_}: differs from the plain version or "
                  "between launches")
            results["quant_encode"].append({"tag": f"{kind} E={E_}", "err": 0.0})

    # the unpacked qgram: within TOL x max(|X̂| |y|^T), as gram
    def qgram_bound(codes, cents, y):
        """The codes, the looked-up centroids, y and the output once; the
        FMAs of the rows that hold a code in the table."""
        m, n, d = codes.shape
        looked, inside = looked_up(codes, cents.shape[-1])
        rows = int(inside.any(-1).sum())
        return bound(4 * (codes.numel() + looked + y.numel() + m * n * y.shape[-2]),
                     2 * rows * y.shape[-2] * d)

    def time_qgram(tag, codes, cents, y, xhat, reps):
        row = {"ms": device_ms(lambda: qgram_cuda(codes, cents, y), reps),
               "plain_ms": device_ms(lambda: qgram_plain(codes, cents, y), reps),
               "matmul_ms": device_ms(lambda: torch.matmul(xhat, y.transpose(-1, -2)), reps),
               "library_ms": None}  # no single PyTorch call decodes and multiplies
        row["bound_ms"], row["bound_by"] = qgram_bound(codes, cents, y)
        print(f"[time]   qgram         {tag:44s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  torch.matmul(x̂, y) {row['matmul_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.7f} ms ({row['bound_by']})  library: none (no single "
              "PyTorch call decodes codes and multiplies)", flush=True)
        return row

    def unpacked_case(tag, m, n, d, p, bits, max_bits, pad_rows, shared_y, reps=0,
                      variant=None):
        codes, cents, y = qgram_operands(m, n, d, p, bits, max_bits=max_bits, seed=m + n + p,
                                         pad_rows=pad_rows, shared_y=shared_y, device=dev)
        pl = qgram_plan(m, n + pad_rows, p, d, None, cents.shape[-1], sms)
        check(variant is None or pl.variant == variant,
              f"qgram {tag}: plan {pl}, not the {variant} variant")
        got, again = qgram_cuda(codes, cents, y), qgram_cuda(codes, cents, y)
        want = qgram_plain(codes, cents, y)
        xhat = decode_gathered(codes, cents)
        scale = float((xhat.abs() @ y.abs().transpose(-1, -2)).max())
        row = {"tag": tag, "err": compare("qgram", tag, got, want, scale)}
        check(torch.equal(got, again), f"qgram {tag}: two launches differ")
        check(not bool(got[:, n:].any()), f"qgram {tag}: a -1 row did not give a zero row")
        print(f"[kernel] qgram         {tag:44s} plan {pl.variant}/{pl.walk} (variant/walk): "
              "two launches give the same bits", flush=True)
        if reps:
            row.update(time_qgram(tag, codes, cents, y, xhat, reps))
        results["qgram"].append(row)

    unpacked_case("bench: n=1024 d=128 p=1024, 4d bits", 1, 1024, 128, 1024, 512, 8, 0,
                  True, reps=50, variant="long")
    unpacked_case("ragged batched: 3 x (37+5 rows of -1), d=13 p=70", 3, 37, 13, 70, 30, 12,
                  5, False)
    unpacked_case("wide p: 2 x (100+3 rows of -1), d=21 p=3001", 2, 100, 21, 3001, 24, 12, 3,
                  False, variant="wide")
    unpacked_case("ragged d: 2 x (77+4), d=45 p=300, C=4096", 2, 77, 45, 300, 60, 12, 4,
                  False, variant="small")
    unpacked_case("ragged d, staged: 2 x (1000+5), d=45 p=1000", 2, 1000, 45, 1000, 90, 8, 5,
                  True, variant="long")

    # decode attention: within 1e-5 x max|V| of the plain version
    def attn_case(tag, B, S, KV, G, hd, pos, reps=0, window=None, q_dtype=torch.float32,
                  kv_dtype=torch.bfloat16, ring=False, empty=(), slot_order=False,
                  one_split_row=None, softcap=None):
        q, K, V, kpos = decode_attn_operands(B, S, KV, G, hd, pos=pos, q_dtype=q_dtype,
                                             kv_dtype=kv_dtype, ring=ring, empty_rows=empty,
                                             seed=S + hd, device=dev, slot_order=slot_order)
        pl = attn_plan(B, S, KV, G, hd, K.element_size(), sms)
        if one_split_row is not None:  # that row's valid slots: the first 40 of its first range
            kpos[one_split_row] = -1
            kpos[one_split_row, :40] = torch.arange(pos - 39, pos + 1, dtype=torch.int32,
                                                    device=dev)
            check(pl.splits > 1 and pl.slots_per_split >= 40,
                  f"decode_attn {tag}: the plan does not split S past the row's valid slots")
        valid = (kpos >= 0) & (kpos <= pos)
        if window is not None:
            valid &= kpos > pos - window
        if softcap is not None:  # scores of std ~64 at hd = 256: the cap bends most of them
            q = (q.float() * 4).to(q_dtype)
        got = decode_attn_cuda(q, K, V, kpos, pos, window=window, softcap=softcap)
        again = decode_attn_cuda(q, K, V, kpos, torch.tensor(pos, dtype=torch.int32, device=dev),
                                 window=window, softcap=softcap)
        want = decode_attn_plain(q, K, V, kpos, pos, window=window, softcap=softcap)
        torch.cuda.synchronize()
        vmax = float(V.float().abs().max())
        err, tol = float((got - want).abs().max()), 1e-5 * vmax
        no_key = [b for b in range(B) if not bool(valid[b].any())]
        print(f"[kernel] decode_attn   {tag:44s} max_abs_err {err:.3e} tol {tol:.3e} "
              f"(1e-5 max|V|)  plan {pl.path}/{pl.splits}x{pl.slots_per_split}  same bits "
              f"{torch.equal(got, again)}  rows with no valid key {no_key}", flush=True)
        check(bool(torch.isfinite(got).all()), f"decode_attn {tag}: non-finite output")
        check(err <= tol, f"decode_attn {tag}: error {err:.3e} above {tol:.3e}")
        check(torch.equal(got, again), f"decode_attn {tag}: two launches differ")
        check(set(empty) <= set(no_key), f"decode_attn {tag}: an emptied row has a valid key")
        for b in no_key:
            mean = V[b].float().mean(0)[:, None, :]
            check(float((got[b] - mean).abs().max()) <= tol,
                  f"decode_attn {tag}: a row with no valid key is not the mean of V")
        row = {"tag": tag, "err": err}
        if reps:
            qh = q.reshape(B, KV * G, 1, hd).to(K.dtype)
            kh, vh = K.permute(0, 2, 1, 3), V.permute(0, 2, 1, 3)  # views
            mask = valid[:, None, None, :]
            row["ms"] = device_ms(lambda: decode_attn_cuda(q, K, V, kpos, pos, window=window,
                                                           softcap=softcap), reps)
            row["plain_ms"] = device_ms(
                lambda: decode_attn_plain(q, K, V, kpos, pos, window=window, softcap=softcap),
                reps)
            row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=1.0, enable_gqa=True), reps)
            # the valid slots' K and V rows once (a row with none valid: V only,
            # for its mean), q, kpos and the output once; 4 flops a slot and dim
            n_valid = valid.sum(1)
            k_rows = int(n_valid.sum())
            v_rows = int(torch.where(n_valid > 0, n_valid, torch.full_like(n_valid, S)).sum())
            esz = K.element_size()
            nbytes = (q.numel() * q.element_size() + (k_rows + v_rows) * KV * hd * esz
                      + 4 * B * S + 4 * B * KV * G * hd)
            row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * k_rows * KV * G * hd)
            print(f"[time]   decode_attn   {tag:44s} kernel {row['ms']:.4f} ms  plain "
                  f"{row['plain_ms']:.4f} ms  F.scaled_dot_product_attention (q cast to "
                  f"{str(K.dtype)[6:]}{', no cap' if softcap else ''}) "
                  f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.7f} "
                  f"ms ({row['bound_by']})  {k_rows} valid slots", flush=True)
        results["decode_attn"].append(row)
        return row

    attn_case("bench: B=8 S=8192 KV=4 G=8 hd=128, K/V bf16", 8, 8192, 4, 8, 128, 8191,
              reps=20)
    attn_case("gemma2-2b local: KV=4 G=2 hd=256 w=4096 ring", 8, 8192, 4, 2, 256, 10000,
              reps=20, window=4096, ring=True)
    attn_case("ragged S=1000, f32 K/V, G=12 (two head chunks)", 2, 1000, 2, 12, 64, 900,
              kv_dtype=torch.float32)
    attn_case("no valid key in row 1, S=333, hd=40, bf16 q", 3, 333, 2, 3, 40, 300,
              q_dtype=torch.bfloat16, empty=(1,), window=100)
    attn_case("gemma2-2b local, ring in slot order", 8, 8192, 4, 2, 256, 10000, reps=20,
              window=4096, ring=True, slot_order=True)
    attn_case("bench partly filled: pos=2047 of S=8192", 8, 8192, 4, 8, 128, 2047, reps=20)
    attn_case("bench, K/V fp32 (block kernel)", 8, 8192, 4, 8, 128, 8191, reps=20,
              kv_dtype=torch.float32)
    attn_case("window 0: no valid key, the mean of V", 2, 1000, 4, 8, 128, 999, window=0)
    attn_case("window 1: one valid key", 2, 1000, 4, 8, 128, 999, window=1)
    attn_case("row 2's valid slots in one split", 4, 8192, 4, 8, 128, 8191, one_split_row=2)
    attn_case("hd=512 bf16 (block kernel), G=4", 1, 700, 2, 4, 512, 650)
    # the full-width gemma2-2b decode step (phase 4m's shapes: B = 4, q bf16,
    # softcap 50): a local ring of 4096 that has wrapped, a global cache of
    # 8192 filled to position 6003; the block kernel with the cap too
    main_attn = attn_case("gemma2-2b step: local ring S=4096 w=4096 cap 50", 4, 4096, 4, 2,
                          256, 6003, reps=20, window=4096, ring=True, slot_order=True,
                          q_dtype=torch.bfloat16, softcap=50.0)
    attn_case("gemma2-2b step: local ring S=4096 w=4096, no cap", 4, 4096, 4, 2, 256, 6003,
              reps=20, window=4096, ring=True, slot_order=True, q_dtype=torch.bfloat16)
    attn_case("gemma2-2b step: global S=8192 to pos 6003, cap 50", 4, 8192, 4, 2, 256, 6003,
              reps=20, q_dtype=torch.bfloat16, softcap=50.0)
    attn_case("cap 50, fp32 K/V (block kernel), window 300", 3, 1500, 2, 5, 64, 2000,
              window=300, ring=True, kv_dtype=torch.float32, softcap=50.0)

    # ---- 4. the paths: Fig. 6 SARCOS, fit -> save -> load -> serve --------
    X_tr, y_tr, X_te, y_te = regression_dataset("sarcos", seed=0)
    parts = split_machines(X_tr, y_tr, 40, torch.Generator().manual_seed(0))
    batches = [X_te[i:i + 128] for i in range(0, X_te.shape[0], 128)]
    check(len(batches) == 35, f"expected 35 batches, got {len(batches)}")
    y_true = torch.from_numpy(y_te)
    path_launches = {}

    def smse_of(mu):
        return float(((mu.cpu() - y_true) ** 2).mean() / y_true.var(unbiased=False))

    def run_path(name, cfg, per_request, fit_kernels, roundtrip=True, fit_once=()):
        """Fit on the card, then (optionally save and load and) serve the 35
        requests, with the launch counts read from zero.  ``per_request``:
        the kernels every request must launch exactly once; ``fit_once``:
        those the fit must launch exactly once."""
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
        for k in fit_once:
            check(fit_launches[k] == 1,
                  f"{name}: the fit launched {k} {fit_launches[k]} times, not once")
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
    center = run_path("center", cfg_c, ("gram",), ("gram", "qgram_packed"),
                      fit_once=("qgram_packed",))
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
    bcast = run_path("broadcast", cfg_b, ("gram", "epilogue"), ("gram", "qgram_packed"),
                     fit_once=("qgram_packed",))
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

    # e. the Fig. 6 wire through the quantizer kernels, on a.'s center artifact
    art_c = center["art"]
    wire = art_c.wire
    m_w, n_pad, d_w = wire.decoded.shape
    total = row_bits(cfg_c.bits_per_sample, d_w, cfg_c.max_bits)
    shards = pad_parts(parts, dev)
    lengths = shards.lengths
    # the symbols x_i = X_i T_i^T as the fit formed them (torch_scheme.encode)
    Xp = shards.X.float() @ wire.T.transpose(-1, -2)
    sent = TS.unpack_codes(wire.codes, wire.rates, total_bits=total).to(torch.int32)
    tables = [build_scaled_tables(wire.sigma[i], wire.rates[i], device=dev) for i in range(m_w)]
    xs = [Xp[i, : lengths[i]].contiguous() for i in range(m_w)]
    order = list(art_c.block_order)
    idx = order[1:]  # the machines whose rows reach the center over the wire
    n_rows = 32  # 25 rows a machine, padded to 32 with -1 rows
    Xc = art_c.data["Xc"]
    proj = torch.einsum("pd,mde->mpe", Xc, wire.T_inv[idx]).contiguous()  # _pallas_ip_rows
    cents_w = wire.scaled_cents[idx].contiguous()
    codes_q = torch.full((len(idx), n_rows, d_w), -1, dtype=torch.int32, device=dev)
    for k, i in enumerate(idx):
        codes_q[k, : lengths[i]] = sent[i, : lengths[i]]
    mask_w = (torch.arange(n_pad, device=dev)[None, :]
              < torch.tensor([lengths[i] for i in idx], device=dev)[:, None]).float()
    runtime.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = [encode(xs[i], tables[i][0]) for i in range(m_w)]
    dec = [decode(enc[i], wire.scaled_cents[i]) for i in range(m_w)]
    g_unpacked = qgram_batched(codes_q, cents_w, proj)
    g_packed = qgram_packed_batched(wire.codes[idx], wire.rates[idx], cents_w, proj,
                                    total_bits=total, mask=mask_w)
    torch.cuda.synchronize()
    wire_s = time.perf_counter() - t0
    launches = runtime.launches()
    path_launches["wire"] = launches
    print(f"[wire] {m_w} machines x {n_pad} rows, d={d_w}, R={cfg_c.bits_per_sample}, "
          f"largest rate {int(wire.rates.max())}, so edge tables up to "
          f"{max(t[0].shape[1] for t in tables)} entries and decode tables of "
          f"{wire.scaled_cents.shape[-1]}: {m_w} encodes, "
          f"{m_w} decodes, 1 qgram over {len(idx)} machines, 1 qgram_packed in "
          f"{wire_s * 1e3:.3f} ms (host clock)  launches {launches}", flush=True)
    want_counts = {"quant_encode": m_w, "quant_decode": m_w, "qgram": 1, "qgram_packed": 1}
    check(all(launches[k] == want_counts.get(k, 0) for k in launches),
          f"wire: launches {launches}, expected {want_counts} and no other kernel")
    mismatched = near_edge = 0
    for i in range(m_w):
        edges_i, L = tables[i][0], lengths[i]
        check(torch.equal(enc[i], encode_plain(xs[i], edges_i)),
              f"wire: machine {i}'s codes differ from the plain encode")
        check(torch.equal(dec[i], decode_plain(enc[i], wire.scaled_cents[i])),
              f"wire: machine {i}'s decode differs from the plain decode")
        # symbols within 2 ulp of a finite edge: there the fit's f32-scaled
        # edges and build_scaled_tables' f64-scaled ones may disagree
        fin = torch.where(torch.isfinite(edges_i), edges_i, torch.zeros_like(edges_i))
        gap = (xs[i][:, :, None] - fin[None]).abs()
        ulp = torch.nextafter(fin.abs(), torch.full_like(fin, float("inf"))) - fin.abs()
        near = ((gap <= 2 * ulp[None]) & torch.isfinite(edges_i)[None]).any(-1)
        near_edge += int(near.sum())
        differ = enc[i] != sent[i, :L]
        mismatched += int(differ.sum())
        check(not bool((differ & ~near).any()),
              f"wire: machine {i}: a code differs from the wire's away from any edge")
    print(f"[wire] kernel codes == plain (bitwise, 40 machines); == the wire's unpacked codes "
          f"but {mismatched} (symbols within 2 ulp of an edge: {near_edge}); decode == plain "
          "(bitwise)", flush=True)
    xhat_w = decode_gathered(codes_q, cents_w)
    scale = float((xhat_w.abs() @ proj.abs().transpose(-1, -2)).max())
    err_pk = compare("qgram", "wire: unpacked vs qgram_packed, 39 machines",
                     g_unpacked[:, :n_pad], g_packed, scale)
    two_step = torch.stack([decode_plain(codes_q[k], cents_w[k]) for k in range(len(idx))])
    err_ds = compare("qgram", "wire: vs decode-then-multiply", g_unpacked,
                     two_step @ proj.transpose(-1, -2), scale)
    check(not bool(g_unpacked[:, n_pad:].any()), "wire: a -1 row did not give a zero row")
    # the main rows of the quantizer kernels: the wire's shapes, its largest table
    big = max(range(m_w), key=lambda i: tables[i][0].shape[1])
    tag = (f"wire: 25 x 21, {tables[big][0].shape[1]} edges / "
           f"{wire.scaled_cents.shape[-1]} centroids a row")
    main_enc, main_dec = time_quant(tag, xs[big], tables[big][0], enc[big],
                                    wire.scaled_cents[big], 200)
    main_enc.update(tag=tag, err=0.0)
    main_dec.update(tag=tag, err=0.0)
    results["quant_encode"].append(main_enc)
    results["quant_decode"].append(main_dec)
    main_unpacked = time_qgram("wire: 39 machines x 32 rows, p=25", codes_q, cents_w, proj,
                               xhat_w, 200)
    main_unpacked.update(tag="wire", err=max(err_pk, err_ds))
    results["qgram"].append(main_unpacked)

    # f. the kernel runtime's shape sweep over all eight families, from zero
    def prebuilt(*args):
        return lambda: args

    gx, gy = torch.randn(128, 21, device=dev), torch.randn(25, 21, device=dev)
    bx, by = torch.randn(4449, 21, device=dev), torch.randn(40000, 21, device=dev)
    pk_main = packed_inputs(39, 25, 21, 25, 24)
    pk_big = packed_inputs(40, 1000, 21, 4449, 24)
    epi = epilogue_operands(40, 128, 25, seed=1, device=dev)
    flt = epilogue_fleet_operands(16, 40, 16, 25, seed=1, device=dev)
    qb = quant_operands(1024, 128, 512, max_bits=8, seed=1, device=dev)
    qb_codes = encode_cuda(qb[0], qb[1])
    ub = qgram_operands(1, 1024, 128, 1024, 512, max_bits=8, seed=1, device=dev)
    at = decode_attn_operands(8, 8192, 4, 8, 128, pos=8191, seed=1, device=dev)
    ag = decode_attn_operands(8, 8192, 4, 2, 256, pos=10000, ring=True, seed=2, device=dev)
    sweeps = {
        "gram": [("128x25 d=21", prebuilt(gx, gy), None),
                 ("4449x40000 d=21", prebuilt(bx, by), None)],
        "qgram_packed": [("39x25x25 R=24", prebuilt(*pk_main[:4]),
                          {"total_bits": 24, "mask": pk_main[4]}),
                         ("40x1000x4449 R=24", prebuilt(*pk_big[:4]),
                          {"total_bits": 24, "mask": pk_big[4]})],
        "epilogue": [("m40 t128 K25 kl", prebuilt(*epi), {"fuse": "kl"})],
        "epilogue_fleet": [("T16 m40 t16 K25 kl", prebuilt(*flt), {"fuse": "kl"})],
        "quant_encode": [("wire 25x21 E" + str(tables[big][0].shape[1]),
                          prebuilt(xs[big], tables[big][0]), None),
                         ("1024x128 E256", prebuilt(qb[0], qb[1]), None)],
        "quant_decode": [("wire 25x21", prebuilt(enc[big], wire.scaled_cents[big]), None),
                         ("1024x128", prebuilt(qb_codes, qb[2]), None)],
        "qgram": [("wire 39x32x25", prebuilt(codes_q, cents_w, proj), None),
                  ("1024x128x1024", prebuilt(*ub), None)],
        "decode_attn": [("B8 S8192 KV4 G8 hd128 bf16", prebuilt(*at, 8191), None),
                        ("gemma2 local w4096", prebuilt(*ag, 10000), {"window": 4096})],
    }
    runtime.reset_launches()
    sweep_rows = []
    for name, cases in sweeps.items():
        for label, backend, us in runtime.shape_sweep(name, cases, reps=5):
            sweep_rows.append((name, label, backend, us))
            print(f"[sweep] {name:14s} {label:28s} {backend:5s} {us:12.3f} us/call", flush=True)
    torch.cuda.synchronize()
    path_launches["sweep"] = runtime.launches()
    print(f"[sweep] launches {path_launches['sweep']}", flush=True)
    bad = [r for r in sweep_rows if r[2] == "cuda" and not np.isfinite(r[3])]
    check(not bad, f"sweep: a kernel could not run a case: {bad}")
    check(all(path_launches["sweep"][name] > 0 for name in sweeps),
          f"sweep: a family launched no kernel: {path_launches['sweep']}")

    # g. the Fig. 6 experiment: eight models at three rates, at full width
    t0 = time.perf_counter()
    path_launches.update(fig6_phase(dev))
    print(f"[fig6] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # h. streaming update() on a.'s, b.'s and c.'s artifacts: eight batches of
    # 16 fresh test rows (disjoint from the queries), machines 1-7 then the center
    t0 = time.perf_counter()
    n_stream = sum(n for _, n in STREAM_BATCHES) + STREAM_BATCHES[0][1]
    print(f"[stream] {smi}", flush=True)
    path_launches.update(stream_phase(
        dev, {"center": center["art"], "broadcast": bcast["art"], "poe-rbcm": rbcm["art"]},
        X_te[2048:2048 + n_stream], y_te[2048:2048 + n_stream], X_te[:1024]))
    for name, (_, per_request) in STREAM_LAUNCHES.items():
        check(all(path_launches[f"stream {name}"][k] > 0 for k in per_request),
              f"stream {name}: a kernel of the path never launched")
    print(f"[stream] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # i. fault injection and the vq channel at the same width: faulted fits
    # of a.-c.'s paths, corrupted streaming, degraded requests, vq fits
    t0 = time.perf_counter()
    print(f"[fault] {smi}", flush=True)
    path_launches.update(fault_phase(
        dev, parts, X_te, y_te,
        {"center": (center["smse"], center["art"].wire_bits),
         "broadcast": (bcast["smse"], bcast["art"].wire_bits),
         "poe-rbcm": (rbcm["smse"], 0)},
        X_te[3000:3064], y_te[3000:3064]))
    for name, kernels in (("center", ("gram", "qgram_packed")),
                          ("broadcast", ("gram", "qgram_packed", "epilogue")),
                          ("poe-rbcm", ("gram",))):
        check(all(path_launches[f"fault {name}"][k] > 0 for k in kernels),
              f"fault {name}: a kernel of the path never launched")
    print(f"[fault] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # j. the paper's §4 figures at their full settings, card against CPU
    t0 = time.perf_counter()
    print(f"[paper] {smi}", flush=True)
    path_launches.update(paper_phase(dev))
    for tag in ("fig4", "fig7"):
        check(path_launches[f"paper {tag}"]["gram"] > 0,
              f"paper {tag}: the gram kernel never launched")
    print(f"[paper] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # k. the serving CLI serve_gp at the paper's §6 widths, and the examples
    t0 = time.perf_counter()
    print(f"[serve] {smi}", flush=True)
    path_launches.update(serve_phase(dev))
    for tag, (_, per_request) in SERVE_RUNS.items():
        kernels = ("epilogue_fleet",) if per_request is None else tuple(per_request)
        check(all(path_launches[f"serve {tag}"][k] > 0 for k in kernels),
              f"serve {tag}: a kernel of the path never launched")
    print(f"[serve] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # l. impl="mesh": 40 processes, one per machine, on the card (no kernel:
    # the mesh assembles with "xla", as the reference's does)
    t0 = time.perf_counter()
    print(f"[mesh] {smi}", flush=True)
    path_launches.update(mesh_phase(dev, parts, batches, X_te[3100:3116], y_te[3100:3116]))
    print(f"[mesh] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # m. LLM decode serving: every attention layer through decode_attn
    t0 = time.perf_counter()
    path_launches.update(decode_phase(dev, smi))
    print(f"[decode] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # n. LLM training: the ten archs card vs CPU, gemma2-2b at full width
    # (8 steps, then served through decode_attn), the quantized reduce
    t0 = time.perf_counter()
    path_launches.update(train_phase(dev, smi))
    print(f"[train] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # o. the dry run: fake shards on the production meshes, held against real
    # steps on the card (decode_attn traced as a custom op)
    t0 = time.perf_counter()
    path_launches.update(dryrun_phase(dev, smi))
    print(f"[dryrun] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # p. the autotune cache: every candidate at the paths' shapes, the
    # winners, and a second process on the same cache file
    t0 = time.perf_counter()
    autotune_phase(dev, smi, device_ms)
    print(f"[autotune] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. the kernels line and the result line ---------------------------
    src = "src/repro_torch/kernels/csrc"
    main_rows = {"gram": main_gram, "qgram_packed": main_qgram,
                 "epilogue": next(r for r in main_epi if r["tag"].endswith(" kl")),
                 "epilogue_fleet": next(r for r in main_fleet if r["tag"].endswith(" kl")),
                 "quant_encode": main_enc, "quant_decode": main_dec, "qgram": main_unpacked,
                 "decode_attn": main_attn}
    kernels = []
    for name, replaces in (
        ("gram", "src/repro/kernels/gram/gram.py:35"),
        ("qgram_packed", "src/repro/kernels/qgram/packed.py:87"),
        ("epilogue", "src/repro/kernels/epilogue/epilogue.py:142"),
        ("epilogue_fleet", "src/repro/kernels/epilogue/epilogue.py:113"),
        ("quant_encode", "src/repro/kernels/quant/quant.py:56"),
        ("quant_decode", "src/repro/kernels/quant/quant.py:75"),
        ("qgram", "src/repro/kernels/qgram/qgram.py:51"),
        ("decode_attn", "src/repro/kernels/decode_attn/decode_attn.py:62"),
    ):
        row = main_rows[name]
        errs = [r["err"] for r in results[name]] + [
            r["err_bwd"] for r in results[name] if "err_bwd" in r]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}/{name}.cu",
            "replaces": replaces,
            "launches": sum(counts.get(name, 0) for counts in path_launches.values()),
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
