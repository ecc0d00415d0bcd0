"""The planning functions of repro_torch's redesigned kernels, on the CPU.

``gram.plan`` picks ``csrc/gram.cu``'s tile and its split of K from the
shape alone; ``decode_attn.plan`` picks the kernel and cuts S into its
ranges; ``epilogue.plan`` picks the variant, the point tile and the expert
groups (every tile and expert covered once, the staged bytes within a
block's 232,448).  ``quant_encode``'s rule (search a chunk whose edges do
not decrease, count any other) is modeled in numpy and held bitwise against
the plain version and the reference's ``encode_ref`` on adversarial tables.
``qgram.plan`` picks the tile configuration of the shared quantized-gram
body (``csrc/qgram_body.cuh``) and the column tiles a block walks; the
packed kernel's meta rule (an exclusive prefix sum of the rates) and its
unpack are modeled in numpy and held against ``pack_meta`` and
``unpack_codes``.  All are plain Python: these tests hold what the kernels rely on
(every split non-empty, together covering the reduction exactly, a whole
number of k-slabs or 128-slot units a split) and the shapes the paths give them
(the GP request and fit products stay one launch of one tile; the long-K
backward products take a narrow tile and a split).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant.ref import encode_ref  # noqa: E402

from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    plan as attn_plan, warp_smem,
)
from repro_torch.kernels.epilogue.ops import (  # noqa: E402
    MMA_POINTS, SMALL_K, plan as epi_plan, plan_fleet as epi_plan_fleet, smem_bytes as epi_smem,
)
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.kernels.gram.ops import TILES, Plan, plan as gram_plan  # noqa: E402
from repro_torch.kernels.qgram import ops as qgram_ops  # noqa: E402
from repro_torch.kernels.quant.cases import (  # noqa: E402
    ENCODE_TABLE_KINDS, encode_operands, quant_operands,
)
from repro_torch.kernels.quant.ops import ENCODE_CHUNK, encode_plain  # noqa: E402

GRAM_SHAPES = [  # (n, p, d): output n x p, K = d
    (128, 25, 21),      # a GP request: 128 queries x 25 center points
    (25, 25, 21),       # the fit's center gram
    (4449, 40000, 21),  # the forward at full-SARCOS scale
    (4449, 21, 40000),  # its dX = g Y
    (40000, 21, 4449),  # its dY = g^T X
    (130, 21, 20000),   # a ragged long K
    (21, 130, 20000),
    (130, 70, 50),
    (1, 1, 1),
    (3, 5, 0),          # an empty K
    (4449, 1000, 21),
    (37, 300, 700),
    (1000, 33, 5000),   # a 33-column output: not narrow
    (4449, 25, 21),     # a predict of 4449 queries against 25 centers
    (4449, 25, 40000),  # dX = g Y at d = 25
    (600, 28, 4000),
]


@pytest.mark.parametrize("n,p,d", GRAM_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_gram_splits_cover_k_exactly(n, p, d, sms):
    pl = gram_plan(n, p, d, sms)
    assert pl.tile in TILES and pl.splits >= 1
    bk = TILES[pl.tile][2]
    if d == 0:
        assert pl.splits == 1
        return
    assert pl.k_per_split > 0 and pl.k_per_split % bk == 0
    # ranges [s kps, min(d, (s+1) kps)): each non-empty, together exactly [0, d)
    ranges = [(s * pl.k_per_split, min(d, (s + 1) * pl.k_per_split)) for s in range(pl.splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if pl.splits > 1:
        assert pl.k_per_split >= 256  # no split shorter than its minimum but the last


@pytest.mark.parametrize("n,p", [(128, 25), (25, 25),
                                 (25, 1000), (25, 128)])  # center direct: fit, request
def test_gram_request_and_fit_products_are_one_tile_no_split(n, p):
    plans = {gram_plan(n, p, 21, sms) for sms in (132, 114)}
    assert plans == {Plan("small", 1, gram_plan(n, p, 21).k_per_split)}
    assert gram_plan(128, 25, 21).tile == gram_plan(25, 25, 21).tile


@pytest.mark.parametrize("n,p,d,what", [(4449, 21, 40000, "dX = g Y"),
                                        (40000, 21, 4449, "dY = g^T X")])
def test_gram_backward_products_take_a_narrow_tile_and_a_split(n, p, d, what):
    pl = gram_plan(n, p, d, 132)
    assert pl.tile.startswith("narrow"), what
    assert TILES[pl.tile][1] >= p
    assert pl.splits > 1, what


@pytest.mark.parametrize("n,p,d", [(4449, 25, 21), (4449, 25, 40000), (40000, 32, 4449),
                                   (600, 28, 4000)])
def test_gram_outputs_of_25_to_32_columns_take_the_small_tile(n, p, d):
    assert gram_plan(n, p, d, 132).tile == "small"


def test_gram_forward_at_scale_takes_the_wide_tile_whole():
    assert gram_plan(4449, 40000, 21, 132) == Plan("wide", 1, 32)


@pytest.mark.parametrize("n,p,d", GRAM_SHAPES)
def test_gram_plan_depends_only_on_its_arguments(n, p, d):
    first = gram_plan(n, p, d, 132)
    gram_plan(4449, 21, 40000, 114)  # another call between
    assert gram_plan(n, p, d, 132) == first
    assert gram_plan(n, p, d, sms=132) == first


@pytest.mark.parametrize("n,p,d", GRAM_SHAPES)
def test_gram_grid_stays_within_the_card_limits(n, p, d):
    pl = gram_plan(n, p, d, 132)
    bm, bn, _, _ = TILES[pl.tile]
    assert math.ceil(n / bm) * math.ceil(p / bn) * pl.splits < 2**31
    assert pl.splits <= 65535


ATTN_SHAPES = [  # (B, S, KV, G, hd, kv_bytes)
    (8, 8192, 4, 8, 128, 2),   # the kernels bench shape, bf16 K/V
    (8, 8192, 4, 2, 256, 2),   # a gemma2-2b local layer
    (2, 1000, 2, 12, 64, 4),   # ragged S, fp32 K/V, two head chunks
    (3, 333, 2, 3, 40, 2),     # ragged S and hd
    (1, 64, 2, 2, 8, 4),
    (1, 700, 2, 4, 512, 4),    # the largest head dim, fp32
    (1, 700, 2, 4, 512, 2),
    (2, 130, 1, 12, 16, 4),
    (64, 1, 8, 1, 64, 2),      # one slot
    (1, 100000, 1, 1, 128, 2),  # a long cache
]


@pytest.mark.parametrize("B,S,KV,G,hd,kv_bytes", ATTN_SHAPES)
@pytest.mark.parametrize("sms", [132, 16])
def test_decode_attn_splits_are_non_empty_and_cover_s(B, S, KV, G, hd, kv_bytes, sms):
    pl = attn_plan(B, S, KV, G, hd, kv_bytes, sms)
    assert pl.path in ("mma", "simt")
    assert pl.slots_per_split > 0 and pl.slots_per_split % 128 == 0
    assert pl.splits >= 1
    assert (pl.splits - 1) * pl.slots_per_split < S <= pl.splits * pl.slots_per_split
    assert pl == attn_plan(B, S, KV, G, hd, kv_bytes, sms)  # a function of its arguments


@pytest.mark.parametrize("B,S,KV,G,hd,kv_bytes", ATTN_SHAPES)
def test_decode_attn_path_follows_the_operands(B, S, KV, G, hd, kv_bytes):
    pl = attn_plan(B, S, KV, G, hd, kv_bytes)
    mma = kv_bytes == 2 and hd % 8 == 0 and hd <= 256
    assert pl.path == ("mma" if mma else "simt")
    if mma:  # the warp kernel: four warp ranges of <= 512 slots
        assert pl.slots_per_split <= 4 * 512
        assert pl.slots_per_split % 128 == 0
        assert warp_smem(hd, 3) <= 227 * 1024
    # K or V off 16 bytes: the block kernel, whatever the type
    assert attn_plan(B, S, KV, G, hd, kv_bytes, aligned=False).path == "simt"


def test_decode_attn_bench_and_gemma2_take_the_tensor_core_path():
    bench = attn_plan(8, 8192, 4, 8, 128, 2)
    gemma2 = attn_plan(8, 8192, 4, 2, 256, 2)
    assert bench.path == gemma2.path == "mma"
    assert bench.splits > 1 and gemma2.splits > 1  # 32 (b, kv) rows alone leave SMs idle


@pytest.mark.parametrize("hd", [8, 40, 64, 128, 200, 256])
@pytest.mark.parametrize("q_terms", [1, 3])
def test_decode_attn_warp_kernel_fits_shared_memory(hd, q_terms):
    # a warp-kernel block (bf16 q: one term, fp32 q: three) fits the 227 KB
    # an H100 SM gives, so plan()'s blocks-an-SM count is at least one
    assert warp_smem(hd, q_terms) <= 227 * 1024
    assert warp_smem(hd, 1) < warp_smem(hd, 3)


# ---- the epilogue's plan (csrc/epilogue_body.cuh) ---------------------------------

EPI_SHAPES = [  # (T, m, t, K)
    (1, 40, 128, 25),    # a broadcast request at Fig. 6
    (1, 40, 4449, 25),   # the whole SARCOS test set
    (1, 40, 130, 300),   # large K
    (16, 40, 16, 25),    # a fleet flush
    (8, 40, 128, 25),    # serve-sized fleet requests
    (1, 5, 37, 19),
    (1, 40, 32, 32),     # the small variant's largest K
    (1, 40, 32, 33),     # one past it
    (1, 40, 2048, 25),   # the mma tile of 128 points, exactly 16 tiles
    (1, 40, 2049, 25),   # one past a tile
    (3, 3, 65, 300),
    (1, 2, 10, 1344),    # the largest K at a tile of 32 points
    (1, 2, 10, 1345),    # one past: 16 points
    (1, 2, 10, 2688),    # the largest K the plan takes
    (1, 1, 1, 1),
    (64, 40, 128, 25),
    (1000, 3, 7, 10),
]


@pytest.mark.parametrize("T,m,t,K", EPI_SHAPES)
def test_epilogue_plan_covers_every_tile_and_expert_once(T, m, t, K):
    pl = epi_plan_fleet(T, m, t, K)
    tiles = [(x * pl.tt, min(t, (x + 1) * pl.tt)) for x in range(math.ceil(t / pl.tt))]
    assert all(lo < hi for lo, hi in tiles) and tiles[-1][1] == t
    per = math.ceil(m / pl.groups)
    groups = [range(g * per, min(m, (g + 1) * per)) for g in range(pl.groups)]
    assert all(len(r) > 0 for r in groups)  # no group without an expert
    seen = [e for r in groups for e in r]
    assert seen == list(range(m))  # each expert in exactly one group, in order


@pytest.mark.parametrize("T,m,t,K", EPI_SHAPES)
def test_epilogue_staged_bytes_fit_and_grid_within_limits(T, m, t, K):
    pl = epi_plan_fleet(T, m, t, K)
    assert epi_smem(pl.variant, pl.tt, K) <= 232_448
    assert math.ceil(t / pl.tt) < 2**31 and pl.groups <= 65535 and T <= 65535
    threads = 4 * pl.tt if pl.variant == "small" else 256
    assert threads <= 1024


@pytest.mark.parametrize("T,m,t,K", EPI_SHAPES)
def test_epilogue_variant_follows_k(T, m, t, K):
    pl = epi_plan_fleet(T, m, t, K)
    if K > SMALL_K:
        assert pl.variant == "mma" and pl.tt in (16, 32)
    elif T * t >= MMA_POINTS:
        assert pl == (("mma", 128) + (pl.groups,))
    else:
        assert pl.variant == "small" and pl.tt == (16 if t <= 16 else 32)


@pytest.mark.parametrize("T,m,t,K", EPI_SHAPES)
def test_epilogue_plan_fleet_at_one_tenant_is_plan(T, m, t, K):
    assert epi_plan_fleet(1, m, t, K) == epi_plan(m, t, K)
    assert epi_plan(m, t, K, sms=132) == epi_plan(m, t, K)  # a function of its arguments


def test_epilogue_tile_shrinks_as_k_grows_and_a_k_past_the_last_is_refused():
    tts = [epi_plan(2, 10, K).tt for K in (33, 300, 1344, 1345, 2688)]
    assert tts == sorted(tts, reverse=True) and tts[0] > tts[-1]
    with pytest.raises(ValueError, match="does not fit"):
        epi_plan(2, 10, 2689)


# ---- quant_encode's rule (csrc/quant_encode.cu), modeled in numpy ----------------

def encode_model(x, edges):
    """The kernel's rule: each row in chunks of ENCODE_CHUNK edges; a chunk
    whose edges do not decrease (a <= b for each adjacent pair: a NaN fails)
    is counted by the kernel's branchless lower-bound search, any other in
    full.  Returns the codes and, per row, whether every chunk was searched."""
    n, d = x.shape
    codes = np.zeros((n, d), np.int32)
    searched = np.ones(d, bool)
    for j in range(d):
        for c0 in range(0, edges.shape[1], ENCODE_CHUNK):
            s = edges[j, c0:c0 + ENCODE_CHUNK]
            if bool(np.all(s[:-1] <= s[1:])):
                for i in range(n):
                    base, length = 0, s.size
                    while length > 1:
                        half = length >> 1
                        base = base + half if s[base + half] < x[i, j] else base
                        length -= half
                    codes[i, j] += base + int(s[base] < x[i, j])
            else:
                searched[j] = False
                codes[:, j] += (s[None, :] < x[:, j, None]).sum(1).astype(np.int32)
    return codes, searched


@pytest.mark.parametrize("kind", ENCODE_TABLE_KINDS)
@pytest.mark.parametrize("E", [128, 129, 1000, 4096, ENCODE_CHUNK + 5])
def test_encode_rule_matches_plain_and_reference_bitwise(kind, E):
    n, d = (9, 4) if E > 4096 else (23, 7)
    x, edges = encode_operands(n, d, E, kind, seed=E + len(kind))
    got, searched = encode_model(x.numpy(), edges.numpy())
    np.testing.assert_array_equal(got, encode_plain(x, edges).numpy())
    np.testing.assert_array_equal(got, np.asarray(encode_ref(jnp.asarray(x.numpy()),
                                                             jnp.asarray(edges.numpy()))))
    # the tables take the path they should: ascending rows the search, a row
    # that decreases or holds a NaN edge the full count
    if kind in ("unsorted", "nan_edge"):
        assert not searched[1]
    else:
        assert searched.all()


def test_encode_rule_on_the_wire_tables_takes_the_search():
    x, edges, _, _ = quant_operands(25, 21, 48, max_bits=12, seed=46, dominant=True,
                                    specials=True)
    got, searched = encode_model(x.numpy(), edges.numpy())
    assert edges.shape[1] == 4096 and searched.all()
    np.testing.assert_array_equal(got, encode_plain(x, edges).numpy())


# ---- the quantized-gram body's plan (csrc/qgram_body.cuh) -------------------------

QGRAM_SHAPES = [  # (m, n, p, d, W words a row or None for int32 codes, C table entries)
    (39, 25, 25, 21, 1, 4096),       # the centre's fit call (R = 24)
    (39, 32, 25, 21, None, 4096),    # the wire's qgram (25 rows + 7 of -1)
    (40, 25, 1000, 21, 1, 4096),     # broadcast's fit call
    (39, 25, 1000, 21, 1, 4096),     # center direct's fit call (Y = X_recon)
    (39, 25, 128, 21, 1, 4096),      # center direct's request
    (40, 25, 1000, 21, 2, 4096),     # broadcast direct's fit call D at R = 40
    (40, 25, 128, 21, 2, 4096),      # broadcast direct's request E at R = 40
    (40, 1000, 4449, 21, 1, 4096),   # 40 x 1000 rows against 4449 queries
    (1, 1024, 1024, 128, None, 256),  # the kernels bench shape
    (2, 32, 32, 21, 1, 4096),        # the small tile whole
    (2, 33, 33, 21, 1, 4096),        # one row and column past it
    (300, 32, 64, 21, 1, 4096),      # the flat tile whole
    (300, 32, 65, 21, 1, 4096),      # one column past it
    (200, 64, 128, 21, 1, 4096),     # the wide tile whole
    (200, 65, 129, 21, 1, 4096),     # one row and column past it
    (3, 200, 1001, 21, 4, 4096),     # odd p, W = 4 (straddling codes)
    (2, 1024, 1025, 40, 4, 256),     # the long tile, ragged d and p
    (2, 77, 300, 45, None, 4096),    # d past a chunk, a table too large to stage
    (1, 1, 1, 1, None, 8),
    (2, 10, 3, 5, 0, 4096),          # rate 0: no words
    (1, 4449, 40000, 21, None, 4096),
    (1, 10, 10, 5000, 200, 4096),    # long d: meta rows and words still staged
]


@pytest.mark.parametrize("m,n,p,d,W,C", QGRAM_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_qgram_plan_covers_every_output_once(m, n, p, d, W, C, sms):
    pl = qgram_ops.plan(m, n, p, d, W, C, sms)
    br, bc = qgram_ops.TILES[pl.variant]
    tiles_r, tiles_c = math.ceil(n / br), math.ceil(p / bc)
    assert pl.walk >= 1 and pl.groups == math.ceil(tiles_c / pl.walk)
    # the grid is (column group, row tile, machine): every machine once, and
    # within a machine rows x columns, so each axis covered once suffices
    rows = np.zeros(n, int)
    for r in range(tiles_r):
        rows[r * br:(r + 1) * br] += 1
    cols = np.zeros(p, int)
    for g in range(pl.groups):
        tiles = range(g * pl.walk, min((g + 1) * pl.walk, tiles_c))
        assert len(tiles) > 0  # no group without a column tile
        for t in tiles:
            cols[t * bc:(t + 1) * bc] += 1
    assert (rows == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("m,n,p,d,W,C", QGRAM_SHAPES)
def test_qgram_plan_staged_bytes_and_grid_within_the_card_limits(m, n, p, d, W, C):
    pl = qgram_ops.plan(m, n, p, d, W, C, 132)
    br, _ = qgram_ops.TILES[pl.variant]
    assert qgram_ops.smem_bytes(pl.variant, d, W, C) <= 232_448
    assert pl.groups < 2**31 and math.ceil(n / br) <= 65535 and m <= 65535


@pytest.mark.parametrize("m,n,p,d,W,C", QGRAM_SHAPES)
def test_qgram_plan_depends_only_on_its_arguments(m, n, p, d, W, C):
    first = qgram_ops.plan(m, n, p, d, W, C, 132)
    qgram_ops.plan(1, 1024, 1024, 128, None, 256, 114)  # another call between
    assert qgram_ops.plan(m, n, p, d, W, C, 132) == first
    assert qgram_ops.plan(m, n, p, d, W=W, C=C, sms=132) == first


@pytest.mark.parametrize("m,n,p,d,W,C,variant", [
    (39, 25, 25, 21, 1, 4096, "small"),        # the centre's fit call
    (39, 32, 25, 21, None, 4096, "small"),     # the wire's qgram
    (40, 25, 1000, 21, 1, 4096, "flat"),       # broadcast's fit call
    (39, 25, 1000, 21, 1, 4096, "flat"),       # center direct's fit call
    (39, 25, 128, 21, 1, 4096, "small"),       # center direct's request
    (40, 25, 1000, 21, 2, 4096, "flat"),       # broadcast direct's fit call D
    (40, 25, 128, 21, 2, 4096, "small"),       # broadcast direct's request E
    (40, 1000, 4449, 21, 1, 4096, "wide"),     # the wide output
    (1, 1024, 1024, 128, None, 256, "long"),   # the kernels bench shape
    (300, 32, 65, 21, 1, 4096, "flat"),
    (200, 65, 129, 21, 1, 4096, "wide"),
    (3, 200, 1001, 21, 4, 4096, "wide"),
    (2, 1024, 1025, 40, 4, 256, "long"),
    (2, 77, 300, 45, None, 4096, "small"),     # its table too large to stage
])
def test_qgram_plan_takes_the_variant_named_for_each_shape(m, n, p, d, W, C, variant):
    assert qgram_ops.plan(m, n, p, d, W, C, 132).variant == variant


def test_qgram_fit_calls_are_one_tile_a_machine_and_the_bench_one_column_tile_a_block():
    assert qgram_ops.plan(39, 25, 25, 21, 1, 4096) == qgram_ops.Plan("small", 1, 1)
    assert qgram_ops.plan(1, 1024, 1024, 128, None, 256).walk == 1
    wide = qgram_ops.plan(40, 1000, 4449, 21, 1, 4096)
    assert wide.walk > 1  # a block decodes its rows once for several column tiles


def test_qgram_plan_refuses_a_block_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        qgram_ops.plan(1, 10, 10, 30000, 30000, 4096)


def meta_model(rates):
    """The packed kernel's meta rows: warp 0 scans each machine's rates in
    chunks of 32 lanes (an inclusive shuffle scan plus the carry of the
    chunks before), offset = inclusive - width; word = offset >> 5, bit =
    offset & 31, in 32-bit two's complement."""
    m, d = rates.shape
    meta = np.zeros((m, 3, d), np.int64)
    for b in range(m):
        carry = 0
        for j0 in range(0, d, 32):
            w = np.zeros(32, np.int64)
            live = rates[b, j0:j0 + 32].astype(np.int64)
            w[:live.size] = live
            incl = np.cumsum(w) & 0xFFFFFFFF
            offs = (carry + incl - w) & 0xFFFFFFFF
            offs = np.where(offs >= 2**31, offs - 2**32, offs)  # back to int32
            meta[b, 0, j0:j0 + live.size] = (offs >> 5)[:live.size]
            meta[b, 1, j0:j0 + live.size] = (offs & 31)[:live.size]
            meta[b, 2, j0:j0 + live.size] = live
            carry = (carry + int(incl[31])) & 0xFFFFFFFF
    return meta


def unpack_model(words, meta):
    """The packed kernel's unpack of one row set: width 0 gives 0, the high
    part of a straddling code comes from word + 1, a word past the row
    reads 0, width >= 32 takes the full mask."""
    m, n, W = words.shape
    d = meta.shape[-1]
    w = words.astype(np.int64) & 0xFFFFFFFF
    codes = np.zeros((m, n, d), np.int64)
    for b in range(m):
        for j in range(d):
            wi, bit, width = (int(v) for v in meta[b, :, j])
            if width == 0:
                continue
            lo = (w[b, :, wi] >> bit) if 0 <= wi < W else 0
            hi = ((w[b, :, wi + 1] << (32 - bit)) & 0xFFFFFFFF) if bit > 0 and wi + 1 < W else 0
            mask = 0xFFFFFFFF if width >= 32 else (1 << width) - 1
            codes[b, :, j] = (lo | hi) & mask
    return codes


@pytest.mark.parametrize("m,d,R,cap,zero_dims", [
    (39, 21, 24, 12, ()),       # the wire's rates at R = 24 (W = 1)
    (5, 21, 100, 12, (0, 5)),   # W = 4: codes straddle words, width-0 dims
    (3, 70, 300, 9, (69,)),     # d past a warp's 32 lanes: the scan's carry
    (2, 5, 0, 8, ()),           # rate 0
])
def test_packed_meta_and_unpack_rules_match_pack_meta_and_unpack_codes(m, d, R, cap, zero_dims):
    rng = np.random.default_rng(m + d + R)
    live = [j for j in range(d) if j not in zero_dims]
    rates = np.zeros((m, d), np.int64)
    for b in range(m):
        for _ in range(R):
            j = live[rng.integers(len(live))]
            rates[b, j] = min(rates[b, j] + 1, cap)
    meta = meta_model(rates)
    np.testing.assert_array_equal(meta, qgram_ops.pack_meta(torch.from_numpy(rates)).numpy())
    codes = rng.integers(0, 2 ** rates[:, None, :], size=(m, 17, d))
    words = TS.pack_codes(torch.from_numpy(codes), torch.from_numpy(rates), total_bits=R)
    got = unpack_model(words.numpy(), meta)
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(
        got, TS.unpack_codes(words, torch.from_numpy(rates), total_bits=R).numpy())


# ---- quant_decode's plan (csrc/quant_decode.cu) ---------------------------------

from repro_torch.kernels.quant import ops as quant_ops  # noqa: E402

DECODE_SHAPES = [  # (n, d, C)
    (25, 21, 4096),      # the wire's machine, its largest table
    (1024, 128, 256),    # the kernels bench shape
    (1024, 128, 4096),   # with a 4096-entry row
    (65536, 128, 256),   # bytes set the time
    (1, 1, 8),
    (0, 21, 4096),
    (1, 129, 256),
    (300, 3, 256),
    (37, 13, 4096),
    (64, 128, 256),      # the flat variant's largest call
    (65, 128, 256),      # one row past it
    (4000, 31, 256),
    (4000, 32, 256),
    (33, 129, 4096),     # ragged rows and dimensions
    (67552, 32, 256),    # the last plan of 32-row tiles
    (67584, 32, 256),    # the first of 64
    (33761, 33, 4096),
    (40000, 21, 4096),
    (1000, 12, 128),     # d < 16: flat
    (1000, 16, 128),     # a multiple of 4 from 16: the tile
    (4449, 1000, 256),
]


def decode_cover(n, d, pl):
    """How often the kernel's grid writes each (row, dimension): "flat" one
    thread a symbol over ceil(n d / 256) blocks; "tile" block (x, y) rows
    [x bn, min(n, (x + 1) bn)) x dims [y bd, min(d, (y + 1) bd))."""
    hits = np.zeros(n * d, int)
    if pl.variant == "flat":
        for b in range(math.ceil(n * d / 256)):
            k = np.arange(b * 256, (b + 1) * 256)
            np.add.at(hits, k[k < n * d], 1)
        return hits.reshape(n, d)
    hits = hits.reshape(n, d)
    for x in range(math.ceil(n / pl.bn)):
        for y in range(math.ceil(d / pl.bd)):
            hits[x * pl.bn:min(n, (x + 1) * pl.bn), y * pl.bd:min(d, (y + 1) * pl.bd)] += 1
    return hits


@pytest.mark.parametrize("n,d,C", DECODE_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_decode_plan_covers_every_symbol_once(n, d, C, sms):
    pl = quant_ops.decode_plan(n, d, C, sms)
    if n * d > 2_000_000:  # the model walks every symbol: check the rows on a slice
        n = pl.bn * 3 + 5 if pl.variant == "tile" else 5000 // d
    assert (decode_cover(n, d, pl) == 1).all()


@pytest.mark.parametrize("n,d,C", DECODE_SHAPES)
def test_decode_plan_shared_memory_and_grid_within_the_card_limits(n, d, C):
    pl = quant_ops.decode_plan(n, d, C)
    assert pl.smem == quant_ops.decode_smem_bytes(pl.variant, pl.bn) <= 48 * 1024  # no attribute
    if pl.variant == "flat":
        assert (pl.bn, pl.bd) == (0, 0) and n * d < 2**31
        assert math.ceil(n * d / 256) < 2**31
    else:
        assert pl.bn in quant_ops.DECODE_ROWS and pl.bd == quant_ops.DECODE_BD
        assert math.ceil(n / pl.bn) < 2**31 and math.ceil(d / pl.bd) <= 65535
        assert pl.bn * d < 2**31  # the tile's 32-bit offsets


@pytest.mark.parametrize("n,d,C", DECODE_SHAPES)
def test_decode_plan_depends_only_on_its_arguments(n, d, C):
    first = quant_ops.decode_plan(n, d, C, 132)
    quant_ops.decode_plan(65536, 128, 256, 16)  # another call between
    assert quant_ops.decode_plan(n, d, C, 132) == first
    assert quant_ops.decode_plan(n, d, C=C, sms=132) == first


@pytest.mark.parametrize("n,d,C,variant,bn", [
    # as timed on the card (PERF.md section 6): the wire and small calls
    # take the flat variant, and so does d < 32 where the tile would take
    # its 4-byte path or idle over half its columns; the bench shape and
    # every other d the tile at every C (no table size at which staging the
    # rows in shared memory paid), with 64 rows from 16 blocks an SM
    (25, 21, 4096, "flat", 0),
    (1024, 128, 128, "tile", 32),     # the bench shape's table: 4d bits, max 8
    (1024, 128, 256, "tile", 32),
    (1024, 128, 1024, "tile", 32),
    (1024, 128, 4096, "tile", 32),
    (64, 128, 256, "flat", 0),
    (65, 128, 256, "tile", 32),
    (40000, 21, 4096, "flat", 0),     # flat 0.00395 ms, the tile 0.00437
    (65536, 21, 128, "flat", 0),
    (65536, 3, 128, "flat", 0),
    (65536, 12, 128, "flat", 0),      # flat 0.00341, the tile 0.00353
    (65536, 16, 128, "tile", 32),     # the tile 0.00372, flat 0.00404
    (65536, 24, 128, "tile", 32),
    (4000, 31, 128, "flat", 0),
    (4000, 32, 128, "tile", 32),
    (67552, 32, 256, "tile", 32),
    (67584, 32, 256, "tile", 64),     # 16 blocks an SM of 32-row tiles: 64 rows
    (65536, 128, 128, "tile", 64),
    (16384, 128, 128, "tile", 32),
])
def test_decode_plan_takes_the_variant_named_for_each_shape(n, d, C, variant, bn):
    pl = quant_ops.decode_plan(n, d, C)
    assert (pl.variant, pl.bn) == (variant, bn)


def test_decode_plan_refuses_a_grid_past_the_card_limits():
    with pytest.raises(ValueError, match="grid"):
        quant_ops.decode_plan(2, 65535 * 32 + 1, 256)


def test_decode_stage_copies_apply_to_the_shipped_source():
    # quant/stages.py times copies of csrc/quant_decode.cu with one stage
    # removed: each copy must still find the lines it edits
    from repro_torch.kernels.build import CSRC
    from repro_torch.kernels.quant import stages

    src = (CSRC / "quant_decode.cu").read_text()
    copies = stages.kernel_copies(src)
    assert set(copies) == {"tile", "tile -code load", "tile -lookup", "tile -store", "staged"}
    assert all(c != src for name, c in copies.items() if name != "tile")
