"""The planning functions of repro_torch's redesigned kernels, on the CPU.

``gram.plan`` picks ``csrc/gram.cu``'s tile and its split of K from the
shape alone; ``decode_attn.plan`` picks the kernel and cuts S into its
ranges.  Both are plain Python: these tests hold what the kernels rely on
(every split non-empty, together covering the reduction exactly, a whole
number of k-slabs or 128-slot units a split) and the shapes the paths give them
(the GP request and fit products stay one launch of one tile; the long-K
backward products take a narrow tile and a split).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    plan as attn_plan, warp_smem,
)
from repro_torch.kernels.gram.ops import TILES, Plan, plan as gram_plan  # noqa: E402

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


@pytest.mark.parametrize("n,p", [(128, 25), (25, 25)])
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
