"""The port's quantized collectives (``repro_torch.comm``) on spawned gloo
ranks, against the reference's (``repro.comm``, on the conftest's 8 host
devices) — the counterparts of tests/test_comm.py.

One pool of 8 CPU ranks serves the file (tests/_torch_mesh.py); a case at
m machines runs on ranks 0..m-1.  Inputs are numpy, made from a seed.

Tolerances and why:
* ledgers, rates, packed words and CRCs: integer-equal (given the
  reference's scheme state, substituted for each rank's fit, the words and
  CRCs are the reference's bit for bit);
* reconstructions given that state: 1e-5 of the data scale (the two
  matmul libraries round the decode apart);
* the mesh wire against the port's batched wire on the same blocks: bit for
  bit (every rank sums the moments in machine order, as the batched wire);
* ``q_psum`` at 32 bits: rtol 1e-6 against the float64 sum; its gradients:
  1e-4 at 32 bits, cosine > 0.95 and norm ratio in (0.8, 1.2) at 8 bits, as
  the reference's test holds them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import gather_blocks, mesh_pool, psum, psum_grad  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.comm import q_all_gather as ref_q_all_gather  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.core import jax_scheme as JS  # noqa: E402
from repro_torch.comm import wire_bits_all_gather  # noqa: E402
from repro_torch.comm.accounting import (  # noqa: E402
    payload_bits_formula, side_info_bits, wire_bits_formula,
)
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.core.protocols.wire import _run_wire_protocol  # noqa: E402
from repro_torch.faults import corrupt_words, drop_machine, flip_mask  # noqa: E402

pool = mesh_pool(8)


def _blocks(m, n_loc, d, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(m * n_loc, d))
         @ (rng.normal(size=(d, d)) / np.sqrt(d))).astype(np.float32)
    return X.reshape(m, n_loc, d)


def _run(pool, m, blocks, bits, **kw):
    return pool.run(gather_blocks, blocks, bits, world=m, **kw)


@pytest.fixture(scope="module")
def wide(pool):
    """The reference test's setting: 8 ranks, 64 rows of d = 12, 36 bits."""
    blocks = _blocks(8, 64, 12)
    return blocks, _run(pool, 8, blocks, 36)


def test_q_all_gather_own_block_exact(wide):
    blocks, outs = wide
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out["view"][i], blocks[i])


def test_q_all_gather_peers_within_rate_distortion(wide):
    # 36 bits over 12 dims = 3 bits a dim: distortion well below the power
    blocks, outs = wide
    others = float(np.mean((outs[0]["view"][1:] - blocks[1:]) ** 2))
    assert 0 < others < 0.5 * float(np.mean(blocks**2))


def test_q_all_gather_every_rank_sees_the_same_plane(wide):
    _, outs = wide
    for out in outs[1:]:
        for k in ("codes", "decoded", "rates", "T_inv", "sigma", "mask"):
            np.testing.assert_array_equal(out[k], outs[0][k])
        assert out["wire_bits"] == outs[0]["wire_bits"]


@pytest.mark.parametrize("m", [2, 4, 8])
def test_q_all_gather_shard_counts(pool, m):
    """Own block exact and peers genuinely quantized for 2, 4, 8 ranks."""
    blocks = _blocks(m, 16, 6)
    outs = _run(pool, m, blocks, 18)
    for i in range(m):
        np.testing.assert_array_equal(outs[i]["view"][i], blocks[i])
    peer_mse = np.mean((outs[0]["view"][1:] - blocks[1:]) ** 2)
    assert 0 < peer_mse < np.mean(blocks**2)


@pytest.mark.parametrize("bits", [1, 8, 32])
def test_q_all_gather_bits_edges(pool, bits):
    """1 bit a sample, 8 and a 32-bit budget decode to finite blocks, the
    distortion falling with the rate."""
    blocks = _blocks(4, 16, 6)
    view = _run(pool, 4, blocks, bits)[0]["view"]
    assert np.all(np.isfinite(view))
    mse = np.mean((view[1:] - blocks[1:]) ** 2)
    if bits == 1:
        assert mse > 0
    if bits == 32:
        assert mse < 0.5 * np.mean(blocks**2)


def _ragged(m=4, n_loc=12, d=5, seed=1):
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(m, n_loc, d)).astype(np.float32)
    mask = np.ones((m, n_loc), np.float32)
    mask[1, 9:] = 0.0  # machine 1 is ragged: 9 valid rows
    mask[3, 6:] = 0.0
    return blocks, mask


def test_q_all_gather_state_ledger_matches_formula(pool):
    """The ledgers: ``wire_bits`` the rates of each valid row plus the side
    info a transmitting rank, ``payload_bits`` — measured from the word
    buffer — the payload formula exactly; masked rows are zero words that
    unpack to the -1 sentinel and decode to zero."""
    bits, d = 15, 5
    blocks, mask = _ragged()
    st = _run(pool, 4, blocks, bits, masks=mask)[0]
    lengths = [int(v) for v in mask.sum(1)]
    rates = st["rates"]
    assert st["wire_bits"] == wire_bits_formula(rates, lengths, d)
    assert st["wire_bits"] == sum(int(rates[j].sum()) * lengths[j] + side_info_bits(d)
                                  for j in range(4))
    assert st["payload_bits"] == payload_bits_formula(lengths, d, bits, 8)
    words = st["codes"]
    W = words.shape[-1]
    assert W == (bits + 31) // 32
    pad = sum((32 * W - int(rates[j].sum())) * lengths[j] for j in range(4))
    assert st["payload_bits"] == st["wire_bits"] + pad
    assert st["integrity_bits"] == 16 * sum(lengths)
    assert np.all(words[1, 9:] == 0) and np.all(st["decoded"][1, 9:] == 0.0)
    assert np.all(words[3, 6:] == 0) and np.all(st["decoded"][3, 6:] == 0.0)
    codes = TS.unpack_codes(torch.from_numpy(words), torch.from_numpy(rates), total_bits=bits,
                            mask=torch.from_numpy(st["mask"])).numpy()
    assert np.all(codes[1, 9:] == -1) and np.all(codes[3, 6:] == -1)
    assert np.all(codes[:, :6] >= 0)


def test_q_all_gather_center_mode_charges_no_center(pool):
    bits, d = 15, 5
    blocks, mask = _ragged()
    st = _run(pool, 4, blocks, bits, masks=mask, mode="center", center=2)[0]
    lengths = [int(v) for v in mask.sum(1)]
    assert st["wire_bits"] == wire_bits_formula(st["rates"], lengths, d, skip=2)
    assert st["payload_bits"] == payload_bits_formula(lengths, d, bits, 8, skip=2)
    assert st["integrity_bits"] == 16 * (sum(lengths) - lengths[2])


def test_wire_bits_all_gather_accounting():
    """Both ledger call sites charge the one side-info formula."""
    q, base = wire_bits_all_gather(n_per_shard=100, d=8, bits=24, n_shards=4)
    assert q == 100 * 24 + side_info_bits(8) == 100 * 24 + 2 * 8 * 8 * 32
    assert base == 100 * 8 * 32 and q < base


def test_ledger_call_sites_integer_equal(pool):
    m, n_loc, d, bits = 4, 16, 6, 21
    st = _run(pool, m, _blocks(m, n_loc, d, seed=3), bits)[0]
    assert (st["rates"].sum(axis=1) == bits).all()
    per_shard, _ = wire_bits_all_gather(n_per_shard=n_loc, d=d, bits=bits, n_shards=m)
    assert st["wire_bits"] == m * per_shard


@pytest.mark.parametrize("mode", ["broadcast", "center"])
def test_mesh_wire_is_the_batched_wire_bit_for_bit(pool, mode):
    """The collective and the port's batched wire on the same padded
    blocks: the same words, reconstructions and side info."""
    bits, d = 15, 5
    blocks, mask = _ragged()
    blocks = blocks * mask[..., None]  # the padded layout: invalid rows are zero
    st = _run(pool, 4, blocks, bits, masks=mask, mode=mode, center=1)[0]
    ws = _run_wire_protocol(torch.from_numpy(blocks), torch.from_numpy(mask), bits, 8, mode, 1)
    for k in ("codes", "decoded", "T_inv", "sigma", "rates", "T"):
        np.testing.assert_array_equal(st[k], getattr(ws, k).numpy(), err_msg=k)


def _ref_state(blocks, mask, bits):
    m = blocks.shape[0]
    fn = shard_map(
        lambda x, mk: ref_q_all_gather(x, "m", bits, mask=mk[0], return_state=True)[1],
        mesh=Mesh(np.asarray(jax.devices()[:m]), ("m",)),
        in_specs=(P("m", None), P("m", None)), out_specs=P(), check_vma=False,
    )
    st = jax.jit(fn)(jnp.asarray(blocks.reshape(-1, blocks.shape[-1])), jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in st.items()}


def test_words_and_crcs_equal_the_reference_given_its_scheme_state(pool):
    """The reference's fitted state substituted for each rank's own fit
    (eigenvector signs differ between the eigensolvers): words and CRCs
    bit for bit, reconstructions within 1e-5 of scale, ledgers equal."""
    bits = 24
    blocks, mask = _ragged(d=6, seed=4)
    ref = _ref_state(blocks, mask, bits)
    states = [{k: ref[k][j] for k in ("T", "T_inv", "sigma", "rates")} for j in range(4)]
    st = _run(pool, 4, blocks, bits, masks=mask, scheme_states=states)[0]
    np.testing.assert_array_equal(TS.words_to_uint32(torch.from_numpy(st["codes"])),
                                  ref["codes"])
    np.testing.assert_array_equal(
        TS.crc_words(torch.from_numpy(st["codes"]), torch.from_numpy(st["mask"])).numpy(),
        np.asarray(jax.vmap(JS.crc_words)(jnp.asarray(ref["codes"]), jnp.asarray(ref["mask"]))))
    scale = np.abs(ref["decoded"]).max()
    np.testing.assert_allclose(st["decoded"], ref["decoded"], atol=1e-5 * scale)
    for k in ("wire_bits", "payload_bits", "integrity_bits"):
        assert st[k] == int(ref[k]), k


def test_faults_drop_a_rank_and_demote_flipped_rows(pool):
    """A dropped rank transmits (and is charged) nothing; under flips each
    receiver demotes exactly the rows whose CRC the sender's flip mask
    breaks, and never its own."""
    bits, d = 24, 5
    blocks = _blocks(4, 16, d, seed=5)
    plan = drop_machine(2) | corrupt_words(0.02, seed=3)
    outs = _run(pool, 4, blocks, bits, faults=plan)
    st = outs[0]
    assert np.all(st["mask"][2] == 0) and np.all(st["decoded"][2] == 0.0)
    lengths = [16, 16, 0, 16]
    assert st["wire_bits"] == wire_bits_formula(st["rates"], lengths, d)
    W = st["codes"].shape[-1]
    flips = torch.stack([flip_mask((16, W), 0.02, 3, j) for j in range(4)])
    broken = (flips != 0).any(-1).numpy()
    assert broken.sum() > 0
    for i, out in enumerate(outs):
        want = (~broken).astype(np.float32) * (np.arange(4) != 2)[:, None]
        want[i] = 1.0 if i != 2 else 0.0  # own rows never cross the wire
        np.testing.assert_array_equal(out["mask"], want)


def test_q_psum_fp_fallback_is_exact(pool):
    G = np.stack([np.linspace(-1, 1, 128).astype(np.float32) * (i + 1) for i in range(4)])
    for out in pool.run(psum, G, 32, world=4):
        np.testing.assert_allclose(out, G.sum(0), rtol=1e-6)


def test_q_psum_error_decreases_with_bits(pool):
    g = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32)
    G = np.stack([g * (i + 1) for i in range(8)])
    errs = {}
    for bits in (4, 8):
        s = pool.run(psum, G, bits)[0]
        errs[bits] = float(np.linalg.norm(s - G.sum(0)) / np.linalg.norm(G.sum(0)))
    assert errs[8] < errs[4] < 0.5 and errs[8] < 0.1


@pytest.mark.parametrize("m", [2, 4, 8])
def test_q_psum_gradient_straight_through(pool, m):
    """The gradient flows through q_psum: exact at 32 bits, aligned with the
    exact one at 8 bits, and of its magnitude (the backward sums the
    cotangents of every rank, not 1/m of them)."""
    G = np.random.default_rng(m).normal(size=(m, 256)).astype(np.float32)
    ge = 2.0 * np.broadcast_to(G.sum(0), G.shape)  # d/dx_i of sum(sum_j x_j)^2
    g32 = np.stack(pool.run(psum_grad, G, 32, world=m))
    np.testing.assert_allclose(g32, ge, rtol=1e-4, atol=1e-4)
    g8 = np.stack(pool.run(psum_grad, G, 8, world=m))
    assert np.all(np.isfinite(g8)) and np.linalg.norm(g8) > 0
    cos = float((g8 * ge).sum() / (np.linalg.norm(g8) * np.linalg.norm(ge)))
    assert cos > 0.95
    assert 0.8 < float(np.linalg.norm(g8) / np.linalg.norm(ge)) < 1.2
