"""Known-answer tests for the port's dispatch-level cost counter
(``repro_torch.roofline``), carried over from the reference's
``tests/test_roofline.py`` (one matmul, a 10-step loop, a nested 5 x 10
loop, bytes that scale with the loop), plus what only the port has to get
right: a DTensor matmul on a fake 16 x 16 mesh counts the local shard's
FLOPs alone, a redistribute counts its all-gather's bytes, and
``decode_attn`` traced on fake ``cuda`` tensors is one custom-op call with
its FLOPs and bytes and no launch.
"""
import math

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.decode_attn.ops import decode_attn  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.roofline import COLLECTIVES, CostCounter, analyze  # noqa: E402


def test_single_matmul_flops():
    x, w = torch.randn(64, 32), torch.randn(32, 16)
    c = analyze(lambda a, b: a @ b, x, w)
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)  # operands + result


def test_loop_counts_every_iteration():
    """The reference multiplies a scan body by its trip count; an eager loop
    runs (and is counted) every time."""
    x, w = torch.randn(128, 128), torch.randn(10, 128, 128)

    def f(c, ws):
        for wi in ws:
            c = c @ wi
        return c

    assert analyze(f, x, w).flops == 10 * 2 * 128 ** 3


def test_nested_loop():
    x, ws = torch.randn(128, 128), torch.randn(5, 10, 128, 128)

    def g(c, ws):
        for outer in ws:
            for wi in outer:
                c = c @ wi
        return c

    assert analyze(g, x, ws).flops == 50 * 2 * 128 ** 3


def test_bytes_nonzero_and_scale_with_loop():
    from torch._subclasses.fake_tensor import FakeTensorMode

    def f(c):
        for _ in range(7):
            c = torch.tanh(c) * 2.0
        return c

    with FakeTensorMode():
        c = analyze(f, torch.empty(1024, 1024))
    # at least 7 x (read + write) of the 4 MB buffer
    assert c.bytes >= 7 * 2 * 4 * 1024 * 1024 * 0.9
    assert c.flops == 0 and c.collective_bytes == 0


def _fake_dtensor(mesh, local, placements, shape):
    from torch.distributed.tensor import DTensor

    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(torch.empty(local), mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def test_dtensor_matmul_counts_the_local_shard_only():
    """FlopCounterMode counts such a matmul twice over (the global product
    and the shard's: 17,246,978,048); the counter hands DTensor ops on and
    counts the local ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard

    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            d = _fake_dtensor(mesh, (16, 256), [Shard(0), Shard(1)], (256, 4096))
            w = _fake_dtensor(mesh, (256, 512), [Shard(0), Shard(1)], (4096, 8192))
            with CostCounter() as counter:
                y = d @ w
    assert counter.calls["aten::mm"] == 1
    assert counter.cost.flops == 2 * 256 * 256 * 512  # the shard's product alone
    assert tuple(y.shape) == (256, 8192)
    assert counter.cost.collective_bytes > 0  # the operands' gathers to that product


def test_redistribute_counts_its_all_gather_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            x = _fake_dtensor(mesh, (16, 256), [Shard(0), Shard(1)], (256, 4096))
            with CostCounter() as counter:
                z = x.redistribute(mesh, [Shard(0), Replicate()])
    assert tuple(z.to_local().shape) == (16, 4096)
    gathered = 16 * 4096 * 4  # the all-gather's result over the 16-wide model axis
    assert counter.cost.collectives == {k: (gathered if k == "all-gather" else 0.0)
                                        for k in COLLECTIVES}
    assert counter.cost.collective_bytes == gathered
    assert counter.cost.flops == 0


def test_decode_attn_traces_as_a_custom_op_without_a_launch():
    """Fake ``cuda`` tensors take the kernel's path (``runtime.choose``) and
    its custom op's fake implementation: one call, 4 B KV G S hd FLOPs, q,
    K, V and kpos read once and the output written once, no launch; a CPU
    tensor still takes the plain version, a meta tensor still raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, S, KV, G, hd = 4, 4096, 4, 2, 256
    runtime.reset_launches()
    with FakeTensorMode():
        q = torch.empty(B, KV, G, hd, device="cuda", dtype=torch.bfloat16)
        K = torch.empty(B, S, KV, hd, device="cuda", dtype=torch.bfloat16)
        kpos = torch.empty(B, S, device="cuda", dtype=torch.int32)
        pos = torch.empty((), device="cuda", dtype=torch.int32)
        with CostCounter() as counter:
            out = decode_attn(q, K, K, kpos, pos, window=4096, softcap=50.0)
    assert tuple(out.shape) == (B, KV, G, hd) and out.dtype == torch.float32
    assert out.device.type == "cuda"
    assert counter.calls == {"repro_torch::decode_attn": 1}
    assert counter.cost.flops == 4 * B * KV * G * S * hd
    assert counter.cost.bytes == 2 * B * KV * G * hd + 2 * 2 * B * S * KV * hd + 4 * B * S \
        + 4 * B * KV * G * hd
    assert runtime.launches()["decode_attn"] == 0
    with CostCounter() as counter:
        decode_attn(torch.zeros(1, 1, 1, 8), torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8),
                    torch.zeros(1, 4, dtype=torch.int32), 3)
    assert "repro_torch::decode_attn" not in counter.calls
    with pytest.raises(ValueError, match="meta"):
        decode_attn(*(torch.empty(s, device="meta") for s in ((1, 1, 1, 8), (1, 4, 1, 8),
                                                               (1, 4, 1, 8), (1, 4))), 3)
