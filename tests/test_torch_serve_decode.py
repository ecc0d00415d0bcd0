"""repro_torch's decode-serving entry point and example on the CPU, in-process:
``repro_torch.launch.serve --device cpu --reduce`` for xlstm-125m (no
attention) and gemma2-2b (local rings, softcaps; its ring wraps at
prompt 32 + gen 16 past the reduced window of 32), and
``repro_torch.examples.serve_decode``.  Each prints the generated token
ids; its tokens are the greedy argmax of the port's own decode
step, run again here step by step, and its ``decode_attn`` calls a step
are the family's count."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples.serve_decode import main as example_main  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attn_launches_per_step, cast_compute, decode_step, init_decode_state, init_model,
)


@pytest.mark.parametrize("arch", ["xlstm-125m", "gemma2-2b"])
def test_serve_cli_on_cpu(arch, capsys):
    out = main(["--arch", arch, "--reduce", "--device", "cpu", "--batch", "2",
                "--prompt-len", "32", "--gen", "16"])
    text = capsys.readouterr().out
    assert "generated token ids" in text and "ms/step" in text
    cfg = get_config(arch).reduced()
    assert out["tokens"].shape == (2, 16) and out["steps"] == 47
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert out["attn_launches"] == 0  # the CPU runs the plain version: no kernel launch
    assert str(out["tokens"][0].tolist()) in text

    # the same greedy decode, step by step, from the same weights and prompt
    params = cast_compute(init_model(cfg, seed=0, device="cpu"))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    state = init_decode_state(cfg, 2, 48, "cpu")
    toks, tok = [], None
    with torch.no_grad():
        for p in range(47):
            t = torch.from_numpy(prompt[:, p:p + 1]) if p < 32 else tok
            logits, state = decode_step(params, cfg, state, t, torch.tensor(p, dtype=torch.int32))
            tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(torch.int32)
            if p >= 31:
                toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), out["tokens"])
    if arch == "gemma2-2b":
        local = out["state"]["pairs"]["local"]["kpos"]
        assert int(local.min()) == 47 - 32 and int(local.max()) == 46  # the ring wrapped
    expected = {"xlstm-125m": 0, "gemma2-2b": cfg.num_layers}[arch]
    assert attn_launches_per_step(cfg) == expected


def test_serve_decode_example_on_cpu(capsys):
    out = example_main(["--arch", "gemma2-2b", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--gen", "6"])
    text = capsys.readouterr().out
    assert "generated token ids" in text and "request 1:" in text
    assert out["tokens"].shape == (2, 6)


def test_launches_per_step_by_family():
    counts = {a: attn_launches_per_step(get_config(a)) for a in
              ("gemma-7b", "gemma2-2b", "internvl2-2b", "arctic-480b", "zamba2-2.7b",
               "whisper-medium", "xlstm-125m")}
    assert counts == {"gemma-7b": 28, "gemma2-2b": 26, "internvl2-2b": 24, "arctic-480b": 35,
                      "zamba2-2.7b": 9, "whisper-medium": 48, "xlstm-125m": 0}
