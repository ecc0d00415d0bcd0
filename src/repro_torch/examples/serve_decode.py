"""Serve a small model with batched requests: prefill each prompt, then
decode with the per-family cache machinery (ring caches for sliding-window
layers, recurrent state for ssm/hybrid) — counterpart of the repository's
``examples/serve_decode.py``, on the port, through
``repro_torch.launch.serve.serve``.

Run:  python -m repro_torch.examples.serve_decode --arch gemma2-2b --gen 24 [--device cpu]
(the CUDA card by default; PYTHONPATH=src if not installed).
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_decode")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.protocols.base import resolve_device
    from repro_torch.launch.serve import serve

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=dev)
    print(f"arch={cfg.name} (reduced) batch={args.batch} on {dev}: {out['steps']} steps, "
          f"{1e3 * out['seconds'] / out['steps']:.1f} ms/step")
    for b, row in enumerate(out["tokens"]):
        print(f"request {b}: generated token ids {row.tolist()}")
    return out


if __name__ == "__main__":
    main()
