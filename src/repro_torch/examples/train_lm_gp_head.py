"""Train a small language model, then fit a distributed GP readout on its
features with the paper's quantized-gram protocol — counterpart of the
repository's ``examples/train_lm_gp_head.py``, on the port.

Stage 1: xlstm-125m (the reduced variant) on synthetic LM data
         (``lm_batch_stream``, seed 0), ``make_train_step`` at peak lr 1e-3.
Stage 2: features of 40 more batches through ``forward(kind="prefill")``:
         a 16-dim random projection of the mean-pooled logits, and as the
         probe target the mean next-token entropy; split across 8
         simulated machines, then the full GP, rBCM (zero rate) and
         ``single_center_gp(gram_mode="direct")`` readouts at each rate.

The projection is drawn from a torch generator seeded 7 and the machine
split from one seeded 1 (the reference draws both with ``jax.random``,
which has no PyTorch counterpart).

Run:  python -m repro_torch.examples.train_lm_gp_head --steps 200 [--device cpu]
(the CUDA card by default; PYTHONPATH=src if not installed).
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm_gp_head")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--bits", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--gp-steps", type=int, default=100, help="Adam steps of each GP readout")
    ap.add_argument("--feature-batches", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import poe_baseline, single_center_gp, split_machines, train_gp
    from repro_torch.core.protocols.base import resolve_device
    from repro_torch.data import lm_batch_stream
    from repro_torch.models import forward, init_train_state, make_train_step, param_count

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params, opt = init_train_state(cfg, seed=0, device=dev)
    print(f"stage 1: train {cfg.name} ({param_count(params) / 1e6:.1f}M params reduced) "
          f"for {args.steps} steps on {dev}")
    step = make_train_step(cfg, peak_lr=1e-3, warmup=20, total_steps=args.steps)
    stream = lm_batch_stream(cfg.vocab_size, args.batch, args.seq, seed=0, device=dev)
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, next(stream))
        losses.append(m["loss"])
        if (i + 1) % 50 == 0:
            print(f"  step {i+1:4d} loss {float(m['loss']):.4f}")

    print("stage 2: distributed GP readout on backbone features")
    gen = torch.Generator(device=dev).manual_seed(7)
    proj = torch.randn((cfg.vocab_size, 16), generator=gen, device=dev) / np.sqrt(cfg.vocab_size)

    @torch.no_grad()
    def feat_fn(batch):
        logits, _ = forward(params, cfg, batch, kind="prefill")
        logp = torch.log_softmax(logits.float(), dim=-1)
        ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
        f = torch.mean(logits.float(), dim=1) @ proj
        return f, torch.mean(ent, dim=1)

    Xs, ys = [], []
    for _ in range(args.feature_batches):
        f, t = feat_fn(next(stream))
        Xs.append(f.cpu().numpy())
        ys.append(t.cpu().numpy())
    X = np.concatenate(Xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.float32)
    y = (y - y.mean()).astype(np.float32)
    X = ((X - X.mean(0)) / (X.std(0) + 1e-6)).astype(np.float32)
    n_tr = int(0.8 * len(y))
    Xt, yt = X[n_tr:], y[n_tr:]
    X, y = X[:n_tr], y[:n_tr]
    sm = lambda mu: float(np.mean((yt - mu.detach().cpu().numpy()) ** 2) / max(np.var(yt), 1e-9))
    to = lambda a: torch.from_numpy(a).to(dev)

    smse = {}
    full = train_gp(to(X), to(y), kernel="se", steps=args.gp_steps)
    smse["full"] = sm(full.predict(to(Xt))[0])
    print(f"  full GP readout        smse={smse['full']:.4f}")
    parts = split_machines(X, y, 8, torch.Generator().manual_seed(1))
    mu, _, _ = poe_baseline(parts, Xt, kernel="se", method="rbcm", steps=args.gp_steps,
                            device=dev)
    smse["rbcm"] = sm(mu)
    print(f"  rBCM (zero rate)       smse={smse['rbcm']:.4f}")
    wire = {}
    for bits in args.bits:
        model = single_center_gp(parts, bits, kernel="se", steps=args.gp_steps,
                                 gram_mode="direct", device=dev)
        smse[bits], wire[bits] = sm(model.predict(to(Xt))[0]), model.wire_bits
        print(f"  quantized-gram R={bits:3d}   smse={smse[bits]:.4f} "
              f"wire={wire[bits] / 1e3:.0f} kbit")
    return {"losses": [float(v) for v in losses], "smse": smse, "wire_bits": wire,
            "n_features": X.shape[0] + Xt.shape[0]}


if __name__ == "__main__":
    main()
