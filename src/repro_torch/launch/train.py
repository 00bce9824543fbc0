"""Training CLI of the port:
``PYTHONPATH=src python -m repro_torch.launch.train --arch <id>``.

The reference CLI's flags, plus ``--device`` (the CUDA card unless
``cpu`` is asked for), e.g. ``--arch qwen3-4b --quant pim_w4`` on the card
or ``--arch qwen3-4b --smoke --device cpu``. Weights are random, made from
seed 0; the data is the reference's synthetic stream. Prints the
reference's ``done:`` line; ``main`` returns the loop's history.
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--quant", default=None, choices=[None, "pim_w4",
                                                      "pim_w8"])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=args.quant)
    sched = lambda s: warmup_cosine(s, warmup_steps=max(args.steps // 10, 1),
                                    total_steps=args.steps)
    _, hist = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        opt_cfg=AdamWConfig(lr=args.lr), schedule_fn=sched,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches, compress=args.compress_grads,
        device=args.device)
    print(f"done: {len(hist['loss'])} steps, "
          f"final loss {hist['loss'][-1]:.4f}, "
          f"skipped {hist['skipped']}, stragglers {hist['stragglers']}")
    return hist


if __name__ == "__main__":
    main()
