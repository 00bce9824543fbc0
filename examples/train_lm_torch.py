"""End-to-end example on the PyTorch port: train a ~100M-param
qwen3-family model for a few hundred steps on the synthetic pipeline, with
checkpointing mid-run. Follows ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is asked for. ``--layers``
and ``--vocab`` cut the depth (12) and the vocabulary (32,000) for a quick
run on the CPU.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    # ~100M params: qwen3 family scaled down (12L, d=512, vocab 32k).
    cfg = get_config("qwen3-4b")
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=args.vocab, tie_embeddings=True,
        loss_chunk=128, dtype="float32", remat=False)
    n = cfg.n_params()
    print(f"arch={cfg.arch_id}-100m  params={n/1e6:.1f}M  "
          f"steps={args.steps}  tokens/step={args.batch * args.seq}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    sched = lambda s: warmup_cosine(s, warmup_steps=20,
                                    total_steps=args.steps)
    _, hist = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        opt_cfg=AdamWConfig(lr=3e-3, weight_decay=0.01),
        schedule_fn=sched, ckpt_dir=ckpt_dir, ckpt_every=50,
        device=args.device)

    losses = hist["loss"]
    print(f"\nloss: first10={np.mean(losses[:10]):.4f}  "
          f"last10={np.mean(losses[-10:]):.4f}  "
          f"min={min(losses):.4f}")
    print(f"step time: {np.median(hist['step_time'])*1e3:.0f} ms median; "
          f"skipped={hist['skipped']} stragglers={hist['stragglers']} "
          f"retries={hist['retries']}")
    print(f"checkpoints in {ckpt_dir}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "did not learn!"
    print("OK: loss decreased")
    return hist


if __name__ == "__main__":
    main()
