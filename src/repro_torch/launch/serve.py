"""Serving CLI of the port:
``PYTHONPATH=src python -m repro_torch.launch.serve --arch <id>``.

The reference CLI's flags, plus ``--device`` (the CUDA card unless
``cpu`` is asked for). Weights are random, made from seed 0. Every
architecture of ``repro_torch.configs`` runs, e.g. ``--arch
falcon-mamba-7b --smoke --device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = init_params(cfg, 0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=model.device)}
    gen = torch.Generator(device=model.device).manual_seed(0)
    out = greedy_generate(cfg, model, prompts, max_new_tokens=args.max_new,
                          temperature=args.temperature, generator=gen,
                          device=model.device)
    for i in range(args.batch):
        print(f"req{i}: {out[i].cpu().numpy()}")


if __name__ == "__main__":
    main()
