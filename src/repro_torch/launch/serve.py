"""Serving CLI of the port:
``PYTHONPATH=src python -m repro_torch.launch.serve --arch <id>``.

The reference CLI's flags, plus ``--device`` (the CUDA card unless
``cpu`` is asked for). Weights are random, made from seed 0, and the
prompts from numpy's generator seeded 0: the tokens, then for a
vision-patch model (llava-next-mistral-7b) its ``n_patches`` patch
embeddings, standard normal in float32, which the reference CLI does not
make (it raises ``KeyError``). Each configuration is served at its own
default (bf16, ``quant=None``), at published width and depth unless
``--smoke``: e.g. ``--arch qwen3-4b`` on the card, ``--arch
falcon-mamba-7b --smoke --device cpu`` on a host without one.
musicgen-medium takes frame embeddings, not tokens, and raises, as the
reference's does.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import greedy_generate


def prompts(cfg, batch: int, prompt_len: int, device=None) -> dict:
    """The CLI's prompts for ``cfg``: numpy's generator seeded 0, ``batch``
    rows of ``prompt_len`` tokens, then for a vision-patch model its
    ``n_patches`` patch embeddings, standard normal in float32."""
    rng = np.random.default_rng(0)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int32, device=device)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.n_patches, cfg.d_model),
                                dtype=np.float32), device=device)
    return out


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
    batch = prompts(cfg, args.batch, args.prompt_len, model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    out = greedy_generate(cfg, model, batch, max_new_tokens=args.max_new,
                          temperature=args.temperature, generator=gen,
                          device=model.device)
    for i in range(args.batch):
        print(f"req{i}: {out[i].cpu().numpy()}")


if __name__ == "__main__":
    main()
