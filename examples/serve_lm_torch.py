"""Serve a small model with batched requests on the PyTorch port: prefill
+ decode loop (on the card one CUDA-graph replay per call), PIM-quantized
(pim_w4) variant included. Follows ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is asked for. Weights are
random, made from seed 0 (the reference's ``jax.random`` draws differ).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config("qwen3-4b")
    cfg = dataclasses.replace(
        cfg, n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=768, vocab_size=8_000, tie_embeddings=True, dtype="float32",
        remat=False)
    model = init_params(cfg, 0, device=args.device)
    device = model.device
    rng = np.random.default_rng(0)
    B, S, NEW = 4, 32, 24
    prompts = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32,
        device=device)}

    t0 = time.perf_counter()
    out = greedy_generate(cfg, model, prompts, max_new_tokens=NEW,
                          device=device)
    out.cpu()
    dt = time.perf_counter() - t0
    print(f"batched greedy decode: batch={B} prompt={S} new={NEW}")
    print(f"tokens/s (incl. warm-up and capture): {B*NEW/dt:.1f}")
    for i in range(B):
        print(f"  req{i}: {out[i].cpu().numpy()[:12]} ...")

    t0 = time.perf_counter()
    out2 = greedy_generate(cfg, model, prompts, max_new_tokens=NEW,
                           device=device)
    out2.cpu()
    print(f"tokens/s (warm): {B*NEW/(time.perf_counter()-t0):.1f}")
    assert torch.equal(out, out2), "greedy decode must be deterministic"

    # The paper's technique in serving: bit-plane quantized linears.
    cfg_q = dataclasses.replace(cfg, quant="pim_w4", quant_mode="shift_add")
    model_q = init_params(cfg_q, 0, device=device)
    out_q = greedy_generate(cfg_q, model_q, prompts, max_new_tokens=8,
                            device=device)
    print(f"pim_w4 (shift-and-add bit planes) decode: {tuple(out_q.shape)} "
          "OK")
    return out, out2, out_q


if __name__ == "__main__":
    main()
