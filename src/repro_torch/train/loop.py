"""The fault-tolerant training loop (port of ``repro.train.loop``).

Responsibilities: restore-or-init, host prefetch, the step, periodic +
preemption checkpointing, NaN-skip accounting, straggler flagging, bounded
retry on step failure. Pure orchestration — all math lives in step.py.
"""
from __future__ import annotations

import os

import torch

from ..ckpt import checkpoint
from ..data.pipeline import Prefetcher, make_batch
from ..models import init_params
from ..optim import adamw
from . import fault
from .step import init_train_state, make_train_step


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               opt_cfg=None, schedule_fn=None, ckpt_dir: str | None = None,
               ckpt_every: int = 50, microbatches: int = 1,
               compress: bool = False, seed: int = 0, log=print,
               max_retries: int = 2, device=None):
    """Returns (model, history dict), with the reference's history keys and
    log lines. ``convert.lm_params_to_numpy(model)`` is the reference's
    returned ``params`` (the merged trainable and frozen tree).

    Where the port differs from the reference: the weights come from
    ``models.init_params(cfg, seed, device=device)`` (the reference's
    ``jax.random`` draws are not reproduced; a resumed run takes every
    trainable leaf and moment from its checkpoint); the step is
    ``make_train_step``'s, which updates the model and the optimizer state
    in place (no jit, no donation); each numpy batch is moved to the
    model's device; a checkpoint is ``checkpoint.train_state`` (the
    reference's keys), and a restore copies into the model and the state in
    place, then refreshes the serving heads. ``device=None`` means the CUDA
    card, and raises without one unless ``device="cpu"`` is asked for."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    schedule_fn = schedule_fn or (lambda s: 1.0)

    model = init_params(cfg, seed, device=device)
    opt = init_train_state(model, compress)
    start = 0

    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        last = checkpoint.latest_step(ckpt_dir)
        if last is not None:
            _, manifest = checkpoint.restore(
                ckpt_dir, last, checkpoint.train_state(model, opt),
                model=model)
            start = manifest["step"]
            log(f"[ckpt] resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, schedule_fn, microbatches,
                              compress)

    prefetch = Prefetcher(
        lambda s: make_batch(cfg, batch=batch, seq=seq, step=s, seed=seed),
        start_step=start)
    guard = fault.PreemptionGuard()
    timer = fault.StepTimer()
    history = {"loss": [], "step_time": [], "skipped": 0, "stragglers": 0,
               "retries": 0}

    def save(step):
        if ckpt_dir:
            checkpoint.save(ckpt_dir, step, checkpoint.train_state(model, opt),
                            meta={"arch": cfg.arch_id, "seq": seq,
                                  "batch": batch})

    step = start
    try:
        while step < steps:
            got_step, np_batch = prefetch.get()
            assert got_step == step, (got_step, step)
            batch_dev = {k: torch.as_tensor(v, device=model.device)
                         for k, v in np_batch.items()}

            def run_one():
                timer.start()
                metrics = step_fn(model, opt, batch_dev)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt, straggler = timer.stop()
                return metrics, dt, straggler

            def recover(attempt):
                history["retries"] += 1
                last = checkpoint.latest_step(ckpt_dir) if ckpt_dir else None
                if last is not None:
                    checkpoint.restore(ckpt_dir, last,
                                       checkpoint.train_state(model, opt),
                                       model=model)

            metrics, dt, straggler = fault.with_retries(
                run_one, recover, max_retries=max_retries, log=log)
            history["loss"].append(metrics["loss"])
            history["step_time"].append(dt)
            history["skipped"] += int(metrics["skipped"])
            history["stragglers"] += int(straggler)
            if straggler:
                log(f"[straggler] step {step} took {dt:.2f}s "
                    f"(ewma {timer.ewma:.2f}s)")
            if step % 10 == 0:
                log(f"step {step:5d} loss {metrics['loss']:.4f} "
                    f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f} ms")
            step += 1
            if ckpt_dir and (step % ckpt_every == 0 or guard.requested):
                save(step)
            if guard.requested:
                log(f"[preempt] SIGTERM at step {step}: saved and exiting")
                break
    finally:
        prefetch.close()
        guard.restore()
    save(step)
    return model, history
