"""The training step: microbatched grads, AdamW, NaN guard, optional int8
error-feedback gradient compression.

Port of ``repro.train.step``. The reference's step is a pure function of
(params, optimizer state, batch); the port's updates the model's
parameters and the optimizer state in place and returns the metrics, all
tensors on the model's device (no host sync):

- microbatches: the batch splits into ``microbatches`` equal slices along
  dim 0, run in order; each slice's grads (in the leaves' dtypes, from
  ``torch.autograd.grad``) are added to explicit float32 buffers, as the
  reference adds them to float32 zeros (``.grad`` would accumulate in the
  leaves' dtype, bf16);
- NaN/Inf guard: a step whose loss or grad norm is not finite changes no
  parameter, moment or step counter (``torch.where`` per leaf);
- compression: the grads pass through int8 quantize/dequantize with an
  error-feedback residual carried in the optimizer state;
- after the update the model's float32 serving heads are refreshed in
  place (``models.refresh_heads``), so that ``greedy_generate``'s graphs
  serve the trained weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import loss_fn, refresh_heads, trainable
from ..optim import adamw, grad_compress


def trainable_params(model) -> list:
    """The trainable tensors in the reference's tree order (each stacked
    leaf's layers in order), their gradient on."""
    return [t for _, ts in trainable(model) for t in ts]


def init_train_state(model, compress: bool = False) -> dict:
    """The optimizer state of ``model``'s trainable leaves (float32
    moments, step 0), with a float32 residual per leaf for compression."""
    params = trainable_params(model)
    opt = adamw.init_state(params)
    if compress:
        opt["residual"] = [torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device) for p in params]
    return opt


def _slice(batch: dict, parts: int, i: int) -> dict:
    """Microbatch ``i`` of ``parts``: equal slices along dim 0."""
    def cut(x):
        n = x.shape[0] // parts
        return x[i * n:(i + 1) * n]
    return {k: cut(v if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, schedule_fn,
                    microbatches: int = 1, compress: bool = False):
    """``step(model, opt_state, batch) -> metrics``: loss, grad_norm,
    lr_scale, skipped (1.0 for a skipped step), ce_loss, aux_loss."""

    def grads_of(model, params, batch):
        loss, metrics = loss_fn(cfg, model, batch)
        return loss, metrics, torch.autograd.grad(loss, params)

    def step(model, opt_state: dict, batch: dict) -> dict:
        params = trainable_params(model)
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, params, batch)
            loss = loss.detach()
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                l, _, g = grads_of(model, params,
                                   _slice(batch, microbatches, i))
                acc = [a + gi for a, gi in zip(acc, g)]
                lsum = lsum + l.detach()
            grads = [a / microbatches for a in acc]
            loss = lsum / microbatches
            metrics = {"ce_loss": loss,
                       "aux_loss": torch.zeros_like(loss)}
        if compress:
            codes, scales, opt_state["residual"] = \
                grad_compress.compress_tree(grads, opt_state["residual"])
            grads = grad_compress.decompress_tree(codes, scales)

        lr_scale = schedule_fn(opt_state["step"])
        s = adamw.prepare(grads, opt_state, opt_cfg, lr_scale)
        good = torch.isfinite(loss) & torch.isfinite(s["grad_norm"])
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                mu, nu = opt_state["mu"][i], opt_state["nu"][i]
                new_p, new_mu, new_nu = adamw.update(
                    p, g, mu, nu, opt_cfg, clip=s["clip"], bc1=s["bc1"],
                    bc2=s["bc2"], lr=s["lr"])
                p.copy_(torch.where(good, new_p, p))
                mu.copy_(torch.where(good, new_mu, mu))
                nu.copy_(torch.where(good, new_nu, nu))
            opt_state["step"] = torch.where(good, s["step"],
                                            opt_state["step"])
        refresh_heads(model)
        return dict(metrics, loss=loss, grad_norm=s["grad_norm"],
                    lr_scale=torch.as_tensor(lr_scale),
                    skipped=(~good).to(torch.float32))

    return step
