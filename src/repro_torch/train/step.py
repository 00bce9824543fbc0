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

On a mesh (the model's parameters DTensors, ``launch.sharding``) the
optimizer state is ``init_sharded_train_state``'s: the reference's tree,
one float32 moment per leaf, stacked (L, ...) for a stacked leaf, so that
ZeRO-1 can shard the layer dim over "data" as the reference does. The
step then stacks each leaf's layers and their grads, updates the stacked
leaf, gathers it back to the parameters' placements and copies each
layer in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import loss_fn, param_tree, refresh_heads, trainable
from ..models.transformer import tree_leaves
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


class Leaf:
    """A leaf's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def trainable_leaves(model) -> list:
    """(path, per-layer tensors, stacked) of each trainable leaf of the
    reference's tree, in its order; ``stacked`` for a stack's list of
    layers."""
    stacked = {path: isinstance(leaf, list)
               for path, leaf in tree_leaves(param_tree(model))}
    return [(path, ts, stacked[path]) for path, ts in trainable(model)]


def opt_layout(model, compress: bool = False) -> dict:
    """The reference's optimizer-state tree of ``model``'s trainable
    leaves as :class:`Leaf` records: ``{"mu", "nu"[, "residual"]}`` path
    trees of float32 leaves, stacked (L, ...) for a stacked leaf, and
    ``"step"``, an int32 scalar."""
    tree: dict = {}
    for path, ts, stacked in trainable_leaves(model):
        shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
        for key in ("mu", "nu") + (("residual",) if compress else ()):
            node = tree.setdefault(key, {})
            *parents, name = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = Leaf(shape, torch.float32)
    tree["step"] = Leaf((), torch.int32)
    return tree


def init_sharded_train_state(model, o_shard: dict,
                             compress: bool = False) -> dict:
    """The optimizer state on the model's mesh: each moment (and residual)
    a float32 zero DTensor of its ``launch.sharding.opt_shardings`` spec
    (ZeRO-1 included), in the reference's stacked layout; ``"leaves"``
    lists (path, layers, stacked) in the order of the trainable
    tensors."""
    from torch.distributed import tensor as dt

    from ..launch.sharding import placements
    leaves = trainable_leaves(model)
    layout = opt_layout(model, compress)
    mesh = leaves[0][1][0].device_mesh

    def zeros(key, path):
        node, sh = layout[key], o_shard[key]
        for part in path.split("/"):
            node, sh = node[part], sh[part]
        return dt.zeros(node.shape, dtype=torch.float32, device_mesh=mesh,
                        placements=placements(sh.spec, mesh))

    opt = {key: [zeros(key, path) for path, _, _ in leaves]
           for key in ("mu", "nu") + (("residual",) if compress else ())}
    opt["step"] = dt.zeros((), dtype=torch.int32, device_mesh=mesh,
                           placements=placements((), mesh))
    opt["leaves"] = [(path, len(ts), stacked) for path, ts, stacked in leaves]
    return opt


def _sharded_update(params, grads, loss, opt_state: dict,
                    opt_cfg: adamw.AdamWConfig, lr_scale, compress: bool):
    """The step's update on a mesh (``init_sharded_train_state``'s state):
    per leaf, the layers and their grads stacked, the update on the
    stacked leaf against its stacked moments, the result gathered back to
    the parameters' placements and copied into each layer. Returns
    (grad_norm, good)."""
    from torch.distributed.tensor import Shard

    from ..models.common import redistribute
    per_leaf, gl, i = [], [], 0
    for (path, n, stacked), mu in zip(opt_state["leaves"], opt_state["mu"]):
        ps, gs = params[i:i + n], grads[i:i + n]
        i += n
        per_leaf.append((ps, stacked))
        # the gradient's pending sums reduced onto the moment's shards
        # (ZeRO-1's reduce-scatter where the layers shard over "data")
        g = torch.stack(gs) if stacked else gs[0]
        gl.append(redistribute(g, mu.placements, f"adamw/{path}", "reduce"))
    if compress:
        out = [grad_compress.compress(g, r)
               for g, r in zip(gl, opt_state["residual"])]
        with torch.no_grad():
            for r, (_, _, new_r) in zip(opt_state["residual"], out):
                r.copy_(new_r)
        gl = [grad_compress.decompress(c, sc) for c, sc, _ in out]
    s = adamw.prepare(gl, opt_state, opt_cfg, lr_scale)
    good = torch.isfinite(loss) & torch.isfinite(s["grad_norm"])
    with torch.no_grad():
        for (ps, stacked), g, mu, nu in zip(per_leaf, gl, opt_state["mu"],
                                            opt_state["nu"]):
            p = torch.stack([t.detach() for t in ps]) if stacked \
                else ps[0].detach()
            new_p, new_mu, new_nu = adamw.update(
                p, g, mu, nu, opt_cfg, clip=s["clip"], bc1=s["bc1"],
                bc2=s["bc2"], lr=s["lr"])
            mu.copy_(torch.where(good, new_mu, mu))
            nu.copy_(torch.where(good, new_nu, nu))
            new_p = torch.where(good, new_p, p)
            if stacked:
                # ZeRO-1's gather: the layers back to the parameters'
                # placements (one dim further in)
                new_p = new_p.redistribute(new_p.device_mesh, [
                    Shard(pl.dim + 1) if pl.is_shard() else pl
                    for pl in ps[0].placements])
                for t, row in zip(ps, new_p.unbind(0)):
                    t.copy_(row)
            else:
                ps[0].copy_(new_p.redistribute(new_p.device_mesh,
                                               ps[0].placements))
        opt_state["step"].copy_(torch.where(good, s["step"],
                                            opt_state["step"]))
    return s["grad_norm"], good


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
        # a leaf the loss does not read (the audio frontend's embeddings)
        # has a zero gradient, as ``jax.grad`` gives it
        return loss, metrics, torch.autograd.grad(loss, params,
                                                  allow_unused=True,
                                                  materialize_grads=True)

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
        if "leaves" in opt_state:                       # on a mesh
            lr_scale = schedule_fn(opt_state["step"])
            gnorm, good = _sharded_update(params, grads, loss, opt_state,
                                          opt_cfg, lr_scale, compress)
            refresh_heads(model)
            return dict(metrics, loss=loss, grad_norm=gnorm,
                        lr_scale=torch.as_tensor(lr_scale),
                        skipped=(~good).to(torch.float32))
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
