"""One run of a smoke model's main paths, plain or on a mesh, for the
sharded-model parity test (``tests/test_torch_dist.py``): the loss, a
prefill and one decode step, and one training step from a resumed
optimizer state. The inputs, the weights and the moments come from seeds,
so that a plain run in one process and a run on the ranks of a mesh see
the same values. Every result comes back as a numpy array under a flat
key, DTensors gathered (a collective: every rank calls ``drive`` in the
same order)."""
import numpy as np
import torch

B, S, EXTRA = 4, 32, 8                # batch, prompt, cache slots beyond it


def inputs(cfg) -> tuple[dict, dict]:
    """(batch, next-token inputs) of the config's frontend, from a seed."""
    rng = np.random.default_rng(0)
    D, V = cfg.d_model, cfg.vocab_size

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if cfg.frontend == "audio_frames":
        labels = rng.integers(0, V, (B, S, cfg.n_codebooks))
        return ({"frame_embeds": normal(B, S, D),
                 "labels": torch.from_numpy(labels),
                 "mask": torch.ones(B, S)},
                {"frame_embeds": normal(B, 1, D)})
    text = S - (cfg.n_patches if cfg.frontend == "vision_patches" else 0)
    tok = torch.from_numpy(rng.integers(0, V, (B, text + 1)))
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous(),
             "mask": torch.from_numpy(
                 (rng.random((B, text)) < 0.9).astype(np.float32))}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = normal(B, cfg.n_patches, D)
    return batch, {"tokens": tok[:, -1:].contiguous()}


def _full(x):
    if isinstance(x, dict):
        return {k: _full(v) for k, v in x.items()}
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()


def _flat(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.array(_full(tree).detach())


def _resume(opt: dict, leaves) -> None:
    """Moments of a resumed run (random, the second positive) at step 7,
    per leaf in the reference's stacked layout; a moment that is a DTensor
    takes its own shard of them."""
    from torch.distributed.tensor import distribute_tensor
    rng = np.random.default_rng(1)
    i = 0
    with torch.no_grad():
        for j, (_, ts, stacked) in enumerate(leaves):
            shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            for key, v in (("mu", rng.standard_normal(shape) * 1e-2),
                           ("nu", rng.random(shape) * 1e-3 + 1e-4)):
                v = torch.from_numpy(v.astype(np.float32))
                if "leaves" in opt:                  # stacked DTensors
                    dst = opt[key][j]
                    dst.copy_(distribute_tensor(
                        v, dst.device_mesh, dst.placements,
                        src_data_rank=None))
                else:                                # per-layer tensors
                    for t, row in zip(opt[key][i:i + len(ts)],
                                      v if stacked else [v]):
                        t.copy_(row)
            i += len(ts)
        opt["step"].copy_(torch.tensor(7, dtype=torch.int32))


def _moments(opt: dict, leaves) -> dict:
    """Each leaf's moments, stacked as the reference stacks them."""
    out, i = {}, 0
    for j, (path, ts, stacked) in enumerate(leaves):
        for key in ("mu", "nu"):
            if "leaves" in opt:
                v = _full(opt[key][j])
            else:
                rows = opt[key][i:i + len(ts)]
                v = torch.stack(rows) if stacked else rows[0]
            out[f"train/{key}/{path}"] = v.detach().numpy()
        i += len(ts)
    return out


def drive(arch: str, mesh=None) -> dict:
    """The smoke model of ``arch`` at float32, plain, or on ``mesh`` (a
    (data, model) DeviceMesh) with its parameters, optimizer state, batch
    and caches placed by ``launch.sharding``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.launch import sharding
    from repro_torch.models import (decode_step, init_params, loss_fn,
                                    param_tree, prefill)
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.step import (init_sharded_train_state,
                                        init_train_state, make_train_step,
                                        opt_layout, trainable_leaves)

    cfg = configs.get_config(arch, smoke=True, dtype="float32")
    batch, nxt = inputs(cfg)
    model = init_params(cfg, 3, device="cpu")

    def place(tree, sh):
        if mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: place(v, sh[k]) for k, v in tree.items()}
        return distribute_tensor(tree, mesh, sh.placements,
                                 src_data_rank=None)

    if mesh is not None:
        p_shard, _ = sharding.param_shardings(cfg, mesh, model)
        sharding.distribute_model(model, mesh, p_shard,
                                  sharding.serving_shardings(model, p_shard))
        batch = place(batch, sharding.batch_shardings(mesh, batch, B))
        nxt = place(nxt, sharding.batch_shardings(mesh, nxt, B))
    out: dict = {}
    with torch.no_grad():
        out["loss"] = _full(loss_fn(cfg, model, batch)[0]).numpy()
    prompt = {k: v for k, v in batch.items() if k not in ("labels", "mask")}
    logits, caches = prefill(cfg, model, prompt, S + EXTRA, device="cpu")
    out["prefill/logits"] = _full(logits).numpy()
    _flat("prefill/caches", caches, out)
    # decode from prefill's own caches, and from the same caches placed by
    # the rule engine (as a server that restores them would hold them)
    placed = _copy(_full(caches))
    if mesh is not None:
        placed = place(placed, sharding.cache_shardings(mesh, placed, B))
    for name, c in (("decode", caches), ("decode_placed", placed)):
        logits, c = decode_step(cfg, model, nxt, S, c, device="cpu")
        out[f"{name}/logits"] = _full(logits).numpy()
        _flat(f"{name}/caches", c, out)

    leaves = trainable_leaves(model)
    if mesh is None:
        opt = init_train_state(model)
    else:
        layout = opt_layout(model)
        opt = init_sharded_train_state(
            model, sharding.opt_shardings(mesh, layout, p_shard))
    _resume(opt, leaves)
    step = make_train_step(cfg, adamw.AdamWConfig(), lambda s: 1.0)
    metrics = step(model, opt, batch)
    for k in ("loss", "ce_loss", "aux_loss", "grad_norm", "skipped"):
        out[f"train/{k}"] = np.asarray(_full(torch.as_tensor(metrics[k])))
    for path, leaf in tree_leaves(param_tree(model)):
        v = torch.stack([_full(t) for t in leaf]) \
            if isinstance(leaf, list) else _full(leaf)
        out[f"train/params/{path}"] = v.detach().numpy()
    out.update(_moments(opt, leaves))
    out["train/step"] = _full(opt["step"]).numpy()
    return out


def moe_layer(arch: str, mesh=None) -> dict:
    """The first MoE layer of ``arch``'s float32 smoke model alone, on the
    same input (plain, or on ``mesh`` with the batch over "data" and the
    experts over "model"): its output, aux term, and the gradients of a
    fixed projection of the output plus the aux term with respect to the
    input, the router and the experts."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.launch import sharding
    from repro_torch.models import init_params, trainable
    from repro_torch.models.ffn import MoEFFN, moe_ffn

    cfg = configs.get_config(arch, smoke=True, dtype="float32")
    model = init_params(cfg, 3, device="cpu")
    if mesh is not None:
        p_shard, _ = sharding.param_shardings(cfg, mesh, model)
        sharding.distribute_model(model, mesh, p_shard)
    trainable(model)                                 # gradients on
    p = next(layer.ffn for _, _, _, layer in model.walk()
             if isinstance(getattr(layer, "ffn", None), MoEFFN))
    rng = np.random.default_rng(2)
    x, w = (torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                             .astype(np.float32)) for _ in range(2))
    if mesh is not None:
        pl = sharding.NamedSharding(mesh, ("data", None, None)).placements
        x, w = (distribute_tensor(t, mesh, pl, src_data_rank=None)
                for t in (x, w))
    x.requires_grad_(True)
    y, aux = moe_ffn(cfg, p, x)
    wrt = {"x": x, "router": p.router, "w1": p.w1, "w3": p.w3, "w2": p.w2}
    grads = torch.autograd.grad((y * w).sum() + aux, list(wrt.values()))
    out = {"y": np.array(_full(y).detach()),
           "aux": np.array(_full(aux).detach())}
    out.update({f"grad/{k}": np.array(_full(g)) for k, g in zip(wrt, grads)})
    return out
