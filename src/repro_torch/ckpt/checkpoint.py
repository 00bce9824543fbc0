"""Atomic checkpoints in the reference's layout (port of
``repro.ckpt.checkpoint``).

Layout:  <dir>/step_<N>/
             manifest.json            (step, flat keys, shapes, dtypes, meta)
             host0.npz                (every array)

Properties:
  * atomic    — written to step_<N>.tmp.<pid> then os.rename'd; a crash can
                never leave a half-valid checkpoint visible.
  * resumable — ``latest_step`` scans for the newest complete manifest;
                retention keeps the last K checkpoints.
  * in place  — ``restore`` copies into the skeleton's tensors
                (``copy_``), so whatever holds their addresses (the
                optimizer state, ``greedy_generate``'s captured graphs)
                stays valid.

``save`` writes one process's whole arrays, so ``host0.npz`` holds every
array, as the reference's single host writes it. ``restore`` re-shards:
a leaf on a mesh takes only its own shard of the stored array, whatever
mesh the checkpoint was saved from (elastic restore). Keys are the
reference's: dict keys sorted, list indices, joined by "/"
(``_flatten``); a :class:`Stacked` leaf, one tensor per layer, is saved
as one array stacked along a leading axis, as the reference stacks its
layers. The checkpoints of the two packages read
each other bit for bit: a bfloat16 array is written as its ``uint16``
bits with manifest dtype ``"bfloat16"`` (the reference views those bits
as ``ml_dtypes.bfloat16``), and the raw two-byte void array the
reference's ``np.savez`` writes for bfloat16 is read back through the
same bits; the port never imports ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

SEP = "/"


class Stacked:
    """One checkpoint leaf made of per-layer tensors of one shape and
    dtype, saved stacked along a new leading axis."""

    def __init__(self, tensors):
        self.tensors = list(tensors)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip(SEP)] = tree
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype): a bfloat16 tensor as its uint16
    bits."""
    if isinstance(leaf, Stacked):
        leaf = torch.stack([t.detach() for t in leaf.tensors])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).cpu().numpy()
            return bits.view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor of the manifest's dtype from the stored array: bfloat16
    from its two-byte bits (``uint16``, or the reference's raw void)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)   # keeps 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree, *, meta: dict | None = None,
         keep: int = 3):
    """Save a tree of tensors, :class:`Stacked` leaves and arrays; atomic
    rename; retention of the last ``keep``."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    manifest = {"step": step, "meta": meta or {}, "keys": {}}
    for key, leaf in flat.items():
        np_arr, dtype = _to_numpy(leaf)
        manifest["keys"][key] = {"shape": list(np_arr.shape),
                                 "dtype": dtype}
        arrays[key.replace(SEP, "__")] = np_arr
    np.savez(os.path.join(tmp, "host0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(s for s in os.listdir(ckpt_dir)
                   if s.startswith("step_") and ".tmp" not in s)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, s), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for s in sorted(os.listdir(ckpt_dir)):
        if s.startswith("step_") and ".tmp" not in s:
            if os.path.exists(os.path.join(ckpt_dir, s, "manifest.json")):
                best = int(s.split("_")[1])
    return best


def _copy_into(key: str, dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst.dtype != src.dtype or tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"checkpoint key {key}: {src.dtype} "
                         f"{tuple(src.shape)}, the tensor is {dst.dtype} "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _local(src: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a whole array under ``placements``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        tuple(src.shape), mesh, placements)
    return src[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _restore_leaf(key: str, dst, src: torch.Tensor, sh) -> None:
    """Copy the stored array into ``dst`` in place: a DTensor takes its own
    shard (``to_local().copy_``), a plain tensor with a sharding ``sh``
    (``launch.sharding.NamedSharding``) the shard of ``sh``'s placements,
    any other tensor the whole array."""
    from ..models.common import is_dtensor
    if is_dtensor(dst):
        _copy_into(key, dst.to_local(),
                   _local(src, dst.device_mesh, dst.placements))
    elif sh is not None:
        _copy_into(key, dst, _local(src, sh.mesh, sh.placements))
    else:
        _copy_into(key, dst, src)


def _layer(sh):
    """A stacked leaf's sharding for its layers (the spec without its
    leading entry)."""
    if sh is None:
        return None
    from ..launch.sharding import NamedSharding
    return NamedSharding(sh.mesh, tuple(sh.spec[1:]))


def _load_into(skeleton, flat: dict, shardings: dict, prefix=""):
    """The skeleton with each leaf restored from ``flat``: tensors and
    stacked layers copied in place (on a mesh, their shards), other
    leaves replaced by the stored tensor (with a sharding, a DTensor of
    this rank's shard)."""
    if isinstance(skeleton, dict):
        return {k: _load_into(v, flat, shardings, f"{prefix}{k}{SEP}")
                for k, v in skeleton.items()}
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_load_into(v, flat, shardings,
                                         f"{prefix}{i}{SEP}")
                              for i, v in enumerate(skeleton))
    if skeleton is None:
        return None
    key = prefix.rstrip(SEP)
    src, sh = flat[key], shardings.get(key)
    if isinstance(skeleton, Stacked):
        if src.shape[0] != len(skeleton.tensors):
            raise ValueError(f"checkpoint key {key}: {src.shape[0]} "
                             f"layers, the model has "
                             f"{len(skeleton.tensors)}")
        for t, s in zip(skeleton.tensors, src):
            _restore_leaf(key, t, s, _layer(sh))
        return skeleton
    if isinstance(skeleton, torch.Tensor):
        _restore_leaf(key, skeleton, src, sh)
        return skeleton
    if sh is not None:
        from torch.distributed.tensor import DTensor
        local = _local(src, sh.mesh, sh.placements).to(sh.mesh.device_type)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False)
    return src


def restore(ckpt_dir: str, step: int, skeleton, *, model=None,
            shardings=None):
    """Load into ``skeleton``'s structure, in place: each tensor leaf (and
    each layer of a :class:`Stacked` leaf) takes the stored values by
    ``copy_``, on its own device, in its own dtype and shape (another
    raises ``ValueError``). A DTensor leaf, or a leaf with an entry in
    ``shardings`` (a tree matching the skeleton's, of
    ``launch.sharding.NamedSharding``; a stacked leaf's spec is the
    stacked one), takes only its own shard of the stored array: the mesh
    may differ from the one the checkpoint was saved on. With ``model``,
    its float32 serving heads are refreshed from the restored weights
    (``models.refresh_heads``). Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for fn in os.listdir(path):
        if fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                for k in z.files:
                    data[k.replace("__", SEP)] = z[k]
    missing = set(manifest["keys"]) - set(data)
    if missing:
        raise FileNotFoundError(f"checkpoint incomplete, missing {missing}")
    flat = {k: _from_numpy(arr, manifest["keys"][k]["dtype"])
            for k, arr in data.items()}
    tree = _load_into(skeleton, flat,
                      _flatten(shardings) if shardings is not None else {})
    if model is not None:
        from ..models import refresh_heads
        refresh_heads(model)
    return tree, manifest


def train_state(model, opt: dict) -> dict:
    """The training state as the reference's loop checkpoints it:
    ``{"train": trainable tree, "opt": {"mu", "nu", "step"[, "residual"]}}``
    with the reference's keys (``models.trainable``: every floating leaf of
    the reference's ``init_params`` tree, the int8 codes frozen, each
    stacked leaf's layers one :class:`Stacked`)."""
    from ..models.transformer import param_tree, tree_leaves
    from ..train.step import trainable_params

    paths = []
    for path, leaf in tree_leaves(param_tree(model)):
        ts = leaf if isinstance(leaf, list) else [leaf]
        if ts[0].is_floating_point():
            paths.append((path, isinstance(leaf, list), len(ts)))

    def tree_of(tensors):
        out, i = {}, 0
        for path, stacked, n in paths:
            node = out
            *parents, name = path.split(SEP)
            for p in parents:
                node = node.setdefault(p, {})
            part = tensors[i:i + n]
            node[name] = Stacked(part) if stacked else part[0]
            i += n
        return out

    state = {"train": tree_of(trainable_params(model)),
             "opt": {"mu": tree_of(opt["mu"]), "nu": tree_of(opt["nu"]),
                     "step": opt["step"]}}
    if "residual" in opt:
        state["opt"]["residual"] = tree_of(opt["residual"])
    return state
