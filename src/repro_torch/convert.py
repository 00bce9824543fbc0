"""State and weights carried between the JAX reference and the port.

The PIM simulator has no weights; what crosses is device state and
programs. State crosses as numpy arrays: the reference's uint32 rows become int32
tensors by a dtype view (no value changes), meter fields float32/int32
0-d or ``(n_slots,)`` tensors. Programs cross as ``pim-trace`` text
(``PimProgram.to_trace()`` / ``to_trace_device()`` on one side,
``from_trace*`` on the other), which both packages read and write byte for
byte.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.pim.device import DeviceConfig, DeviceState
from .core.pim.state import (FLOAT_FIELDS, INT_FIELDS, CostMeter,
                             SubarrayState, as_rows, resolve_device)
from .core.pim.timing import DDR3Timing

_ROW_FIELDS = ("bits", "mig_top", "mig_bot", "dcc")


def meter_from_numpy(meter: dict, device=None) -> CostMeter:
    device = resolve_device(device)
    fields = {k: torch.from_numpy(np.array(meter[k], np.float32)).to(device)
              for k in FLOAT_FIELDS}
    fields.update({k: torch.from_numpy(np.array(meter[k], np.int32))
                   .to(device) for k in INT_FIELDS})
    return CostMeter(**fields)


def subarray_from_numpy(bits, mig_top, mig_bot, dcc, meter: dict, *,
                        device=None) -> SubarrayState:
    """A port state from uint32 arrays (with or without a leading slot
    axis) and a ``{field: value}`` meter dict."""
    device = resolve_device(device)
    return SubarrayState(bits=as_rows(bits, device),
                         mig_top=as_rows(mig_top, device),
                         mig_bot=as_rows(mig_bot, device),
                         dcc=as_rows(dcc, device),
                         meter=meter_from_numpy(meter, device))


def device_from_numpy(config_kwargs: dict, arrays: dict,
                      host_credit_ns: float = 0.0, *,
                      device=None) -> DeviceState:
    """A port device from ``DeviceConfig`` keyword arguments (``timing``
    may be a dict of ``DDR3Timing`` fields) and the slot-batched arrays of
    :func:`to_numpy`."""
    kwargs = dict(config_kwargs)
    if isinstance(kwargs.get("timing"), dict):
        kwargs["timing"] = DDR3Timing(**kwargs["timing"])
    banks = subarray_from_numpy(
        *(arrays[k] for k in _ROW_FIELDS),
        meter={k: arrays[k] for k in FLOAT_FIELDS + INT_FIELDS},
        device=device)
    return DeviceState(banks=banks, config=DeviceConfig(**kwargs),
                       host_credit_ns=float(np.float32(host_credit_ns)))


def to_numpy(state) -> dict:
    """The inverse: ``{field: array}`` with uint32 rows, float32 and int32
    meter fields. Takes a ``SubarrayState`` or a ``DeviceState`` (its
    slot-batched banks, plus ``host_credit_ns``)."""
    out = {}
    if isinstance(state, DeviceState):
        credit = state.host_credit_ns
        out["host_credit_ns"] = np.float32(
            credit.item() if isinstance(credit, torch.Tensor) else credit)
        state = state.banks
    for k in _ROW_FIELDS:
        out[k] = getattr(state, k).cpu().numpy().view(np.uint32)
    for k in FLOAT_FIELDS + INT_FIELDS:
        out[k] = getattr(state.meter, k).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# LM weights
# ---------------------------------------------------------------------------

def _float(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact in f32
        a = a.astype(np.float32)
    elif a.dtype.kind != "f":
        raise TypeError(f"expected a float array, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _exact(a, np_dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np_dtype:
        raise TypeError(f"expected {np.dtype(np_dtype)}, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(cfg, params: dict, device=None):
    """The port's model from the reference's ``init_params`` pytree, its
    leaves as numpy arrays: the ``stack`` (transformer or Mamba layers)
    and, for an MoE config with ``first_k_dense``, the
    ``dense_head_layers``; for the hybrid, the ``blocks`` (``sub{i}`` per
    pattern entry: RG-LRU or GQA, each with its dense FFN) and the
    ``tail``; GQA or MLA attention; dense or MoE FFNs (the float32
    ``router``, the stacked experts, the ``shared`` FFN); ``lm_head``, or
    the audio frontend's ``heads``. The stacked ``(L, ...)`` layer leaves
    are sliced per layer; quantized linears keep ``w_int`` int8 and
    ``scales`` float32 exactly; the reference's float32 leaves stay
    float32 (the router; Mamba's ``dt_bias``, ``A_log`` and ``D``; RG-LRU's
    ``b_a``, ``b_x`` and ``lam``); other float weights take the config's
    dtype."""
    from .models import attention, ffn, rglru, ssm, transformer
    from .models.common import Linear, Norm, dtype_of

    device = resolve_device(device)
    dt = dtype_of(cfg)

    def flt(a, dtype=dt):
        return _float(a, dtype, device)

    def at(a, i):
        return np.asarray(a)[i]

    def norm(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: at(a, i))
        return Norm(flt(pick(p["w"])),
                    flt(pick(p["b"])) if "b" in p else None)

    def lin(p, i):
        b = flt(at(p["b"], i)) if "b" in p else None
        if "w_int" in p:
            return Linear(w_int=_exact(at(p["w_int"], i), np.int8, device),
                          scales=_exact(at(p["scales"], i), np.float32,
                                        device), b=b)
        return Linear(flt(at(p["w"], i)), b=b)

    def dense(f, i):
        return ffn.DenseFFN(lin(f["w1"], i), lin(f["w2"], i),
                            lin(f["w3"], i) if "w3" in f else None)

    def leaves(p, i, names, f32=()):
        return {k: flt(at(p[k], i), torch.float32 if k in f32 else dt)
                for k in names if k in p}

    def attn_p(a, i):
        if cfg.attn_type == "mla":
            return attention.MLA(*(flt(at(a[k], i)) for k in (
                "w_dkv", "kv_norm", "w_uk", "w_uv", "w_q", "w_o")))
        return attention.GQA(**leaves(a, i, ("wq", "wk", "wv", "wo", "bq",
                                             "bk", "bv", "q_norm",
                                             "k_norm")))

    def ffn_p(f, i, moe):
        if not moe:
            return dense(f, i)
        shared = dense(f["shared"], i) if "shared" in f else None
        return ffn.MoEFFN(flt(at(f["router"], i), torch.float32),
                          *(flt(at(f[k], i)) for k in ("w1", "w3", "w2")),
                          shared)

    def n_of(stack, ln="ln1"):
        return np.asarray(stack[ln]["w"]).shape[0]

    def layers_of(stack, moe):
        return [transformer.TFLayer(norm(stack["ln1"], i),
                                    attn_p(stack["attn"], i),
                                    norm(stack["ln2"], i),
                                    ffn_p(stack["ffn"], i, moe))
                for i in range(n_of(stack))]

    def mamba_layers(stack):
        mix = stack["mix"]
        return [transformer.MambaLayer(norm(stack["ln"], i), ssm.Mamba(
            **leaves(mix, i, ("in_proj", "conv_w", "conv_b", "x_proj",
                              "dt_proj", "dt_bias", "A_log", "D",
                              "out_proj", "dt_norm", "b_norm", "c_norm"),
                     f32=("dt_bias", "A_log", "D"))))
            for i in range(n_of(stack, "ln"))]

    def subs(stack):
        def mix(m, i):
            if "lam" not in m:
                return attn_p(m, i)
            return rglru.RGLRU(**leaves(
                m, i, ("w_in", "w_gate_branch", "conv_w", "conv_b", "w_a",
                       "b_a", "w_x", "b_x", "lam", "w_out"),
                f32=("b_a", "b_x", "lam")))
        return [transformer.HybridSub(norm(stack["ln1"], i),
                                      mix(stack["mix"], i),
                                      norm(stack["ln2"], i),
                                      dense(stack["mlp"], i))
                for i in range(n_of(stack))]

    layers, blocks, tail = [], [], []
    if cfg.family == "ssm":
        layers = mamba_layers(params["stack"])
    elif cfg.rglru is not None:
        per_sub = [subs(params["blocks"][f"sub{j}"])
                   for j in range(len(cfg.rglru.pattern))]
        blocks = [list(block) for block in zip(*per_sub)]
        tail = subs(params["tail"]) if "tail" in params else []
    else:
        layers = layers_of(params["stack"], cfg.moe is not None)
    dense_head = (layers_of(params["dense_head_layers"], False)
                  if "dense_head_layers" in params else [])
    lm_head = flt(params["lm_head"]) if "lm_head" in params else None
    heads = flt(params["heads"]) if "heads" in params else None
    return transformer.LM(cfg, flt(params["embed"]), layers,
                          norm(params["final_norm"]), lm_head,
                          dense_head_layers=dense_head, heads=heads,
                          blocks=blocks, tail=tail)


def _numpy_leaf(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: floats as float32 (a bf16 value is exact in
    float32), int8 codes as int8."""
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.is_floating_point() else t).numpy()


def lm_params_to_numpy(model, *, grads: bool = False) -> dict:
    """The reverse of :func:`lm_params_from_numpy`: the model's parameters
    as the reference's ``init_params`` pytree of numpy arrays (stacked
    layers along a leading axis; floats as float32, codes as int8). With
    ``grads``, each floating leaf's ``.grad`` instead (zeros where the
    loss does not reach it, e.g. the audio frontend's unused ``embed``) and
    no codes: the tree ``jax.grad`` gives over the reference's
    ``adamw.partition`` trainable tree, laid on the port's names."""
    from .models.transformer import param_tree

    def leaf(x):
        ts = x if isinstance(x, list) else [x]
        if grads:
            if not ts[0].is_floating_point():
                return None
            ts = [torch.zeros_like(t) if t.grad is None else t.grad
                  for t in ts]
        arrs = [_numpy_leaf(t) for t in ts]
        return np.stack(arrs) if isinstance(x, list) else arrs[0]

    def walk(tree):
        out = {}
        for k, v in tree.items():
            got = walk(v) if isinstance(v, dict) else leaf(v)
            if got is not None and not (isinstance(got, dict) and not got):
                out[k] = got
        return out

    return walk(param_tree(model))
