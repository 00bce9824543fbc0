"""CUDA graphs of the PIM path: the reference's single dispatch on the card.

The reference runs a warm ``execute``, ``schedule``, ``schedule_pipeline``
and ``schedule_workload`` call as ONE XLA dispatch (a ``jax.jit``, a
``lax.scan``). On the card the port runs it as one CUDA-graph replay:

- A signature's first call runs eagerly. It is the warm-up: kernels built,
  constant tables uploaded, allocator blocks made. A one-off program, such
  as a fresh VM flush, pays no capture.
- The second call captures, and it and every later call copy their
  inputs into the graph's static inputs, replay, and clone the outputs
  out. So a result never aliases a graph's buffers, a later call never
  changes what an earlier one returned, and the caller's tensors are
  never written.
- A capture or replay that fails raises: the card has no eager fallback.
  On the CPU nothing is captured; the eager run is the CPU path.

``steps`` runs K uniform steps (a pipeline): as one graph of K steps when
it holds at most ``_MAX_NODES`` nodes, else as a graph of a chunk of steps
replayed once per chunk (and one of the remainder), the chunk sized from
the nodes of the K-step graph, which is then dropped. ``phases`` runs a
sequence of such step runs back to back as one graph when it fits, else
each through ``steps``. A signature found too large is remembered in
``_seen``, so that it is captured whole only once.

The graphs live in ``_entries``, one LRU keyed on their owner (a runner,
a step plan, a workload plan: the entry pins it, so an id is never reused
while its key lives) and signature. It is bounded by the bytes each
entry's static inputs and outputs hold (``_MAX_BYTES``); evicting an entry
frees its graph. ``_seen`` remembers the signatures whose first call ran
and the chunk of those too large for one graph, by weak reference to their
owner. The tests drop the caches by clearing both.

A graph's replays move no launch counter of the kernels' wrappers: the
launches that its capture recorded (``kops.recorded``) are taken out of
the counts and kept with it as a label of its nodes; its kernels on a
replay are read from the profiler.
"""
from __future__ import annotations

import collections
import ctypes
import time
import weakref

import torch
from torch.utils import _pytree

from ...kernels.rowops import ops as kops

# A graph of more nodes than this runs its steps in chunks.
_MAX_NODES = 10_000
# The bytes the cached graphs' static inputs and outputs may hold.
_MAX_BYTES = 8 << 30
# The most graphs the cache keeps, and the most first calls it remembers.
_MAX_ENTRIES = 256
_MAX_SEEN = 4096

# key -> _Graph, least recently used first
_entries: collections.OrderedDict = collections.OrderedDict()
# key -> (weak reference to the owner, value) of a signature whose first
# call ran (value None) or whose graph was too large (value: its chunk of
# steps): one-off owners (a VM flush's runner) are neither pinned nor
# allowed to push graphs out of ``_entries``
_seen: collections.OrderedDict = collections.OrderedDict()
_capture_streams: dict = {}
# Set to a list to record every graph replayed (chip_smoke.py reads it).
_replay_log: list | None = None


def _pool_handle(dev: torch.device):
    """The one private memory pool that every PIM graph on ``dev``
    allocates from: a live graph's, or a new one when no graph lives there
    (a pool whose graphs are all gone is released, and is not handed out
    again). Sharing it is
    safe only because every replay is followed, on the same stream and
    before any other replay, by the copy of its outputs out of the graph
    (a clone, or the next chunk's copy-in): a graph captured later may lay
    its outputs over an earlier graph's scratch, which that graph's next
    replay overwrites."""
    for e in _entries.values():
        if e.device == dev:
            return e.graph.pool()
    return torch.cuda.graph_pool_handle()


def _capture(graph: torch.cuda.CUDAGraph, dev: torch.device, fn, args,
             kernels: dict):
    """``fn(*args)`` captured into ``graph`` on a side stream, allocating
    from the shared pool; the wrappers' launches it recorded go to
    ``kernels``. If ``fn`` raises (a host sync, for one, fails a capture),
    the capture is ended and the pool handed back before the error
    propagates, so that later captures still find the pool free."""
    torch.cuda.synchronize(dev)
    stream = _capture_streams.get(dev)
    if stream is None:
        stream = _capture_streams[dev] = torch.cuda.Stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        pool = _pool_handle(dev)
        graph.capture_begin(pool=pool)
        try:
            with kops.recorded(kernels):
                out = fn(*args)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                # the capture was invalidated: capture_end raised before it
                # ended the pool's allocation
                torch._C._cuda_endAllocateToPool(
                    dev.index if dev.index is not None
                    else torch.cuda.current_device(), pool)
            raise
        graph.capture_end()
    return out


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph (kept with ``keep_graph=True``), from
    libcuda's ``cuGraphGetNodes``."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {rc}")
    return n.value


def _stacked_base(fields):
    """The contiguous (..., n) tensor whose last-axis slices are exactly
    ``fields`` (a meter that came out of a stack), else None: copying it
    is one memcpy, where stacking the fields would launch a kernel."""
    base = fields[0]._base
    if (base is None or not base.is_contiguous() or base.dim() == 0
            or base.shape[-1] != len(fields)
            or base.numel() != len(fields) * fields[0].numel()):
        return None
    for j, t in enumerate(fields):
        if (t._base is not base
                or t.storage_offset() != base.storage_offset() + j
                or (t.dim() and t.numel() > 1
                    and t.stride()[-1] != len(fields))):
            return None
    return base


def stack_fields(fields) -> torch.Tensor:
    """``torch.stack(fields, -1)``: their common base itself when they are
    its slices (a graph's copy-in then moves it in one memcpy)."""
    base = _stacked_base(fields)
    if base is None:
        return torch.stack(fields, -1)
    return base.reshape(fields[0].shape + (len(fields),))


def _nbytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            n += st.nbytes()
    return n


def _leaves(tree):
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


class _Graph:
    """One captured signature: the graph, its static inputs (allocated
    outside the pool) and outputs, its nodes, the row-entry launches its
    capture recorded (``kernels``: a label of its nodes, (counter, key) ->
    count as ``kops.recorded`` gives them), the bytes it pins and the ms
    its capture took."""

    def __init__(self, owner, fn, args):
        self.owner = owner
        flat, self.in_spec = _pytree.tree_flatten(args)
        self.inputs = [torch.empty_like(t, memory_format=torch.
                                        contiguous_format)
                       if isinstance(t, torch.Tensor) else t for t in flat]
        dev = self.device = _leaves(self.inputs)[0].device
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.kernels: dict = {}
        out = _capture(self.graph, dev, fn,
                       _pytree.tree_unflatten(self.inputs, self.in_spec),
                       self.kernels)
        self.graph.instantiate()
        self.outputs, self.out_spec = _pytree.tree_flatten(out)
        self.nodes = _graph_nodes(self.graph)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.nbytes = _nbytes(_leaves(self.inputs) + _leaves(self.outputs))
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        from .exec import RUNNER_STATS
        RUNNER_STATS["traces"] += 1

    def replay(self, args) -> None:
        """Copy ``args`` into the static inputs and replay once."""
        for s, t in zip(self.inputs, _pytree.tree_leaves(args)):
            if isinstance(s, torch.Tensor):
                s.copy_(t)
        self.graph.replay()
        if _replay_log is not None:
            _replay_log.append(self)

    def __call__(self, args):
        self.replay(args)
        return _pytree.tree_unflatten(
            [t.clone(memory_format=torch.contiguous_format)
             if isinstance(t, torch.Tensor) else t for t in self.outputs],
            self.out_spec)


def _put(key, entry) -> None:
    """Insert at the MRU end; evict LRU graphs (never the newest) until the
    count and the byte budget hold."""
    _entries[key] = entry
    total = sum(e.nbytes for e in _entries.values())
    while (len(_entries) > _MAX_ENTRIES or total > _MAX_BYTES) \
            and len(_entries) > 1:
        old = _entries.pop(next(iter(_entries)))
        total -= old.nbytes
        old.graph.reset()


def _remember(key, owner, value=None) -> None:
    _seen.pop(key, None)
    _seen[key] = (weakref.ref(owner), value)
    if len(_seen) > _MAX_SEEN:
        _seen.popitem(last=False)


def _recalled(key, owner):
    """``(True, value)`` when ``key`` was remembered for this ``owner``,
    else ``(False, None)``."""
    hit = _seen.get(key)
    if hit is None or hit[0]() is not owner:
        return False, None
    return True, hit[1]


def _first_call(key, owner) -> bool:
    """True once per key and owner: the call that runs eagerly (and marks
    it)."""
    seen, _ = _recalled(key, owner)
    _remember(key, owner)
    return not seen


def first_call(calls) -> bool:
    """Whether any of ``calls``, ``(key, owner, n)`` as ``steps`` takes
    them, is on its first call; marks them all. A caller that runs several
    signatures as one sequence (``schedule_workload`` with ``order=``)
    decides once, so that its first call runs eagerly throughout."""
    firsts = [_first_call(("first", key, n), owner)
              for key, owner, n in calls]
    return any(firsts)


def _graph_for(key, owner, fn, args) -> _Graph:
    """The cached graph of ``key``, captured from ``fn(*args)`` if there is
    none (``args`` give shapes only: the capture runs nothing)."""
    hit = _entries.pop(key, None)
    if hit is None:
        hit = _Graph(owner, fn, args)
    _put(key, hit)
    return hit


def _fitting_graph(key, owner, fn, args, n: int):
    """The graph of ``key`` (``n`` steps), or None when it holds more than
    ``_MAX_NODES`` nodes: it is then dropped, and the chunk of steps that
    fits (at least one) remembered. ``(graph or None, chunk)``."""
    split, chunk = _recalled(("split",) + key, owner)
    if split:
        return None, chunk
    g = _graph_for(key, owner, fn, args)
    if g.nodes <= _MAX_NODES or n <= 1:
        return g, n
    _entries.pop(key)
    g.graph.reset()
    chunk = max(1, min(n - 1, _MAX_NODES * n // g.nodes))
    _remember(("split",) + key, owner, chunk)
    return None, chunk


def _eager(fn, args, writes):
    """``fn(*args)`` with the arguments at ``writes`` cloned first (``fn``
    writes them in place)."""
    args = list(args)
    for j in writes:
        args[j] = _pytree.tree_map(lambda t: t.clone(), args[j])
    return fn(*args)


def _on_card(args) -> bool:
    return any(t.device.type == "cuda" for t in _leaves(args))


def call(key, owner, fn, args, *, writes=()):
    """``fn(*args)`` for one signature: eagerly on the CPU and on the first
    call, else one replay of its graph."""
    if not _on_card(args) or _first_call(("first",) + key, owner):
        return _eager(fn, args, writes)
    return _graph_for(("graph",) + key, owner, fn, args)(args)


def _empty_steps(ys, n: int):
    """Buffers for ``n`` steps of ``ys`` (every leaf with a step axis)."""
    return _pytree.tree_map(
        lambda t: torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device), ys)


def _put_steps(out, ys, lo: int) -> None:
    """Copy ``ys`` into steps ``lo``.. of ``out``: memcpys on the card,
    where ``torch.cat`` would launch kernels."""
    for dst, src in zip(_leaves(out), _leaves(ys)):
        dst[lo:lo + src.shape[0]].copy_(src)


def concat_steps(ys_list):
    """Per-call ``ys`` (every leaf with a leading step axis) joined along
    it."""
    out = _empty_steps(ys_list[0],
                       sum(_leaves(ys)[0].shape[0] for ys in ys_list))
    lo = 0
    for ys in ys_list:
        _put_steps(out, ys, lo)
        lo += _leaves(ys)[0].shape[0]
    return out


def _slice(xs, lo, hi):
    return _pytree.tree_map(lambda t: t[lo:hi], xs)


def steps(key, owner, make, carry, xs, n: int, *, writes=(0,),
          first: bool | None = None):
    """``n`` uniform steps: ``make(m)`` builds ``fn(carry, xs_m) ->
    (carry, ys)`` running ``m`` steps, where every leaf of ``xs_m`` and
    ``ys`` has a leading step axis ``m``. On the CPU and on the first call
    ``make(n)`` runs eagerly; on the card else one graph of the ``n``
    steps, or chunks of them, replayed in turn: each chunk's carry is
    copied into the next replay's inputs, its ``ys`` into the result.
    ``first`` decides the first call for the caller (default: this call's
    own signature). Returns ``(carry, ys, replays)``. ``writes``: the
    argument ``fn`` writes in place (the carry), cloned for an eager
    run."""
    on_card = _on_card((carry, xs))
    if on_card and first is None:
        first = _first_call(("first", key, n), owner)
    if not on_card or first:
        c, ys = _eager(make(n), (carry, xs), writes)
        return c, ys, 0
    g, chunk = _fitting_graph(("graph", key, n), owner, make(n),
                              (carry, xs), n)
    if g is not None:
        carry, ys = g((carry, xs))
        return carry, ys, 1
    ys_full, replays, lo = None, 0, 0
    while lo < n:
        m = min(chunk, n - lo)
        g = _graph_for(("graph", key, m), owner, make(m),
                       (carry, _slice(xs, 0, m)))
        g.replay((carry, _slice(xs, lo, lo + m)))
        replays += 1
        # the graph's own outputs: copied into the next replay's inputs
        # and into the result before the graph replays again
        carry, ys = _pytree.tree_unflatten(g.outputs, g.out_spec)
        if ys_full is None:
            ys_full = _empty_steps(ys, n)
        _put_steps(ys_full, ys, lo)
        lo += m
    carry = _pytree.tree_map(
        lambda t: t.clone(memory_format=torch.contiguous_format), carry)
    return carry, ys_full, replays


def phases(key, owner, parts, carry, *, writes=(0,)):
    """Step runs back to back, the carry threaded through: ``parts`` is a
    sequence of ``(step key, step owner, make, xs, n)`` as ``steps``
    takes them. On the CPU and on the first call eagerly; on the card else
    one graph of every part when it holds at most ``_MAX_NODES`` nodes,
    else each part through ``steps``. Returns ``(carry, [ys per part],
    replays)``."""
    parts = tuple(parts)

    def make_all(c, xs_all):
        ys_all = []
        for (_, _, make, _, n), xs in zip(parts, xs_all):
            c, ys = make(n)(c, xs)
            ys_all.append(ys)
        return c, ys_all

    xs_all = [p[3] for p in parts]
    if not _on_card((carry, xs_all)) or _first_call(("first",) + key, owner):
        c, ys_all = _eager(make_all, (carry, xs_all), writes)
        return c, ys_all, 0
    g, _ = _fitting_graph(("graph",) + key, owner, make_all,
                          (carry, xs_all), sum(p[4] for p in parts))
    if g is not None:
        c, ys_all = g((carry, xs_all))
        return c, ys_all, 1
    out, replays = [], 0
    for k, o, make, xs, n in parts:
        carry, ys, r = steps(k, o, make, carry, xs, n, first=False)
        out.append(ys)
        replays += r
    return carry, out, replays
