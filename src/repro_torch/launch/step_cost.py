"""One device's cost of a step, counted while the step runs (the counting
half of ``launch/dryrun.py``'s analysis).

``StepCost`` is a ``TorchDispatchMode``. Run a step under it, on meta
tensors or on DTensors whose local shards are meta tensors, and it counts
what one device does:

* ``flops``: FLOPs of every op in ``torch.utils.flop_counter``'s registry
  (matmuls, bmm, convolutions and their backwards; 2·M·N·K), and an op
  outside it is decomposed first, as ``FlopCounterMode`` does, so a
  step on the card under ``FlopCounterMode`` counts the same number;
* ``bytes_accessed``: operand and result bytes of every op that is not a
  view, an allocation (``empty*``) or an in-place change of metadata
  (``detach_``), each distinct element once (an
  expanded dim counts once), unfused, so an upper bound on what a fusing
  compiler moves;
* ``peak``: the most bytes of live meta storages, held arguments
  included; each storage counts once (views and in-place results
  add nothing) and is freed when its last reference dies, the caching
  allocator's own rule;
* ``collectives``: result bytes and counts of the functional collectives
  under XLA's names.

DTensors: an op on DTensors is handed to DTensor, which runs it on the
local shards; those local ops, the redistributions' collectives among
them, come back to this mode, so every count is per device with no rule
to derive it: replicated work counts in full on each device, a
contraction split over "model" counts once per shard. ``FlopCounterMode``
over DTensor operands instead counts each op at its global shapes.

Where DTensor's sharding propagation refuses an op, the mode does what a
partitioner would, and counts it under ``reshards``:

* a lookup of rows in a table sharded along its rows (``table[ids]``, the
  embedding) is vocabulary parallel: each device gathers what its rows
  hold and the partial sums are reduced;
* ``t.new_zeros(size)`` and its kin are sharded as ``t`` where ``size``
  keeps its dims (DTensor makes the global tensor on every device);
* an indexed write into a sharded tensor (``index_put_``, the decode
  cache write) is done shard by shard: indices and values are moved to
  the written tensor's placements and each device writes its rows;
* an in-place op into a plain tensor (a buffer the step made, so
  replicated implicitly) that reads DTensors replicates them and runs on
  every device's copy (the MoE dispatch's ``index_add_``);
* a convolution and its backward run data parallel: the activations keep
  only their batch sharding, weights are replicated, and the weight
  gradients are partial sums over the batch (DTensor's own convolution
  handlers refuse a batch sharded over two mesh dims, or a partial input);
* any other op is retried with its inputs replicated on one more mesh
  dim at a time, the last mesh dim first ("model" before "data"); an
  in-place op keeps its own tensor's placement.

What is still refused raises, and the caller records the op
(``failed_op``, the first to fail) and DTensor's message.
"""
from __future__ import annotations

import math
import sys
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
# functional collectives (op namespace.name) -> XLA's names
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
# bookkeeping ops of the functional collectives: they move nothing
_COLLECTIVE_NOOPS = ("_c10d_functional.wait_tensor",
                     "_c10d_functional._wrap_tensor_autograd")
aten = torch.ops.aten
# metadata queries, as FlopCounterMode leaves them alone
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}
# ops that move no data: allocations, and in-place changes of metadata
_NO_DATA = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
            aten.new_empty_strided, aten.detach_, aten.squeeze_,
            aten.unsqueeze_, aten.transpose_, aten.t_, aten.as_strided_}
_INDEXED_WRITES = {aten.index_put_.default}
# factories on a tensor (``grad.new_zeros(size)``): DTensor replicates
# their result at its global size; ``_new_like`` shards it as its tensor
_NEW_LIKE = {aten.new_zeros, aten.new_ones, aten.new_full, aten.new_empty}
# convolutions run data parallel (``_local_conv``): the number of leading
# activation arguments, which keep their batch sharding
_BATCH_ONLY = {aten.convolution.default: 1,
               aten.convolution_backward.default: 2}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor reads: an expanded (stride
    0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n * t.element_size()


_PROPAGATION_CODES: set = set()


def _in_propagation() -> bool:
    """Whether an op runs inside DTensor's sharding propagation, which runs
    each new op once of its own (at global shapes on fake tensors, or
    through a decomposition on a fake mesh) to find its strategy: work
    that no device does."""
    if not _PROPAGATION_CODES:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        for name in ("propagate_op_sharding_non_cached",
                     "_propagate_tensor_meta_non_cached"):
            fn = getattr(ShardingPropagator, name, None)
            if fn is not None:
                _PROPAGATION_CODES.add(fn.__code__)
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in _PROPAGATION_CODES:
            return True
        f = f.f_back
    return False


def _wrap(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) over a local shard."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, mesh, placements, shape=torch.Size(shape),
                              stride=tuple(stride), run_check=False)


def _refused(e: Exception) -> bool:
    """Whether DTensor refused an op before running it: its sharding
    propagation failed, or the op has no sharding strategy."""
    msg = str(e)
    return "propagation failed" in msg or "sharding strategy" in msg


def _is_table_lookup(func, args) -> bool:
    """``table[ids]``: rows of a 2-D DTensor sharded along its rows (an
    embedding lookup on a vocabulary-sharded table)."""
    from torch.distributed.tensor import DTensor, Shard
    if func is not aten.index.Tensor or not isinstance(args[0], DTensor):
        return False
    table, indices = args[0], args[1]
    return (table.dim() == 2 and len(indices) == 1
            and indices[0] is not None and Shard(0) in table.placements)


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class StepCost(TorchDispatchMode):
    """Counts one device's FLOPs, bytes, live storages (those on the meta
    device) and collectives of what runs under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, Any] = {op: 0 for op in COLLECTIVE_OPS}
        self.counts = {op: 0 for op in COLLECTIVE_OPS}
        self.current = 0
        self.peak = 0
        self.reshards: Dict[str, int] = {}
        self.failed_op: Optional[str] = None
        self._live = WeakIdKeyDictionary()
        self._passthrough = False
        self._distributed = False           # a DTensor op has been seen

    # ------------------------------------------------------------ storages
    def _free(self, n: int) -> None:
        self.current -= n

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` (a tree) as live from now on;
        returns the bytes newly counted."""
        new = 0
        for t in _tensors(tensors):
            if not t.is_meta:
                continue
            st = t.untyped_storage()
            if st in self._live:
                continue
            n = st.nbytes()
            self._live[st] = n
            weakref.finalize(st, self._free, n)
            new += n
        self.current += new
        self.peak = max(self.peak, self.current)
        return new

    def live_bytes(self, tensors) -> int:
        """Bytes of the distinct meta storages of ``tensors``."""
        seen = {}
        for t in _tensors(tensors):
            if t.is_meta:
                st = t.untyped_storage()
                seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if self._distributed and _in_propagation():
            return func(*args, **kwargs)
        if any(_is_dtensor_type(t) for t in types):
            self._distributed = True
            if self._passthrough:           # our own re-dispatch: DTensor's turn
                self._passthrough = False
                return NotImplemented
            return self._dtensor_op(func, types, args, kwargs)
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        try:
            out = func(*args, **kwargs)
        except Exception:
            self.failed_op = self.failed_op or str(func)
            raise
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = f"{func.namespace}.{packet.__name__}"
        outs = _tensors(out)
        if name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            self.collectives[op] += sum(_nbytes(t) for t in outs)
            self.counts[op] += 1
        elif func.namespace in ("_c10d_functional", "c10d") \
                and name not in _COLLECTIVE_NOOPS:
            raise NotImplementedError(f"collective {func} has no XLA name here")
        ins = _tensors((args, kwargs))
        in_st = {t.untyped_storage()._cdata for t in ins}
        aliases = all(t.untyped_storage()._cdata in in_st for t in outs)
        if not (func.is_view or packet in _NO_DATA
                or (aliases and not func._schema.is_mutable)):
            self.bytes_accessed += sum(_distinct_bytes(t) for t in ins + outs)
        self.track(outs)

    # ------------------------------------------------------------ DTensor
    def _redispatch(self, func, args, kwargs):
        """Run ``func`` on DTensors with this mode active, so DTensor's
        local ops come back here."""
        with self:
            self._passthrough = True
            try:
                return func(*args, **kwargs)
            finally:
                self._passthrough = False

    def _dtensor_op(self, func, types, args, kwargs):
        name = str(func)
        if func._schema.is_mutable and args \
                and not _is_dtensor_type(type(args[0])):
            return self._into_plain(func, args, kwargs)
        if func in _BATCH_ONLY:
            return self._reduced(self._local_conv(func, args))
        if _is_table_lookup(func, args):
            return self._reduced(self._table_lookup(func, args))
        if func._overloadpacket in _NEW_LIKE:
            return self._new_like(func, args, kwargs)
        try:
            out = self._redispatch(func, args, kwargs)
        except Exception as refused:        # noqa: BLE001 — retried below
            if not _refused(refused):
                self.failed_op = self.failed_op or name
                raise
            try:
                if func in _INDEXED_WRITES:
                    out = self._indexed_write(func, args, kwargs)
                else:
                    out = self._replicated_retry(func, args, kwargs, refused)
            except Exception:
                self.failed_op = self.failed_op or name
                raise
            self.reshards[name] = self.reshards.get(name, 0) + 1
        if func._schema.is_mutable:
            return out
        return self._reduced(out)

    def _reduced(self, out):
        """A result's partial sums reduced at once (an all-reduce), as
        GSPMD and Megatron reduce a row-parallel product: left partial,
        DTensor defers the choice to the next op, whose cheapest move by
        its own cost can be to move the other operand instead (a whole
        embedding, to form full-vocabulary logits on every device)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        flat, spec = tree_flatten(out)
        for i, t in enumerate(flat):
            if isinstance(t, DTensor) and any(isinstance(p, Partial)
                                              for p in t.placements):
                pl = [Replicate() if isinstance(p, Partial) else p
                      for p in t.placements]
                with self:
                    flat[i] = t.redistribute(t.device_mesh, pl)
        return spec.unflatten(flat)

    def _local_conv(self, func, args):
        """A convolution or its backward, data parallel: the activations
        keep only their batch sharding (``Shard(0)``), weights and bias are
        replicated, every device convolves its own rows, and the weight and
        bias gradients are partial sums over the batch's mesh dims."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        n_act = _BATCH_ONLY[func]
        mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
        batch = [Shard(0)] * mesh.ndim
        local = list(args)
        with self:
            for i, t in enumerate(args):
                if isinstance(t, DTensor):
                    pl = [p if i < n_act and p == Shard(0) else Replicate()
                          for p in t.placements]
                    if i == n_act - 1:              # the input's batch
                        batch = pl
                    local[i] = t.redistribute(mesh, pl).to_local()
            out = func(*local)
        split = math.prod(mesh.size(m) for m, p in enumerate(batch)
                          if p == Shard(0))

        def wrap(t, pl, scale):
            if t is None:
                return None
            return _wrap(t, mesh, pl, (t.shape[0] * scale,) + tuple(t.shape[1:]))
        name = str(func)
        self.reshards[name] = self.reshards.get(name, 0) + 1
        if func is aten.convolution.default:
            return wrap(out, batch, split)
        summed = [Partial() if p == Shard(0) else Replicate() for p in batch]
        return (wrap(out[0], batch, split), wrap(out[1], summed, 1),
                wrap(out[2], summed, 1))

    def _into_plain(self, func, args, kwargs):
        """An in-place op into a plain tensor (a buffer the step made,
        replicated implicitly) that reads DTensors: they are replicated,
        and every device runs the op on its copy, as implicit replication
        means."""
        from torch.distributed.tensor import DTensor, Replicate

        def local(t):
            if not isinstance(t, DTensor):
                return t
            whole = [Replicate()] * t.device_mesh.ndim
            return t.redistribute(t.device_mesh, whole).to_local()
        with self:
            flat, spec = tree_flatten((args, kwargs))
            a, k = spec.unflatten([local(t) for t in flat])
            func(*a, **k)
        name = str(func)
        self.reshards[name] = self.reshards.get(name, 0) + 1
        return args[0]

    def _replicated_retry(self, func, args, kwargs, first):
        from torch.distributed.tensor import DTensor, Replicate
        flat, spec = tree_flatten((args, kwargs))
        dts = [i for i, a in enumerate(flat) if isinstance(a, DTensor)]
        mesh = flat[dts[0]].device_mesh
        inplace = 0 if func._schema.is_mutable else None
        for m in reversed(range(mesh.ndim)):
            with self:
                for i in dts:
                    if i == inplace:
                        continue
                    pl = list(flat[i].placements)
                    if m < len(pl) and not isinstance(pl[m], Replicate):
                        pl[m] = Replicate()
                        flat[i] = flat[i].redistribute(mesh, pl)
            a, k = spec.unflatten(flat)
            try:
                return self._redispatch(func, a, k)
            except Exception:               # noqa: BLE001 — next mesh dim
                continue
        raise first

    def _new_like(self, func, args, kwargs):
        """``t.new_zeros(size)`` and its kin, sharded as ``t`` on every dim
        where ``size`` keeps ``t``'s size, and replicated elsewhere. DTensor
        would make the whole global tensor on every device (the gradient of
        a gather over the vocabulary: B x S x V on each)."""
        from torch.distributed.tensor import Replicate, Shard
        t, size = args[0], list(args[1])
        mesh = t.device_mesh
        pl, local = [], list(size)
        for m, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim < len(size) \
                    and size[p.dim] == t.shape[p.dim] \
                    and local[p.dim] % mesh.size(m) == 0:
                pl.append(p)
                local[p.dim] //= mesh.size(m)
            else:
                pl.append(Replicate())
        with self:
            out = func(t._local_tensor, local, *args[2:], **kwargs)
        return _wrap(out, mesh, pl, size)

    def _table_lookup(self, func, args):
        """``table[ids]`` on a table sharded along its rows, vocabulary
        parallel: each device gathers the ids its rows hold (a partial sum,
        the other rows zero) and the partial sums are reduced. DTensor would
        instead move the whole table to a sharding along its columns."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        table, ids = args[0], args[1][0]
        mesh = table.device_mesh
        if not isinstance(ids, DTensor):
            ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        id_pl, out_pl = [], []
        for p, q in zip(table.placements, ids.placements):
            if p == Shard(0):
                id_pl.append(Replicate())
                out_pl.append(Partial())
            elif isinstance(p, Shard):          # along the columns
                id_pl.append(Replicate())
                out_pl.append(Shard(ids.dim()))
            else:
                id_pl.append(q if isinstance(q, Shard) else Replicate())
                out_pl.append(id_pl[-1])
        with self:
            local_ids = ids.redistribute(mesh, id_pl).to_local()
            out = func(table._local_tensor, [local_ids])
        self.reshards[str(func)] = self.reshards.get(str(func), 0) + 1
        return _wrap(out, mesh, out_pl, tuple(ids.shape) + (table.shape[1],))

    def _indexed_write(self, func, args, kwargs):
        """``dst[indices] = values`` on a sharded ``dst``, shard by shard:
        each index tensor (1-D, of one length n) and ``values`` are moved to
        ``dst``'s placements and every device writes its own rows."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dst, indices, values = args[:3]
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                                False)
        mesh = dst.device_mesh
        adv = [d for d, ix in enumerate(indices) if ix is not None]
        if any(indices[d].dim() != 1 for d in adv):
            raise NotImplementedError(f"{func}: only 1-D index tensors")
        rest = [d for d in range(dst.dim()) if d not in adv]
        if adv == list(range(adv[0], adv[-1] + 1)):      # adjacent: in place
            pos = sum(d < adv[0] for d in rest)
            layout = rest[:pos] + ["n"] + rest[pos:]
        else:                                            # apart: first
            layout = ["n"] + rest
        skip = len(layout) - values.dim()                # values broadcast
        v_pl, i_pl = [], []
        for p in dst.placements:
            if isinstance(p, Shard):
                at = layout.index("n" if p.dim in adv else p.dim) - skip
                v_pl.append(Shard(at) if at >= 0 else Replicate())
                i_pl.append(Shard(0) if p.dim in adv else Replicate())
            elif isinstance(p, Replicate):
                v_pl.append(Replicate())
                i_pl.append(Replicate())
            else:
                raise NotImplementedError(f"{func} into a {p} tensor")

        def local(t, pl):
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return t.redistribute(mesh, pl).to_local()
        with self:
            lidx = [None if ix is None else local(ix, i_pl) for ix in indices]
            func(dst._local_tensor, lidx, local(values, v_pl), accumulate)
        return dst
