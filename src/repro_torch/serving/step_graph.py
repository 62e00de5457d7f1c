"""Serve steps captured once as CUDA graphs and replayed: the port's
stand-in for the reference's ``jax.jit`` of its serve steps
(``repro/serving/engine.py``; the JAX package has no module like this
one, since XLA compiles there).

``StepGraphs.run(name, step, inputs, cache)`` runs ``step(cache,
**inputs) -> (logits, cache)``. The first call with a key warms the step
up on a side stream (that run is the call's own step, so the cache moves
once), then captures it with ``torch.cuda.graph`` into the memory pool all
of one runner's live graphs share (a new pool once none is left); a later
call with the same key copies its inputs into the entry's static buffers
and replays the graph. The key is
the step's name, the shapes and dtypes of the inputs, the ``data_ptr()``,
shape and dtype of every cache leaf (the graph reads and writes the cache
in place, at those addresses) and the installed autotune cache (which
picks kernels and tiles at capture time): a new cache or a new tuning
means a new capture, never a stale replay. An entry whose cache has died
is dropped. The logits come back as a ``clone()``, because the next replay
overwrites the static output. A capture that fails raises; nothing falls
back to the eager step.

The kernel wrappers count launches when Python calls them, which a replay
does not do. So the runner takes each counter's growth during the capture
(nothing ran: the counters are put back) and adds it at every replay, and
the counts stay those of kernels that ran. The warm-up counts as the eager
call it is. A capture that counts other launches than its warm-up took a
branch on a host value, and raises.

On the CPU (which the caller must ask for) there is no graph: the runner
stages the same way (static buffers, keys, ``clone()``, counters) around
an eager call of the step, so the CPU tests cover everything but the
capture itself.

Under a ``torch.profiler`` session a call opens ``graph.stage`` (the
sweep, the key, the input copies), then ``graph.replay`` or
``graph.capture`` (``serving/trace.py``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import autotune as AT
from repro_torch.kernels import chunk_attention as CA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssm_scan as SS
from repro_torch.serving.trace import span

# every kernel wrapper's launch count (an attribute ``launches``)
COUNTERS = (FA.flash_attention, FA.flash_attention_bwd, DA.decode_attention,
            DA.paged_decode_attention, DA.paged_decode_attention_int8,
            SS.ssd_scan, SS.ssd_scan_bwd, CA.paged_chunk_attention)

Step = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _counts() -> List[int]:
    return [fn.launches for fn in COUNTERS]


def _set_counts(values: List[int]) -> None:
    for fn, n in zip(COUNTERS, values):
        fn.launches = n


def _grown(after: List[int], before: List[int]) -> Tuple[int, ...]:
    return tuple(a - b for a, b in zip(after, before))


@dataclass
class _Entry:
    static: Dict[str, torch.Tensor]       # input buffers, filled by copy_
    leaves: List[weakref.ref]             # the cache leaves it was made on
    tuning: Any                           # the autotune cache it saw (held,
                                          # so the id in the key stays its)
    counts: Tuple[int, ...]               # launches one step counts
    graph: Optional[Any]                  # torch.cuda.CUDAGraph; None on CPU
    out: Optional[torch.Tensor]           # the static logits


class StepGraphs:
    """One engine's captured serve steps (see the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures = 0
        self.replays = 0
        self._entries: Dict[tuple, _Entry] = {}
        self._cuda = self.device.type == "cuda"
        self._pool = None
        self._side = torch.cuda.Stream(self.device) if self._cuda else None

    def __len__(self) -> int:
        return len(self._entries)

    def run(self, name: str, step: Step, inputs: Dict[str, Any],
            cache: Dict[str, torch.Tensor]):
        """``step(cache, **inputs)`` captured or replayed; ``inputs`` are
        tensors or Python ints (a 0-d int32 buffer takes an int)."""
        with span("graph.stage"):
            for k, v in inputs.items():
                if not isinstance(v, (torch.Tensor, int)):
                    raise TypeError(f"{name}: input {k!r} is a "
                                    f"{type(v).__name__}, not a tensor or "
                                    f"an int")
            self._entries = {k: e for k, e in self._entries.items()
                             if all(r() is not None for r in e.leaves)}
            if self._cuda and not self._entries:
                # the allocator releases a pool with its last graph, and a
                # capture into a released pool's handle fails
                self._pool = torch.cuda.graph_pool_handle()
            key = self._key(name, inputs, cache)
            entry = self._entries.get(key)
            if entry is not None:
                for k, v in inputs.items():
                    buf = entry.static[k]
                    if isinstance(v, torch.Tensor):
                        buf.copy_(v)
                    else:
                        buf.fill_(v)
        if entry is None:
            with span("graph.capture"):
                logits, self._entries[key] = self._capture(name, step,
                                                           inputs, cache)
            return logits, cache
        with span("graph.replay"):
            if entry.graph is not None:
                entry.graph.replay()
            else:
                held = _counts()
                entry.out, _ = step(cache, **entry.static)
                _set_counts(held)
            for fn, n in zip(COUNTERS, entry.counts):
                fn.launches += n
            self.replays += 1
            logits = entry.out.clone()
        return logits, cache

    @staticmethod
    def _key(name: str, inputs: Dict[str, Any],
            cache: Dict[str, torch.Tensor]) -> tuple:
        ins = tuple((k, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                    else (k, "int") for k, v in sorted(inputs.items()))
        leaves = tuple((k, t.data_ptr(), tuple(t.shape), t.dtype)
                       for k, t in sorted(cache.items()))
        return name, ins, leaves, id(AT.installed())

    def _buffer(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.clone(memory_format=torch.contiguous_format)
        return torch.full((), v, dtype=torch.int32, device=self.device)

    def _capture(self, name: str, step: Step, inputs: Dict[str, Any],
                 cache: Dict[str, torch.Tensor]):
        """This call's step run once for real (the warm-up), then captured
        (CUDA) or kept as the eager call (CPU). Returns the step's logits
        and the new entry."""
        static = {k: self._buffer(v) for k, v in inputs.items()}
        leaves = dict(cache)
        before = _counts()
        graph = out = None
        if self._side is None:
            logits, got = step(cache, **static)
            counts = _grown(_counts(), before)
        else:
            main = torch.cuda.current_stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                logits, got = step(cache, **static)
            main.wait_stream(self._side)
            warm = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                out, got = step(cache, **static)
            counts = _grown(_counts(), warm)
            _set_counts(warm)               # the capture launched nothing
            if counts != _grown(warm, before):
                raise RuntimeError(
                    f"{name}: the capture counted launches {counts}, its "
                    f"warm-up {_grown(warm, before)}: the step branches on "
                    f"a host value")
        if got is not cache or any(cache.get(k) is not t
                                   for k, t in leaves.items()) \
                or cache.keys() != leaves.keys():
            raise RuntimeError(f"{name}: the step replaced its cache or a "
                               f"leaf of it; a replay needs it in place")
        self.captures += 1
        return logits, _Entry(static=static,
                              leaves=[weakref.ref(t) for t in leaves.values()],
                              tuning=AT.installed(), counts=counts,
                              graph=graph, out=out)
