"""The serving path's own tracing: profiler spans, per-request stamps and a
tick log.

  * ``span(name)`` — a ``torch.profiler.record_function`` annotation while
    a ``torch.profiler`` session runs, else one shared no-op context (a
    flag read: ``record_function`` costs microseconds even with no
    profiler). The annotations sit on the profiler's clock beside the
    CUDA runtime launches and the device ops, nested on the host thread.
  * ``RequestTimes`` — ``time.perf_counter`` stamps a ``Request`` carries
    from the router to its retirement, always recorded (the counterpart
    of vLLM's per-request metrics).
  * ``TICKS`` — the process's tick log, always recorded: one ``Tick`` per
    batcher ``step()``, in a deque of fixed length (the default recorder,
    as ``prometheus_client.REGISTRY`` is the default registry).

Stamps and ticks cost a clock read and an append each; a reader takes
them against its own ``perf_counter`` readings.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

clock = time.perf_counter

# every span the serving path opens, by where it is opened
SPANS = (
    # FleetRouter.submit
    "router.snapshot", "router.dispatch", "router.book", "router.enqueue",
    # a batcher's step(): paged admission, the dense refill and its lanes,
    # the paged prefill chunks, the decode, the host syncs and what follows
    "tick.admit", "tick.fill", "lane.cache", "lane.prefill", "lane.splice",
    "tick.prefill", "tick.decode", "tick.sync", "tick.book",
    # StepGraphs.run
    "graph.stage", "graph.replay", "graph.capture",
)

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler annotation ``name`` while a profiler runs, else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


@dataclass(slots=True)
class RequestTimes:
    """A request's ``perf_counter`` stamps (None until reached)."""
    arrived: Optional[float] = None     # FleetRouter.submit entered
    routed: Optional[float] = None      # the plan resolved
    booked: Optional[float] = None      # the plan booked in PoolStats
    queued: Optional[float] = None      # in its batcher's queue
    admitted: Optional[float] = None    # given a lane
    emitted: List[float] = field(default_factory=list)  # per output token,
    # right after the host sync that brought it
    done: Optional[float] = None        # retired
    blocked: int = 0                    # ticks at the queue's head whose
    # admission stopped on memory


class Tick(NamedTuple):
    """One batcher ``step()``."""
    pool: str               # the pool the router gave the batcher
    start: float
    end: float
    sync_s: float           # seconds inside the tick's host syncs
    admitted: int           # requests given a lane
    blocked: bool           # admission stopped on memory
    decode_lanes: int       # lanes in the tick's decode step (0: none)
    queued: int             # queue length at the tick's end


TICKS: Deque[Tick] = deque(maxlen=65_536)
