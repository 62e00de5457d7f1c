"""Continuous batching: the fixed-slot dense loop and the paged-KV runtime
(counterpart of ``repro/serving/batching.py``).

  * ``ContinuousBatcher`` — ``slots`` decode lanes over one dense cache
    (K/V ``(layers, slots, heads, max_len, hd)``, or the SSM/hybrid conv,
    ssm and ak/av tensors, all with the lane at axis 1); a finished lane is
    refilled by a whole-prompt prefill spliced into its region.
  * ``PagedContinuousBatcher`` — a shared block pool plus per-lane block
    tables, with memory-aware admission, chunked prefill interleaved with
    decode ticks, and refcounted prefix-block sharing (dense family only:
    ``model.init_paged_cache`` refuses SSM and hybrid configs). A decode
    tick runs the decoding lanes alone, padded to the least row count of
    ``DECODE_ROWS`` that holds them, each count a captured step of its own.

Both keep one batched host sync per tick: the tokens a tick emits come to
the host together, while the next tick's input stays on the device.
Host-to-device copies go through pinned memory without a stream sync.

Each ``step()`` appends a ``trace.Tick`` to ``trace.TICKS`` and stamps the
requests' ``times`` (queued, admitted, each token after its sync, done);
under a ``torch.profiler`` session it opens the ``tick.*`` and ``lane.*``
spans (``serving/trace.py``).

KV handoff between two paged pools (disaggregated prefill and decode): a
held request (``Request.hold``) prefills on one batcher and never decodes
there; ``adopt_lane`` on another copies its prompt blocks across with
``migrate_kv_blocks`` (on the pools' device, no host round trip) and seats
it in a free lane; the source then frees its lane with ``release_lane``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import kv_blocks_needed
from repro_torch.models.model import NULL_BLOCK
from repro_torch.serving import trace
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.trace import RequestTimes, clock, span


@dataclass
class Request:
    rid: int
    tokens: np.ndarray              # (m,) prompt
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    eos_id: Optional[int] = None    # stop early when this token is emitted
    hold: bool = False              # prefill only; decode waits for a handoff
    times: RequestTimes = field(default_factory=RequestTimes)  # trace stamps


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To the card it goes through pinned memory
    with ``non_blocking``, so the copy does not wait for queued work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _BatcherBase:
    """Queue/lane state and the tick loop shared by both runtimes. The EOS
    retirement predicate must stay ONE definition: the dense/paged token
    parity depends on identical completion rules."""

    def __init__(self, engine: InferenceEngine, slots: int):
        self.engine = engine
        self.device = engine.device
        self.slots = slots
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self._last_tok = torch.zeros((slots,), dtype=torch.int32,
                                     device=self.device)
        self.pool = ""              # the tick log's name for it (the router's)
        # the current tick's record: host sync seconds, admissions, and
        # whether admission stopped on memory
        self._sync_s = 0.0
        self._admitted = 0
        self._blocked = False
        self._moe = (0, 0)          # the decode's routed rows, experts read

    def submit(self, req: Request) -> None:
        req.times.queued = clock()
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def _finished(self, req: Request) -> bool:
        """A request retires when it emits its eos_id or exhausts its token
        budget, whichever comes first."""
        if req.eos_id is not None and req.out_tokens and \
                req.out_tokens[-1] == req.eos_id:
            return True
        return len(req.out_tokens) >= req.max_new_tokens

    def _seed_lanes(self, lanes: List[int], tok_devs: List[torch.Tensor]):
        """Write each lane's first token into the next decode input on the
        device, then ONE host sync for all of them."""
        for i, t in zip(lanes, tok_devs):
            self._last_tok[i] = t                         # in place, on device
        t0 = clock()
        with span("tick.sync"):
            # one sync per admission  # repro-lint: allow[torch-host-sync]
            toks = torch.stack(tok_devs).cpu().numpy()
        now = clock()
        self._sync_s += now - t0
        self._book(lanes, toks, now)          # eos on a first token retires

    def _emit(self, logits: torch.Tensor, live: List[int],
              lanes: Optional[torch.Tensor] = None) -> None:
        """The argmax stays on the device as next tick's input (dead lanes
        pick up garbage, overwritten before any read); one host sync per
        tick for the bookkeeping, which brings the step's MoE counts
        (``moe_stats``) back with the tokens. Row i of ``logits`` is lane i,
        or with ``lanes`` (the step's rows, ``live`` first) lane lanes[i]."""
        tok_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        rows = live
        if lanes is None:
            self._last_tok = tok_dev
        else:
            rows = list(range(len(live)))
            self._last_tok.index_copy_(0, lanes[:len(live)],      # in place
                                       tok_dev[:len(live)])
        counted = "moe_stats" in self.cache
        both = torch.cat([tok_dev.long(), self.cache["moe_stats"]]) \
            if counted else tok_dev
        t0 = clock()
        with span("tick.sync"):
            # one sync per tick  # repro-lint: allow[torch-host-sync]
            got = both.cpu().numpy()
        toks = got[:tok_dev.shape[0]]
        if counted:
            self._moe = (int(got[-2]), int(got[-1]))
        now = clock()
        self._sync_s += now - t0
        self._book(live, toks[rows], now)

    def _book(self, lanes: List[int], toks: np.ndarray, now: float) -> None:
        """Each lane's token (on the host), stamped ``now``, the sync that
        brought it; a finished request retires."""
        with span("tick.book"):
            for i, tok in zip(lanes, toks):
                req = self.active[i]
                req.out_tokens.append(int(tok))
                req.times.emitted.append(now)
                if self._finished(req):
                    self._retire(i)
                    req.times.done = clock()

    def _retire(self, i: int) -> None:
        raise NotImplementedError

    def step(self) -> None:
        """One scheduler tick (``_tick``), logged in ``trace.TICKS``."""
        start = clock()
        self._sync_s, self._admitted, self._blocked = 0.0, 0, False
        self._moe = (0, 0)
        lanes = self._tick()
        trace.TICKS.append(trace.Tick(self.pool, start, clock(), self._sync_s,
                                      self._admitted, self._blocked, lanes,
                                      len(self.queue), *self._moe))

    def _tick(self) -> int:
        """The tick's work; returns the lanes it decoded (0: no decode)."""
        raise NotImplementedError

    def run(self, max_ticks: int = 10_000) -> None:
        ticks = 0
        while self.busy and ticks < max_ticks:
            self.step()
            ticks += 1


# the lengths a captured prefill pads a prompt to (up to the engine's
# max_len); a longer prompt prefills eagerly at its own length
PREFILL_BUCKETS = tuple(16 << i for i in range(8))          # 16 .. 2048


class ContinuousBatcher(_BatcherBase):
    """Fixed-slot continuous batching loop on one engine (dense cache).

    A model whose cache holds the lanes' live mask (``block_pattern``)
    prefills a lane through the engine's captured step, its prompt padded
    to the next of ``PREFILL_BUCKETS``; every bucket is captured here,
    before any request. Other models prefill eagerly at the prompt's
    length."""

    def __init__(self, engine: InferenceEngine, slots: int = 4):
        super().__init__(engine, slots)
        self.cache = engine.new_cache(slots)
        self._live = "live" in self.cache    # the lanes' live mask
        self._buckets: Tuple[int, ...] = ()
        if self._live and engine.graphs is not None:
            self._buckets = tuple(b for b in PREFILL_BUCKETS
                                  if b <= engine.max_len)
            lane = engine.lane_cache()
            for b in self._buckets:
                engine.prefill({"tokens": torch.zeros(
                    (1, b), dtype=torch.int32, device=self.device),
                    "n_valid": b}, lane)

    def _retire(self, i: int) -> None:
        self.active[i].done = True
        self.active[i] = None
        # the decode kernels mask by kv_len, so stale KV rows are
        # unreachable; SSM states are overwritten by the next splice
        self.cache["pos"][i] = 0                          # in place
        if self._live:                # the lane routes to no expert now
            self.cache["live"][i] = False                 # in place

    def _fill_slots(self) -> None:
        admitted: List[int] = []
        tok_devs: List[torch.Tensor] = []
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                req.times.admitted = clock()
                self._admitted += 1
                self.active[i] = req
                # per-request prefill into a single-lane cache, then
                # splice the lane into the batched cache
                m = len(req.tokens)
                S = next((b for b in self._buckets if b >= m), 0)
                with span("lane.cache"):
                    lane_cache = self.engine.lane_cache() if S else \
                        self.engine.new_cache(1)
                with span("lane.prefill"):
                    toks = np.zeros((1, max(S, m)), np.int32)
                    toks[0, :m] = req.tokens
                    batch = {"tokens": _to_device(toks, self.device)}
                    if S:
                        batch["n_valid"] = m
                    logits, lane_cache = self.engine.prefill(batch,
                                                             lane_cache)
                    tok_devs.append(
                        torch.argmax(logits, dim=-1)[0].to(torch.int32))
                admitted.append(i)
                with span("lane.splice"):
                    _splice_lane(self.cache, lane_cache, i)
        if admitted:
            self._seed_lanes(admitted, tok_devs)

    def _tick(self) -> int:
        """Refill empty lanes, then one batched decode step."""
        with span("tick.fill"):
            self._fill_slots()
        with span("tick.decode"):
            live = [i for i, r in enumerate(self.active) if r is not None]
            if not live:
                return 0
            logits, self.cache = self.engine.decode(self._last_tok[:, None],
                                                    self.cache)
        self._emit(logits, live)
        return len(live)


# ===========================================================================
# paged runtime
# ===========================================================================
class BlockAllocator:
    """Host-side refcounted free-list over the shared pool.

    Block 0 (``model.NULL_BLOCK``) is reserved as the sink for redirected
    writes and is never handed out; usable capacity is ``num_blocks - 1``.
    Refcounts > 1 arise from prefix sharing — a block returns to the free
    list only when its last reference drops.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() yields low ids
        self.refcount = [0] * num_blocks
        self.total_allocs = 0          # fresh blocks ever handed out
        self.peak_used = 0

    @property
    def total_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.total_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None if they don't fit."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        self.total_allocs += n
        self.peak_used = max(self.peak_used, self.used_blocks)
        return out

    def incref(self, blocks: List[int]) -> None:
        for b in blocks:
            if self.refcount[b] <= 0:
                raise ValueError(f"incref of free block {b}")
            self.refcount[b] += 1

    def decref(self, blocks: List[int]) -> None:
        for b in blocks:
            self.refcount[b] -= 1
            if self.refcount[b] < 0:
                raise ValueError(f"double free of block {b}")
            if self.refcount[b] == 0:
                self._free.append(b)


class PrefixBlockCache:
    """Content-addressed map of fully written prompt blocks -> pool blocks.

    Keys chain parent key + the block's tokens, so a hit at depth d implies
    hits at all shallower depths (radix-tree semantics in a flat dict). Each
    entry holds one owned reference; ``evict`` releases entries whose only
    remaining reference is the cache's own, deepest first.
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self._map: Dict[Tuple, int] = {}     # chain key -> block id
        self.hits = 0                        # blocks reused via sharing

    @staticmethod
    def _chain(prompt: np.ndarray, block_size: int, upto_blocks: int):
        key: Tuple = ()
        for b in range(upto_blocks):
            key = (key, tuple(int(t) for t in
                              prompt[b * block_size:(b + 1) * block_size]))
            yield key

    def match(self, prompt: np.ndarray, block_size: int) -> List[int]:
        """Longest shared prefix as pool block ids. Matches at most
        ``(m - 1) // block_size`` blocks so every admitted request computes
        at least its final prompt token (whose logits seed decode)."""
        limit = (len(prompt) - 1) // block_size
        out: List[int] = []
        for key in self._chain(prompt, block_size, limit):
            blk = self._map.get(key)
            if blk is None:
                break
            out.append(blk)
        if out:
            self.allocator.incref(out)
            self.hits += len(out)
        return out

    def register(self, prompt: np.ndarray, block_size: int,
                 table: List[int], lo_block: int, hi_block: int) -> None:
        """Pin prompt blocks [lo_block, hi_block) — now fully written — under
        their content keys. Idempotent per key; the pin is an owned ref."""
        for b, key in enumerate(self._chain(prompt, block_size, hi_block)):
            if b < lo_block or key in self._map:
                continue
            self._map[key] = table[b]
            self.allocator.incref([table[b]])

    def evict(self, need: int) -> None:
        """Drop pinned-only entries (refcount == 1), deepest first, until
        ``need`` blocks are free or nothing more can be released. Evicting a
        shallow key first would orphan its descendants, still pinned."""
        if need <= self.allocator.free_blocks:
            return
        for key in reversed(list(self._map)):
            blk = self._map[key]
            if self.allocator.refcount[blk] == 1:
                del self._map[key]
                self.allocator.decref([blk])
                if self.allocator.free_blocks >= need:
                    return


# the rows a paged decode step runs: the decoding lanes, padded to the
# least of these that holds them (or to every slot), so the step's products
# cost about the live lanes, not every slot. Each count is a capture of its
# own (set-up time), so they step by 4: below 32 rows a 7B step's products
# cost about its weight read whatever the rows.
DECODE_ROWS = tuple(32 << 2 * i for i in range(4))           # 32 .. 2048


@dataclass
class _LaneState:
    """Host-side bookkeeping for one decode lane of the paged batcher."""
    blocks: List[int]            # this request's block-table prefix (owned refs)
    prefilled: int               # prompt tokens already written (incl. shared)
    registered: int              # full prompt blocks already in the prefix map
    prompt_dev: torch.Tensor     # the prompt on the device, padded to chunks


class PagedContinuousBatcher(_BatcherBase):
    """Paged-KV continuous batching: block-table cache, chunked prefill
    interleaved with decode ticks, refcounted prefix sharing, and
    memory-aware admission.

    Interface-compatible with ``ContinuousBatcher`` (submit/step/run/busy)
    plus the memory state (``free_blocks``/``total_blocks``) the router
    exports to schedulers via ``PoolSnapshot``.
    """

    def __init__(self, engine: InferenceEngine, slots: int = 4, *,
                 num_blocks: int = 64, block_size: int = 16, chunk: int = 32,
                 prefix_sharing: bool = True):
        super().__init__(engine, slots)
        self.block_size = block_size
        self.chunk = chunk
        self.cache = engine.new_paged_cache(slots, num_blocks, block_size)
        self.allocator = BlockAllocator(num_blocks)
        self.prefix = PrefixBlockCache(self.allocator) if prefix_sharing else None
        self.max_blocks_per_lane = kv_blocks_needed(engine.max_len, block_size)
        self._lane: List[Optional[_LaneState]] = [None] * slots
        self._rows = tuple(n for n in DECODE_ROWS if n < slots) + (slots,)
        self._rows_run = False

    # ---------------------------------------------------------------- state
    @property
    def total_blocks(self) -> int:
        return self.allocator.total_blocks

    @property
    def free_blocks(self) -> int:
        """Admission headroom: free-list blocks plus what prefix eviction
        could reclaim (pinned-only entries)."""
        return self.allocator.free_blocks + self._evictable()

    def _evictable(self) -> int:
        if self.prefix is None:
            return 0
        return sum(1 for blk in self.prefix._map.values()
                   if self.allocator.refcount[blk] == 1)

    def submit(self, req: Request) -> None:
        need = self._blocks_needed(req)
        cap = min(self.max_blocks_per_lane, self.allocator.total_blocks)
        if need > cap:
            raise ValueError(
                f"request {req.rid}: worst-case context "
                f"{len(req.tokens) + req.max_new_tokens} tokens needs {need} "
                f"blocks, but a lane holds at most {cap}")
        super().submit(req)

    def _blocks_needed(self, req: Request) -> int:
        return kv_blocks_needed(len(req.tokens) + req.max_new_tokens,
                                self.block_size)

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        """Memory-aware lane refill: the FIFO head is admitted only when its
        worst-case block need fits (after prefix reuse and eviction)."""
        for i in range(self.slots):
            if self.active[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            prompt = np.asarray(req.tokens)
            need = self._blocks_needed(req)
            shared: List[int] = []
            if self.prefix is not None:
                shared = self.prefix.match(prompt, self.block_size)
            fresh_need = need - len(shared)
            if self.prefix is not None:
                self.prefix.evict(fresh_need)
            fresh = self.allocator.alloc(fresh_need)
            if fresh is None:                     # memory-bound: head waits
                if shared:
                    self.allocator.decref(shared)
                req.times.blocked += 1
                self._blocked = True
                break
            self.queue.pop(0)
            req.times.admitted = clock()
            self._admitted += 1
            self.active[i] = req
            blocks = shared + fresh
            # the whole prompt goes to the device once, padded to chunks, so
            # prefill ticks slice it there instead of copying per chunk
            padded = np.zeros((-(-len(prompt) // self.chunk) * self.chunk,),
                              np.int32)
            padded[:len(prompt)] = prompt
            self._lane[i] = _LaneState(
                blocks=blocks, prefilled=len(shared) * self.block_size,
                registered=len(shared),
                prompt_dev=_to_device(padded, self.device))
            row = np.full((self.cache["block_tables"].shape[1],), NULL_BLOCK,
                          np.int32)
            row[:len(blocks)] = blocks
            self.cache["block_tables"][i] = _to_device(row, self.device)  # in place
            self.cache["pos"][i] = len(shared) * self.block_size          # in place

    # ------------------------------------------------------------- prefill
    def _prefill_tick(self) -> None:
        """Advance every still-prefilling lane by one chunk. The final chunk
        yields the first output token, exactly like a dense prefill."""
        done_lanes: List[int] = []
        tok_devs: List[torch.Tensor] = []
        for i in range(self.slots):
            req, lane = self.active[i], self._lane[i]
            if req is None or lane.prefilled >= len(req.tokens):
                continue
            m = len(req.tokens)
            c = min(self.chunk, m - lane.prefilled)
            # a chunk window of the padded device prompt; rows past c lie past
            # the prompt (zeros): masked, and written to the null block
            buf = lane.prompt_dev[lane.prefilled:lane.prefilled + self.chunk]
            if buf.shape[0] < self.chunk:         # shared prefix shifted it
                buf = torch.nn.functional.pad(buf, (0, self.chunk - buf.shape[0]))
            logits, self.cache = self.engine.prefill_chunk(
                buf[None], self.cache, i, c)
            lane.prefilled += c
            if self.prefix is not None:
                full = min(lane.prefilled, m) // self.block_size
                if full > lane.registered:
                    self.prefix.register(np.asarray(req.tokens),
                                         self.block_size, lane.blocks,
                                         lane.registered, full)
                    lane.registered = full
            if lane.prefilled >= m:
                done_lanes.append(i)
                tok_devs.append(torch.argmax(logits, dim=-1)[0].to(torch.int32))
        if done_lanes:
            self._seed_lanes(done_lanes, tok_devs)

    # -------------------------------------------------------------- decode
    def _decode_lanes(self) -> List[int]:
        """Lanes with complete prompts, excluding held ones: a held request
        has prefilled here but decodes elsewhere — its first token (seeded by
        the final prefill chunk) waits in ``out_tokens`` until ``adopt_lane``
        moves the KV to the decode pool."""
        return [i for i, r in enumerate(self.active)
                if r is not None and not r.hold
                and self._lane[i].prefilled >= len(r.tokens)]

    def _tick(self) -> int:
        """Admit, one prefill chunk per filling lane, one batched decode
        step for lanes with complete prompts. Decode lanes advance even
        while another lane's long prompt is mid-prefill."""
        with span("tick.admit"):
            self._admit()
        with span("tick.prefill"):
            self._prefill_tick()
        with span("tick.decode"):
            live = self._decode_lanes()
            if not live:
                return 0
            if not self._rows_run:
                self._run_rows()
            n = next(r for r in self._rows if r >= len(live))
            rows = np.full((n,), -1, np.int64)
            rows[:len(live)] = live
            lanes = _to_device(rows, self.device)
            logits, self.cache = self.engine.decode_paged(
                self._last_tok[:, None], self.cache, lanes)
        self._emit(logits, live, lanes)
        return len(live)

    def _run_rows(self) -> None:
        """Each row count's decode step, run once on padding alone (it
        changes no lane): with graphs, the first decode tick captures them
        all, and no later tick captures."""
        for n in self._rows:
            pad = torch.full((n,), -1, dtype=torch.int64, device=self.device)
            self.engine.decode_paged(self._last_tok[:, None], self.cache, pad)
        self._rows_run = True

    def _retire(self, i: int) -> None:
        self.active[i].done = True
        self.release_lane(i)

    def release_lane(self, i: int) -> None:
        """Free lane ``i`` without completing its request: drop the owned
        block refs (prefix-shared blocks stay pinned) and null the device
        row. ``_retire`` is release + done; a disaggregated handoff releases
        the prefill-side lane after ``adopt_lane`` copied its blocks out,
        leaving the request alive on the decode pool."""
        lane = self._lane[i]
        self.active[i] = None
        self._lane[i] = None
        self.allocator.decref(lane.blocks)        # shared blocks stay pinned
        self.cache["block_tables"][i] = NULL_BLOCK        # in place
        self.cache["pos"][i] = 0                          # in place

    # ------------------------------------------------------------- handoff
    def adopt_lane(self, req: Request, src: "PagedContinuousBatcher",
                   src_i: int) -> Optional[int]:
        """Resume a held request here: copy its prefilled KV blocks from
        ``src`` and seat it in a free decode lane.

        The request must have finished prefill on ``src`` (its first output
        token, seeded by the final prefill chunk, is in ``out_tokens``; the
        source lane's KV therefore holds exactly the ``m`` prompt tokens —
        the held lane never entered decode). Blocks are copied, not stolen:
        prefix-shared source blocks keep serving the source pool, and the
        caller releases the source lane afterwards (``src.release_lane``).

        Returns the KV payload bytes moved, or ``None`` when no free lane or
        not enough free blocks exist yet — the caller retries next tick, so
        a migration racing admission on a block-starved target degrades to
        waiting, never to a partial copy.
        """
        lane_src = src._lane[src_i]
        if src.active[src_i] is not req or not req.out_tokens or \
                lane_src.prefilled < len(req.tokens):
            raise ValueError(f"request {req.rid}: adopt_lane before its "
                             f"prefill completed on the source pool")
        if self.block_size != src.block_size:
            raise ValueError(
                f"KV migration needs equal block sizes "
                f"(src {src.block_size}, dst {self.block_size})")
        slot = next((i for i, r in enumerate(self.active) if r is None), None)
        if slot is None:
            return None
        ctx = len(req.tokens)                 # prompt only; see docstring
        need = self._blocks_needed(req)       # worst-case full-context hold
        if self.prefix is not None:
            self.prefix.evict(need)
        fresh = self.allocator.alloc(need)
        if fresh is None:                     # block-starved: retry next tick
            return None
        n_copy = kv_blocks_needed(ctx, self.block_size)
        self.cache, moved = migrate_kv_blocks(
            src.cache, lane_src.blocks[:n_copy], self.cache, fresh[:n_copy])
        self.active[slot] = req
        # migrated blocks are private copies — nothing registered for
        # sharing; the lane enters complete (prefilled == m), so
        # ``_prefill_tick`` never reads its prompt: an empty one stands in
        self._lane[slot] = _LaneState(
            blocks=fresh, prefilled=ctx, registered=0,
            prompt_dev=torch.zeros((0,), dtype=torch.int32,
                                   device=self.device))
        row = np.full((self.cache["block_tables"].shape[1],), NULL_BLOCK,
                      np.int32)
        row[:len(fresh)] = fresh
        self.cache["block_tables"][slot] = _to_device(row, self.device)  # in place
        self.cache["pos"][slot] = ctx                                     # in place
        # the first token is already on the host: a host-to-device write,
        # no read back
        self._last_tok[slot] = req.out_tokens[-1]
        req.hold = False
        return moved

    def stats(self) -> Dict[str, int]:
        return {
            "total_blocks": self.total_blocks,
            "free_blocks": self.allocator.free_blocks,
            "fresh_allocs": self.allocator.total_allocs,
            "peak_used": self.allocator.peak_used,
            "prefix_hits": self.prefix.hits if self.prefix else 0,
        }


# --------------------------------------------------------------------- lane ops
# Paged-pool tensors subject to KV migration: the K/V block pools and, when
# the cache is int8-quantized, their per-row scale pools. ``pos`` and
# ``block_tables`` are per-lane (not per-block) and stay host-managed.
_KV_POOL_KEYS = ("kp", "vp", "kp_scale", "vp_scale")


def migrate_kv_blocks(src_cache: Dict, src_blocks: List[int],
                      dst_cache: Dict, dst_blocks: List[int]) -> Tuple[Dict, int]:
    """Device-side KV-block migration between two paged pools.

    Gathers ``src_blocks`` along the pool axis (axis 1 of every
    ``(layers, num_blocks, Hkv, block_size, hd)`` pool tensor) of
    ``src_cache`` with ``index_select`` and writes them into ``dst_blocks``
    of ``dst_cache`` with ``index_copy_``, in place, on the pools' own
    device — the serving realisation of the bytes the pricing model charges
    via ``CostModel.migration_terms``. The source pool is read, never
    written (copy, not steal), so blocks shared through a
    ``PrefixBlockCache`` keep serving the source pool. Returns
    ``(dst_cache, payload_bytes)`` where payload_bytes counts the K/V
    (+scale) bytes moved once.
    """
    if len(src_blocks) != len(dst_blocks):
        raise ValueError(f"block list length mismatch: {len(src_blocks)} "
                         f"source vs {len(dst_blocks)} destination")
    if not src_blocks:
        return dst_cache, 0
    pairs = []
    for k in _KV_POOL_KEYS:
        if k not in src_cache:
            continue
        sv, dv = src_cache[k], dst_cache.get(k)
        if dv is None or sv.shape[:1] + sv.shape[2:] != dv.shape[:1] + dv.shape[2:] \
                or sv.dtype != dv.dtype:
            raise ValueError(
                f"pool geometry mismatch on {k!r}: migration needs the same "
                f"model/block_size/dtype on both ends")
        if sv.device != dv.device:
            raise ValueError(
                f"pools on two devices ({sv.device}, {dv.device}) on {k!r}: "
                f"migration copies on one device")
        pairs.append((sv, dv))
    if not pairs:
        return dst_cache, 0
    device = pairs[0][0].device
    src_ids = _to_device(np.asarray(src_blocks, np.int64), device)
    dst_ids = _to_device(np.asarray(dst_blocks, np.int64), device)
    moved = 0
    for sv, dv in pairs:
        payload = sv.index_select(1, src_ids)
        dv.index_copy_(1, dst_ids, payload)
        moved += payload.numel() * payload.element_size()
    return dst_cache, moved


# Cache keys whose leading axis is the batch; every other dense-cache tensor
# is layer-leading with the batch at axis 1. Explicit metadata, not a shape
# heuristic (a heuristic misreads batch-leading tensors when slots == 1).
_BATCH_LEADING_KEYS = frozenset({"pos", "live"})
# Cache keys of the whole step, not of a lane: never spliced.
_STEP_KEYS = frozenset({"moe_stats"})


def _splice_lane(cache: Dict, lane: Dict, i: int) -> None:
    """Copy a single-lane cache (batch dim 1) into batch position i, in
    place."""
    for k, v in cache.items():
        if k in _STEP_KEYS:
            continue
        if k in _BATCH_LEADING_KEYS:
            v[i] = lane[k][0]
        else:
            v[:, i] = lane[k][:, 0]
