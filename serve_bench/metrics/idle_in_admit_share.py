"""idle_in_admit_share: the share of the card's idle time inside ticks,
outside the program's ``graph.replay`` spans, that the host spent
admitting requests, inside the program's ``tick.admit`` (paged) or
``tick.fill`` (dense) spans and their children.

Idle time inside ``graph.replay`` is left out of the share: under the
profiler the card waits inside each ``cudaGraphLaunch`` for milliseconds,
longer than an untraced tick's whole host work (``tick_host_ms``), so
that idle time is the profiler's, and a change that launched fewer graphs
would otherwise raise the share with admission unchanged. The table on
standard error keeps it.

The idle time is ``idle_share``'s: each ``batcher.step`` span less the
union of the device ops launched in it (their correlation ids). A tick's
ops are put on the host's clock by their device timestamps less the
tick's smallest (device start - host launch): no op starts before the
host launched it, and a tick's first op, launched on an idle card after
the last tick's sync, starts within microseconds of its launch. The two
clocks drift apart by up to 2 ms a second and jump where the profiler
aligns them again, so one difference for the whole slice would not do;
within a tick the drift is a fraction of a millisecond, and a constant
offset changes nothing. (Each gap is not put just before the launch of
the op that ends it: a ``cudaGraphLaunch`` holds the host for
milliseconds under the profiler while the card waits, so the wait lies
inside the launch call, not before it.) Standard error gets the idle ms
per tick by the innermost program span (``batcher.step`` where none is
open)."""
import bisect
import sys

from serve_bench import harness as H

ADMIT = ("tick.admit", "tick.fill")
REPLAY = "graph.replay"


def idle_on_host(p):
    """[(a, b)]: every tick's idle time as host intervals, and the ticks."""
    steps = H.spans_of(p, "batcher.step")
    mine = {}
    for ts, te, at in p.device:
        i = H.place(steps, at)
        if i >= 0:
            mine.setdefault(i, []).append((ts, te, at))
    out = []
    for i, (s0, s1) in enumerate(steps):
        ops = mine.get(i, ())
        off = min((ts - at for ts, _, at in ops), default=0.0)
        cur = s0
        for a, b in H.union([(ts - off, te - off) for ts, te, _ in ops]):
            if a >= s1:
                break
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if cur < s1:
            out.append((cur, s1))
    return out, len(steps)


def minus(ivs, cuts):
    """The parts of the sorted, disjoint intervals ``ivs`` outside the
    sorted, disjoint ``cuts``."""
    out, j = [], 0
    for a, b in ivs:
        while j < len(cuts) and cuts[j][1] <= a:
            j += 1
        k = j
        while a < b and k < len(cuts) and cuts[k][0] < b:
            if cuts[k][0] > a:
                out.append((a, cuts[k][0]))
            a = max(a, cuts[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def innermost(spans):
    """Disjoint (a, b, name) pieces of nested (a, b, name) spans, each named
    by the innermost span holding it."""
    out, stack, cur = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, n = stack.pop()
            if cur < end:
                out.append((cur, end, n))
                cur = end
        if stack and cur < a:
            out.append((cur, a, stack[-1][1]))
        cur = a
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    while stack:
        end, n = stack.pop()
        if cur < end:
            out.append((cur, end, n))
            cur = end
    return out


def covered(iv, pieces, starts):
    """The length of ``iv`` that the sorted, disjoint ``pieces`` (their
    ``starts``) cover, by name: {name: length}."""
    a, b = iv
    got = {}
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(pieces) and pieces[i][0] < b:
        lo, hi = max(a, pieces[i][0]), min(b, pieces[i][1])
        if hi > lo:
            n = pieces[i][2]
            got[n] = got.get(n, 0.0) + hi - lo
        i += 1
    return got


def read(t):
    try:
        from repro_torch.serving.trace import SPANS
    except ImportError:
        return None
    p = t.profile
    prog = [(ts, ts + d, n) for n, ts, d in p.annotations if n in SPANS]
    if not prog:
        return None
    idle, n_ticks = idle_on_host(p)
    total = sum(b - a for a, b in idle)
    if not total:
        return None
    counted = minus(idle, H.union([(a, b) for a, b, n in prog
                                   if n == REPLAY]))
    share = sum(b - a for a, b in counted)
    admit = [(a, b, "admit") for a, b in
             H.union([(a, b) for a, b, n in prog if n in ADMIT])]
    a_starts = [a for a, _, _ in admit]
    inside = sum(covered(iv, admit, a_starts).get("admit", 0.0)
                 for iv in counted)
    steps = [(a, b, "batcher.step") for a, b in
             H.spans_of(p, "batcher.step")]
    segs = innermost(steps + prog)
    s_starts = [a for a, _, _ in segs]
    by = {}
    for iv in idle:
        for n, d in covered(iv, segs, s_starts).items():
            by[n] = by.get(n, 0.0) + d
    print(f"idle_in_admit_share: idle ms per tick over {n_ticks} ticks "
          f"({total / n_ticks * 1e-3:.3f} in all, "
          f"{share / n_ticks * 1e-3:.3f} outside {REPLAY}, "
          f"{inside / n_ticks * 1e-3:.3f} in admission) by innermost "
          "program span: " + ", ".join(
              f"{n} {d / n_ticks * 1e-3:.3f}" for n, d in
              sorted(by.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    return inside / share * 100.0 if share else None
