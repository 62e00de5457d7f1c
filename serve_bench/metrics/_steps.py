"""A kernel's device time and calls, tick by tick, from the profiled
slice: a kernel belongs to the ``batcher.step`` span holding its launch
on the host (``harness.Profile``), and a tick's calls are the engine-call
spans it holds. A tick counts when its kernels are exactly the ones its
calls launch; a tick with a record missing is left out, and how many
were is printed."""
import sys
from collections import Counter

from serve_bench import harness as H


def ticks(t, call, is_kernel, per_call, meta_of):
    """[(metas, device us)] for each complete tick holding ``call``
    spans; ``is_kernel(name)`` -> 0 (not this kernel's), 1 (one of its
    kernels) or 2 (one of its kernels, counted once per call);
    ``per_call`` the counted kernels one call launches."""
    p = t.profile
    steps = H.spans_of(p, "batcher.step")
    calls = H.spans_of(p, "engine." + call)
    metas = [meta_of(kind, meta) for kind, _, a, b, meta in t.calls
             if kind == call and t.in_slice(a, b)]
    if len(calls) != len(metas):
        print(f"{call}: {len(calls)} profiled calls, {len(metas)} recorded",
              file=sys.stderr)
        return None
    by_step = {}
    for (ts, _), m in zip(calls, metas):
        by_step.setdefault(H.place(steps, ts), []).append(m)
    dev = {i: 0.0 for i in by_step}
    cnt = {i: 0 for i in by_step}
    lost = 0
    for name, _, d, at in p.kernels:
        kind = is_kernel(name)
        if not kind:
            continue
        i = H.place(steps, at)
        if i in by_step and i >= 0:
            dev[i] += d
            cnt[i] += kind == 2
        else:
            lost += 1
    out, seen = [], Counter()
    for i, ms in by_step.items():
        seen[(cnt[i], per_call * len(ms))] += 1
        if i >= 0 and cnt[i] == per_call * len(ms):
            out.append((ms, dev[i]))
    bad = {k: v for k, v in seen.items() if k[0] != k[1]}
    print(f"{call}: {len(out)} of {len(by_step)} ticks complete, {lost} "
          f"kernels placed in no such tick"
          + (f"; (found, launched): ticks {dict(bad)}" if bad else ""),
          file=sys.stderr)
    return out
