"""K7 (``moe_experts``: the grouped expert kernel, two device kernels a
call) in the decode-only ticks of the profiled slice: a tick that holds
one ``engine.decode`` call and no prefill, whose K7 kernels the profile
holds in full (one down product a MoE layer). Each such tick is matched
to the program's own tick record (``trace.TICKS``, the harness's clock)
for its routed rows and experts touched. Nothing where the program
launches no K7 or keeps no such counts."""
import re
import sys
from collections import Counter

from serve_bench import harness as H

KERNEL = re.compile(r"moe_gemm<(true|false)>")


def decode_ticks(t):
    """[(tick record, K7 device us, the tick's busy device us)], or None."""
    try:
        from repro_torch.serving import trace
    except ImportError:
        return None
    m = t.model
    n_e = m.get("block_pattern", "").count("E")
    if not n_e:
        return None
    p = t.profile
    steps = H.spans_of(p, "batcher.step")
    mine = sorted((a, b) for n, a, b, _ in t.spans
                  if n == "batcher.step" and t.in_slice(a, b))
    if not steps or len(mine) != len(steps):
        print(f"k7: {len(steps)} profiled ticks, {len(mine)} recorded",
              file=sys.stderr)
        return None
    dec = Counter(H.place(steps, a) for a, _ in H.spans_of(p, "engine.decode"))
    pre = {H.place(steps, a) for a, _ in H.spans_of(p, "engine.prefill")}
    dev, down, busy = Counter(), Counter(), {}
    for name, _, d, at in p.kernels:
        hit = KERNEL.search(name)
        if hit:
            i = H.place(steps, at)
            dev[i] += d
            down[i] += hit.group(1) == "false"
    for ts, te, at in p.device:
        busy.setdefault(H.place(steps, at), []).append((ts, te))
    t0 = t.served.t0
    recs = [k for k in trace.TICKS
            if getattr(k, "experts_touched", 0) and t.in_slice(
                k.start - t0, k.end - t0)]
    out, skipped = [], 0
    for i, (a, b) in enumerate(mine):
        if dec[i] != 1 or i in pre:
            continue
        rec = [k for k in recs if a <= k.start - t0 and k.end - t0 <= b]
        if down[i] != n_e or len(rec) != 1:
            skipped += 1
            continue
        tot = sum(y - x for x, y in H.union(busy.get(i, [])))
        out.append((rec[0], dev[i], tot))
    print(f"k7: {len(out)} decode-only ticks complete, {skipped} left out",
          file=sys.stderr)
    if out:
        k = m["moe"]["num_experts_per_tok"]
        bad = sum(1 for r, _, _ in out
                  if r.routed_rows != n_e * k * r.decode_lanes)
        share = sum(d for _, d, _ in out) / sum(b for _, _, b in out)
        print(f"k7: routed rows != {n_e} x {k} x live lanes in {bad} ticks; "
              f"K7 {share * 100:.2f}% of those ticks' busy device time",
              file=sys.stderr)
    return out or None
