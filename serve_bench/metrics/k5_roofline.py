"""k5_roofline: K5 (``ssd_scan``: chunk states, a scan over chunks, the
outputs) against its roofline over the profiled slice, one call per Mamba
layer of each whole-prompt prefill. A call's bound at prompt length S
(H, P, N and the chunk L from the configuration): FLOPs 2 H (pairs (N +
P) + 2 S P N), pairs the causal (i, j) within each chunk of the S rows;
bytes x and y, B and C, dt and A, the final state, each once. The share
is the bounds' sum over the K5 kernels' device time, over the ticks whose
K5 kernels the profile holds in full (``_steps.py``); the wrapper's
``launches`` over the slice must equal layers x prefills."""
import sys

from serve_bench import flops as F
from serve_bench.metrics._steps import ticks

PASSES = ("ssd_chunk_state", "ssd_state_scan", "ssd_output")


def bound_s(S, H, P, N, L):
    full, r = divmod(S, L)
    pairs = full * L * (L + 1) // 2 + r * (r + 1) // 2
    flops = 2 * H * (pairs * (N + P) + 2 * S * P * N)
    nbytes = (2 * H * S * P + 2 * S * N) * 2 + (H * S + H) * 4 + H * P * N * 4
    return F.bound_s(flops, nbytes)


def _k5(name):
    base = name.split("<")[0].split("(")[0].split()[-1].split("::")[-1]
    if not base.startswith(PASSES):
        return 0
    return 2 if base.startswith("ssd_output") else 1


def read(t):
    m = t.model
    s = m["ssm"]
    P, N = s["head_dim"], s["state_dim"]
    H = s["expand"] * m["d_model"] // P
    layers = m["num_layers"]
    n_calls = sum(1 for kind, _, a, b, _ in t.calls
                  if kind == "prefill" and t.in_slice(a, b))
    if t.launches.get("ssd_scan") != layers * n_calls:
        print(f"k5_roofline: launches {t.launches} against {n_calls} "
              f"prefills of {layers} layers", file=sys.stderr)
        return None
    got = ticks(t, "prefill", _k5, layers, lambda kind, meta: meta[1])
    if not got:
        return None
    want = sum(layers * bound_s(S, H, P, N, s["chunk_size"])
               for ss, _ in got for S in ss)
    dev = sum(d for _, d in got)
    return want / (dev * 1e-6) * 100.0
