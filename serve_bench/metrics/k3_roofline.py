"""k3_roofline: K3 (``paged_decode_attention``: a split-KV kernel through
the block tables and a combine pass) against its roofline over the
profiled slice. Each call's bound is max(FLOPs / 989e12, bytes /
3.35e12) from that tick's live lanes and their kv_len capped at the
window, each byte counted once: q and o, the window's K and V rows, the
kv_len and the block-table entries. The share is the bounds' sum over the
K3 kernels' device time, over the ticks whose K3 kernels the profile
holds in full (one split and one combine a layer; ``_steps.py``). The
wrapper's ``launches`` over the slice must equal layers x decode steps."""
import re
import sys

from serve_bench import flops as F
from serve_bench.metrics._steps import ticks

SPLIT = re.compile(r"decode_split_kernel<[^(]*true>")


def bound_s(m, block_size, kv_lens):
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], F.head_dim(m)
    win = m.get("sliding_window")
    ks = [min(k, win) if win else k for k in kv_lens]
    flops = 4 * hq * hd * sum(ks)
    nbytes = (2 * len(ks) * hq * hd + 2 * hkv * hd * sum(ks)) * 2 \
        + 4 * len(ks) + 4 * sum(-(-k // block_size) for k in ks)
    return F.bound_s(flops, nbytes)


def _k3(name):
    if "decode_split_kernel" in name:
        return 2 if SPLIT.search(name) else 0
    # the combine is K2's and K3's alike; this cell's decode runs K3 alone
    return 1 if "decode_combine_kernel" in name else 0


def read(t):
    m = t.model
    bs = t.config["serving"]["block_size"]
    layers = m["num_layers"]
    n_calls = sum(1 for kind, _, a, b, _ in t.calls
                  if kind == "decode_paged" and t.in_slice(a, b))
    launched = t.launches.get("paged_decode_attention")
    if launched != layers * n_calls or t.launches.get("decode_attention"):
        print(f"k3_roofline: launches {t.launches} against {n_calls} decode "
              f"steps of {layers} layers", file=sys.stderr)
        return None
    got = ticks(t, "decode_paged", _k3, layers, lambda kind, meta: meta)
    if not got:
        return None
    want = sum(layers * bound_s(m, bs, kv) for ms, _ in got for kv in ms)
    dev = sum(d for _, d in got)
    return want / (dev * 1e-6) * 100.0
