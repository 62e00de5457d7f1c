"""The yardstick's FLOP and byte functions against hand counts at small
sizes, and the model FLOPs against PyTorch's own count of the plain
reference's products."""
import importlib.util

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _tiny
from serve_bench import flops as F
from serve_bench.reference import dense, hybrid


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, _tiny.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("start,n,window", [(0, 5, None), (3, 4, None),
                                            (0, 10, 4), (2, 5, 4),
                                            (6, 3, 4), (3, 1, 4)])
def test_keys_sum(start, n, window):
    want = sum(min(p + 1, window) if window else p + 1
               for p in range(start, start + n))
    assert F.keys_sum(start, n, window) == want


def test_dense_hand_count():
    m = dict(_tiny.DENSE, sliding_window=4)      # d 64, 4/2 heads of 16
    d, f, V = 64, 128, 256
    per_layer = 2 * (d * 64 + 2 * d * 32 + 64 * d + 3 * d * f)
    assert F.token_mm_flops(m) == 2 * per_layer
    # a prompt of 6 at 0: keys 1, 2, 3, 4, 4, 4; one row of logits
    attn = 2 * 4 * 4 * 16 * (1 + 2 + 3 + 4 + 4 + 4)
    assert F.prefill_flops(m, 0, 6, True) == 6 * 2 * per_layer + attn \
        + 2 * d * V
    assert F.prefill_flops(m, 0, 6, False) == 6 * 2 * per_layer + attn
    # a decode token at kv_len 9 sees the window's 4 keys
    assert F.decode_flops(m, 9) == 2 * per_layer + 2 * 4 * 4 * 16 * 4 \
        + 2 * d * V


def test_hybrid_hand_count():
    m = _tiny.HYBRID                 # 3 Mamba layers, the shared block once
    d, di, N, H, P, W, f = 64, 128, 16, 8, 16, 4, 128
    mamba = 2 * (d * (2 * di + 2 * N + H) + di * d) + 2 * W * (di + 2 * N) \
        + 4 * H * P * N
    shared = 2 * 4 * d * 64 + 2 * 2 * d * f
    assert F.token_mm_flops(m) == 3 * mamba + shared
    assert F.decode_flops(m, 7) == 3 * mamba + shared + 4 * 4 * 16 * 7 \
        + 2 * d * 256


@pytest.mark.parametrize("ref,model", [(dense, _tiny.DENSE),
                                       (hybrid, _tiny.HYBRID)],
                         ids=["dense", "hybrid"])
def test_matches_flop_counter(ref, model):
    """One prompt through the plain reference: PyTorch's count of its
    matrix products (projections, MLP, scores and values over the whole
    unmasked square, the logits of every row) against flops.py's, with
    the attention and logit terms put on the same footing."""
    S = 40
    m = dict(model, sliding_window=None)
    w = ref.make_weights(m, torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    toks = torch.randint(0, m["vocab_size"], (S,))
    with FlopCounterMode(display=False) as fc:
        ref.forward(w, m, [toks], [0])
    got = fc.get_total_flops()
    # the reference scores every (i, j) of the square and masks after
    square = F.attention_layers(m) * 4 * m["num_heads"] * F.head_dim(m) \
        * S * S
    want = F.prefill_flops(m, 0, S, True) - F.attn_flops(
        m, F.keys_sum(0, S, None)) + square + (S - 1) * F.unembed_flops(m)
    if m["family"] == "hybrid":
        # the reference's scan is its chunked quadratic form, not the
        # recurrence flops.py counts: take both out
        s = m["ssm"]
        H = s["expand"] * m["d_model"] // s["head_dim"]
        want -= m["num_layers"] * S * 4 * H * s["head_dim"] * s["state_dim"]
        conv = m["num_layers"] * S * 2 * s["conv_width"] * (
            s["expand"] * m["d_model"] + 2 * s["state_dim"])
        want -= conv                    # elementwise there, uncounted
        got -= _ssd_counted(m, S)
    assert got == want


def _ssd_counted(m, S):
    """FlopCounterMode's count of the reference scan's products."""
    s = m["ssm"]
    H, P, N = s["expand"] * m["d_model"] // s["head_dim"], s["head_dim"], \
        s["state_dim"]
    total = 0
    for a in range(0, S, hybrid.CHUNK):
        l = min(S, a + hybrid.CHUNK) - a
        total += 2 * l * l * N                    # C Bᵀ
        total += 2 * l * l * H * P                # the weighted sum of x
        total += 2 * l * N * H * P                # C against the state
        total += 2 * l * H * P * N                # the state's update
    return m["num_layers"] * total


def test_k3_bound_hand_count():
    k3 = _reader("k3_roofline")
    m = {"num_heads": 32, "num_kv_heads": 8, "d_model": 4096,
         "sliding_window": 4096}
    kv = [40, 5000]                  # the second capped at the window
    flops = 4 * 32 * 128 * (40 + 4096)
    nbytes = (2 * 2 * 32 * 128 + 2 * 8 * 128 * (40 + 4096)) * 2 + 4 * 2 \
        + 4 * (3 + 256)
    assert k3.bound_s(m, 16, kv) == max(flops / 989e12, nbytes / 3.35e12)


def test_k5_bound_hand_count():
    k5 = _reader("k5_roofline")
    S, H, P, N, L = 300, 64, 64, 64, 128          # chunks of 128, 128, 44
    pairs = 2 * 128 * 129 // 2 + 44 * 45 // 2
    flops = 2 * H * (pairs * (N + P) + 2 * S * P * N)
    nbytes = (2 * H * S * P + 2 * S * N) * 2 + (H * S + H) * 4 \
        + H * P * N * 4
    assert k5.bound_s(S, H, P, N, L) == max(flops / 989e12, nbytes / 3.35e12)
