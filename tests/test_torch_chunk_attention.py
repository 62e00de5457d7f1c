"""K6, the paged chunk attention of chunked prefill
(``kernels/chunk_attention.py``, ``csrc/chunk_attention.cu``).

On the CPU: the plain version against ``ref.mha_attention`` on the lane's
gathered table (the path it replaced), valid rows only, and its padded rows
zero; the ``prefill_chunk`` step staged by ``StepGraphs`` against the eager
step, bit for bit.

On the card (marker ``gpu``; each test skips without a CUDA device): the
kernel against its plain version in bf16 and float32 at mistral-7b's chunk
shape and at every (head dim, group) the paged families serve; one captured
graph replayed for two lanes; the engine's replayed chunk step counting a
launch a layer; and the float-pool path reaching neither the gather nor the
dense attention. This file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_chunk_attention.py -q
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import chunk_attention as CA
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.serving.engine import InferenceEngine

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GARBAGE = 1e4      # what the null block holds: finite, never read


def _lane(gen, *, G, D, Hkv=2, C=8, bs=4, max_blocks=12, q_offset=0,
          n_valid=5, num_blocks=40, dtype=torch.float32, device="cpu"):
    """One lane's chunk: q (1, G·Hkv, C, D); pools with the null block full
    of garbage; the lane's table holding its blocks in a shuffled order,
    the rest the null block; kv_len (1,) and q_offset (0-d) int32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)
    kp, vp = randn(num_blocks, Hkv, bs, D), randn(num_blocks, Hkv, bs, D)
    kp[0], vp[0] = GARBAGE, -GARBAGE
    kv_len = q_offset + n_valid
    used = -(-kv_len // bs)
    ids = torch.randperm(num_blocks - 1, generator=gen)[:used] + 1
    table = torch.zeros(max_blocks, dtype=torch.int32)
    table[:used] = ids.to(torch.int32)
    return (randn(1, G * Hkv, C, D), kp, vp, table.to(device),
            torch.tensor([kv_len], dtype=torch.int32, device=device),
            torch.tensor(q_offset, dtype=torch.int32, device=device))


def _old_path(q, kp, vp, table, kv_len, q_offset, **kw):
    """What chunked prefill ran before K6: the whole table gathered, then
    the dense masked attention."""
    return ref.mha_attention(q, ref.gather_paged_kv(kp, table[None]),
                             ref.gather_paged_kv(vp, table[None]),
                             causal=True, q_offset=q_offset, kv_len=kv_len,
                             **kw)


# q_offset and valid rows of a chunk of 8, blocks of 4: the prompt's first
# chunk, a later chunk starting mid-block, the first chunk after a prefix
# of three whole blocks taken from the prefix cache (q_offset at a block
# edge), a window that binds (5 of the 29 rows reachable), a softcap; every
# case has padded rows and null blocks in its table
CASES = {"start": dict(q_offset=0, n_valid=5),
         "mid": dict(q_offset=13, n_valid=6),
         "prefix": dict(q_offset=12, n_valid=7),
         "window": dict(q_offset=21, n_valid=8, window=5),
         "softcap": dict(q_offset=9, n_valid=4, softcap=2.0)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 71])
def test_plain_version_is_the_gathered_attention_on_valid_rows(G, D, case):
    """The plain version gives the old path's valid rows, null blocks and
    padded rows in the table notwithstanding; its padded rows are zero."""
    kw = dict(CASES[case])
    att = {k: kw.pop(k) for k in ("window", "softcap") if k in kw}
    gen = torch.Generator().manual_seed(G * 1000 + D)
    q, kp, vp, table, kv_len, q_offset = _lane(gen, G=G, D=D, **kw)
    got = CA.paged_chunk_attention(q, kp, vp, table, kv_len, q_offset, **att)
    want = _old_path(q, kp, vp, table, kv_len, q_offset, **att)
    n = kw["n_valid"]
    torch.testing.assert_close(got[:, :, :n], want[:, :, :n], atol=1e-5,
                               rtol=1e-5)
    assert torch.count_nonzero(got[:, :, n:]) == 0
    assert got.dtype == q.dtype and got.shape == q.shape


def _chunk_engines(arch, graphs=(True, False), device="cpu",
                   dtype=torch.float32):
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=device).manual_seed(3)
    params = M.init_params(cfg, gen, dtype, device)
    return {g: InferenceEngine(cfg, params, max_len=64, device=device,
                               dtype=dtype, graphs=g) for g in graphs}


def _chunk_calls(eng, cache, seed=0):
    """Three chunks of 8 on two lanes of a paged cache (blocks of 4): lane
    1's first chunk, 5 valid rows; lane 0's first, full; lane 0's second,
    3 valid rows from q_offset 8. Returns each call's logits."""
    dev = cache["pos"].device
    cache["block_tables"][0, :4] = torch.tensor([5, 2, 9, 7])
    cache["block_tables"][1, :2] = torch.tensor([3, 11])
    gen = torch.Generator().manual_seed(seed)
    out = []
    for lane, n_valid in ((1, 5), (0, 8), (0, 3)):
        tokens = torch.randint(0, eng.cfg.vocab_size, (1, 8), generator=gen,
                               dtype=torch.int32).to(dev)
        logits, cache = eng.prefill_chunk(
            tokens, cache, torch.tensor(lane, dtype=torch.int32, device=dev),
            torch.tensor(n_valid, dtype=torch.int32, device=dev))
        out.append(logits)
    return out


@pytest.mark.parametrize("arch", ["mistral-7b", "phi3.5-moe-42b-a6.6b"])
def test_staged_chunk_step_is_the_eager_step(arch):
    """``prefill_chunk`` through ``StepGraphs`` (on the CPU it stages its
    buffers around an eager call) against the eager step: the same logits
    and cache, bit for bit; one entry for the chunk shape, replayed for
    both lanes and every valid count."""
    eng = _chunk_engines(arch)
    logits, caches = {}, {}
    for g, e in eng.items():
        caches[g] = e.new_paged_cache(2, 16, 4)
        logits[g] = _chunk_calls(e, caches[g])
    for a, b in zip(logits[True], logits[False]):
        assert torch.equal(a, b)
    for k in caches[False]:
        assert torch.equal(caches[True][k], caches[False][k]), k
    runner = eng[True].graphs
    assert (runner.captures, runner.replays, len(runner)) == (1, 2, 1)


# ------------------------------------------------------------------ card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")


def _card_lane(dtype, **kw):
    gen = torch.Generator().manual_seed(7)
    return _lane(gen, dtype=dtype, device="cuda", **kw)


# (D, G) of every paged configuration: D 128 at G 1 (llama2-7b,
# deepseek-7b), 4 (mistral-7b, phi3.5-moe, phi3-medium), 6 (grok-1), 8
# (qwen2.5-3b); D 64 at G 3 (smollm-360m) and 71 (falcon-7b)
HEADS = [(128, 1), (128, 4), (128, 6), (128, 8), (64, 3), (64, 71)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,G", HEADS)
def test_kernel_matches_plain_at_every_head_shape_on_card(D, G, dtype):
    """K6 against its plain version, every row (padded ones zero in both):
    a first chunk, one mid-prompt and mid-block, one past 300 rows of
    context under a binding window, and one with a softcap."""
    _need_card()
    before = CA.paged_chunk_attention.launches
    cases = [dict(q_offset=0, n_valid=37), dict(q_offset=77, n_valid=64),
             dict(q_offset=300, n_valid=50, window=96),
             dict(q_offset=40, n_valid=20, softcap=30.0)]
    for kw in cases:
        att = {k: kw.pop(k) for k in ("window", "softcap") if k in kw}
        inp = _card_lane(dtype, G=G, D=D, C=64, bs=16, max_blocks=32,
                         num_blocks=64, **kw)
        got = CA.paged_chunk_attention(*inp, **att)
        torch.cuda.synchronize()
        want = CA.paged_chunk_attention_ref(*inp, **att)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert CA.paged_chunk_attention.launches == before + len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("q_offset", [0, 1024])
@pytest.mark.parametrize("n_valid", [38, 256])
def test_kernel_matches_plain_at_mistral_chunk_on_card(n_valid, q_offset):
    """mistral-7b's chunk: C 256, 32/8 heads of 128, blocks of 16, a
    384-entry table, window 4096, bf16. After 1,024 prior rows an output
    is ~0.05, so each valid row is also held within 2e-2 of its own
    largest output; padded rows are 0."""
    _need_card()
    inp = _card_lane(torch.bfloat16, G=4, D=128, Hkv=8, C=256, bs=16,
                     max_blocks=384, q_offset=q_offset, n_valid=n_valid,
                     num_blocks=160)
    got = CA.paged_chunk_attention(*inp, window=4096).float()
    want = CA.paged_chunk_attention_ref(*inp, window=4096).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    err = (got - want)[:, :, :n_valid].abs()
    row = want[:, :, :n_valid].abs().amax(-1, keepdim=True)
    assert (err / row).max().item() <= 2e-2
    assert torch.count_nonzero(got[:, :, n_valid:]) == 0


@pytest.mark.gpu
def test_one_captured_chunk_serves_two_lanes_on_card():
    """One CUDA graph of K6, replayed for two lanes with their own table,
    q_offset and kv_len copied into its buffers: each lane's own answer."""
    _need_card()
    lanes = [_card_lane(torch.bfloat16, G=4, D=128, C=64, bs=16,
                        max_blocks=32, num_blocks=64, **kw)
             for kw in (dict(q_offset=0, n_valid=38),
                        dict(q_offset=200, n_valid=64))]
    # one pool pair for both: lane 1 reads lane 0's pools through its table
    q, kp, vp, table, kv_len, q_offset = lanes[0]
    q, table, kv_len, q_offset = (t.clone()
                                  for t in (q, table, kv_len, q_offset))
    CA.paged_chunk_attention(q, kp, vp, table, kv_len, q_offset)   # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = CA.paged_chunk_attention(q, kp, vp, table, kv_len, q_offset)
    answers = []
    for lq, _, _, lt, lk, lo in lanes:
        for buf, val in ((q, lq), (table, lt), (kv_len, lk), (q_offset, lo)):
            buf.copy_(val)
        graph.replay()
        torch.cuda.synchronize()
        want = CA.paged_chunk_attention_ref(lq, kp, vp, lt, lk, lo)
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        answers.append(out.clone())
    assert not torch.equal(answers[0], answers[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_replayed_chunk_step_counts_a_launch_a_layer_on_card(dtype):
    """The engine's chunk step on the card, replayed and eager: the same
    logits (within the dtype's tolerance) and the same greedy tokens, one
    capture, and K6's launches growing by the layer count at every call."""
    _need_card()
    eng = _chunk_engines("mistral-7b", device="cuda", dtype=dtype)
    layers = eng[True].cfg.num_layers
    logits, grown = {}, {}
    for g, e in eng.items():
        before = CA.paged_chunk_attention.launches
        logits[g] = _chunk_calls(e, e.new_paged_cache(2, 16, 4))
        torch.cuda.synchronize()
        grown[g] = CA.paged_chunk_attention.launches - before
    for a, b in zip(logits[True], logits[False]):
        torch.testing.assert_close(a, b, atol=TOL[dtype], rtol=TOL[dtype])
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    assert grown == {True: 3 * layers, False: 3 * layers}
    runner = eng[True].graphs
    assert (runner.captures, runner.replays) == (1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_float_pools_reach_neither_gather_nor_dense_attention_on_card(
        dtype, monkeypatch):
    """On the CUDA path with float pools the chunk step calls neither
    ``ref.gather_paged_kv`` nor ``ref.mha_attention``."""
    _need_card()
    def refuse(*a, **k):
        raise AssertionError("the plain chunk path was taken on the card")
    monkeypatch.setattr(ref, "gather_paged_kv", refuse)
    monkeypatch.setattr(ref, "mha_attention", refuse)
    (e,) = _chunk_engines("mistral-7b", graphs=(False,), device="cuda",
                          dtype=dtype).values()
    before = CA.paged_chunk_attention.launches
    _chunk_calls(e, e.new_paged_cache(2, 16, 4))
    torch.cuda.synchronize()
    assert CA.paged_chunk_attention.launches == before + 3 * e.cfg.num_layers
