"""A run at a tiny size on the CPU (the look for a card skipped), with the
timed path broken underneath: ``correct`` has to come out false for each
fault a serving cell can have, and true with nothing broken. (One chip:
there is no exchange between chips to leave out.)"""
import pytest
import torch

import _tiny


DECODES = ("decode_paged", "decode")


def state_unchanged(prog):
    """The decode step returns the cache as it found it."""
    for name in DECODES:
        inner = getattr(prog.engine, name)

        def step(tokens, cache, *a, inner=inner):
            held = {k: v.clone() for k, v in cache.items()}
            out = inner(tokens, cache, *a)
            for k, v in held.items():
                cache[k].copy_(v)
            return out
        setattr(prog.engine, name, step)


def half_batch(prog):
    """The decode step computes the first half of the lanes; the second
    half gets the first half's logits."""
    for name in DECODES:
        inner = getattr(prog.engine, name)

        def step(tokens, cache, *a, inner=inner):
            logits, cache = inner(tokens, cache, *a)
            h = logits.shape[0] // 2
            logits = logits.clone()
            logits[h:2 * h] = logits[:h]
            return logits, cache
        setattr(prog.engine, name, step)


def token_altered(prog):
    """Every third decode step serves another token than its argmax."""
    n = [0]
    for name in DECODES:
        inner = getattr(prog.engine, name)

        def step(tokens, cache, *a, inner=inner):
            logits, cache = inner(tokens, cache, *a)
            n[0] += 1
            if n[0] % 3 == 0:
                logits = logits.clone()
                best = logits.argmax(-1)
                logits[torch.arange(len(best)), (best + 1)
                       % logits.shape[-1]] += 1e3
            return logits, cache
        setattr(prog.engine, name, step)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.hybrid"])
@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch,
                                   token_altered],
                         ids=["sound", "state_unchanged", "half_batch",
                              "token_altered"])
def test_fault_fails_correct(root, cell, fault):
    res = _tiny.run(root, cell, seconds=3.0, hook=fault)
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), res["checks"]
