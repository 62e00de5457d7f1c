"""The plain references against the served package's forward at a tiny
size, on the same weights (drawn by the reference, handed to both), and
the references' independence from the package."""
import subprocess
import sys

import pytest
import torch

import _tiny
from serve_bench.reference import dense, hybrid


def _port(model):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    kw = dict(model)
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(name="tiny", **kw)


@pytest.mark.parametrize("ref,model,S", [
    (dense, _tiny.DENSE, 70),                     # past the window of 48
    (dense, dict(_tiny.DENSE, sliding_window=None), 33),
    (hybrid, _tiny.HYBRID, 150),                  # several scan chunks
    (hybrid, dict(_tiny.HYBRID, num_layers=5), 9)],
    ids=["dense-window", "dense-full", "hybrid", "hybrid-5"])
def test_reference_equals_forward(ref, model, S):
    from repro_torch.models import model as M
    g = torch.Generator().manual_seed(5)
    w = ref.make_weights(model, g, torch.float32, "cpu")
    toks = torch.randint(0, model["vocab_size"], (2, S), generator=g)
    want, _ = M.forward_train(w, _port(model), {"tokens": toks})
    got = ref.forward(w, model, [toks[0], toks[1]], [0, S // 2])
    assert torch.allclose(got[0], want[0], atol=2e-5, rtol=0)
    assert torch.allclose(got[1], want[1, S // 2:], atol=2e-5, rtol=0)


@pytest.mark.parametrize("ref,model", [(dense, _tiny.DENSE),
                                       (hybrid, _tiny.HYBRID)],
                         ids=["dense", "hybrid"])
def test_served_prefill_and_decode(ref, model):
    """Prefill then decode through the package's cache agree with the
    reference's one pass over the whole sequence (bf16 weights both)."""
    from repro_torch.serving.engine import InferenceEngine
    g = torch.Generator().manual_seed(6)
    w = ref.make_weights(model, g, torch.bfloat16, "cpu")
    eng = InferenceEngine(_port(model), w, max_len=64, dtype=torch.bfloat16,
                          device="cpu")
    toks = torch.randint(0, model["vocab_size"], (1, 12), generator=g)
    res = eng.generate({"tokens": toks}, 6)
    seq = torch.cat([toks[0], torch.as_tensor(res.tokens[0][:-1])])
    lg = ref.forward(w, model, [seq], [11])[0]
    served = torch.as_tensor(res.tokens[0], dtype=torch.long)
    gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
    assert float(gap.max()) < _tiny.LIMIT


def test_weights_from_the_seed():
    a = dense.make_weights(_tiny.DENSE, torch.Generator().manual_seed(1),
                           torch.bfloat16, "cpu")
    b = dense.make_weights(_tiny.DENSE, torch.Generator().manual_seed(1),
                           torch.bfloat16, "cpu")
    assert torch.equal(a["layers"][1]["mlp"]["down"]["w"],
                       b["layers"][1]["mlp"]["down"]["w"])
    assert a["layers"][0]["attn"]["q"]["w"].dtype == torch.bfloat16
    sd = a["layers"][0]["attn"]["q"]["w"].float().std().item()
    assert sd == pytest.approx(64 ** -0.5, rel=0.1)


def test_references_import_nothing_of_the_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import serve_bench.reference.dense, serve_bench.reference.hybrid"
            "; bad = sorted({k.split('.')[0] for k in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}); print(bad)"
            % str(_tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
