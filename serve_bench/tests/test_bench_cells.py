"""The repository's benchmark as it stands: every cell found, loaded and
cross-checked."""
import json

import _tiny
from serve_bench.bench import validate


def test_the_repository_benchmark_validates_its_cells():
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    assert validate(bench, _tiny.REPO) == [
        "mistral7b.chat", "zamba2.burst", "mistral7b.longprompt",
        "nemotron3nano.chat"]


def test_longprompt_offers_every_seed_the_same_requests():
    """A 1-4k prompt is over 1% of the window's tokens, so the long-prompt
    mix does not shuffle: every seed gets the same arrivals and sizes in
    the same order, and only its own prompt ids."""
    mix = json.loads((_tiny.REPO / "serve_bench/traffic/longprompt.json")
                     .read_text())
    from serve_bench import traffic as T
    runs = [T.make_requests(mix, seed, 100, 56.0)
            for seed in (1, 2 ** 31 + 7, 2 ** 33)]
    assert [(r.due, r.m, r.n) for r in runs[0]] == \
        [(r.due, r.m, r.n) for r in runs[1]] == \
        [(r.due, r.m, r.n) for r in runs[2]]
    assert runs[0][0].prompt.tobytes() != runs[1][0].prompt.tobytes()
