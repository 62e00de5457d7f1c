"""tick_ms: wall milliseconds inside a batcher's ``step()`` per tick, over
the window (admission, prefill, the decode step and its host sync)."""


def read(t):
    d = [b - a for n, a, b, _ in t.spans
         if n == "batcher.step" and t.in_window(a, b)]
    return sum(d) / len(d) * 1e3 if d else None
