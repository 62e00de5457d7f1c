"""queue_wait_ms: the median time from ``submit`` until the request leaves
its batcher's queue for a lane, over requests submitted in the window
that left it there (the batching layer's admission). A look for who has
left is taken at each engine call's entry and each tick's end."""
import statistics


def read(t):
    w = [r.leave_t - r.submit_t for r in t.served.reqs
         if r.leave_t is not None and r.submit_t is not None
         and t.in_window(r.submit_t, r.leave_t)]
    return statistics.median(w) * 1e3 if w else None
