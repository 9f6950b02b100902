"""Device kernels a decode step at batch 8, every kernel of a replayed
CUDA graph counted one by one: in each traced request, the kernels that
start from kernel E's first launch of the second step up to its first
launch of the last step, over the steps between (E runs once a layer a
step; the first step, the prefill, is left out).  Segment switches inside
that stretch count with the steps.  None where the trace holds another
number of E launches than the traced requests' steps call for."""

from bisect import bisect_left

from harness import readers


def read(ctx):
    tw = ctx.trace
    layers = ctx.config["model"]["n_layer"]
    steps = ctx.counters["steps"]
    requests = ctx.counters.get("traced_units", 0)
    if tw is None or not requests or steps < 3:
        return None
    is_e = readers.contains("decode_attention_kernel")
    starts = sorted(k.start_ns for k in tw.kernels)
    e = sorted(k.start_ns for k in tw.kernels if is_e(k.name))
    per_request = layers * steps
    if len(e) != requests * per_request:
        return None
    count = 0
    for r in range(requests):
        lo = e[r * per_request + layers]
        hi = e[r * per_request + (steps - 1) * layers]
        count += bisect_left(starts, hi) - bisect_left(starts, lo)
    return count / (requests * (steps - 2))
