"""The service's milliseconds a request outside the pipeline's stages: a
request's wall time at the client less the synchronised spans of its
``generate_tokens``, ``decode_specs`` and ``vocode``, averaged over the
window's requests."""

import math


def read(ctx):
    lat = [x for x in getattr(ctx.runner, "latencies", []) if
           math.isfinite(x)]
    stages = [ctx.spans.get(s) or [] for s in
              ("generate_tokens", "decode_specs", "vocode")]
    if not lat or not all(stages):
        return None
    return 1e3 * (sum(lat) - sum(sum(s) for s in stages)) / len(lat)
