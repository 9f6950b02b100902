"""The service's own milliseconds a request: the program's span
``service.request`` less its children ``pipeline.*`` (the three stages
and the copies to the host) and less the host's device synchronisations
between them, which are the benchmark's (its outside spans synchronise
around each stage; the program makes none on this path), averaged over
the traced requests."""

from harness import spans


def _overlap_ns(iv, span):
    return max(0, min(iv[1], span.end_ns) - max(iv[0], span.start_ns))


def read(ctx):
    requests = spans.named(ctx, "service.request")
    if not requests:
        return None
    stages = [s for s in spans.traced(ctx) if s.name.startswith("pipeline.")]
    syncs = spans.host_syncs(ctx)
    total = 0.0
    for r in requests:
        mine = [s for s in stages if s.parent == r.id]
        if not mine:
            return None
        outside = sum(_overlap_ns(iv, r) - sum(_overlap_ns(iv, s)
                                               for s in mine)
                      for iv in syncs)
        total += r.ms - sum(s.ms for s in mine) - outside / 1e6
    return total / len(requests)
