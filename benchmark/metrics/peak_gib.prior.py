"""The prior cell's peak of allocated device memory over the measured
window (``torch.cuda.max_memory_allocated`` after set-up), in GiB."""

from harness import readers


def read(ctx):
    return readers.peak_gib(ctx)
