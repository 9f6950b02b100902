"""The measured window's peak of allocated device memory
(``torch.cuda.max_memory_allocated`` after set-up), in GiB."""

from harness import readers


def read(ctx):
    return readers.peak_gib(ctx)
