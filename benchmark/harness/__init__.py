"""The benchmark's yardstick: cells read from BENCHMARK.json, seeded
inputs and weights, the window's clocks, the profiler's trace, operation
and byte counts, the table of peaks and the comparisons that decide
``correct``."""
