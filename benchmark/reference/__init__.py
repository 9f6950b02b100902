"""Plain float32 references of the benchmark's configurations: plain
PyTorch, no kernel, cache, quantisation or batching, and nothing of the
program under test (checked by benchmark/tests/test_bench_imports.py)."""
