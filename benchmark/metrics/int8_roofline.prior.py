"""The int8 block product's share of its roofline over the traced batch's
decode, at M = 256 (past the one-launch kernel's 16 rows, so the chain):
``quantize_rows``, cuBLASLt's int8 GEMM (``torch._int_mm``) and
``rescale_bias``, four products a layer a step.  A product's least time is
the larger of its bytes -- the int8 weights (K x N), the bf16 rows in (M x
K) and out (M x N), the weights' float32 scales and bf16 bias (N) and the
rows' float32 scales (M) -- over the memory rate and of its 2 M K N int8
operations over the int8 peak; the chain's intermediates (the int8 rows,
the int32 sums) are work the product need not do and are not counted.
Over the three kernels' device time in the trace."""

from harness import counts, readers

KERNELS = ("quantize_rows_kernel", "rescale_bias_kernel")
# cuBLASLt's int8 GEMMs: CUTLASS's "..._i16832gemm_s8_..." on the H100, or
# an "s8s8" / "imma" kernel of another cuBLAS
GEMMS = ("gemm_s8", "s8s8", "imma")


def is_chain(name: str) -> bool:
    key = name.lower()
    return any(k in key for k in KERNELS) or any(g in key for g in GEMMS)


def product_bound(m: int, k: int, n: int) -> float:
    n_bytes = k * n + 2 * m * k + 2 * m * n + 4 * n + 2 * n + 4 * m
    return counts.bound_s(n_bytes, 2.0 * m * k * n, "int8")


def read(ctx):
    cfg = ctx.config["model"]
    m = ctx.counters.get("traced_clips", 0)
    steps = ctx.counters["steps"]
    if not m:
        return None
    d = cfg["n_embd"]
    shapes = ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d))
    per_step = sum(product_bound(m, k, n) for k, n in shapes)
    bound = per_step * cfg["n_layer"] * steps
    return readers.roofline(ctx, is_chain, bound,
                            3 * len(shapes) * cfg["n_layer"] * steps)
