"""Nothing under benchmark/ imports JAX or the JAX package (compared as
whole top-level names: the program's name begins with the JAX
package's), and the reference imports nothing of the program nor of the
harness that drives it."""

import ast
from pathlib import Path

import pytest

from harness import cell as cells
from harness.cell import BENCH_DIR

FILES = sorted(BENCH_DIR.rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not set(imported(path)) & set(cells.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    names = set(imported(path))
    assert "melspec_gpt_vqvae_tpu_torch" not in names
    assert not names & {"harness", "generators", "run"}


def test_forbidden_compares_whole_names():
    assert cells.forbidden_loaded(["melspec_gpt_vqvae_tpu_torch.models",
                                   "jaxtyping", "numpy"]) == []
    assert cells.forbidden_loaded(["jax.numpy", "melspec_gpt_vqvae_tpu.ops",
                                   "flax"]) == ["flax", "jax",
                                                "melspec_gpt_vqvae_tpu"]
