"""Nothing under ``portbench/`` imports JAX or the JAX package, compared by
whole top-level module name (``melspec_tpu_torch`` is not
``melspec_tpu``), and the reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from portbench.lib import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "melspec_tpu"}
FILES = sorted(registry.ROOT.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(registry.ROOT)))
def test_no_jax_imports(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((registry.ROOT / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "melspec_tpu_torch" not in top_level_imports(path)


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "a.py"
    f.write_text("import melspec_tpu_torch.ops\nfrom jax import numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}


def test_run_names_a_loaded_jax_package():
    from portbench import run

    assert run.forbidden_modules(["melspec_tpu_torch.ops", "torch",
                                  "portbench_entries_x"]) == []
    assert run.forbidden_modules(["melspec_tpu.ops", "jaxlib.xla_client",
                                  "melspec_tpu_torch"]) == ["jaxlib",
                                                            "melspec_tpu"]
