"""The benchmark loads neither JAX nor the JAX package nor the repo's older
harnesses, and its reference nothing of the program either.  Module names
are compared by their whole top-level name: `utree_tpu_torch` is not
`utree_tpu`."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "utree_tpu", "bench", "chip_smoke", "kernel_ab"}


def imported(path: pathlib.Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not imported(path) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "utree_tpu_torch" not in imported(path)
    assert imported(path) <= {"__future__", "numpy", "torch", "portbench"}


def test_top_level_names_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import utree_tpu_torch.pipeline\nfrom utree_tpu_torch import lookup\n")
    assert imported(p) == {"utree_tpu_torch"}
    assert not imported(p) & NEVER
