"""Nothing in the benchmark imports JAX or the JAX package, and the
reference and its inputs import nothing of the program either (top-level
names compared whole: the program's name begins with the JAX package's)."""

import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "yet_another_wizz_tpu"}
PROGRAM = "yet_another_wizz_tpu_torch"
REFERENCE = ("harness/reference.py", "harness/cosmo.py", "harness/inputs.py",
             "harness/check.py", "harness/roofline.py")


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        imports = top_level_imports(BENCH / name)
        assert PROGRAM not in imports, name
        assert imports <= {"__future__", "dataclasses", "math", "numpy", "torch",
                           "harness"}, name


def test_the_guard_sees_a_whole_name(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import yet_another_wizz_tpu_torch.ops\nfrom jax import numpy\n")
    assert top_level_imports(path) == {PROGRAM, "jax"}
