"""Nothing under benchmark/ imports JAX or the JAX package (the top-level
module name compared whole: brush_tpu_torch is the program and
allowed), and nothing reads the JAX package's benchmark files."""

import ast
import os

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "brush_tpu"}
JAX_FILES = ("bench.py", "BENCH_r0", "BASELINE.json", "MULTICHIP_r0")


def sources():
    base = os.path.join(ROOT, "benchmark")
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_import():
    found = []
    for path in sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names
                      if n.split(".")[0] in BANNED]
    assert not found


def strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_reads_no_jax_benchmark_file():
    """No code string names the JAX package's benchmark files."""
    for path in sources():
        if path.endswith("test_bench_imports.py"):
            continue
        for text in strings(ast.parse(open(path).read())):
            assert not any(name in text for name in JAX_FILES), path


def test_forbidden_modules_compares_whole_names():
    import sys

    from benchmark import harness

    sys.modules["brush_tpu_torchx"] = sys
    sys.modules["brush_tpu.probe"] = sys
    try:
        found = harness.forbidden_modules()
    finally:
        del sys.modules["brush_tpu_torchx"], sys.modules["brush_tpu.probe"]
    assert "brush_tpu.probe" in found and "brush_tpu_torchx" not in found
