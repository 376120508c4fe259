"""Nothing the benchmark runs imports jax or the JAX package, and the
reference imports nothing of the port: every import of every Python file
under bench_port, by its top-level name compared whole (the port's name
begins with the JAX package's)."""
import ast
import sys

import pytest

from harness import main as hm
from harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "deep_tracking_control_tpu"}
PORT = "deep_tracking_control_tpu_torch"


def imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(p for p in manifest.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


@pytest.mark.parametrize("part", ["harness", "reference", "metrics",
                                  "counts", "run"])
def test_no_jax(part):
    files = [p for p in FILES if p.relative_to(manifest.BENCH).parts[0]
             .removesuffix(".py") == part]
    assert files
    for p in files:
        names = set(imports(p))
        assert not names & FORBIDDEN, (p, names & FORBIDDEN)
        if part == "reference":
            assert PORT not in names, p


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert hm.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "deep_tracking_control_tpu.fake",
                        object())
    assert "deep_tracking_control_tpu" in hm.forbidden_modules()
