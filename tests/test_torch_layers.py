"""The direction of the port's imports, read from its sources with ``ast``:
the kernels' wrappers (``ops/``) and the utilities (``utils/``) import
nothing of the layers above them, and ``stats``, which the dispatcher
uses, does not import ``api``, which sits above the dispatcher.
"""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "sz3_tpu_torch"
ABOVE = ("algos", "api", "serving", "parallel", "cli", "mdz", "pysz", "h5")


def imported(source: str, package: str):
    """(line, module of the package) for each import of `source`, a module
    of `package`, relative imports resolved; ``from X import y`` gives X.y
    too, as y may be a module."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[:len(parts) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            yield node.lineno, base
            for a in node.names:
                yield node.lineno, f"{base}.{a.name}"


def _reaches(source: str, package: str, layers) -> list:
    heads = {f"sz3_tpu_torch.{name}" for name in layers}
    return [(line, mod) for line, mod in imported(source, package)
            if any(mod == h or mod.startswith(h + ".") for h in heads)]


def _module(rel: str):
    path = PKG / rel
    return path.read_text(), ".".join(("sz3_tpu_torch",) + path.relative_to(PKG).parent.parts)


@pytest.mark.parametrize("rel", sorted(p.relative_to(PKG).as_posix() for d in ("ops", "utils")
                                       for p in (PKG / d).rglob("*.py")))
def test_ops_and_utils_import_nothing_above_them(rel):
    assert _reaches(*_module(rel), ABOVE) == []


def test_stats_does_not_import_api():
    assert _reaches(*_module("stats.py"), ("api",)) == []


def test_the_reader_resolves_relative_imports():
    """A module of ops/ that reaches the dispatcher or api, in either form
    and inside a function, is caught; a sibling of ops/ is not."""
    src = ("from ..algos import torch_backend\nfrom . import quantize\n"
           "def f():\n    from .. import api\n")
    assert _reaches(src, "sz3_tpu_torch.ops", ABOVE) == [
        (1, "sz3_tpu_torch.algos"), (1, "sz3_tpu_torch.algos.torch_backend"),
        (4, "sz3_tpu_torch.api")]
    assert _reaches("from .api import on_device\n", "sz3_tpu_torch", ("api",)) == [
        (1, "sz3_tpu_torch.api"), (1, "sz3_tpu_torch.api.on_device")]
