"""The port stays whole: every module of the JAX package has its counterpart
in sz3_tpu_torch/ (or a stated reason it has none), and every TPU kernel of
the JAX package (each function that reaches pl.pallas_call) is a `replaces`
or `also_replaces` of a row of chip_smoke.py's kernels line, whose source is
a file of the port."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "sz3_tpu"
PORT = ROOT / "sz3_tpu_torch"

# files of the JAX package without a file of the same path in the port:
# (the port's file that does its work, or None, and why)
NO_SAME_PATH = {
    "algos/jax_backend.py": ("algos/torch_backend.py", "renamed after its framework"),
    "algos/mdz_jax.py": ("algos/mdz_torch.py", "renamed after its framework"),
    "native/__init__.py": ("runtime.py", "the port binds its engine copy in runtime.py"),
    "native/build.py": ("build.py", "builds the engine copy and the CUDA kernels"),
    "ops/stream_layout.py": ("ops/stream_order.py",
                             "the TPU's gather-free layout is one cached gather on the card"),
    "ops/stream_unlayout.py": ("ops/stream_order.py", "its inverse, one cached scatter"),
    "ops/exactf64.py": (None, "a softfloat f64 for the TPU, which has no IEEE f64; "
                              "the card has it"),
    "ops/blockwise_device.py": (None, "a parity oracle of the JAX package's LORENZO_REG, "
                                      "not a device route"),
}


def _rel(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_every_module_of_the_jax_package_has_a_counterpart():
    port = set(_rel(PORT))
    missing = [f for f in _rel(REF) if f not in port and f not in NO_SAME_PATH]
    assert missing == []
    for f, (counterpart, why) in NO_SAME_PATH.items():
        assert why
        assert counterpart is None or counterpart in port, (f, counterpart)


def test_the_module_map_has_no_stale_entry():
    ref, port = set(_rel(REF)), set(_rel(PORT))
    assert len(ref) >= 40
    for f in NO_SAME_PATH:
        assert f in ref, f"{f} is not a file of the JAX package"
        assert f not in port, f"{f} has a file of the same path in the port"


def _kernel_of(arg, scope_assigns, defs):
    """The module-level def named by pallas_call's first argument: a name,
    functools.partial(name, ...), or a local bound to either."""
    if isinstance(arg, ast.Call):
        return _kernel_of(arg.args[0], scope_assigns, defs)
    if isinstance(arg, ast.Name):
        if arg.id in defs:
            return defs[arg.id]
        if arg.id in scope_assigns:
            return _kernel_of(scope_assigns[arg.id], {}, defs)
    raise AssertionError(f"cannot resolve the kernel of pallas_call at line {arg.lineno}")


def _pallas_kernels():
    """{"sz3_tpu/<file>:<line of the kernel's def>": def name} over the JAX
    package, and the number of pallas_call sites."""
    found, sites = {}, 0
    for path in sorted(REF.rglob("*.py")):
        tree = ast.parse(path.read_text())
        defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            assigns = {t.id: n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                       for t in n.targets if isinstance(t, ast.Name)}
            for call in ast.walk(fn):
                if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "pallas_call"):
                    sites += 1
                    k = _kernel_of(call.args[0], assigns, defs)
                    found[f"{path.relative_to(ROOT).as_posix()}:{k.lineno}"] = k.name
    return found, sites


def _smoke_rows():
    """(replaces and also_replaces strings, sources) of chip_smoke.py's
    row(name, source, replaces, ...) calls."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    replaces, sources = set(), []
    for call in ast.walk(tree):
        if isinstance(call, ast.Call) and isinstance(call.func, ast.Name) \
                and call.func.id == "row":
            sources.append(call.args[1].value)
            replaces.add(call.args[2].value)
            replaces.update(k.value.value for k in call.keywords if k.arg == "also_replaces")
    return replaces, sources


def test_every_tpu_kernel_is_a_row_of_the_smokes_kernel_table():
    kernels, sites = _pallas_kernels()
    assert sites == len(kernels) == 5, kernels
    assert sorted(kernels.values()) == ["_compact_kernel", "_hist_kernel", "_pack_kernel",
                                        "_scan_kernel", "_splice_kernel"]
    replaces, sources = _smoke_rows()
    assert sorted(set(kernels) - replaces) == []
    for src in sources:
        assert (PORT / "csrc" / src).is_file(), src
    for ref in replaces:
        f, line = ref.rsplit(":", 1)
        assert (ROOT / f).is_file() and int(line) > 0, ref


# algorithms outside tests/test_torch_matrix.py, each with where it is held
NOT_IN_MATRIX = {
    "LOSSLESS": "no predictor: zstd of the bytes, which the dispatcher takes on a bound of 0 "
                "or by the ratio rule: tests/test_torch_api.py",
    "BIOMD": "takes (frames, atoms, 3) trajectories: tests/test_torch_biomd.py",
    "BIOMDXTC": "takes (frames, atoms, 3) trajectories: tests/test_torch_xtc.py",
}


def test_the_matrix_spans_every_dtype_and_plain_field_algorithm():
    """tests/test_torch_matrix.py runs every member of the port's DataType
    and every ALGO that the dispatcher routes for a plain field, so that a
    dtype or an algorithm added later cannot miss it."""
    import numpy as np

    import test_torch_matrix as m
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.config import ALGO, DataType

    assert sorted(runtime.np_dtype_id(np.empty(0, dt)) for dt in m.DTYPES) == sorted(DataType)
    assert len(m.DTYPES) == len(set(m.DTYPES))
    assert sorted(a.name for a in m.ALGOS) == sorted(
        a.name for a in ALGO if a.name not in NOT_IN_MATRIX)
    assert set(NOT_IN_MATRIX) <= {a.name for a in ALGO}
