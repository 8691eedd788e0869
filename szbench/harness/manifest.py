"""Everything a cell is made of, found by name.

BENCHMARK.json names the cells; each cell names a configuration (the file
its `configs` entry gives, under szbench/configs/) and a traffic mix
(szbench/traffic/<mix>.json). The mix names its entry
(szbench/entries/<entry>.py), the configuration its generator
(szbench/data/<generator>.py), and each per-layer metric is read by
szbench/metrics/<metric>.py. A later cell, mix, configuration or metric is
a new file and a new entry in BENCHMARK.json, with no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict            # the configuration's file, as it is run
    traffic: dict           # the traffic mix's file
    end_to_end: List[dict]  # BENCHMARK.json's entries this cell reports
    per_layer: List[dict]


def _checked(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def load_manifest(root) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def _for_cell(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(manifest: dict, workload: str, root=None, bench_dir: Optional[Path] = None) -> Cell:
    """The cell `workload` of the manifest, with its files read."""
    bench_dir = Path(bench_dir or BENCH_DIR)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf_path = Path(root or bench_dir.parent) / configs[_checked(w["config"], "config")]["file"]
    config = json.loads(conf_path.read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{_checked(w['traffic'], 'traffic')}.json")
                         .read_text())
    e2e = [m for m in manifest["end_to_end"] if _for_cell(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at `path` as a module named `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _by_name(kind: str, name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    path = Path(bench_dir or BENCH_DIR) / kind / f"{_checked(name, kind)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return load_module(path, f"szbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}")


def metric_reader(name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    return _by_name("metrics", name, bench_dir)


def entry(name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    return _by_name("entries", name, bench_dir)


def generator(name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    return _by_name("data", name, bench_dir)
