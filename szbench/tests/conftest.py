"""Shared helpers of the benchmark's own tests (run them from the repo root:
``python -m pytest szbench/tests -q``; the card's cases: ``-m cuda``).

The tests know no cell, configuration or metric by name: they read them from
BENCHMARK.json and from the files under szbench/, so that a new cell comes in
by new files and new entries alone."""

import copy
import json
import math
import time
from pathlib import Path

import pytest

from szbench.harness import manifest

ROOT = manifest.BENCH_DIR.parent
MANIFEST = manifest.load_manifest(ROOT)
CELLS = tuple(w["name"] for w in MANIFEST["workloads"])
SMALL_VALUES = 24 ** 3      # about as many values as a field of a CPU test holds


def small_shape(shape) -> list:
    """The shape at a size a CPU test holds: the same rank, each axis capped
    at the largest length at which the field holds at most SMALL_VALUES."""
    cap = 1
    while cap < max(shape) and math.prod(min(n, cap + 1) for n in shape) <= SMALL_VALUES:
        cap += 1
    return [min(n, cap) for n in shape]


def with_unnamed(m: dict, root=ROOT) -> dict:
    """The manifest with a cell for each configuration file and traffic mix
    under szbench/ that no cell names yet, so that each is still run: such a
    configuration under the first cell's traffic, such a mix on the first
    cell's configuration."""
    m = copy.deepcopy(m)
    bench = Path(root) / manifest.BENCH_DIR.name
    first = m["workloads"][0]
    named = {c["file"] for c in m["configs"]}
    for path in sorted((bench / "configs").glob("*.json")):
        rel = path.relative_to(root).as_posix()
        if rel in named:
            continue
        conf = json.loads(path.read_text())
        m["configs"].append({"name": conf["name"], "source": conf["source"], "file": rel,
                             "reduced": conf["reduced"], "why": "named by no cell yet"})
        m["workloads"].append({"name": f"{conf['name']}.{first['traffic']}",
                               "config": conf["name"], "traffic": first["traffic"], "chips": 1,
                               "why": "named by no cell yet"})
    used = {w["traffic"] for w in m["workloads"]}
    for path in sorted((bench / "traffic").glob("*.json")):
        if path.stem not in used:
            m["workloads"].append({"name": f"{first['config']}.{path.stem}",
                                   "config": first["config"], "traffic": path.stem, "chips": 1,
                                   "why": "named by no cell yet"})
    return m


TESTED = with_unnamed(MANIFEST)
# every cell of BENCHMARK.json, then one for each file that no cell names yet
ALL = tuple(w["name"] for w in TESTED["workloads"])


def small_cell(name: str, fields: int = 3, m: dict = TESTED, root=ROOT,
               bench_dir=None) -> manifest.Cell:
    """The cell as the manifest has it, at a size a CPU test holds."""
    c = manifest.find_cell(m, name, root, bench_dir)
    cfg = dict(c.config, shape=small_shape(c.config["shape"]), fields=fields)
    return c._replace(config=cfg)


def run_small(name: str, program=None, seconds: float = 0.5, trace: bool = False,
              seed: int = 2**31 + 7, device: str = "cpu", m: dict = TESTED, root=ROOT,
              bench_dir=None) -> dict:
    return __import__("szbench.harness.cell", fromlist=["run"]).run(
        small_cell(name, m=m, root=root, bench_dir=bench_dir), seed, seconds, trace, device,
        time.perf_counter(), program=program, bench_dir=bench_dir)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return "cuda"
