"""Shared helpers of the benchmark's own tests (run them from the repo root:
``python -m pytest szbench/tests -q``; the card's cases: ``-m cuda``)."""

import time

import pytest

from szbench.harness import manifest

ROOT = manifest.BENCH_DIR.parent
SMALL = {"nyx-512-f32-rel1e-4": [24, 24, 24], "cesm-atm-1800x3600-f32-rel1e-4": [40, 60]}
CELLS = ("nyx512-roundtrip", "nyx512-lorenzo")
# cells whose files are kept, not in BENCHMARK.json (PERF.md, Open questions):
# the entries that would add them back
KEPT = {
    "cesm2d-fields": {
        "configs": [{"name": "cesm-atm-1800x3600-f32-rel1e-4", "source": "SDRBench CESM-ATM",
                     "file": "szbench/configs/cesm-atm-1800x3600-f32-rel1e-4.json",
                     "reduced": [], "why": "kept for a later change"}],
        "workloads": [{"name": "cesm2d-fields", "config": "cesm-atm-1800x3600-f32-rel1e-4",
                       "traffic": "roundtrip", "chips": 1, "why": "kept for a later change"}],
        "end_to_end": [{"name": "compress_p95_ms", "unit": "ms", "better": "lower",
                        "bound": 0.25, "source": "host_clock", "workloads": ["cesm2d-fields"]}]},
    "nyx512-steps4": {
        "workloads": [{"name": "nyx512-steps4", "config": "nyx-512-f32-rel1e-4",
                       "traffic": "batch", "chips": 1, "why": "kept for a later change"}]},
}


def manifest_with_kept() -> dict:
    """BENCHMARK.json with the kept cells' entries added, in memory."""
    m = manifest.load_manifest(ROOT)
    for kept in KEPT.values():
        for key, entries in kept.items():
            m[key].extend(entries)
    return m


def small_cell(name: str, fields: int = 3) -> manifest.Cell:
    """The cell as BENCHMARK.json has it, at a size a CPU test holds."""
    c = manifest.find_cell(manifest_with_kept(), name, ROOT)
    cfg = dict(c.config, shape=SMALL[c.config["name"]], fields=fields)
    return c._replace(config=cfg)


def run_small(name: str, program=None, seconds: float = 0.5, trace: bool = False,
              seed: int = 2**31 + 7, device: str = "cpu") -> dict:
    return __import__("szbench.harness.cell", fromlist=["run"]).run(
        small_cell(name), seed, seconds, trace, device, time.perf_counter(), program=program)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return "cuda"
