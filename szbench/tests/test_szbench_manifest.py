"""Every configuration, traffic mix, entry, generator and metric is a file
of its own that the harness finds by name, and a new one is taken up with no
edit."""

import json
import shutil

import pytest

from szbench.harness import cell, manifest, port

from .conftest import CELLS, KEPT, ROOT, manifest_with_kept, run_small

MANIFEST = manifest.load_manifest(ROOT)


def test_cells_in_the_order_proven():
    assert [w["name"] for w in MANIFEST["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


@pytest.mark.parametrize("name", CELLS + tuple(KEPT))
def test_cell_files_load_by_name(name):
    m = manifest_with_kept()
    c = manifest.find_cell(m, name, ROOT)
    assert c.config["name"] == next(w["config"] for w in m["workloads"] if w["name"] == name)
    gen = manifest.generator(c.config["generator"])
    ent = manifest.entry(c.traffic["entry"])
    assert callable(gen.make) and callable(ent.warm) and callable(ent.step)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "ratio", "compress_kernel_GBps", "decompress_kernel_GBps"} <= names
    assert ("compress_p95_ms" in names) == (name == "cesm2d-fields")
    assert bool(c.per_layer) == (name in CELLS)


@pytest.mark.parametrize("entry", MANIFEST["end_to_end"] + MANIFEST["per_layer"] +
                         [e for k in KEPT.values() for e in k.get("end_to_end", ())],
                         ids=lambda m: m["name"])
def test_metric_files_load_and_agree(entry):
    mod = manifest.metric_reader(entry["name"])
    assert callable(mod.read)
    if "layer" in entry:
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
        moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == entry["moves"])
        assert set(entry["workloads"]) <= set(moved.get("workloads", CELLS))
        assert set(entry["workloads"]) <= set(CELLS)
    for key in getattr(mod, "WRAPS", ()):
        modname, attr = key.split(":")
        assert callable(getattr(__import__(modname, fromlist=[attr]), attr))


@pytest.mark.parametrize("key", port.SPANS)
def test_the_layer_spans_exist(key):
    modname, attr = key.split(":")
    assert callable(getattr(__import__(modname, fromlist=[attr]), attr))


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(name):
    r = run_small(name, trace=True)
    assert r["correct"], r["checks"]
    wanted = {m["name"] for m in manifest.find_cell(MANIFEST, name, ROOT).per_layer}
    assert set(r["metrics"]) <= wanted
    # the wall throughputs need no device trace; the kernels' (none on the CPU) do
    assert r["metrics"]["compress_wall_GBps"]["value"] > 0
    assert r["metrics"]["decompress_wall_GBps"]["value"] > 0
    assert "entropy_encode_roofline" not in r["metrics"]


def test_bits_per_value_sum_over_the_seals():
    from szbench.harness.reading import Reading
    from szbench.harness.spans import Span

    mod = manifest.metric_reader("huffman_bits_per_value")
    interp, block = mod.WRAPS
    info = [mod.note(interp, (None, b"", b"", 300, 100, None, 0), {}, b""),
            mod.note(block, (None, b"", b""), {"bit_count": 100, "count": 100}, b"")]
    r = Reading([], {interp: [Span(0, 1, info[0]), Span(1, 2, {})], block: [Span(2, 3, info[1])]})
    assert mod.read(r) == 2.0
    assert mod.read(Reading([], {})) is None


def test_kernel_seconds_are_the_union_of_the_calls_kernels():
    import numpy as np

    from szbench.harness.reading import Call, Reading
    from szbench.harness.trace import DeviceOps

    calls = [Call("compress", 0, 100, 10**9, 1, 1), Call("decompress", 100, 200, 10**9, 1, 1),
             Call("compress", 200, 300, 10**9, 1, 1)]
    # kernels launched in the first compress overlap (two streams); a copy
    # there is left out; one kernel each in the decompress and the second compress
    ops = DeviceOps(start=np.array([10, 20, 30, 150, 250]), end=np.array([40, 60, 90, 170, 260]),
                    launch=np.array([5, 6, 7, 120, 210]), kind=np.array([0, 0, 1, 0, 0]),
                    name=np.zeros(5, np.int64), names=["k"])
    r = Reading(calls, {}, ops)
    assert r.kernel_s("compress") == 60e-9 and r.kernel_s("decompress") == 20e-9
    assert manifest.metric_reader("compress_kernel_GBps").read(r) == pytest.approx(2 / 60e-9)
    assert manifest.metric_reader("compress_kernel_GBps").read(Reading(calls, {})) is None


@pytest.mark.parametrize("c", MANIFEST["configs"] +
                         [c for k in KEPT.values() for c in k.get("configs", ())],
                         ids=lambda c: c["name"])
def test_config_files(c):
    conf = json.loads((ROOT / c["file"]).read_text())
    assert conf["name"] == c["name"]
    assert conf["source"] == c["source"] or c["why"] == "kept for a later change"
    assert conf["reduced"] == c["reduced"] == []
    assert {"shape", "dtype", "error_bound", "generator", "fields", "assumed"} <= set(conf)


def test_a_new_config_file_is_taken_up(tmp_path):
    bench = tmp_path / "szbench"
    for sub in ("traffic", "entries", "data", "metrics"):
        shutil.copytree(ROOT / "szbench" / sub, bench / sub)
    (bench / "configs").mkdir()
    conf = json.loads((ROOT / "szbench/configs/nyx-512-f32-rel1e-4.json").read_text())
    conf.update(name="nyx-tiny-f32-abs", shape=[20, 22, 24], fields=2,
                error_bound={"mode": "ABS", "abs": 1e-3})
    (bench / "configs/nyx-tiny-f32-abs.json").write_text(json.dumps(conf))
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "nyx-tiny-f32-abs", "source": conf["source"],
                         "file": "szbench/configs/nyx-tiny-f32-abs.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "tiny-roundtrip", "config": "nyx-tiny-f32-abs",
                           "traffic": "roundtrip", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    found = manifest.find_cell(manifest.load_manifest(tmp_path), "tiny-roundtrip", tmp_path,
                               bench_dir=bench)
    assert found.config["shape"] == [20, 22, 24]
    r = cell.run(found, 5, 0.3, False, "cpu", 0.0, bench_dir=bench)
    assert r["correct"] and r["metrics"]["ratio"]["value"] > 0


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        manifest.find_cell(MANIFEST, "no-such-cell", ROOT)
    with pytest.raises(ValueError):
        manifest.metric_reader("../harness/cell")
