"""Every configuration, traffic mix, entry, generator and metric is a file
of its own that the harness finds by name, and a new one is taken up with no
edit. The manifest's invariants are functions of (manifest, root), so that
BENCHMARK.json and a copy with a cell added go through the same code."""

import copy
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from szbench.harness import manifest, port

from .conftest import ALL, CELLS, MANIFEST, ROOT, SMALL_VALUES, TESTED, run_small, small_shape


def _bench(root) -> Path:
    return Path(root) / manifest.BENCH_DIR.name


def _cells(m, root) -> dict:
    return {w["name"]: manifest.find_cell(m, w["name"], root, _bench(root))
            for w in m["workloads"]}


def names_are_valid_and_used_once(m, root):
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[key]]
        assert all(manifest._NAME.match(n) for n in names), (key, names)
        assert len(set(names)) == len(names), (key, names)
    metrics = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(set(metrics)) == len(metrics), metrics
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs), pairs


def cell_files_exist(m, root):
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        assert w["config"] in configs, w
        assert (Path(root) / configs[w["config"]]["file"]).is_file(), w
        assert (_bench(root) / "traffic" / f"{w['traffic']}.json").is_file(), w
    assert {w["config"] for w in m["workloads"]} == set(configs)


def chips_are_1_or_4(m, root):
    assert all(w["chips"] in (1, 4) for w in m["workloads"])


def at_most_a_quarter_on_4_chips(m, root):
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def every_cell_reports_setup_and_a_per_layer_metric(m, root):
    for name, c in _cells(m, root).items():
        e2e = {e["name"] for e in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, (name, e2e)
        assert c.per_layer, name


def per_layer_cells_are_cells_that_report_what_it_moves(m, root):
    cells = _cells(m, root)
    for metric in m["per_layer"]:
        listed = metric.get("workloads", cells)
        assert set(listed) <= set(cells), metric["name"]
        for name in listed:
            assert metric["moves"] in {e["name"] for e in cells[name].end_to_end}, \
                (metric["name"], name)
            assert metric in cells[name].per_layer, (metric["name"], name)


INVARIANTS = (names_are_valid_and_used_once, cell_files_exist, chips_are_1_or_4,
              at_most_a_quarter_on_4_chips, every_cell_reports_setup_and_a_per_layer_metric,
              per_layer_cells_are_cells_that_report_what_it_moves)


@pytest.mark.parametrize("invariant", INVARIANTS, ids=lambda f: f.__name__)
def test_manifest_invariant(invariant):
    invariant(MANIFEST, ROOT)


def _two_on_4_chips(m):
    for w in m["workloads"][:2]:
        w["chips"] = 4


def _first_cell_without_per_layer_metrics(m):
    for p in m["per_layer"]:
        p["workloads"] = [c for c in p.get("workloads", CELLS) if c != CELLS[0]]


def _a_listed_cell_without_what_it_moves(m):
    p = m["per_layer"][0]
    left_out = p.get("workloads", CELLS)[0]
    for e in m["end_to_end"]:
        if e["name"] == p["moves"]:
            e["workloads"] = [c for c in CELLS if c != left_out]


def _a_cell_without_setup_s(m):
    for e in m["end_to_end"]:
        if e["name"] == "setup_s":
            e["workloads"] = list(CELLS[1:])


# each break, and the invariant that has to refuse it
BREAKS = {
    "a_cell_named_twice": (names_are_valid_and_used_once,
                           lambda m: m["workloads"].append(dict(m["workloads"][0]))),
    "a_bad_name": (names_are_valid_and_used_once,
                   lambda m: m["workloads"][0].update(name="a cell")),
    "a_missing_traffic_file": (cell_files_exist,
                               lambda m: m["workloads"][0].update(traffic="no-such-mix")),
    "a_config_no_cell_uses": (cell_files_exist,
                              lambda m: m["configs"].append(dict(m["configs"][0], name="x"))),
    "two_chips": (chips_are_1_or_4, lambda m: m["workloads"][0].update(chips=2)),
    "too_many_on_4_chips": (at_most_a_quarter_on_4_chips, _two_on_4_chips),
    "a_cell_without_setup_s": (every_cell_reports_setup_and_a_per_layer_metric,
                               _a_cell_without_setup_s),
    "a_cell_without_per_layer_metrics": (every_cell_reports_setup_and_a_per_layer_metric,
                                         _first_cell_without_per_layer_metrics),
    "a_per_layer_metric_on_no_such_cell": (
        per_layer_cells_are_cells_that_report_what_it_moves,
        lambda m: m["per_layer"][0].update(workloads=["no-such-cell"])),
    "a_cell_that_does_not_report_what_it_moves": (
        per_layer_cells_are_cells_that_report_what_it_moves, _a_listed_cell_without_what_it_moves),
}


@pytest.mark.parametrize("name", sorted(BREAKS))
def test_the_invariants_refuse_a_broken_manifest(name):
    invariant, broken = BREAKS[name]
    m = copy.deepcopy(MANIFEST)
    broken(m)
    with pytest.raises(AssertionError):
        invariant(m, ROOT)


@pytest.mark.parametrize("name", ALL)
def test_cell_files_load_by_name(name):
    c = manifest.find_cell(TESTED, name, ROOT)
    assert c.config["name"] == next(w["config"] for w in TESTED["workloads"]
                                    if w["name"] == name)
    gen = manifest.generator(c.config["generator"])
    ent = manifest.entry(c.traffic["entry"])
    assert callable(gen.make) and callable(ent.warm) and callable(ent.step)
    assert "setup_s" in {m["name"] for m in c.end_to_end}


@pytest.mark.parametrize("entry", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files_load_and_agree(entry):
    mod = manifest.metric_reader(entry["name"])
    assert callable(mod.read)
    if "layer" in entry:
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
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
    per_layer = manifest.find_cell(MANIFEST, name, ROOT).per_layer
    assert set(r["metrics"]) <= {m["name"] for m in per_layer}
    # the host's clock needs no device trace; a roofline share (none on the CPU) does
    for m in per_layer:
        if m["source"] == "host_clock":
            assert r["metrics"][m["name"]]["value"] > 0, m["name"]
        if m["unit"] == "%":
            assert m["name"] not in r["metrics"], m["name"]


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


@pytest.mark.parametrize("c", TESTED["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    conf = json.loads((ROOT / c["file"]).read_text())
    assert conf["name"] == c["name"] and conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"]
    assert {"shape", "dtype", "error_bound", "generator", "fields", "assumed"} <= set(conf)


def test_small_shapes_keep_the_rank_and_about_24_cubed_values():
    assert small_shape([512, 512, 512]) == [24, 24, 24]
    assert small_shape([20, 22, 24]) == [20, 22, 24]
    for shape in ([1800, 3600], [288, 115, 69, 69], [5, 1000, 1000], [10**9]):
        small = small_shape(shape)
        assert len(small) == len(shape) and all(1 <= s <= n for s, n in zip(small, shape))
        assert SMALL_VALUES / 2 <= math.prod(small) <= SMALL_VALUES


def pending_cells(root=ROOT) -> list:
    """The cells that PERF.md's open questions (section 7) write out for a later
    PR to append: one JSON object a line in its fenced json blocks, each with
    `configs` and `workloads` entries and the per-layer metrics the cell joins.
    None once the cells have landed and the block is gone."""
    perf = Path(root) / "PERF.md"
    text = perf.read_text() if perf.is_file() else ""
    section = re.split(r"^## 7\.", text, maxsplit=1, flags=re.M)[1:]
    blocks = re.findall(r"^```json\n(.*?)^```", "".join(section), flags=re.M | re.S)
    return [json.loads(line) for b in blocks for line in b.splitlines() if line.strip()]


def _append(m, key, entry) -> bool:
    """Append the entry unless the manifest has one of that name."""
    if entry["name"] in {e["name"] for e in m[key]}:
        return False
    m[key].append(entry)
    return True


def _join(m, metrics, cells):
    for p in m["per_layer"]:
        if p["name"] in metrics and "workloads" in p:
            p["workloads"] += cells


def test_a_new_cell_is_taken_up_with_no_edit(tmp_path):
    """In a copy of BENCHMARK.json and szbench/, with new files and appended
    entries only: a configuration cut to size (and to an ABS bound), a 1-chip
    and a 4-chip cell on it, the 1-chip cell in a per-layer metric's list, and
    the cells PERF.md section 7 writes out, as it writes them. The invariants
    hold on the copy, each new cell reads its own configuration file, and each
    new 1-chip cell runs correct."""
    bench = _bench(tmp_path)
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = copy.deepcopy(MANIFEST)
    conf = json.loads((ROOT / m["configs"][0]["file"]).read_text())
    # unequal axes that small_shape leaves as they are, so the run is at this shape
    conf.update(name="szbench-test-cut", shape=[20, 22, 24][-len(conf["shape"]):],
                error_bound={"mode": "ABS", "abs": 1e-3}, reduced=["shape", "error_bound"])
    assert small_shape(conf["shape"]) == conf["shape"]
    (bench / "configs/szbench-test-cut.json").write_text(json.dumps(conf))
    _append(m, "configs", {"name": conf["name"], "source": conf["source"],
                           "file": "szbench/configs/szbench-test-cut.json",
                           "reduced": conf["reduced"], "why": "a test"})
    traffic = m["workloads"][0]["traffic"]
    _append(m, "workloads", {"name": "szbench-test-1", "config": conf["name"],
                             "traffic": traffic, "chips": 1, "why": "a test"})
    new = ["szbench-test-1"]
    for pending in pending_cells():
        for entry in pending.get("configs", []):
            _append(m, "configs", entry)
        added = [w["name"] for w in pending["workloads"] if _append(m, "workloads", w)]
        _join(m, pending.get("per_layer", []), added)
        new += added
    # as many 1-chip cells more as a 4-chip cell more needs, each on a mix of its own
    fours = sum(w["chips"] == 4 for w in m["workloads"]) + 1
    for i in range(4 * fours - len(m["workloads"]) - 1):
        shutil.copy(bench / f"traffic/{traffic}.json", bench / f"traffic/szbench-test-{i}.json")
        _append(m, "workloads", {"name": f"szbench-test-pad-{i}", "config": conf["name"],
                                 "traffic": f"szbench-test-{i}", "chips": 1, "why": "a test"})
    taken = {(w["config"], w["traffic"]) for w in m["workloads"]}
    four = next(t.stem for t in sorted((bench / "traffic").glob("*.json"))
                if (conf["name"], t.stem) not in taken)
    _append(m, "workloads", {"name": "szbench-test-4", "config": conf["name"],
                             "traffic": four, "chips": 4, "why": "a test"})
    _join(m, ["interp_launches.encode"],
          [w["name"] for w in m["workloads"] if w["name"].startswith("szbench-test-")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m, indent=2))

    copied = manifest.load_manifest(tmp_path)
    for invariant in INVARIANTS:
        invariant(copied, tmp_path)
    cut = manifest.find_cell(copied, "szbench-test-1", tmp_path, bench)
    assert cut.config == conf
    assert "interp_launches.encode" in {p["name"] for p in cut.per_layer}
    assert manifest.find_cell(copied, "szbench-test-4", tmp_path, bench).chips == 4
    configs = {c["name"]: c["file"] for c in copied["configs"]}
    for name in new:
        w = next(w for w in copied["workloads"] if w["name"] == name)
        c = manifest.find_cell(copied, name, tmp_path, bench)
        assert c.config == json.loads((tmp_path / configs[w["config"]]).read_text()), name
        r = run_small(name, seconds=0.3, m=copied, root=tmp_path, bench_dir=bench)
        assert r["correct"], (name, r["checks"])
        assert r["metrics"]["ratio"]["value"] > 0


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        manifest.find_cell(MANIFEST, "no-such-cell", ROOT)
    with pytest.raises(ValueError):
        manifest.metric_reader("../harness/cell")
