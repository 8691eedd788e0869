"""The program's layer spans laid over the device trace
(szbench/harness/program_spans.py) and the per-layer metrics that read them,
on synthetic readings and synthetic spans: each reader gives the number the
spans and the operations make, and None with nothing to read; an idle gap
that crosses two spans is split between them, clipped to each."""

from types import SimpleNamespace

import numpy as np
import pytest

from szbench.harness import manifest, program_spans
from szbench.harness.reading import Call, Reading
from szbench.harness.trace import DeviceOps

from .conftest import run_small


def span(name, t0, t1, sid, parent=None, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, id=sid, parent=parent, call=0, attrs=attrs)


@pytest.fixture
def spans(monkeypatch):
    """The program's spans replaced by a list the test fills."""
    held = []
    monkeypatch.setattr(program_spans, "_program", None)
    monkeypatch.setattr(program_spans, "_taken", held)
    monkeypatch.setattr(program_spans, "_reported", set())
    return held


def ops_of(rows):
    """DeviceOps from (start, end, launch, kind) rows, ns."""
    a = np.array(rows, np.int64).reshape(-1, 4)
    return DeviceOps(start=a[:, 0], end=a[:, 1], launch=a[:, 2], kind=a[:, 3],
                     name=np.zeros(len(a), np.int64), names=["k"])


CALLS = [Call("compress", 0, 1000, 10**9, 1, 1), Call("decompress", 1000, 1500, 10**9, 1, 1),
         Call("compress", 2000, 3000, 10**9, 1, 1)]


def test_tuner_kernel_ms_is_the_union_inside_the_tune_spans(spans):
    spans += [span("api.compress", 0, 1000, 1), span("dispatch.tune", 100, 400, 2, 1),
              span("api.compress", 2000, 3000, 3), span("dispatch.tune", 2100, 2300, 4, 3),
              span("dispatch.tune", 5000, 6000, 5)]          # outside the calls: not read
    ops = ops_of([[110, 150, 105, 0], [140, 200, 120, 0],     # overlap: 90 ns
                  [300, 900, 390, 1],                         # a copy: left out
                  [500, 600, 450, 0],                         # launched after the span
                  [2200, 2250, 2150, 0],                      # 50 ns
                  [5100, 5200, 5050, 0]])
    r = Reading(CALLS, {}, ops)
    mod = manifest.metric_reader("tuner_kernel_ms.encode")
    assert mod.read(r) == pytest.approx(140e-6 / 2)          # ms over the 2 compresses
    assert program_spans.kernel_s(r, program_spans.named(r, "dispatch.tune")) == 140e-9


def test_select_kernel_ms_reads_the_select_spans(spans):
    spans += [span("api.compress", 0, 1000, 1), span("lorenzo.encode", 10, 990, 2, 1),
              span("lorenzo.select", 20, 100, 3, 2, phase="speculate", pass_no=0),
              span("lorenzo.sweep", 100, 500, 4, 2),
              span("lorenzo.select", 500, 600, 5, 2, phase="certify", pass_no=1)]
    ops = ops_of([[30, 60, 25, 0], [200, 480, 150, 0], [520, 540, 510, 0], [530, 560, 520, 0]])
    r = Reading(CALLS[:2], {}, ops)
    assert manifest.metric_reader("lorenzo_select_kernel_ms.encode").read(r) == \
        pytest.approx(70e-6)


def test_lorenzo_passes_is_the_mean_over_the_compresses(spans):
    spans += [span("lorenzo.encode", 10, 900, 1, passes=5),
              span("lorenzo.encode", 2010, 2900, 2, passes=6),
              span("lorenzo.encode", 1100, 1400, 3, passes=9)]   # in a decompress: not read
    r = Reading(CALLS, {}, ops_of([[20, 30, 15, 0]]))
    assert manifest.metric_reader("lorenzo_passes.encode").read(r) == 5.5


@pytest.mark.parametrize("name", ["tuner_kernel_ms.encode", "lorenzo_select_kernel_ms.encode",
                                  "lorenzo_passes.encode"])
def test_nothing_to_read_reads_none(spans, name):
    mod = manifest.metric_reader(name)
    assert mod.LAYER and mod.MOVES == "compress_kernel_GBps" and mod.WRAPS == ()
    assert mod.read(Reading(CALLS, {}, ops_of([[20, 30, 15, 0]]))) is None   # no spans
    spans += [span("api.compress", 0, 1000, 1)]
    assert mod.read(Reading(CALLS, {})) is None                          # nor a trace
    assert mod.read(Reading([], {}, ops_of([[20, 30, 15, 0]]))) is None   # nor a call


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_program", None)
    monkeypatch.setattr(program_spans, "_taken", [])
    r = Reading(CALLS, {}, ops_of([[20, 30, 15, 0]]))
    assert program_spans.taken() == [] and program_spans.idle_split(r) == \
        pytest.approx({"(no span)": 2.49e-6})
    assert manifest.metric_reader("tuner_kernel_ms.encode").read(r) is None


def test_a_gap_across_two_spans_is_clipped_to_each(spans):
    """One call [0, 1000): A [100, 500) and B [500, 850) under the root; the
    card busy [0, 100), [300, 350) and [900, 1000). The gap [350, 900)
    crosses A, B and the root alone: 150, 350 and 50 ns, where its midpoint
    (625) would give all 550 to B."""
    spans += [span("api.compress", 0, 1000, 1), span("A", 100, 500, 2, 1),
              span("B", 500, 850, 3, 1)]
    ops = ops_of([[0, 100, 0, 0], [300, 350, 90, 0], [900, 1000, 600, 0]])
    r = Reading(CALLS[:1], {}, ops)
    split = program_spans.idle_split(r)
    assert split == pytest.approx({"A": 350e-9, "B": 350e-9, "api.compress": 50e-9})
    assert program_spans.roots(r) == {"api.compress"}


def test_the_deepest_span_takes_the_gap_and_calls_bound_it(spans):
    """Idle time between two calls is no call's; a child's gap goes to the
    child, not to its parent, whichever began first."""
    spans += [span("api.compress", 0, 1000, 1), span("lorenzo.encode", 0, 1000, 2, 1),
              span("lorenzo.select", 0, 400, 3, 2), span("api.decompress", 1000, 1500, 4)]
    ops = ops_of([[400, 1000, 500, 0], [1200, 1500, 1100, 0], [1500, 2000, 1400, 0]])
    r = Reading(CALLS, {}, ops)
    assert program_spans.idle_split(r) == pytest.approx(
        {"lorenzo.select": 400e-9, "api.decompress": 200e-9, "(no span)": 1000e-9})


def test_a_cpu_run_of_the_lorenzo_cell_reads_its_passes():
    """The program's own counter needs no device trace: a traced CPU run
    reads lorenzo_passes.encode from the real program's spans."""
    # on as a traced run's fresh process has them (another test may have
    # turned them off since this module was first imported)
    program_spans._program.enable(ranges=False)
    r = run_small("nyx512-lorenzo", trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["lorenzo_passes.encode"]["value"] >= 1
    assert "lorenzo_select_kernel_ms.encode" not in r["metrics"]    # no card, no kernels
