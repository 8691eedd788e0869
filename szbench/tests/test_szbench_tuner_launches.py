"""tuner_launches.encode on synthetic readings: it counts the kernels
launched inside the dispatch.tune spans of the compress calls, a compress,
and leaves out copies, kernels launched outside those spans and spans
outside the compresses; with no device trace or no such span it reads None."""

import pytest

from szbench.harness import manifest
from szbench.harness.reading import Call, Reading

from .test_szbench_program_spans import CALLS, ops_of, span, spans  # noqa: F401

NAME = "tuner_launches.encode"


def test_counts_the_kernels_launched_in_the_tune_spans_of_compresses(spans):  # noqa: F811
    spans += [span("api.compress", 0, 1000, 1), span("dispatch.tune", 100, 400, 2, 1),
              span("api.decompress", 1000, 1500, 3),
              span("dispatch.tune", 1100, 1200, 4, 3),       # in a decompress: not read
              span("api.compress", 2000, 3000, 5), span("dispatch.tune", 2100, 2300, 6, 5),
              span("dispatch.tune", 5000, 6000, 7)]          # outside the calls: not read
    ops = ops_of([[110, 150, 105, 0], [140, 200, 120, 0],     # two kernels
                  [300, 900, 390, 1],                         # a copy: left out
                  [320, 330, 395, 2],                         # a fill: left out
                  [500, 600, 450, 0],                         # launched after the span
                  [1150, 1160, 1120, 0],                      # in the decompress's span
                  [2200, 2250, 2150, 0],                      # one kernel
                  [2260, 2270, -1, 0],                        # no launch found: left out
                  [5100, 5200, 5050, 0]])
    r = Reading(CALLS, {}, ops)
    assert manifest.metric_reader(NAME).read(r) == pytest.approx(3 / 2)


def test_a_compress_without_tuning_counts_in_the_mean(spans):  # noqa: F811
    spans += [span("dispatch.tune", 100, 400, 1)]
    calls = CALLS + [Call("compress", 4000, 5000, 10**9, 1, 1)]
    r = Reading(calls, {}, ops_of([[110, 150, 105, 0], [160, 170, 130, 0]]))
    assert manifest.metric_reader(NAME).read(r) == pytest.approx(2 / 3)


def test_nothing_to_read_reads_none(spans):  # noqa: F811
    reader = manifest.metric_reader(NAME)
    assert reader.read(Reading(CALLS, {}, None)) is None            # no device trace
    assert reader.read(Reading(CALLS, {}, ops_of([[110, 150, 105, 0]]))) is None   # no span
    spans += [span("dispatch.tune", 100, 400, 1)]
    assert reader.read(Reading(CALLS, {}, None)) is None
    assert reader.read(Reading([], {}, ops_of([[110, 150, 105, 0]]))) is None
