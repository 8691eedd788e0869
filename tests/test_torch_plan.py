"""The port's interpolation plan equals the JAX package's, field for field."""

import dataclasses
import itertools
import math

import numpy as np
import pytest

from sz3_tpu.ops import interp_fast as jif
from sz3_tpu_torch.ops import interp_fast as tif

SHAPES = [(4000,), (10000,), (96, 113), (129, 129), (33, 37, 41), (48, 48, 48),
          (9, 10, 11, 12), (33, 34, 35, 20)]
ANCHORS = [4096, 128, 32, 16]


def _directions(ndim):
    n = math.factorial(ndim)
    return sorted({0, n - 1})


CASES = [(shape, algo, d) for shape in SHAPES for algo in (0, 1)
         for d in _directions(len(shape))]


def _assert_same(jp, tp):
    for f in dataclasses.fields(tif.FastPlan):
        if f.name != "passes":
            assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert len(tp.passes) == len(jp.passes)
    for js, ts in zip(jp.passes, tp.passes):
        for f in dataclasses.fields(tif.FastPass):
            a, b = getattr(js, f.name), getattr(ts, f.name)
            if f.name == "kind":
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("shape,algo,direction", CASES)
@pytest.mark.parametrize("anchored", [True, False])
def test_plan_matches_jax(shape, algo, direction, anchored):
    stride = ANCHORS[len(shape) - 1] if anchored else max(shape)
    kw = dict(interp_algo=algo, direction=direction, anchor_stride=stride, alpha=1.25,
              beta=2.0, eb=1e-3, quantbin_cnt=65536)
    jp = jif.build_fast_plan(shape, **kw)
    tp = tif.build_fast_plan(shape, **kw)
    _assert_same(jp, tp)
    _assert_same(jp, tif.from_jax_plan(jp))


@pytest.mark.parametrize("alpha,beta", [(-1.0, 1.0), (1.0, 1.0), (0.5, 3.0), (1.5, 4.0)])
def test_plan_eb_schedule_matches_jax(alpha, beta):
    for shape, algo in itertools.product([(33, 37, 41), (96, 113)], (0, 1)):
        kw = dict(interp_algo=algo, direction=0, anchor_stride=ANCHORS[len(shape) - 1],
                  alpha=alpha, beta=beta, eb=3.7e-4, quantbin_cnt=16384)
        _assert_same(jif.build_fast_plan(shape, **kw), tif.build_fast_plan(shape, **kw))
