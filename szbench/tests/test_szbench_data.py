"""The seeded generators repeat exactly for one seed and differ across
seeds, each as a configuration calls it, at the configuration's rank."""

import json

import numpy as np
import pytest
import torch

from szbench.harness import cell, manifest

from .conftest import ROOT, TESTED, small_shape

CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in TESTED["configs"]}


def _uneven(shape) -> list:
    """The shape at its small size with every axis of another length, so that
    a field made with its axes in another order shows in its shape."""
    return [max(1, n - 2 * i) for i, n in enumerate(small_shape(shape))]


def _made(name, count, seed):
    conf = CONFIGS[name]
    shape = _uneven(conf["shape"])
    return shape, manifest.generator(conf["generator"]).make(shape, count, seed, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_same_seed_same_fields(name):
    shape, a = _made(name, 3, 2**31 + 11)
    _, b = _made(name, 3, 2**31 + 11)
    assert a.dtype == torch.float32 and a.shape == (3, *shape)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_other_seed_other_fields(name):
    assert not torch.equal(_made(name, 2, 1)[1], _made(name, 2, 2)[1])


def test_nyx_snapshots_are_rolls():
    a = manifest.generator("nyx_like").make((20, 24, 28), 3, 9, "cpu")
    assert a.shape == (3, 20, 24, 28)
    for k in range(3):
        assert torch.equal(a[k], torch.roll(a[0], 3 * k, dims=0))
    rng = float(a.max() - a.min())
    assert 4.0 < rng < 8.0     # about 5.9: exp of waves reaching about +-1.75


def test_wave_fields_differ_by_variable():
    a = manifest.generator("wave_field").make((30, 50), 3, 9, "cpu")
    assert a.shape == (3, 30, 50)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])


@pytest.mark.parametrize("name", sorted(n for n, c in CONFIGS.items() if "data_seed" in c))
def test_a_data_seed_gives_every_run_the_same_fields_in_its_own_order(name):
    conf = dict(CONFIGS[name], shape=small_shape(CONFIGS[name]["shape"]), fields=4)
    gen = manifest.generator(conf["generator"])
    a, b = (cell.inputs(gen, conf, s, "cpu").numpy() for s in (2**31 + 5, 2**31 + 6))
    assert np.array_equal(a, cell.inputs(gen, conf, 2**31 + 5, "cpu").numpy())
    assert sorted(x.tobytes() for x in a) == sorted(x.tobytes() for x in b)
    free = {k: v for k, v in conf.items() if k != "data_seed"}
    assert not np.array_equal(cell.inputs(gen, free, 1, "cpu").numpy(),
                              cell.inputs(gen, free, 2, "cpu").numpy())
