"""The seeded generators repeat exactly for one seed and differ across seeds."""

import pytest
import torch

from szbench.harness import manifest

GENS = {"nyx_like": (20, 24, 28), "wave_field": (30, 50)}


@pytest.mark.parametrize("name", sorted(GENS))
def test_same_seed_same_fields(name):
    gen = manifest.generator(name)
    a = gen.make(GENS[name], 3, 2**31 + 11, "cpu")
    b = gen.make(GENS[name], 3, 2**31 + 11, "cpu")
    assert a.dtype == torch.float32 and a.shape == (3, *GENS[name])
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(GENS))
def test_other_seed_other_fields(name):
    gen = manifest.generator(name)
    a = gen.make(GENS[name], 2, 1, "cpu")
    b = gen.make(GENS[name], 2, 2, "cpu")
    assert not torch.equal(a, b)


def test_nyx_snapshots_are_rolls():
    a = manifest.generator("nyx_like").make((20, 24, 28), 3, 9, "cpu")
    for k in range(3):
        assert torch.equal(a[k], torch.roll(a[0], 3 * k, dims=0))
    rng = float(a.max() - a.min())
    assert 4.0 < rng < 8.0     # about 5.9: exp of waves reaching about +-1.75


def test_wave_fields_differ_by_variable():
    a = manifest.generator("wave_field").make((30, 50), 3, 9, "cpu")
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])


def test_a_data_seed_gives_every_run_the_same_fields_in_its_own_order():
    import numpy as np

    from szbench.harness import cell, manifest

    from .conftest import small_cell

    c = small_cell("nyx512-roundtrip", fields=4)
    gen = manifest.generator(c.config["generator"])
    a, b = (cell.inputs(gen, c.config, s, "cpu").numpy() for s in (2**31 + 5, 2**31 + 6))
    assert np.array_equal(a, cell.inputs(gen, c.config, 2**31 + 5, "cpu").numpy())
    assert sorted(x.tobytes() for x in a) == sorted(x.tobytes() for x in b)
    free = {k: v for k, v in c.config.items() if k != "data_seed"}
    assert not np.array_equal(cell.inputs(gen, free, 1, "cpu").numpy(),
                              cell.inputs(gen, free, 2, "cpu").numpy())
