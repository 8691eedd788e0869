"""The port's interpolation passes are bit-equal to the JAX package's:
per-pass bins of encode_grid_fast, the decoded grid of decode_grid_fast,
and the bins grid, run from one plan on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sz3_tpu.ops import interp_fast as jif
from sz3_tpu_torch.ops import interp_fast as tif

SHAPES = [(4000,), (96, 113), (33, 37, 41), (9, 10, 11, 12)]
ANCHORS = [4096, 128, 32, 16]


def _field(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(shape).astype(dtype), axis=-1) * 0.1).astype(dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _roundtrip(x, algo, anchor, direction=0):
    shape = x.shape
    # the JAX package's jitted encode_grid_fast (one XLA compile per case)
    jp, run = jif._jit_encode(shape, algo, direction, anchor, 1.25, 2.0, 1e-3, 65536,
                              str(x.dtype))
    tp = tif.from_jax_plan(jp)
    flat, jb0 = run(jnp.asarray(x))
    jbins = jif._split_flat(np.asarray(flat), jp)
    jb0 = np.asarray(jb0) if jp.anchor_stride == 0 else None
    tbins, tb0, trec = tif.encode_grid_fast(torch.from_numpy(x), tp)
    assert len(jbins) == len(tbins) == len(tp.passes)
    for k, (a, b) in enumerate(zip(jbins, tbins)):
        assert np.array_equal(a, b.numpy()), f"pass {k} bins differ"
    assert (jb0 is None) == (tb0 is None)
    if jb0 is not None:
        assert int(jb0) == int(tb0)

    grid = tif.bins_to_grid(tbins, tp, tb0, "cpu")
    jgrid = jif.bins_to_grid(jbins, jp, jb0)
    assert np.array_equal(jgrid, grid.numpy())

    # decode from the bins grid and a literal grid holding the originals
    literal = np.where(jgrid == 0, x, 0).astype(x.dtype)
    jout = jif.interp_decode_grid(jgrid, literal, x.dtype, interp_algo=algo,
                                  direction=direction, anchor_stride=anchor, alpha=1.25,
                                  beta=2.0, eb=1e-3, quantbin_cnt=65536)
    lit_t = torch.from_numpy(literal)
    tout = tif.decode_grid_fast(tif.grid_to_pass_slices(grid, tp),
                                tif.grid_to_pass_slices(lit_t, tp), tp,
                                tif.initial_literal(lit_t, tp), grid[(0,) * grid.dim()],
                                lit_t.dtype)
    assert np.array_equal(_bits(jout), _bits(tout.numpy()))
    assert np.array_equal(_bits(tout.numpy()), _bits(trec.numpy()))
    assert np.abs(tout.numpy().astype(np.float64) - x).max() <= 1e-3


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("algo", [0, 1])
def test_passes_match_jax(shape, algo):
    _roundtrip(_field(shape), algo, ANCHORS[len(shape) - 1])


@pytest.mark.parametrize("shape", [(33, 37, 41), (96, 113)])
def test_passes_match_jax_anchored_small_stride(shape):
    """A stride below the dims gives an anchor grid in 1D/2D too."""
    _roundtrip(_field(shape, seed=2), 1, 16)


@pytest.mark.parametrize("direction", [1, 5])
def test_passes_match_jax_direction(direction):
    _roundtrip(_field((20, 24, 28), seed=4), 0, 16, direction=direction)


def test_passes_match_jax_f64():
    _roundtrip(_field((24, 25, 26), np.float64, seed=3), 1, 32)
