"""The port's single-step INTERP encode (sz3_tpu_torch/entry.py and
ops/interp_fast.encode_step) against the JAX package's
sz3_tpu/ops/interp_fast.py::_jit_encode, on the CPU: flat bins and b0
bit-equal (tolerance: exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sz3_tpu.ops.interp_fast import _jit_encode
from sz3_tpu_torch import entry as pentry
from sz3_tpu_torch.ops import interp_fast
from sz3_tpu_torch.parallel import sharded


def _jax_step(args, x: np.ndarray):
    _, run = _jit_encode(*args)
    flat, b0 = run(jnp.asarray(x))
    return np.asarray(flat), int(b0)


def _torch_step(args, x: np.ndarray):
    _, run = pentry.encode_step(*args)
    flat, b0 = run(torch.from_numpy(x))
    assert flat.dtype == torch.int32 and flat.ndim == 1 and b0.ndim == 0
    return flat.numpy(), int(b0)


def test_entry_matches_jit_encode_at_64_cubed():
    run, (x,) = pentry.entry("cpu")
    assert x.device.type == "cpu" and tuple(x.shape) == (64, 64, 64) and x.dtype == torch.float32
    flat, b0 = run(x)
    want_flat, want_b0 = _jax_step(((64, 64, 64), 1, 0, 32, 1.25, 2.0, 1e-3, 65536, "float32"),
                                   x.numpy())
    assert flat.numpy().tobytes() == want_flat.tobytes()
    assert int(b0) == want_b0 == 0          # anchored: the plan has no first-point bin
    assert flat.numel() == 64 ** 3 - 8      # every point but the 2 x 2 x 2 anchors


@pytest.mark.parametrize("args", [
    ((48, 40), 1, 1, 32, 1.25, 2.0, 1e-3, 65536, "float32"),        # 2D cubic, anchored
    ((24, 20, 16), 0, 3, 32, 1.0, 1.0, 5e-4, 32768, "float64"),      # 3D f64, no anchor grid
], ids=["2d-cubic-f32", "3d-linear-f64"])
def test_encode_step_matches_jit_encode(args):
    dims, dtype = args[0], np.dtype(args[-1])
    rng = np.random.default_rng(7)
    x = (np.cumsum(rng.standard_normal(dims), axis=-1) * 0.05).astype(dtype)
    flat, b0 = _torch_step(args, x)
    want_flat, want_b0 = _jax_step(args, x)
    assert flat.tobytes() == want_flat.tobytes()
    assert b0 == want_b0
    plan, _ = pentry.encode_step(*args)
    assert (plan.anchor_stride == 0) == (max(dims) <= 32)
    assert pentry.encode_step(*args)[1] is pentry.encode_step(*args)[1]   # cached


def test_chunk_model_times_the_encode_step(monkeypatch):
    """scaling_bench's chunk model runs the cached encode step, one plan a
    chunk shape."""
    from sz3_tpu_torch.tools import scaling_bench

    seen, step = [], interp_fast.encode_step

    def counting(*args):
        plan, run = step(*args)
        seen.append(args)
        return plan, lambda x: seen.append(tuple(x.shape)) or run(x)

    monkeypatch.setattr(interp_fast, "encode_step", counting)
    chunks = scaling_bench.chunk_model(16, splits=(1, 2), device="cpu")
    assert [r["chunk_shape"] for r in chunks] == [[16, 16, 16], [8, 16, 16]]
    assert seen[0] == ((16, 16, 16), 1, 0, 32, 1.25, 2.0, 1e-3, 65536, "float32")
    assert seen.count((16, 16, 16)) >= scaling_bench.K and (8, 16, 16) in seen


def test_entry_without_a_card_raises_before_any_work(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    built = []
    monkeypatch.setattr(pentry, "encode_step", lambda *a: built.append(a))
    with pytest.raises(RuntimeError, match="cuda"):
        pentry.entry()
    assert built == []


def test_one_module_holds_both_entry_points():
    assert pentry.dryrun_multichip is sharded.dryrun_multichip
    assert pentry.encode_step is interp_fast.encode_step
    assert set(pentry.__all__) == {"encode_step", "entry", "dryrun_multichip"}
