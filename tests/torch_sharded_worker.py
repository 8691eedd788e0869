"""The ranks of tests/test_torch_sharded.py: spawned by torch.multiprocessing,
so this module imports no jax and nothing of the JAX package (a rank starts
in seconds). Each rank runs the cases over a gloo group on the CPU and
pickles what it saw to <out>/rank<r>.pkl."""

import pickle

import numpy as np
import torch

from sz3_tpu_torch.config import ALGO, EB, Config
from sz3_tpu_torch.parallel import chunked, sharded


def field(shape, seed=3):
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(np.cumsum(rng.standard_normal(shape), axis=-1) * 0.1,
                                dtype=np.float32)


def step_cases(world):
    """name -> (data, sharded_encode keyword arguments)."""
    data = field((8 * world, 8, 8))
    peak = data.copy()
    peak[0, 0, 0] = 50.0            # the global maximum in rank 0's rows only
    kw = dict(interp_algo=1, direction=0, anchor_stride=32, alpha=1.25, beta=2.0,
              quantbin_cnt=65536)
    return {"ABS": (data, dict(kw, eb_mode=EB.ABS, eb_value=1e-3)),
            "REL": (peak, dict(kw, eb_mode=EB.REL, eb_value=1e-3)),
            "ABS_OR_REL": (peak, dict(kw, eb_mode=EB.ABS_OR_REL, eb_value=1e-3, eb_abs=1e-6,
                                      eb_rel=1e-3))}


def payload_cases(world):
    """name -> (data, a function of a config module's namespace that makes
    the Config)."""
    rows = 10 * world + 1           # ragged: heights 10 and 11
    data = field((rows, 12, 10))
    nan = data.copy()
    nan[rows - 3, 4, 5] = np.nan    # in the last rank's rows
    first = nan.copy()
    first[0, 0, 0] = np.nan         # the field's first element
    const = np.full((rows, 12, 10), 2.5, np.float32)

    def rel(ns):
        return ns.Config(cmprAlgo=ns.ALGO.INTERP, errorBoundMode=ns.EB.REL, relErrorBound=1e-3,
                         openmp=True)

    def abs_(ns):
        return ns.Config(cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-3, openmp=True)

    return {"ABS": (data, abs_), "REL": (data, rel), "REL, NaN": (nan, rel),
            "REL, first NaN": (first, rel), "REL, constant": (const, rel)}


class _Namespace:
    ALGO, EB, Config = ALGO, EB, Config


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def run(rank, world, store, out):
    torch.set_num_threads(1)
    sharded.init_file_group(store, rank, world)
    seen = {"step": {}, "payload": {}, "decode": {}}
    try:
        for name, (data, kw) in step_cases(world).items():
            _, bins, b0, eb = sharded.sharded_encode(data, device="cpu", **kw)
            seen["step"][name] = (bins.numpy(), b0, eb)
        for name, (data, make) in payload_cases(world).items():
            payload = sharded.sharded_encode_payload(make(_Namespace), data, device="cpu")
            seen["payload"][name] = payload
            dec = sharded.sharded_decode_payload(Config(dims=data.shape, openmp=True), payload,
                                                 dtype=np.float32, device="cpu")
            seen["decode"][name] = dec.numpy()
        few = field((world - 1, 12, 10)) if world > 2 else field((1,))
        seen["fewer rows"] = _raises(lambda: sharded.sharded_encode_payload(
            Config(cmprAlgo=ALGO.INTERP, absErrorBound=1e-3, openmp=True), few, device="cpu"))
        seen["not divisible"] = _raises(lambda: sharded.sharded_encode(
            field((8 * world + 1, 8, 8)), device="cpu", **step_cases(world)["ABS"][1]))
        seen["not INTERP"] = _raises(lambda: sharded.sharded_encode_payload(
            Config(absErrorBound=1e-3, openmp=True), field((4 * world, 8, 8)), device="cpu"))
        nopred = Config(cmprAlgo=ALGO.NOPRED, absErrorBound=1e-3, openmp=True)
        data = 1 + field((4 * world, 8, 8)) * 1e-4     # NOPRED beats zstd on it
        blob = chunked.compress_chunked(nopred, data, world, torch.device("cpu"))
        seen["decode NOPRED"] = _raises(lambda: sharded.sharded_decode_payload(
            Config(dims=data.shape, openmp=True), blob, device="cpu"))
    finally:
        sharded.dist.destroy_process_group()
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(seen, f)
