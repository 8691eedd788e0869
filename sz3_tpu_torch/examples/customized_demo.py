"""The four extension patterns of the reference's customized demo
(tools/sz3/sz3_customized_demo.cpp:1-15,135-168), on the CUDA card by
default; the counterpart of examples/customized_demo.py, pattern for pattern:

  1. use the high-level API with a configured Config;
  2. assemble a pipeline from existing modules (quantize on the device ->
     Huffman -> zstd);
  3. plug a custom decomposition (predictor) into the standard tail;
  4. build a fully custom compressor on the primitive layers.

Each pattern returns what it produced; main() prints one line a pattern.

Run from the repository root:
    python -m sz3_tpu_torch.examples.customized_demo [--device cuda|cpu]
or by path: python sz3_tpu_torch/examples/customized_demo.py [--device ...].
Without a CUDA device, --device cuda (the default) raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __name__ == "__main__" and not __package__:
    # run by path: the package lies two directories up
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch
import torch.nn.functional as F

import sz3_tpu_torch as szp
from sz3_tpu_torch import runtime
from sz3_tpu_torch.api import on_device
from sz3_tpu_torch.config import ALGO, Config, INTERP_ALGO
from sz3_tpu_torch.encoders import truncate_compress, truncate_decompress
from sz3_tpu_torch.ops.quantize import quantize, recover

EB = 1e-3
RADIUS = 32768


def make_data(shape=(64, 64, 64)) -> np.ndarray:
    g = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    return (np.sin(6 * g[0]) + np.cos(9 * g[1]) * g[2]).astype(np.float32)


def pattern1_highlevel_api(device="cuda"):
    """Reference pattern 1: SZ_compress with a configured Config. Returns
    (archive, decoded tensor on `device`)."""
    data = make_data()
    conf = Config(dims=data.shape, cmprAlgo=ALGO.INTERP, interpAlgo=INTERP_ALGO.LINEAR,
                  absErrorBound=EB)
    blob = szp.compress(data, conf, device=device)
    out, _ = szp.decompress(blob, device=device)
    assert float((out - on_device(data, out.device)).abs().max()) <= EB
    return blob, out


def _seal(bins: torch.Tensor) -> bytes:
    """The stock host tail: Huffman over the bins (copied to the host once),
    then zstd."""
    return runtime.zstd_compress(runtime.huff_encode(bins.cpu().numpy().ravel()))


def pattern2_assemble_modules(device="cuda"):
    """Reference pattern 2: compose quantizer + encoder + lossless yourself.
    Here: quantization on `device` against a zero prediction, the stock
    Huffman coder and the zstd backend, a NOPRED from parts. Returns (bins,
    payload, recovered field), the tensors on `device`."""
    x = on_device(make_data(), device)
    zero = torch.zeros_like(x)
    bins, _ = quantize(x, zero, EB, RADIUS)
    payload = _seal(bins)

    decoded = runtime.huff_decode(runtime.zstd_decompress(payload), x.numel())
    out = recover(zero, on_device(decoded.reshape(x.shape), x.device), x, EB, RADIUS)
    pred = bins != 0
    assert float((out[pred] - x[pred]).abs().max()) <= EB
    return bins, payload, out


def pattern3_custom_decomposition(device="cuda"):
    """Reference pattern 3: your own predictor feeding the standard
    quantize/encode/lossless tail. Example: the mean of the causal
    neighbours in the previous plane and the previous row (a toy: no
    reconstruction feedback). Returns (bins on `device`, payload)."""
    x = on_device(make_data(), device)
    pred = (F.pad(x, (0, 0, 0, 0, 1, 0))[:-1] + F.pad(x, (0, 0, 1, 0))[:, :-1]) * 0.5
    bins, _ = quantize(x, pred.to(x.dtype), EB, RADIUS)
    return bins, _seal(bins)


def pattern4_custom_compressor():
    """Reference pattern 4: a fully custom compressor, here byte truncation
    (the SZTruncateCompressor specialization) from the encoders toolbox, on
    the host. Returns (blob, decoded array)."""
    data = make_data()
    blob = truncate_compress(data, byte_len=2)
    return blob, truncate_decompress(blob, data.size, byte_len=2).reshape(data.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    data = make_data()

    blob, _ = pattern1_highlevel_api(args.device)
    print(f"1. high-level API: ratio {data.nbytes / len(blob):.1f}")
    _, payload, _ = pattern2_assemble_modules(args.device)
    print(f"2. assembled modules: payload {len(payload)} bytes")
    _, payload = pattern3_custom_decomposition(args.device)
    print(f"3. custom decomposition: ratio {data.nbytes / len(payload):.1f} "
          f"(toy predictor, no reconstruction feedback)")
    blob, out = pattern4_custom_compressor()
    rel = np.abs((out - data) / np.maximum(np.abs(data), 1e-9)).max()
    print(f"4. custom compressor (truncate): ratio {data.nbytes / len(blob):.1f}, "
          f"max rel err {rel:.1e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
