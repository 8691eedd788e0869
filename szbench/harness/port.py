"""sz3_tpu_torch as the program under test.

Each call looks its function up on the package when it is made, so a test
that breaks the package's functions underneath breaks the timed path.
"""

from __future__ import annotations

# the port's layer entry points, wrapped in every traced run so that the
# breakdown names the host layer each idle gap of the card falls in,
# whatever per-layer metrics the cell reads
SPANS = ("sz3_tpu_torch.algos.torch_backend:cal_abs_error_bound",
         "sz3_tpu_torch.serving:cal_abs_error_bound",
         "sz3_tpu_torch.algos.tuner:tune",
         "sz3_tpu_torch.algos.device_encode:encode_grid_fast",
         "sz3_tpu_torch.ops.blockwise_wavefront_encode:sweep_encode",
         "sz3_tpu_torch.ops.entropy_device:hist_and_literals",
         "sz3_tpu_torch.ops.entropy_device:pack_bits",
         "sz3_tpu_torch.runtime:interp_seal_packed",
         "sz3_tpu_torch.runtime:blockwise_seal_packed",
         "sz3_tpu_torch.runtime:open_packed",
         "sz3_tpu_torch.runtime:blockwise_open_packed",
         "sz3_tpu_torch.algos.device_decode:decode_stream")

_BOUND_KEYS = {"abs": "absErrorBound", "rel": "relErrorBound", "psnr": "psnrErrorBound",
               "l2norm": "l2normErrorBound"}


def settings(config: dict, traffic: dict) -> dict:
    """The program's settings of a cell: the configuration's error bound
    and the algorithm the traffic pins (none: the default Config)."""
    eb = config["error_bound"]
    out = {"errorBoundMode": eb["mode"]}
    out.update({_BOUND_KEYS[k]: float(v) for k, v in eb.items() if k in _BOUND_KEYS})
    if traffic.get("algo"):
        out["cmprAlgo"] = traffic["algo"]
    return out


class Port:
    def __init__(self, device) -> None:
        import sz3_tpu_torch
        from sz3_tpu_torch import serving

        self._pkg, self._serving, self.device = sz3_tpu_torch, serving, device

    def config(self, settings: dict):
        pkg = self._pkg
        kw = dict(settings)
        kw["errorBoundMode"] = pkg.EB[kw["errorBoundMode"]]
        if "cmprAlgo" in kw:
            kw["cmprAlgo"] = pkg.ALGO[kw["cmprAlgo"]]
        return pkg.Config(**kw)

    def compress(self, field, conf) -> bytes:
        return self._pkg.compress(field, conf, device=self.device)

    def decompress(self, blob: bytes):
        return self._pkg.decompress(blob, device=self.device)[0]

    def compress_batch(self, stack, conf):
        return self._serving.compress_batch(stack, conf, device=self.device)

    def decompress_batch(self, blobs):
        return self._serving.decompress_batch(blobs, device=self.device)
