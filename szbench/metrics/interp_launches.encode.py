"""interp_launches.encode: the kernels launched by the INTERP passes of one
field's encode (ops/interp_fast.encode_grid_fast as algos/device_encode
calls it), from the device trace, a field."""

LAYER = "INTERP passes"
MOVES = "compress_kernel_GBps"
WRAPS = ("sz3_tpu_torch.algos.device_encode:encode_grid_fast",)


def read(r):
    spans = r.spans(WRAPS)
    if not r.traced or not spans:
        return None
    return r.launches(WRAPS) / len(spans)
