"""lorenzo_sweep_roofline: LORENZO_REG's encode sweep (csrc/lorenzo_sweep.cu
in its quantize form, through ops/blockwise_wavefront_encode.sweep_encode),
its bytes bound (each cell's value read, its bin and reconstruction written,
once a pass) over the device time of everything launched inside the sweep
calls of the window's compresses, %."""

from szbench.roofline import stages

LAYER = "LORENZO_REG encode"
MOVES = "compress_kernel_GBps"
WRAPS = ("sz3_tpu_torch.ops.blockwise_wavefront_encode:sweep_encode",)


def note(key, args, kwargs, result):
    types = args[1] if len(args) > 1 else kwargs["types"]
    return {"cells": int(types.numel())}


def read(r):
    if not r.traced:
        return None
    nbytes = sum(stages.lorenzo_sweep_bytes(s.info.get("cells", 0)) for s in r.spans(WRAPS))
    return stages.share_pct(nbytes, r.device_s(WRAPS))
