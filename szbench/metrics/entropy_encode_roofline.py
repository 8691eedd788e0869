"""entropy_encode_roofline: the Huffman encode on the card (K1,
ops/entropy_device.hist_and_literals; K2+K3, .pack_bits), its bytes bound
(every symbol read once, the coded stream written once) over the device
time of everything launched inside those calls, %."""

from szbench.roofline import stages

LAYER = "entropy encode"
MOVES = "compress_kernel_GBps"
WRAPS = ("sz3_tpu_torch.ops.entropy_device:hist_and_literals",
         "sz3_tpu_torch.ops.entropy_device:pack_bits")


def note(key, args, kwargs, result):
    bins = args[0] if args else kwargs["bins"]
    if key.endswith(":pack_bits"):
        return {"total_bits": int(args[4] if len(args) > 4 else kwargs["total_bits"])}
    return {"symbols": int(bins.numel())}


def read(r):
    if not r.traced:
        return None
    spans = r.spans(WRAPS)
    nbytes = sum(stages.entropy_encode_bytes(s.info.get("symbols", 0),
                                             s.info.get("total_bits", 0)) for s in spans)
    return stages.share_pct(nbytes, r.device_s(WRAPS))
