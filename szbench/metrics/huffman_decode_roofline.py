"""huffman_decode_roofline: the Huffman decode on the card
(ops/entropy_decode.decode_stream as algos/device_decode calls it: the
stream's upload, the count phase csrc/huff_scan.cu and the write phase
csrc/huff_write.cu), its bytes bound (the coded stream read once, every
symbol written once) over the device time of everything launched inside
those calls, %."""

from szbench.roofline import stages

LAYER = "entropy decode"
MOVES = "decompress_kernel_GBps"
WRAPS = ("sz3_tpu_torch.algos.device_decode:decode_stream",)


def note(key, args, kwargs, result):
    bits = args[0] if args else kwargs["bits"]
    count = args[1] if len(args) > 1 else kwargs["count"]
    return {"stream_bytes": int(getattr(bits, "nbytes", None) or len(bits)),
            "symbols": int(count)}


def read(r):
    if not r.traced:
        return None
    nbytes = sum(stages.huffman_decode_bytes(s.info.get("stream_bytes", 0),
                                             s.info.get("symbols", 0)) for s in r.spans(WRAPS))
    return stages.share_pct(nbytes, r.device_s(WRAPS))
