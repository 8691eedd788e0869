"""huffman_bits_per_value: the Huffman stream's bits over the quantization
symbols it codes, summed over every field the window sealed (the bit count
and the symbol count the entropy encode hands the host engine's seal,
runtime.interp_seal_packed / blockwise_seal_packed). Fewer bits a value is
a smaller archive before zstd."""

LAYER = "entropy encode"
MOVES = "ratio"
WRAPS = ("sz3_tpu_torch.runtime:interp_seal_packed",
         "sz3_tpu_torch.runtime:blockwise_seal_packed")


def note(key, args, kwargs, result):
    def arg(i, name):
        return int(args[i] if len(args) > i else kwargs[name])
    return {"bit_count": arg(3, "bit_count"), "count": arg(4, "count")}


def read(r):
    spans = [s for s in r.spans(WRAPS) if "count" in s.info]
    count = sum(s.info["count"] for s in spans)
    return sum(s.info["bit_count"] for s in spans) / count if count > 0 else None
