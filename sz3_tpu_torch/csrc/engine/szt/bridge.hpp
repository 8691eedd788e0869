// Host-side bridge for the device (JAX/TPU) compute path.
//
// The device produces/consumes quant bins laid out on the data grid; the
// archive wants them in the reference's traversal order with unpredictable
// literals interleaved in that same order. These helpers do the order
// conversion with a single data-independent walk (InterpCodec::traverse over
// the int32 bins grid) plus the payload seal/open around the entropy stage —
// so device-path archives are byte-identical to host-path archives.
#ifndef SZT_BRIDGE_HPP
#define SZT_BRIDGE_HPP

#include "pipeline.hpp"

namespace szt {

template <class T, int N>
InterpCodec<int32_t, N> make_walker(const Conf& conf) {
    InterpCodec<int32_t, N> w;
    for (int i = 0; i < N; i++) w.dims[i] = conf.dims[i];
    w.interp_id = conf.interpAlgo;
    w.direction = conf.interpDirection;
    w.anchor_stride = size_t(conf.interpAnchorStride);
    w.alpha = conf.interpAlpha;
    w.beta = conf.interpBeta;
    w.blocksize = 32;
    return w;
}

// grid-order bins + original data -> stream-order bins + unpred literals
template <class T, int N>
void interp_emit(const Conf& conf, const int32_t* bins, const T* orig, int32_t* stream,
                 std::vector<T>& unpred) {
    auto w = make_walker<T, N>(conf);
    int32_t* base = const_cast<int32_t*>(bins);
    size_t k = 0;
    w.traverse(
        base,
        [&](int32_t* d) {
            stream[k++] = 0;
            unpred.push_back(orig[d - base]);
        },
        [&](int32_t* d, int32_t) {
            int32_t b = *d;
            stream[k++] = b;
            if (!b) unpred.push_back(orig[d - base]);
        });
}

// stream-order bins + unpred literals -> grid-order bins + literal grid
template <class T, int N>
void interp_place(const Conf& conf, const int32_t* stream, const T* unpred, int32_t* bins_grid,
                  T* literal_grid) {
    auto w = make_walker<T, N>(conf);
    size_t k = 0, j = 0;
    w.traverse(
        bins_grid,
        [&](int32_t* d) {
            *d = stream[k++];  // always 0 for anchors
            literal_grid[d - bins_grid] = unpred[j++];
        },
        [&](int32_t* d, int32_t) {
            int32_t b = stream[k++];
            *d = b;
            if (!b) literal_grid[d - bins_grid] = unpred[j++];
        });
}

// stream position -> flat grid index, for the whole archive stream. The
// traversal is data-independent, so callers cache this per (dims, direction,
// anchor_stride) and do emit/place as vectorized gathers/scatters.
template <int N>
void interp_order(const Conf& conf, int64_t* order) {
    auto w = make_walker<float, N>(conf);
    std::vector<int32_t> grid(conf.num(), 0);
    int32_t* base = grid.data();
    size_t k = 0;
    w.traverse(
        base,
        [&](int32_t* d) { order[k++] = d - base; },
        [&](int32_t* d, int32_t) { order[k++] = d - base; });
}

// stream + literals -> full payload bytes (identical to the host encoder's)
template <class T, int N>
std::vector<uint8_t> interp_seal(Conf& conf, const int32_t* stream, size_t n, const T* unpred,
                                 size_t un, size_t cap) {
    default_anchor_stride(conf);
    auto codec = make_interp<T, N>(conf);
    codec.resolve_params();  // clamp anchor_stride exactly like compress() would
    codec.quant.unpred.assign(unpred, unpred + un);
    std::vector<int32_t> bins(stream, stream + n);
    return seal_payload<T>(codec, bins, cap);
}

// device-packed pieces -> full payload bytes, identical to seal_payload's
// (SZGenericCompressor.hpp:38-63 framing): zstd([decomp.save][tree][count]
// [bitstream-len u64][bitstream]). The bitstream arrives already packed by
// the device entropy stage; `bit_count` trailing bits determine byte length.
template <class T, int N>
std::vector<uint8_t> interp_seal_packed(Conf& conf, const uint8_t* tree, size_t tree_len,
                                        const uint8_t* bits, size_t bit_count, size_t count,
                                        const T* unpred, size_t un, size_t cap) {
    default_anchor_stride(conf);
    auto codec = make_interp<T, N>(conf);
    codec.resolve_params();
    codec.quant.unpred.assign(unpred, unpred + un);
    size_t nbytes = (bit_count + 7) / 8;
    Sink inner;
    inner.reserve(tree_len + nbytes + un * sizeof(T) + 4096);
    codec.save(inner);
    inner.raw(tree, tree_len);
    inner.put<size_t>(count);
    inner.put<size_t>(nbytes);
    inner.raw(bits, nbytes);
    return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
}

// device-computed blockwise streams -> full payload (byte-identical to
// compress_lorenzo_reg's seal of the same sweep)
template <class T, int N>
std::vector<uint8_t> blockwise_seal(Conf& conf, const int32_t* bins, size_t n,
                                    const int32_t* sel, size_t nsel, const int32_t* regb,
                                    size_t nregb, const T* qlu, size_t nqlu, const T* qiu,
                                    size_t nqiu, const T* unpred, size_t nun, size_t cap) {
    auto codec = make_blockwise<T, N>(conf);
    codec.adopt_streams(std::vector<int32_t>(sel, sel + nsel),
                        std::vector<int32_t>(regb, regb + nregb),
                        std::vector<T>(qlu, qlu + nqlu), std::vector<T>(qiu, qiu + nqiu),
                        std::vector<T>(unpred, unpred + nun));
    std::vector<int32_t> bv(bins, bins + n);
    return seal_payload<T>(codec, bv, cap);
}

// device-packed blockwise pieces -> full payload bytes, identical to
// seal_payload's framing: zstd([codec.save (regression + selection +
// quantizer streams)][tree][count][bitstream-len][bitstream]). The bins
// bitstream arrives packed by the device entropy stage; the element
// literals were extracted on-device in stream order.
template <class T, int N>
std::vector<uint8_t> blockwise_seal_packed(Conf& conf, const uint8_t* tree, size_t tree_len,
                                           const uint8_t* bits, size_t bit_count, size_t count,
                                           const int32_t* sel, size_t nsel,
                                           const int32_t* regb, size_t nregb, const T* qlu,
                                           size_t nqlu, const T* qiu, size_t nqiu,
                                           const T* unpred, size_t nun, size_t cap) {
    auto codec = make_blockwise<T, N>(conf);
    codec.adopt_streams(std::vector<int32_t>(sel, sel + nsel),
                        std::vector<int32_t>(regb, regb + nregb),
                        std::vector<T>(qlu, qlu + nqlu), std::vector<T>(qiu, qiu + nqiu),
                        std::vector<T>(unpred, unpred + nun));
    size_t nbytes = (bit_count + 7) / 8;
    Sink inner;
    inner.reserve(tree_len + nbytes + nun * sizeof(T) + 4096);
    codec.save(inner);
    inner.raw(tree, tree_len);
    inner.put<size_t>(count);
    inner.put<size_t>(nbytes);
    inner.raw(bits, nbytes);
    return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
}

// blockwise payload opened WITHOUT entropy-decoding the element bins: side
// streams load normally (they are tiny), the bins Huffman bitstream and the
// exported code table come back raw so the device decode kernels can do the
// bit-walk on-chip (counterpart of blockwise_seal_packed).
template <class T, int N>
void blockwise_open_packed(Conf& conf, const uint8_t* payload, size_t len,
                           std::vector<uint8_t>& bits, uint64_t& count, int64_t& offset,
                           std::vector<uint32_t>& codes, std::vector<uint8_t>& lens,
                           int64_t& const_sym, std::vector<int32_t>& sel,
                           std::vector<int32_t>& regb, std::vector<T>& qlu,
                           std::vector<T>& qiu, std::vector<T>& unpred) {
    auto codec = make_blockwise<T, N>(conf);
    auto raw = zstd_unpack(payload, len);
    Source src(raw.data(), raw.size());
    codec.load(src);
    Huffman<int32_t> huff;
    huff.load(src);
    count = src.template get<size_t>();
    size_t nbytes = src.template get<size_t>();
    const uint8_t* stream = src.take(nbytes);
    bits.assign(stream, stream + nbytes);
    offset = int64_t(huff.offset());
    const_sym = -1;
    if (huff.constant_stream()) {
        const_sym = int64_t(huff.constant_symbol());
    } else if (!huff.export_loaded_codes(codes, lens)) {
        throw std::runtime_error("huffman codes exceed 32 bits");
    }
    codec.export_streams(sel, regb, qlu, qiu, unpred);
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

// blockwise payload bytes -> all archive streams (bins in block-sweep
// order, selection, coefficient bins + coef-quantizer literals, element
// literals) + effective params written into conf (absErrorBound = archived
// eb, quantbinCnt = 2*radius) — everything the device sweep needs to replay
// the block recurrence.
template <class T, int N>
void blockwise_open(Conf& conf, const uint8_t* payload, size_t len,
                    std::vector<int32_t>& bins, std::vector<int32_t>& sel,
                    std::vector<int32_t>& regb, std::vector<T>& qlu,
                    std::vector<T>& qiu, std::vector<T>& unpred) {
    auto codec = make_blockwise<T, N>(conf);
    open_payload(codec, payload, len, bins, conf.num());
    codec.export_streams(sel, regb, qlu, qiu, unpred);
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

// payload bytes -> stream + literals + effective params (written into conf:
// interp fields, absErrorBound = archived eb, quantbinCnt = 2*radius)
template <class T, int N>
void interp_open(Conf& conf, const uint8_t* payload, size_t len, std::vector<int32_t>& stream,
                 std::vector<T>& unpred) {
    InterpCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    open_payload(codec, payload, len, stream, conf.num());
    unpred = codec.quant.unpred;
    conf.interpAlgo = uint8_t(codec.interp_id);
    conf.interpDirection = codec.direction;
    conf.interpAnchorStride = int64_t(codec.anchor_stride);
    conf.interpAlpha = codec.alpha;
    conf.interpBeta = codec.beta;
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

// INTERP payload opened WITHOUT entropy-decoding: the raw Huffman bitstream
// plus the exported code table come back so the device decode kernels can do
// the bit-walk on-chip (counterpart of interp_seal_packed; layout per
// SZGenericCompressor.hpp:65-84 with the decode step deferred).
// const_sym: -1, or the constant symbol when the tree is a single leaf
// (HuffmanEncoder.hpp:233-237) — the bitstream is then empty.
// CodeT (uint32_t or uint64_t) is the width of the exported right-aligned codes.
template <class T, int N, class CodeT>
void interp_open_packed(Conf& conf, const uint8_t* payload, size_t len,
                        std::vector<uint8_t>& bits, uint64_t& count, int64_t& offset,
                        std::vector<CodeT>& codes, std::vector<uint8_t>& lens,
                        int64_t& const_sym, std::vector<T>& unpred) {
    InterpCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    auto raw = zstd_unpack(payload, len);
    Source src(raw.data(), raw.size());
    codec.load(src);
    Huffman<int32_t> huff;
    huff.load(src);
    count = src.template get<size_t>();
    size_t nbytes = src.template get<size_t>();
    const uint8_t* stream = src.take(nbytes);
    bits.assign(stream, stream + nbytes);
    offset = int64_t(huff.offset());
    const_sym = -1;
    if (huff.constant_stream()) {
        const_sym = int64_t(huff.constant_symbol());
    } else if (!huff.export_loaded_codes(codes, lens)) {
        throw std::runtime_error("huffman codes exceed " +
                                 std::to_string(8 * sizeof(CodeT)) + " bits");
    }
    unpred = codec.quant.unpred;
    conf.interpAlgo = uint8_t(codec.interp_id);
    conf.interpDirection = codec.direction;
    conf.interpAnchorStride = int64_t(codec.anchor_stride);
    conf.interpAlpha = codec.alpha;
    conf.interpBeta = codec.beta;
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

// NOPRED variant of the packed open (same deferred-decode contract)
template <class T, class CodeT>
void nopred_open_packed(Conf& conf, const uint8_t* payload, size_t len,
                        std::vector<uint8_t>& bits, uint64_t& count, int64_t& offset,
                        std::vector<CodeT>& codes, std::vector<uint8_t>& lens,
                        int64_t& const_sym, std::vector<T>& unpred) {
    NopredCodec<T> codec;
    codec.n = conf.num();
    auto raw = zstd_unpack(payload, len);
    Source src(raw.data(), raw.size());
    codec.load(src);
    Huffman<int32_t> huff;
    huff.load(src);
    count = src.template get<size_t>();
    size_t nbytes = src.template get<size_t>();
    const uint8_t* stream = src.take(nbytes);
    bits.assign(stream, stream + nbytes);
    offset = int64_t(huff.offset());
    const_sym = -1;
    if (huff.constant_stream()) {
        const_sym = int64_t(huff.constant_symbol());
    } else if (!huff.export_loaded_codes(codes, lens)) {
        throw std::runtime_error("huffman codes exceed " +
                                 std::to_string(8 * sizeof(CodeT)) + " bits");
    }
    unpred = codec.quant.unpred;
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

// device-packed pieces -> NOPRED payload, same framing as interp_seal_packed
// (reference SZAlgoNopred.hpp:13-36: NoPredictionDecomposition saves only the
// quantizer; the encoder/count/bits layout is SZGenericCompressor.hpp:38-63)
template <class T>
std::vector<uint8_t> nopred_seal_packed(Conf& conf, const uint8_t* tree, size_t tree_len,
                                        const uint8_t* bits, size_t bit_count, size_t count,
                                        const T* unpred, size_t un, size_t cap) {
    NopredCodec<T> codec;
    codec.n = conf.num();
    codec.quant = LinearQuantizer<T>(conf.absErrorBound, conf.quantbinCnt / 2);
    codec.quant.unpred.assign(unpred, unpred + un);
    size_t nbytes = (bit_count + 7) / 8;
    Sink inner;
    inner.reserve(tree_len + nbytes + un * sizeof(T) + 4096);
    codec.save(inner);
    inner.raw(tree, tree_len);
    inner.put<size_t>(count);
    inner.put<size_t>(nbytes);
    inner.raw(bits, nbytes);
    return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
}

// NOPRED payload -> element-order bins + unpredictable literals; effective
// quantizer params written back into conf
template <class T>
void nopred_open(Conf& conf, const uint8_t* payload, size_t len, std::vector<int32_t>& bins,
                 std::vector<T>& unpred) {
    NopredCodec<T> codec;
    codec.n = conf.num();
    open_payload(codec, payload, len, bins, codec.n);
    unpred = codec.quant.unpred;
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

}  // namespace szt
#endif
