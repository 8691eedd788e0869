/* Declarations of the zstd functions the host engine (csrc/engine) calls,
 * for machines that have zstd's runtime library but not its development
 * header. The signatures and constants are those of zstd's stable public API
 * (zstd.h, v1.4 and later); the engine links the installed libzstd.so.1.
 * Used only when the system's own zstd.h is missing (see build.py). */
#ifndef SZT_ZSTD_DECLS_H
#define SZT_ZSTD_DECLS_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR   (0ULL - 2)

size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize,
                     int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t srcSize);
unsigned ZSTD_isError(size_t code);
const char* ZSTD_getErrorName(size_t code);

typedef struct ZSTD_DCtx_s ZSTD_DCtx;
typedef struct ZSTD_inBuffer_s {
    const void* src;
    size_t size;
    size_t pos;
} ZSTD_inBuffer;
typedef struct ZSTD_outBuffer_s {
    void* dst;
    size_t size;
    size_t pos;
} ZSTD_outBuffer;
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_decompressStream(ZSTD_DCtx* zds, ZSTD_outBuffer* output, ZSTD_inBuffer* input);

#ifdef __cplusplus
}
#endif

#endif
