/* SZ2-compatible C API exported by the port's host engine (drop-in for the
 * reference tools/sz3c/include/sz3c.h). Link against the library that
 * `python -c "from sz3_tpu_torch import build; print(build.build_engine())"`
 * builds (sz3_tpu_torch/_build/libszt_host-*.so).
 */
#ifndef SZT_SZ3C_H
#define SZT_SZ3C_H

#include <stddef.h>

/* SZ2 error-bound modes (subset supported, like the reference) */
#define ABS 0
#define REL 1
#define VR_REL 1
#define ABS_AND_REL 2
#define ABS_OR_REL 3
#define PSNR 4
#define NORM 5

#define PW_REL 10 /* unsupported: SZ_compress_args returns NULL */

/* SZ2 data types */
#define SZ_FLOAT 0
#define SZ_DOUBLE 1
#define SZ_UINT8 2
#define SZ_INT8 3
#define SZ_UINT16 4
#define SZ_INT16 5
#define SZ_UINT32 6
#define SZ_INT32 7
#define SZ_UINT64 8
#define SZ_INT64 9

#ifdef __cplusplus
extern "C" {
#endif

/* Compress to a malloc'd self-describing SZ3 archive; r5..r1 give the dims
 * with r1 fastest-varying and zero-valued leading dims unused. Returns NULL
 * on unsupported dtype/mode. Caller frees with free_buf(). */
unsigned char *SZ_compress_args(int dataType, void *data, size_t *outSize, int errBoundMode,
                                double absErrBound, double relBoundRatio, double pwrBoundRatio,
                                size_t r5, size_t r4, size_t r3, size_t r2, size_t r1);

/* Decompress a full archive into a malloc'd buffer of r1*...*r5 elements. */
void *SZ_decompress(int dataType, unsigned char *bytes, size_t byteLength, size_t r5, size_t r4,
                    size_t r3, size_t r2, size_t r1);

void free_buf(void *p);

#ifdef __cplusplus
}
#endif

#endif /* SZT_SZ3C_H */
