/* The stable libzstd API subset the native runtime calls (zstd.h, "simple
 * API"), declared for hosts that ship the libzstd runtime (libzstd.so.1)
 * without its development header.  native/Makefile puts this directory on
 * the include path only when <zstd.h> is not found; the code always links
 * the system libzstd. */
#ifndef EBCC_COMPAT_ZSTD_H
#define EBCC_COMPAT_ZSTD_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* EBCC_COMPAT_ZSTD_H */
