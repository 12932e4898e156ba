// Chunk codecs for compressed raw forward indexes: the port's copy of
// the reference package's native packer (its chunk half; the bit-packing
// codec lives in storage/bitpack.py, numpy only, the same byte format).
//
// The role of the reference's per-chunk compressors behind
// Fixed/VarByteChunkSVForwardIndex (segment/local/io/compression/): each
// raw forward index is split into 256 KiB chunks, each compressed alone
// with zlib, zstd or lz4, so either package reads what the other wrote.
//
// Built on demand by pinot_tpu_torch/native/__init__.py with the system
// g++ into pinot_tpu_torch/_build/, each codec compiled in only where its
// library links (a plain extern "C" interface, loaded with ctypes); a
// codec compiled out is served by Python (zlib from the standard library,
// zstd through the zstandard package where installed, lz4 by a pure-Python
// block codec), reading and writing the same bytes.

#include <cstdint>
#include <cstring>

// ---------------------------------------------------------------------------
// Chunked zlib decompression for compressed raw forward indexes — the
// reference's chunk-decompressor role (segment/local/io/compression/,
// e.g. ZstandardCompressor/LZ4Compressor behind VarByteChunkSVForwardIndex).
// zlib keeps the format readable by the pure-Python fallback (stdlib zlib).
//
// Compiled out with -DPINOT_NO_ZLIB on hosts without zlib dev headers;
// Python's stdlib zlib then serves the same bytes, slower.
// ---------------------------------------------------------------------------

#ifndef PINOT_NO_ZLIB
#include <zlib.h>

extern "C" {

// src: concatenated compressed chunks; offsets[n_chunks+1]: byte offsets of
// each chunk in src; dst_offsets[n_chunks+1]: uncompressed byte offsets.
// Returns 0 on success, the zlib error code of the first failing chunk
// otherwise.
int inflate_chunks(const uint8_t* src, const int64_t* offsets,
                   int64_t n_chunks, uint8_t* dst,
                   const int64_t* dst_offsets) {
    for (int64_t c = 0; c < n_chunks; ++c) {
        uLongf dst_len = static_cast<uLongf>(dst_offsets[c + 1] - dst_offsets[c]);
        const uLong src_len = static_cast<uLong>(offsets[c + 1] - offsets[c]);
        int rc = uncompress(dst + dst_offsets[c], &dst_len,
                            src + offsets[c], src_len);
        if (rc != Z_OK ||
            dst_len != static_cast<uLongf>(dst_offsets[c + 1] - dst_offsets[c])) {
            return rc != Z_OK ? rc : Z_DATA_ERROR;
        }
    }
    return 0;
}

}  // extern "C"
#endif  // PINOT_NO_ZLIB

// ---------------------------------------------------------------------------
// zstd chunk codec (reference ChunkCompressionType.ZSTANDARD,
// io/compression/ZstandardCompressor). System libzstd; compiled out with
// -DPINOT_NO_ZSTD where the dev header is absent (python `zstandard`
// serves the same frames).
// ---------------------------------------------------------------------------

#ifndef PINOT_NO_ZSTD
#include <zstd.h>

extern "C" {

int zstd_decompress_chunks(const uint8_t* src, const int64_t* offsets,
                           int64_t n_chunks, uint8_t* dst,
                           const int64_t* dst_offsets) {
    for (int64_t c = 0; c < n_chunks; ++c) {
        const size_t cap = static_cast<size_t>(dst_offsets[c + 1] - dst_offsets[c]);
        size_t rc = ZSTD_decompress(dst + dst_offsets[c], cap,
                                    src + offsets[c],
                                    static_cast<size_t>(offsets[c + 1] - offsets[c]));
        if (ZSTD_isError(rc) || rc != cap) return -1;
    }
    return 0;
}

int64_t zstd_compress_chunk(const uint8_t* src, int64_t src_len,
                            uint8_t* dst, int64_t cap, int level) {
    size_t rc = ZSTD_compress(dst, static_cast<size_t>(cap), src,
                              static_cast<size_t>(src_len), level);
    return ZSTD_isError(rc) ? -1 : static_cast<int64_t>(rc);
}

int64_t zstd_bound(int64_t n) {
    return static_cast<int64_t>(ZSTD_compressBound(static_cast<size_t>(n)));
}

}  // extern "C"
#endif  // PINOT_NO_ZSTD

// ---------------------------------------------------------------------------
// LZ4 block chunk codec (reference ChunkCompressionType.LZ4,
// io/compression/LZ4Compressor). The build image ships liblz4.so.1 but no
// header, so the stable liblz4 ABI is declared here; compiled out with
// -DPINOT_NO_LZ4 where the library is absent (a pure-python block decoder
// in pinot_tpu_torch/native/__init__.py reads the same bytes).
// ---------------------------------------------------------------------------

#ifndef PINOT_NO_LZ4
extern "C" {
int LZ4_compress_default(const char* src, char* dst, int srcSize, int dstCap);
int LZ4_decompress_safe(const char* src, char* dst, int srcSize, int dstCap);
int LZ4_compressBound(int inputSize);
}

extern "C" {

int lz4_decompress_chunks(const uint8_t* src, const int64_t* offsets,
                          int64_t n_chunks, uint8_t* dst,
                          const int64_t* dst_offsets) {
    for (int64_t c = 0; c < n_chunks; ++c) {
        const int cap = static_cast<int>(dst_offsets[c + 1] - dst_offsets[c]);
        int rc = LZ4_decompress_safe(
            reinterpret_cast<const char*>(src + offsets[c]),
            reinterpret_cast<char*>(dst + dst_offsets[c]),
            static_cast<int>(offsets[c + 1] - offsets[c]), cap);
        if (rc != cap) return -1;
    }
    return 0;
}

int64_t lz4_compress_chunk(const uint8_t* src, int64_t src_len,
                           uint8_t* dst, int64_t cap) {
    int rc = LZ4_compress_default(reinterpret_cast<const char*>(src),
                                  reinterpret_cast<char*>(dst),
                                  static_cast<int>(src_len),
                                  static_cast<int>(cap));
    return rc <= 0 ? -1 : static_cast<int64_t>(rc);
}

int64_t lz4_bound(int64_t n) {
    return static_cast<int64_t>(LZ4_compressBound(static_cast<int>(n)));
}

}  // extern "C"
#endif  // PINOT_NO_LZ4
