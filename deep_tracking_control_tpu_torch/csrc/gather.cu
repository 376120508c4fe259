// Grouped row gather: the minibatch shuffle of the PPO update.
//
// Replaces the JAX package's Pallas kernel experimental/pallas_gather.py
// (`_gather` -> `_kernel`, behind `permute_groups`).  For every field of
// the flattened (T*N, ...) rollout batch, out[g] = src[perm[g]] over chunks
// of G flat-adjacent rows: chunk g of a field is the contiguous byte range
// [g * cb, (g + 1) * cb) with cb = G * row bytes, so the kernel is a byte
// copy and does not care about the dtype.  The TPU kernel's G % 8 == 0 and
// >= 512-byte-row rules were Mosaic tiling rules; here any G >= 1 works.
//
// Bound on the H100: bytes.  Nothing is computed; each byte is read once
// and written once.  A lite3_dtc batch at 4096 envs is 3,904 bytes a row x
// 98,304 rows = 383.8 MB, so an update moves about 767.6 MB (0.23 ms at
// 3.35 TB/s).  Design: ONE launch moves every field (a pointer table
// passed by value), one block per chunk, and the threads of a block copy
// the chunk of each field in turn with 16-byte vector loads and stores,
// neighbouring threads on neighbouring addresses.  A chunk whose addresses
// or size are not multiples of 16 bytes is copied in 4-byte words, or in
// bytes when not even that holds.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_FIELDS = 32;

struct GatherTable {
    const char* src[MAX_FIELDS];
    char* dst[MAX_FIELDS];
    long long chunk_bytes[MAX_FIELDS];
    int n;
};

template <typename V>
__device__ __forceinline__ void copy_chunk(const char* s, char* d,
                                           long long nbytes) {
    const V* sv = reinterpret_cast<const V*>(s);
    V* dv = reinterpret_cast<V*>(d);
    const long long n = nbytes / (long long)sizeof(V);
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dv[i] = sv[i];
}

__global__ void gather_kernel(GatherTable t, const long long* __restrict__ perm,
                              long long C) {
    for (long long g = blockIdx.x; g < C; g += gridDim.x) {
        const long long p = perm[g];
        for (int f = 0; f < t.n; ++f) {
            const long long cb = t.chunk_bytes[f];
            const char* s = t.src[f] + p * cb;
            char* d = t.dst[f] + g * cb;
            const unsigned long long a =
                (unsigned long long)(uintptr_t)s | (unsigned long long)(uintptr_t)d
                | (unsigned long long)cb;
            if ((a & 15) == 0) {
                copy_chunk<uint4>(s, d, cb);
            } else if ((a & 3) == 0) {
                copy_chunk<uint32_t>(s, d, cb);
            } else {
                copy_chunk<uint8_t>(s, d, cb);
            }
        }
    }
}

}  // namespace

// table: host array of 3 * n int64 — n source addresses, n destination
// addresses, n chunk sizes in bytes; perm: device int64 (C,).
DTC_EXPORT int dtc_permute_groups(const void* table, int n, const void* perm,
                                  int C, void* stream) {
    if (n < 0 || n > MAX_FIELDS) return (int)cudaErrorInvalidValue;
    const long long* tab = (const long long*)table;
    GatherTable t;
    for (int f = 0; f < n; ++f) {
        t.src[f] = (const char*)(uintptr_t)tab[f];
        t.dst[f] = (char*)(uintptr_t)tab[n + f];
        t.chunk_bytes[f] = tab[2 * n + f];
    }
    t.n = n;
    if (C > 0 && n > 0) {
        gather_kernel<<<C, 256, 0, (cudaStream_t)stream>>>(
            t, (const long long*)perm, (long long)C);
    }
    return (int)cudaGetLastError();
}
