// Row-wise top-k (largest) of a float32 [q, n] matrix for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel hyperspace_tpu/ops/topk.py:46
// (_make_tile_kernel, driven by _pallas_topk and topk): for every row, the
// k largest values and their column indices, ordered by value descending,
// with NaN counted as -inf, -0.0 equal to +0.0 (the Pallas kernel's
// `x == m`) and ties going to the lowest column. The kernel selects and
// does no arithmetic on the values, so it is bit-exact against any other
// correct selection under that order (ops/topk.py::topk_plain).
//
// One 64-bit key per score makes the whole order one unsigned compare:
//   high 32 bits: the float's bits mapped to an order-preserving unsigned
//                 integer and inverted (largest value -> smallest key),
//                 with NaN sent to -inf's key and -0.0 to +0.0's;
//   low 32 bits:  the column index (ties -> lowest column first).
// The smallest k keys of a row are its top k. A pad is the largest key
// (all ones), above every real score, -inf included.
//
// Passes (hs_topk_pass, driven by ops/topk.py): a grid of (row, tile)
// blocks; each loads a tile of T keys (a power of two, T >= 2k, at most
// 4096: 32 KB of shared memory) and bitonic-sorts it, then writes its
// first k keys. The first pass maps the scores to keys as it loads them;
// later passes sort the [q, tiles*k] partial keys of the pass before, until
// one tile is left, whose pass decodes values and indices.
//
// What bounds it on the H100: the function must read q*n*4 bytes and write
// q*k*8 (at the brute-force shape, [32, 1M], 128 MB: 0.038 ms at 3.35 TB/s).
// This first version is bound by the bitonic sort instead: a tile of T keys
// costs log2(T)(log2(T)+1)/4 * T compare-exchanges in shared memory, each
// followed by a block barrier, whatever k is (78 steps at T = 4096). The
// TPU kernel ran k max/argmax/mask rounds over its tile, which is O(k*T);
// the sort does not depend on k, which lets one kernel serve k = 100 and
// the routing shape (n = 64) alike. Selecting without a full sort (a
// per-warp candidate filter against the running k-th key, radix select)
// and TMA loads are later work.
// The kernel allocates nothing: the caller passes every output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 4096;
constexpr int kMaxThreads = 512;
constexpr unsigned long long kPad = ~0ULL;

__device__ __forceinline__ unsigned int score_high(float x) {
    unsigned int bits = __float_as_uint(x);
    if (x != x) bits = 0xFF800000u;      // NaN -> -inf
    if ((bits << 1) == 0u) bits = 0u;    // -0.0 -> +0.0
    // Order-preserving map (ascending with the value), then inverted.
    unsigned int ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
    return ~ord;
}

__device__ __forceinline__ float high_score(unsigned int high) {
    unsigned int ord = ~high;
    unsigned int bits = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
    return __uint_as_float(bits);
}

// Block b handles tile (b % tiles) of row (b / tiles). `in` is float32
// [q, len] when !IN_KEYS, else uint64 keys [q, len]. With FINAL the grid
// has one tile a row and the block writes values and indices [q, k];
// else it writes its k keys to out_keys [q, tiles*k].
template <bool IN_KEYS, bool FINAL>
__global__ void topk_tile(const void* __restrict__ in, long long len, int k, int tile, int tiles,
                          unsigned long long* __restrict__ out_keys, float* __restrict__ out_vals,
                          int* __restrict__ out_idx) {
    __shared__ unsigned long long s[kMaxTile];
    long long row = blockIdx.x / tiles;
    int t = blockIdx.x % tiles;
    long long base = (long long)t * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        long long c = base + i;
        unsigned long long key = kPad;
        if (c < len) {
            if (IN_KEYS) {
                key = static_cast<const unsigned long long*>(in)[row * len + c];
            } else {
                float x = static_cast<const float*>(in)[row * len + c];
                key = ((unsigned long long)score_high(x) << 32) | (unsigned long long)(unsigned int)c;
            }
        }
        s[i] = key;
    }
    __syncthreads();
    // Bitonic sort of s[0, tile), ascending.
    const int half = tile >> 1;
    for (int size = 2; size <= tile; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                int lo = 2 * i - (i & (stride - 1));
                int hi = lo + stride;
                bool ascending = (lo & size) == 0;
                unsigned long long a = s[lo], b = s[hi];
                if ((a > b) == ascending) {
                    s[lo] = b;
                    s[hi] = a;
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        unsigned long long key = s[i];
        if (FINAL) {
            out_vals[row * k + i] = high_score((unsigned int)(key >> 32));
            out_idx[row * k + i] = (int)(unsigned int)(key & 0xFFFFFFFFull);
        } else {
            out_keys[(row * tiles + t) * (long long)k + i] = key;
        }
    }
}

template <bool IN_KEYS, bool FINAL>
cudaError_t launch(const void* in, long long q, long long len, int k, int tile, int tiles,
                   unsigned long long* out_keys, float* out_vals, int* out_idx, cudaStream_t stream) {
    int threads = tile / 2 < kMaxThreads ? tile / 2 : kMaxThreads;
    if (threads < 32) threads = 32;
    topk_tile<IN_KEYS, FINAL><<<(unsigned int)(q * tiles), threads, 0, stream>>>(
        in, len, k, tile, tiles, out_keys, out_vals, out_idx);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass over `in` [q, len] (float32 scores when in_keys == 0, else
// uint64 keys) with tiles of `tile` columns: writes the k smallest keys of
// every tile to out_keys [q, ceil(len/tile)*k], or, when out_keys is null
// (one tile a row: len <= tile), the decoded values and indices [q, k].
// Returns the CUDA error of the launch (0 on success); 1000 + n for a bad
// argument n.
int hs_topk_pass(const void* in, int in_keys, long long q, long long len, int k, int tile,
                 unsigned long long* out_keys, float* out_vals, int* out_idx, void* stream) {
    if (tile < 2 || tile > kMaxTile || (tile & (tile - 1)) != 0) return 1006;
    if (k < 1 || 2 * k > tile) return 1005;
    if (q < 1 || len < k) return 1003;
    long long tiles = (len + tile - 1) / tile;
    if (q * tiles > 0x7FFFFFFFLL || len > 0xFFFFFFFFLL) return 1004;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_keys == nullptr) {
        if (tiles != 1) return 1007;
        return in_keys ? launch<true, true>(in, q, len, k, tile, 1, nullptr, out_vals, out_idx, s)
                       : launch<false, true>(in, q, len, k, tile, 1, nullptr, out_vals, out_idx, s);
    }
    return in_keys ? launch<true, false>(in, q, len, k, tile, (int)tiles, out_keys, nullptr, nullptr, s)
                   : launch<false, false>(in, q, len, k, tile, (int)tiles, out_keys, nullptr, nullptr, s);
}

}  // extern "C"
