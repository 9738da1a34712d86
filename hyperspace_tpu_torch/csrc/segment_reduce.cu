// Fused multi-channel segment reduce for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// hyperspace_tpu/ops/aggregate.py:81 (_make_pallas_segment_reduce): channel
// c of vals [C, n] (float64) is reduced by fns[c] in {sum, min, max} over the
// shared int32 group ids gid [n] into out [C, K] (float64). Sum channels
// start at 0, min channels at +inf, max channels at -inf; a group with no
// rows keeps that identity. Extrema propagate NaN (a group holding a NaN
// reduces to NaN), as jnp.minimum / jnp.maximum do; fmin/fmax would drop it.
// Rows whose group id lies outside [0, K) are skipped.
// Channel kinds travel as two 64-bit masks, so one call takes at most 64
// channels; the caller splits wider inputs into blocks of channels, which
// are independent of each other.
//
// Min/max run on an order-preserving int64 map of the double's bits: a
// non-negative double keeps its bits, a negative one flips all but the sign
// bit, so signed int64 order is the double order. Every NaN is mapped to the
// extreme key of its channel (INT64_MIN for min, INT64_MAX for max), so it
// wins every comparison and decodes back to a NaN.
//
// What bounds it on the H100: memory. The work is one pass over
// n * (4 + 8C) bytes of input plus 8CK bytes of output (3.35 TB/s), with one
// add or compare per value. The TPU kernel kept the whole [C, K] accumulator
// in VMEM and walked row tiles in order; on Hopper blocks run in parallel
// and in no order, and atomics onto few words serialize. Three regimes,
// which the caller (ops/segment_reduce.py::reduce_plan) picks by K:
//   * lanes (K <= 8: Q1's 6 groups, the join's group fold): warp w takes
//     channel w; each lane keeps its channel's K accumulators in registers
//     and updates them with a compare and select a group, four rows in
//     flight. No atomics, so no contention however few the groups; every
//     block's warps fold their lanes with shuffles into one partial [C, K];
//   * block (C*K*8 bytes fit a block's shared memory): one shared [C, K]
//     copy a block, updated with shared atomics, written as its partial;
//     both are one cooperative launch: after a grid-wide barrier the grid
//     folds the blocks' partials in block order (a warp an entry) and
//     decodes the extrema into out, so out needs no initialising pass and
//     the lanes regime's sums repeat bit for bit;
//   * global (larger K: revenue's 1.5M groups, the join's run extrema):
//     init (the identities, a 2-D grid over channel and group: no
//     division an element), reduce (device atomics, all fire-and-forget
//     but one rare case: atomicAdd for sums; atomicMin on the order key
//     for a min channel, which finish then decodes; a max channel holds
//     doubles throughout, so it needs no finish: atomicMax on the bits of
//     a sign-clear value, whose signed order is the key order against any
//     double, and a compare-and-swap decided by the keys for a sign-set
//     one), and finish only where there is a min channel. Group ids that
//     come in runs (a source written in key order, the join's run ids)
//     cost one atomic a run a warp, not one a row: adjacent lanes with
//     equal ids combine by a segmented shuffle reduction and only the
//     run's first lane updates out; a warp whose ids differ lane to lane
//     skips that step. Four tiles of rows a block are loaded at a time.
// Determinism: integral sums below 2^53, all extrema and the count channels
// are exact in any order and so identical from run to run (and bit-equal to
// the JAX result). Non-integral sums in the block and global regimes depend
// on the order the atomics land in, so their last bits may differ between
// runs. The kernel allocates nothing: the caller passes out and the
// partials.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr long long kNanMinKey = (long long)0x8000000000000000ULL;  // INT64_MIN
constexpr long long kNanMaxKey = 0x7FFFFFFFFFFFFFFFLL;              // INT64_MAX
constexpr unsigned int kFull = 0xFFFFFFFFu;

enum Regime { kLanes = 0, kBlock = 1, kGlobal = 2 };

__device__ __forceinline__ long long to_key(double v, bool is_min) {
    if (v != v) return is_min ? kNanMinKey : kNanMaxKey;
    long long b = __double_as_longlong(v);
    return b >= 0 ? b : (b ^ 0x7FFFFFFFFFFFFFFFLL);
}

__device__ __forceinline__ double from_key(long long k) {
    if (k == kNanMinKey || k == kNanMaxKey) return __longlong_as_double(0x7FF8000000000000LL);
    return __longlong_as_double(k >= 0 ? k : (k ^ 0x7FFFFFFFFFFFFFFFLL));
}

// Channel kind from the two bit masks: 0 sum, 1 min, 2 max.
__device__ __forceinline__ int kind_of(int c, unsigned long long min_mask,
                                       unsigned long long max_mask) {
    if ((min_mask >> c) & 1ULL) return 1;
    if ((max_mask >> c) & 1ULL) return 2;
    return 0;
}

// The identity of a channel in accumulator form (a double's bits for sums,
// an order key for extrema).
__device__ __forceinline__ long long identity_bits(int kind) {
    if (kind == 1) return to_key(__longlong_as_double(0x7FF0000000000000LL), true);   // +inf
    if (kind == 2) return to_key(__longlong_as_double(0xFFF0000000000000LL), false);  // -inf
    return 0LL;  // +0.0
}

// Accumulator form of a value: a double's bits for sums, else its key.
__device__ __forceinline__ long long acc_form(int kind, double v) {
    return kind == 0 ? __double_as_longlong(v) : to_key(v, kind == 1);
}

// Two accumulators of one kind combined.
__device__ __forceinline__ long long combine(int kind, long long a, long long b) {
    if (kind == 0) return __double_as_longlong(__longlong_as_double(a) + __longlong_as_double(b));
    if (kind == 1) return a < b ? a : b;
    return a > b ? a : b;
}

__device__ __forceinline__ double decode(int kind, long long a) {
    return kind == 0 ? __longlong_as_double(a) : from_key(a);
}

__device__ __forceinline__ void atomic_combine(long long* at, int kind, long long a) {
    if (kind == 0) {
        atomicAdd(reinterpret_cast<double*>(at), __longlong_as_double(a));
    } else if (kind == 1) {
        atomicMin(at, a);
    } else {
        atomicMax(at, a);
    }
}

// Lane 0 gets the combination of every lane's accumulator.
__device__ __forceinline__ long long warp_combine(int kind, long long a) {
    for (int o = 16; o > 0; o >>= 1) a = combine(kind, a, __shfl_down_sync(kFull, a, o));
    return a;
}

// The blocks' partials [gridDim.x, C*K] (accumulator form) folded in block
// order into out, decoded: a warp an entry, over the whole grid.
__device__ void merge_partials(const long long* __restrict__ partial, double* __restrict__ out, int C, int K,
                               unsigned long long min_mask, unsigned long long max_mask) {
    const int entries = C * K;
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    for (int e = blockIdx.x * warps + (threadIdx.x >> 5); e < entries; e += gridDim.x * warps) {
        int kind = kind_of(e / K, min_mask, max_mask);
        long long a = identity_bits(kind);
        for (int b = lane; b < (int)gridDim.x; b += 32) a = combine(kind, a, partial[(long long)b * entries + e]);
        a = warp_combine(kind, a);
        if (lane == 0) out[e] = decode(kind, a);
    }
}

// -- lanes regime: K <= kLaneGroups ---------------------------------------------

// Warp w of a block takes channels w, w + warps, ...; every lane keeps its
// channel's K accumulators in registers (a compare and select a group),
// over rows lane, lane + 32, ... of the block's tiles of kTile rows.
constexpr int kLaneGroups = 8;
constexpr int kLaneUnroll = 4;
constexpr int kTile = 32 * kLaneUnroll;

// The K <= 8 accumulators are eight named registers, not an array: with
// an array updated as "if (g == j) acc[j] = ..." for every j, ptxas kept
// it in local memory (a 64-byte stack frame).
#define HS_EACH_GROUP(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

template <int KIND>
__device__ __forceinline__ void lanes_channel(const int* __restrict__ gid, const double* __restrict__ v,
                                              long long n, int K, long long* __restrict__ partial_row) {
    const int lane = threadIdx.x & 31;
#define HS_DECLARE(J) long long acc##J = identity_bits(KIND);
    HS_EACH_GROUP(HS_DECLARE)
#undef HS_DECLARE
    for (long long base = (long long)blockIdx.x * kTile; base < n; base += (long long)gridDim.x * kTile) {
        int g[kLaneUnroll];
        double x[kLaneUnroll];
#pragma unroll
        for (int u = 0; u < kLaneUnroll; ++u) {
            long long i = base + u * 32 + lane;
            g[u] = i < n ? gid[i] : -1;
            x[u] = i < n ? v[i] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kLaneUnroll; ++u) {
            const long long a = acc_form(KIND, x[u]);
            const int gu = g[u];  // ids outside [0, K) match no live group
#define HS_UPDATE(J) acc##J = gu == J ? combine(KIND, acc##J, a) : acc##J;
            HS_EACH_GROUP(HS_UPDATE)
#undef HS_UPDATE
        }
    }
#define HS_FOLD(J)                                                                               \
    if (J < K) {                                                                                 \
        long long r = acc##J;                                                                    \
        for (int o = 16; o > 0; o >>= 1) r = combine(KIND, r, __shfl_down_sync(kFull, r, o)); \
        if (lane == 0) partial_row[J] = r;                                                       \
    }
    HS_EACH_GROUP(HS_FOLD)
#undef HS_FOLD
}

__global__ void __launch_bounds__(32 * 16) segment_reduce_lanes(const int* __restrict__ gid, const double* __restrict__ vals,
                                     double* __restrict__ out, long long* __restrict__ partial, int C,
                                     long long n, int K, unsigned long long min_mask,
                                     unsigned long long max_mask) {
    const int warps = blockDim.x >> 5;
    for (int c = threadIdx.x >> 5; c < C; c += warps) {
        long long* row = partial + (long long)blockIdx.x * C * K + (long long)c * K;
        switch (kind_of(c, min_mask, max_mask)) {
            case 0: lanes_channel<0>(gid, vals + c * n, n, K, row); break;
            case 1: lanes_channel<1>(gid, vals + c * n, n, K, row); break;
            default: lanes_channel<2>(gid, vals + c * n, n, K, row); break;
        }
    }
    cg::this_grid().sync();
    merge_partials(partial, out, C, K, min_mask, max_mask);
}

// -- block regime: C*K*8 bytes fit shared memory ----------------------------------

__global__ void __launch_bounds__(kThreads) segment_reduce_block(
        const int* __restrict__ gid, const double* __restrict__ vals, double* __restrict__ out,
        long long* __restrict__ partial, int C, long long n, int K, unsigned long long min_mask,
        unsigned long long max_mask) {
    extern __shared__ long long acc[];
    const int entries = C * K;
    for (int c = 0; c < C; ++c) {
        long long ident = identity_bits(kind_of(c, min_mask, max_mask));
        for (int g = threadIdx.x; g < K; g += kThreads) acc[c * K + g] = ident;
    }
    __syncthreads();
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += (long long)gridDim.x * kThreads) {
        int g = gid[i];
        if (g < 0 || g >= K) continue;
        for (int c = 0; c < C; ++c) {
            int kind = kind_of(c, min_mask, max_mask);
            atomic_combine(&acc[c * K + g], kind, acc_form(kind, vals[c * n + i]));
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += kThreads) partial[(long long)blockIdx.x * entries + e] = acc[e];
    cg::this_grid().sync();
    merge_partials(partial, out, C, K, min_mask, max_mask);
}

// -- global regime ------------------------------------------------------------

// The identities: blockIdx.y is the channel (no division to find it). A
// min channel holds order keys until finish; +inf's key is +inf's bits.
__global__ void segment_reduce_init(double* __restrict__ out, int K, unsigned long long min_mask,
                                    unsigned long long max_mask) {
    const int kind = kind_of(blockIdx.y, min_mask, max_mask);
    const double ident = kind == 0 ? 0.0 : (kind == 1 ? __longlong_as_double(0x7FF0000000000000LL)
                                                      : __longlong_as_double(0xFFF0000000000000LL));
    double* row = out + (long long)blockIdx.y * K;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < K; g += gridDim.x * blockDim.x) row[g] = ident;
}

// The min channels' order keys decoded into doubles.
__global__ void segment_reduce_finish(double* __restrict__ out, int K, unsigned long long min_mask) {
    if (!((min_mask >> blockIdx.y) & 1ULL)) return;
    long long* row = reinterpret_cast<long long*>(out) + (long long)blockIdx.y * K;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < K; g += gridDim.x * blockDim.x) {
        reinterpret_cast<double*>(row)[g] = from_key(row[g]);
    }
}

// A max channel holds doubles throughout. out[g] <- the larger of out[g]
// and the value whose order key is `key` (NaN wins, +0.0 above -0.0): for
// a sign-clear value (or the canonical NaN), whose bits as a signed
// integer order it right against every double out can hold, one
// fire-and-forget atomicMax on the bits; for a sign-set value, a
// compare-and-swap loop decided by the keys, whose first swap assumes out
// still holds the identity.
__device__ __forceinline__ void atomic_max_double(double* at, long long key) {
    const long long bits = __double_as_longlong(from_key(key));
    if (bits >= 0) {
        atomicMax(reinterpret_cast<long long*>(at), bits);
        return;
    }
    unsigned long long* word = reinterpret_cast<unsigned long long*>(at);
    unsigned long long seen = 0xFFF0000000000000ULL;  // -inf
    while (true) {
        if (key <= to_key(__longlong_as_double((long long)seen), false)) return;  // out holds the max already
        unsigned long long before = atomicCAS(word, seen, (unsigned long long)bits);
        if (before == seen) return;
        seen = before;
    }
}

// A block takes kGlobalUnroll tiles of kThreads rows at a time, their loads
// in flight together; a warp's lanes hold 32 consecutive rows of a tile
// (blocks and strides are multiples of 32, so every lane of a warp runs
// every step). Runs of equal ids inside the warp combine into their first
// lane, which alone updates out.
constexpr int kGlobalUnroll = 4;

__global__ void __launch_bounds__(kThreads) segment_reduce_global(
        const int* __restrict__ gid, const double* __restrict__ vals, double* __restrict__ out, int C,
        long long n, int K, unsigned long long min_mask, unsigned long long max_mask) {
    constexpr int U = kGlobalUnroll;
    const int lane = threadIdx.x & 31;
    for (long long base = (long long)blockIdx.x * kThreads * U; base < n; base += (long long)gridDim.x * kThreads * U) {
        int g[U], end[U];
        bool head[U], valid[U], runs[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long i = base + u * kThreads + threadIdx.x;
            g[u] = i < n ? gid[i] : -1;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            valid[u] = g[u] >= 0 && g[u] < K;  // rows past n carry -1
            const int before = __shfl_up_sync(kFull, g[u], 1);
            const unsigned int heads = __ballot_sync(kFull, lane == 0 || g[u] != before);
            head[u] = (heads >> lane) & 1u;
            runs[u] = heads != kFull;  // some lanes continue a run
            // The last lane of this lane's run: the lane before the next head.
            const unsigned int later = lane == 31 ? 0u : heads & (kFull << (lane + 1));
            end[u] = later ? __ffs(later) - 2 : 31;
        }
        for (int c = 0; c < C; ++c) {
            const int kind = kind_of(c, min_mask, max_mask);
            double x[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const long long i = base + u * kThreads + threadIdx.x;
                x[u] = i < n ? vals[c * n + i] : 0.0;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                long long a = acc_form(kind, x[u]);
                if (runs[u]) {  // combine each run into its head
                    for (int o = 1; o < 32; o <<= 1) {
                        long long other = __shfl_down_sync(kFull, a, o);
                        if (lane + o <= end[u]) a = combine(kind, a, other);
                    }
                }
                if (!head[u] || !valid[u]) continue;
                double* at = &out[(long long)c * K + g[u]];
                if (kind == 0) {
                    atomicAdd(at, __longlong_as_double(a));
                } else if (kind == 1) {
                    atomicMin(reinterpret_cast<long long*>(at), a);
                } else {
                    atomic_max_double(at, a);
                }
            }
        }
    }
}

struct DeviceLimits {
    int sms = 0;
    int smem_optin = 0;
    int block_smem_set = 0;  // the dynamic shared memory segment_reduce_block was last allowed
    int per_sm[17] = {};  // resident blocks of the lanes regime an SM, by threads / 32 (cached)
};

DeviceLimits limits[64];

}  // namespace

extern "C" {

// Reduces C <= 64 channels on `stream` in `regime` (0 lanes, 1 block, 2
// global; ops/segment_reduce.py::reduce_plan picks it) with at most `grid`
// blocks of `threads` threads for the reduce (the lanes and block regimes'
// cooperative launch cuts it to what the card holds at once, which a
// grid-wide barrier needs). The lanes and block regimes take `partial`,
// grid * C * K int64 words of scratch. Returns cudaGetLastError() after
// the launches (0 on success), or cudaErrorInvalidValue for arguments the
// regime cannot take.
int hs_segment_reduce(const void* gid, const void* vals, void* out, int C, long long n, long long K,
                      unsigned long long min_mask, unsigned long long max_mask, int regime, int grid,
                      int threads, void* partial, void* stream) {
    if (C < 1 || C > 64 || K < 1 || K > 0x7FFFFFFFLL || n < 0 || grid < 1) return (int)cudaErrorInvalidValue;
    if (regime < kLanes || regime > kGlobal || threads < 32 || threads > 512 || threads % 32) {
        return (int)cudaErrorInvalidValue;
    }
    if (regime != kLanes && threads != kThreads) return (int)cudaErrorInvalidValue;
    if (regime == kLanes && K > kLaneGroups) return (int)cudaErrorInvalidValue;
    if (regime != kGlobal && partial == nullptr) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
    DeviceLimits& lim = limits[dev];
    if (lim.sms == 0) {
        cudaDeviceGetAttribute(&lim.sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&lim.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    cudaGetLastError();  // clear any stale error so the return is ours
    if (regime == kGlobal) {
        cudaStream_t st = static_cast<cudaStream_t>(stream);
        long long cols = (K + kThreads - 1) / kThreads;
        long long cap = (long long)lim.sms * 8 / C + 1;
        dim3 per_channel((unsigned int)(cols < cap ? cols : cap), (unsigned int)C);
        segment_reduce_init<<<per_channel, kThreads, 0, st>>>(static_cast<double*>(out), (int)K, min_mask,
                                                              max_mask);
        if (n > 0) {
            segment_reduce_global<<<grid, kThreads, 0, st>>>(static_cast<const int*>(gid),
                                                             static_cast<const double*>(vals),
                                                             static_cast<double*>(out), C, n, (int)K, min_mask,
                                                             max_mask);
        }
        if (min_mask) segment_reduce_finish<<<per_channel, kThreads, 0, st>>>(static_cast<double*>(out), (int)K, min_mask);
        return (int)cudaGetLastError();
    }
    const void* kernel = regime == kLanes ? (const void*)segment_reduce_lanes : (const void*)segment_reduce_block;
    size_t smem = 0;
    if (regime == kBlock) {
        long long bytes = (long long)C * K * 8;
        if (bytes > lim.smem_optin) return (int)cudaErrorInvalidValue;
        smem = (size_t)bytes;
        if ((int)smem > lim.block_smem_set) {
            cudaError_t err = cudaFuncSetAttribute(segment_reduce_block,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
            lim.block_smem_set = (int)smem;
        }
    }
    // Blocks an SM holds at once: cached, except where shared memory varies.
    int per_sm = regime == kBlock ? 0 : lim.per_sm[threads / 32];
    if (per_sm == 0) {
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        if (regime == kLanes) lim.per_sm[threads / 32] = per_sm;
    }
    if (grid > per_sm * lim.sms) grid = per_sm * lim.sms;
    const int* g = static_cast<const int*>(gid);
    const double* v = static_cast<const double*>(vals);
    long long* p = static_cast<long long*>(partial);
    int k = (int)K;
    void* args[] = {&g, &v, &out, &p, &C, &n, &k, &min_mask, &max_mask};
    cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem,
                                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
