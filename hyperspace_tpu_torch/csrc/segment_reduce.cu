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
// What bounds it on the H100: memory. The work is one pass over
// n * (4 + 8C) bytes of input plus 8CK bytes of output (3.35 TB/s), with one
// add or compare per value. The TPU kernel kept the whole [C, K] accumulator
// in VMEM and walked row tiles in order; on Hopper blocks run in parallel
// and in no order, so the design is:
//   * init:   out <- identities (sums 0.0; min/max as order keys, below).
//   * reduce: a grid-stride loop over rows. When C*K*8 bytes fit in shared
//             memory, each block accumulates into a private [C, K] copy in
//             shared memory (dynamic, above 48 KB after
//             cudaFuncSetAttribute) and merges it into out with one global
//             atomic per touched entry; otherwise every row updates out
//             directly with global atomics.
//   * finish: min/max channels are decoded from keys back to doubles.
// Sums use atomicAdd(double). Min/max run on an order-preserving int64 map
// of the double's bits (atomicMin/atomicMax on long long, native on both
// shared and global memory): a non-negative double keeps its bits, a
// negative one flips all but the sign bit, so signed int64 order is the
// double order. Every NaN is mapped to the extreme key of its channel
// (INT64_MIN for min, INT64_MAX for max), so it wins every comparison and
// decodes back to a NaN.
//
// Determinism: integral sums below 2^53, all extrema and the count
// channels come out identical from run to run (and bit-equal to the JAX
// result). Non-integral sums depend on the order the atomics land in, which
// changes from run to run, so their last bits may differ between runs.
// The kernel allocates nothing: the caller passes out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kNanMinKey = (long long)0x8000000000000000ULL;  // INT64_MIN
constexpr long long kNanMaxKey = 0x7FFFFFFFFFFFFFFFLL;              // INT64_MAX

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

__device__ __forceinline__ void accumulate(long long* acc, int kind, double v) {
    if (kind == 0) {
        atomicAdd(reinterpret_cast<double*>(acc), v);
    } else if (kind == 1) {
        atomicMin(acc, to_key(v, true));
    } else {
        atomicMax(acc, to_key(v, false));
    }
}

__global__ void segment_reduce_init(long long* out, int C, long long K,
                            unsigned long long min_mask, unsigned long long max_mask) {
    long long total = (long long)C * K;
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < total;
         j += (long long)gridDim.x * blockDim.x) {
        out[j] = identity_bits(kind_of((int)(j / K), min_mask, max_mask));
    }
}

__global__ void segment_reduce_finish(long long* out, int C, long long K,
                              unsigned long long min_mask, unsigned long long max_mask) {
    long long total = (long long)C * K;
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < total;
         j += (long long)gridDim.x * blockDim.x) {
        if (kind_of((int)(j / K), min_mask, max_mask) != 0) {
            reinterpret_cast<double*>(out)[j] = from_key(out[j]);
        }
    }
}

// Private [C, K] accumulator per block in shared memory, merged at the end.
__global__ void segment_reduce_shared(const int* __restrict__ gid, const double* __restrict__ vals,
                                     long long* out, int C, long long n, long long K,
                                     unsigned long long min_mask, unsigned long long max_mask) {
    extern __shared__ long long acc[];
    long long total = (long long)C * K;
    for (long long j = threadIdx.x; j < total; j += blockDim.x) {
        acc[j] = identity_bits(kind_of((int)(j / K), min_mask, max_mask));
    }
    __syncthreads();
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        int g = gid[i];
        if (g < 0 || (long long)g >= K) continue;
        for (int c = 0; c < C; ++c) {
            accumulate(&acc[(long long)c * K + g], kind_of(c, min_mask, max_mask),
                       vals[(long long)c * n + i]);
        }
    }
    __syncthreads();
    for (long long j = threadIdx.x; j < total; j += blockDim.x) {
        int kind = kind_of((int)(j / K), min_mask, max_mask);
        long long a = acc[j];
        if (a == identity_bits(kind)) continue;  // untouched by this block
        if (kind == 0) {
            atomicAdd(reinterpret_cast<double*>(&out[j]), __longlong_as_double(a));
        } else if (kind == 1) {
            atomicMin(&out[j], a);
        } else {
            atomicMax(&out[j], a);
        }
    }
}

// Every row updates the global accumulator directly.
__global__ void segment_reduce_global(const int* __restrict__ gid, const double* __restrict__ vals,
                                     long long* out, int C, long long n, long long K,
                                     unsigned long long min_mask, unsigned long long max_mask) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        int g = gid[i];
        if (g < 0 || (long long)g >= K) continue;
        for (int c = 0; c < C; ++c) {
            accumulate(&out[(long long)c * K + g], kind_of(c, min_mask, max_mask),
                       vals[(long long)c * n + i]);
        }
    }
}

int grid_for(long long work, int blocks_per_sm_cap) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long want = (work + kThreads - 1) / kThreads;
    long long cap = (long long)sms * blocks_per_sm_cap;
    if (want > cap) want = cap;
    return want < 1 ? 1 : (int)want;
}

}  // namespace

extern "C" {

// Launches init, reduce and finish on `stream` for C <= 64 channels (the
// caller splits wider inputs into blocks of channels). The reduce keeps
// per-block shared-memory accumulators when C*K*8 bytes fit the device's
// opt-in per-block limit, and updates `out` with global atomics otherwise.
// Returns cudaGetLastError() after the launches (0 on success).
int hs_segment_reduce(const void* gid, const void* vals, void* out, int C, long long n,
                      long long K, unsigned long long min_mask, unsigned long long max_mask,
                      void* stream) {
    if (C < 0 || C > 64) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long* acc = static_cast<long long*>(out);
    const int* g = static_cast<const int*>(gid);
    const double* v = static_cast<const double*>(vals);
    long long total = (long long)C * K;

    cudaGetLastError();  // clear any stale error so the return is ours
    segment_reduce_init<<<grid_for(total, 8), kThreads, 0, s>>>(acc, C, K, min_mask, max_mask);
    if (n > 0) {
        int dev = 0, smem_limit = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (total * (long long)sizeof(long long) <= smem_limit) {
            int smem = (int)(total * sizeof(long long));
            cudaError_t err = cudaFuncSetAttribute(
                segment_reduce_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return (int)err;
            int per_sm = 0;
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_reduce_shared, kThreads,
                                                          smem);
            if (per_sm < 1) per_sm = 1;
            segment_reduce_shared<<<grid_for(n, per_sm), kThreads, smem, s>>>(
                g, v, acc, C, n, K, min_mask, max_mask);
        } else {
            segment_reduce_global<<<grid_for(n, 8), kThreads, 0, s>>>(g, v, acc, C, n, K, min_mask,
                                                                      max_mask);
        }
    }
    segment_reduce_finish<<<grid_for(total, 8), kThreads, 0, s>>>(acc, C, K, min_mask, max_mask);
    return (int)cudaGetLastError();
}

}  // extern "C"
