// Batched run bounds (searchsorted left and right) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// hyperspace_tpu/ops/sortkeys.py:212 (_make_run_bounds_kernel, reached
// through pallas_run_bounds): for every bucket b and primary code
// pk[b, i] (int32 [B, Lp]),
//     st[b, i] = #(sk[b] <  pk[b, i])
//     en[b, i] = #(sk[b] <= pk[b, i])
// where sk[b] (int32 [B, Ls]) is bucket b's secondary row, sorted, with
// pads at INT32_MAX at its end. pk need not be sorted, and every element
// is computed, pads included: a pk pad (INT32_MAX) gets st = the number
// of real entries of sk[b] and en = Ls; Ls = 0 gives zeros. The results
// are integers, so the kernel and any other correct searchsorted agree
// exactly.
//
// What bounds it on the H100: memory, at best. The function reads pk and
// sk once and writes st and en once: 4*B*Lp + 4*B*Ls + 8*B*Lp bytes at
// 3.35 TB/s. The TPU kernel compared the whole sk[b] row with a 128-row
// tile of pk (O(Lp*Ls) work), affordable only under its Ls <= 8192 cap;
// the join's buckets are far wider (about 30k lineitem rows a bucket at
// SF1 with 200 buckets, 6.0M in one partition without the index). Here
// each thread runs two binary searches per primary row: O(Lp*log2(Ls))
// work, with no cap on Ls. Two regimes, picked by hs_run_bounds itself:
//   * shared: when Ls*4 bytes fit the opt-in per-block shared memory
//     (about 58k keys on the H100) and the bucket has at least as many
//     primary rows as secondary keys (Lp >= Ls), each block stages sk[b]
//     once into dynamic shared memory and then walks a chunk of bucket
//     b's primary rows (a loop over the chunk, not one 128-row tile), so
//     sk is staged a few times per bucket, not Lp/128 times.
//   * global: otherwise the searches read sk[b] in device memory, and L2
//     serves the upper levels of every search.
//   Staging pays when many rows search one staged row: on the H100 the
//   shared regime was the faster at the join's aligned shape with Lp/Ls
//   about 4 and the slower at Lp/Ls about 0.25 (chip_smoke.py times both
//   regimes there); where between the two the crossover lies is not
//   measured, and Lp >= Ls splits the two shapes.
// Why it does not reach the byte bound: each search is log2(Ls) dependent
// loads (shared or L2/global), so a row costs 2*log2(Ls) load latencies
// rather than 12 bytes of streaming; with the whole card's threads in
// flight that latency is hidden only partly. Merge-path searching over a
// sorted primary and TMA staging are later work.
// The kernel allocates nothing: the caller passes st and en.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;

// First position in s[lo, n) whose value is >= v (then > v for upper).
template <typename Ptr>
__device__ __forceinline__ int lower_bound(Ptr s, int lo, int n, int v) {
    int hi = n;
    while (lo < hi) {
        int mid = lo + ((hi - lo) >> 1);
        if (s[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

template <typename Ptr>
__device__ __forceinline__ int upper_bound(Ptr s, int lo, int n, int v) {
    int hi = n;
    while (lo < hi) {
        int mid = lo + ((hi - lo) >> 1);
        if (s[mid] <= v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Block (b, c) stages sk[b] in shared memory, then searches chunk c of
// bucket b's primary rows.
__global__ void run_bounds_shared(const int* __restrict__ pk, const int* __restrict__ sk,
                                  int* __restrict__ st, int* __restrict__ en, int Lp, int Ls,
                                  int chunks) {
    extern __shared__ int s[];
    long long b = blockIdx.x / chunks;
    int c = blockIdx.x % chunks;
    const int* skb = sk + b * (long long)Ls;
    // Stage sk[b]: scalar loads up to the first 16-byte boundary, then
    // 16-byte loads (several in flight per thread), then the scalar tail.
    int head = (int)((4 - ((reinterpret_cast<unsigned long long>(skb) >> 2) & 3)) & 3);
    if (head > Ls) head = Ls;
    int nvec = (Ls - head) >> 2;
    if (threadIdx.x < head) s[threadIdx.x] = skb[threadIdx.x];
    const int4* src4 = reinterpret_cast<const int4*>(skb + head);
#pragma unroll 4
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
        int4 v = __ldg(src4 + j);
        int o = head + 4 * j;
        s[o] = v.x;
        s[o + 1] = v.y;
        s[o + 2] = v.z;
        s[o + 3] = v.w;
    }
    for (int j = head + 4 * nvec + threadIdx.x; j < Ls; j += blockDim.x) s[j] = skb[j];
    __syncthreads();
    int per = (Lp + chunks - 1) / chunks;
    int r0 = c * per;
    int r1 = min(Lp, r0 + per);
    long long base = b * (long long)Lp;
    for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
        int v = pk[base + i];
        int lo = lower_bound(s, 0, Ls, v);
        st[base + i] = lo;
        en[base + i] = upper_bound(s, lo, Ls, v);
    }
}

// A grid-stride loop over all B*Lp primary rows, searching in device
// memory.
__global__ void run_bounds_global(const int* __restrict__ pk, const int* __restrict__ sk,
                                  int* __restrict__ st, int* __restrict__ en, long long B,
                                  long long Lp, int Ls) {
    long long total = B * Lp;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
         i += (long long)gridDim.x * blockDim.x) {
        const int* skb = sk + (i / Lp) * (long long)Ls;
        int v = pk[i];
        int lo = lower_bound(skb, 0, Ls, v);
        st[i] = lo;
        en[i] = upper_bound(skb, lo, Ls, v);
    }
}

}  // namespace

extern "C" {

// Launches one kernel on `stream` for pk/st/en [B, Lp] and sk [B, Ls]
// (int32, row-major, contiguous). *regime on entry: 0 picks (shared when
// Ls*4 bytes fit the device's opt-in per-block shared memory and
// Lp >= Ls, else global), 1 forces global, 2 forces shared (an error when
// sk[b] does not fit); on return it holds the regime launched (1 or 2).
// Returns cudaGetLastError() after the launch (0 on success).
int hs_run_bounds(const void* pk, const void* sk, void* st, void* en, long long B, long long Lp,
                  long long Ls, int* regime, void* stream) {
    if (B < 0 || Lp < 0 || Ls < 0 || Lp > INT_MAX || Ls > INT_MAX || *regime < 0 || *regime > 2) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* p = static_cast<const int*>(pk);
    const int* k = static_cast<const int*>(sk);
    int* lo = static_cast<int*>(st);
    int* hi = static_cast<int*>(en);

    cudaGetLastError();  // clear any stale error so the return is ours
    int dev = 0, sms = 0, smem_limit = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    long long smem = Ls * (long long)sizeof(int);
    bool fits = smem <= smem_limit;
    if (*regime == 0) *regime = (fits && Lp >= Ls) ? 2 : 1;
    if (*regime == 2 && !fits) return (int)cudaErrorInvalidValue;
    if (B == 0 || Lp == 0) return 0;
    if (*regime == 2) {
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                run_bounds_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, run_bounds_shared, kSharedThreads,
                                                      (size_t)smem);
        if (per_sm < 1) per_sm = 1;
        // About two waves of blocks over the card, but never a chunk
        // narrower than one block of threads.
        long long chunks = (2LL * sms * per_sm + B - 1) / B;
        long long max_chunks = (Lp + kSharedThreads - 1) / kSharedThreads;
        if (chunks > max_chunks) chunks = max_chunks;
        if (chunks < 1) chunks = 1;
        if (B * chunks > INT_MAX) chunks = INT_MAX / B;
        if (chunks < 1) return (int)cudaErrorInvalidConfiguration;
        run_bounds_shared<<<(unsigned)(B * chunks), kSharedThreads, (size_t)smem, s>>>(
            p, k, lo, hi, (int)Lp, (int)Ls, (int)chunks);
    } else {
        long long want = (B * Lp + kGlobalThreads - 1) / kGlobalThreads;
        long long cap = (long long)sms * 8;
        int grid = (int)(want < cap ? want : cap);
        run_bounds_global<<<grid, kGlobalThreads, 0, s>>>(p, k, lo, hi, B, Lp, (int)Ls);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
