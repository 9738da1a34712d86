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
// Each score maps to a 32-bit key: the float's bits mapped to an
// order-preserving unsigned integer and inverted (largest value ->
// smallest key), with NaN sent to -inf's key and -0.0 to +0.0's. The top k
// of a row are its k smallest keys, ties broken by the lowest column; a
// 64-bit key (32-bit key over the column) makes that one unsigned compare.
//
// What bounds it on the H100: bytes. The function must read q*n*4 bytes
// and write q*k*8 (at the brute-force shape, [32, 1M], 128 MB: 0.038 ms at
// 3.35 TB/s); its work is one compare a score. The design is a radix
// select, every step on the device and no step a full sort:
//   * digits (3 launches): each row is split into `blocks_per_row`
//     contiguous chunks, enough blocks to fill the SMs at q = 32. Pass p
//     histograms one digit of the key (11, 11 and 10 bits, high to low)
//     over the keys that match the digits chosen so far, in shared
//     memory, and writes the block's histogram (no atomics in device
//     memory, nothing to zero first);
//   * scan (3 launches, one block a row): sums the blocks' histograms and
//     picks the digit that holds the row's k-th key. After the third the
//     row's k-th key T is known, with `need`, how many of the keys equal
//     to T belong to the top k, and each block's count of earlier ties
//     (an exclusive prefix over the row's blocks in column order);
//   * gather (1 launch): every key below T goes to the row's candidate
//     list (warp-aggregated atomic slots: their order does not matter),
//     and the lowest-column `need` keys equal to T go after them, ranked
//     by the block's tie offset plus a block-wide count in column order;
//     that is the "ties -> lowest column" rule exactly, with no atomic
//     order involved. Only the block where the cut falls ranks; a block
//     all of whose ties are taken places them in any order;
//   * sort (1 launch, one block a row): a bitonic sort of the k 64-bit
//     candidates in shared memory (at most 2,048: 16 KB), decoded into
//     values and indices.
// Where n and the chunk are multiples of 4, the digit and gather passes
// load float4s. So the row is read four times, in 8 launches whatever k is. A row of at
// most 4,096 columns (the routing shape, n = 64) takes one launch instead:
// one block sorts the whole row's 64-bit keys and keeps the first k.
// The kernel allocates nothing: the caller passes the outputs and the
// workspace (ops/topk.py::workspace_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmallMax = 4096;  // columns a row may have for the one-launch path
constexpr int kMaxK = 2048;
constexpr int kThreads = 512;  // digit and gather blocks
constexpr int kScanThreads = 1024;
constexpr int kBins = 2048;  // histogram stride: 11-bit digits (the last has 10 bits)
constexpr unsigned long long kPad = ~0ULL;
constexpr unsigned int kOutside = 0xFFFFFFFFu;  // above every real key (-inf's is 0xFF800000)

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

// Digit pass P: the key's bits [shift, shift + log2(bins)), counted over
// the keys whose bits above them match the digits chosen so far.
template <int P> struct Digit {
    static constexpr int shift = P == 0 ? 21 : (P == 1 ? 10 : 0);
    static constexpr int bins = P == 2 ? 1024 : 2048;
    static constexpr int fixed = P == 1 ? 21 : 10;  // shift of the matched prefix (P > 0)
    __device__ static unsigned int of(unsigned int key) { return (key >> shift) & (bins - 1); }
    __device__ static bool matches(unsigned int key, unsigned int prefix) {
        return P == 0 || (key >> fixed) == (prefix >> fixed);
    }
};

// Per-row state words in the workspace: [0] the key bits chosen so far
// (after the last scan, T), [1] how many keys matching them still belong
// to the top k (after the last scan, `need`), [2] the gather's count of
// keys below T.
constexpr int kState = 4;

struct Workspace {
    unsigned long long* cand;  // [q, k]
    int* hist;                 // [q, bpr, kBins]
    int* tiebase;              // [q, bpr]
    int* state;                // [q, kState]
};

Workspace carve(void* base, long long q, int k, int bpr) {
    Workspace w;
    w.cand = static_cast<unsigned long long*>(base);
    w.hist = reinterpret_cast<int*>(w.cand + q * k);
    w.tiebase = w.hist + q * bpr * (long long)kBins;
    w.state = w.tiebase + q * bpr;
    return w;
}

// Exclusive prefix of v over the block's threads in thread order; *total
// gets the block's sum. Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < warps ? warp_sums[lane] : 0;
        int wi = w;
        for (int o = 1; o < 32; o <<= 1) {
            int t = __shfl_up_sync(0xFFFFFFFFu, wi, o);
            if (lane >= o) wi += t;
        }
        warp_sums[lane] = wi - w;
        if (lane == 31) warp_sums[32] = wi;
    }
    __syncthreads();
    int out = warp_sums[warp] + incl - v;
    *total = warp_sums[32];
    __syncthreads();  // warp_sums may be reused at once
    return out;
}

// Ascending bitonic sort of s[0, size), size a power of two.
__device__ void bitonic_sort(unsigned long long* s, int size) {
    const int half = size >> 1;
    for (int len = 2; len <= size; len <<= 1) {
        for (int stride = len >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < half; i += blockDim.x) {
                int lo = 2 * i - (i & (stride - 1));
                int hi = lo + stride;
                bool ascending = (lo & len) == 0;
                unsigned long long a = s[lo], b = s[hi];
                if ((a > b) == ascending) {
                    s[lo] = b;
                    s[hi] = a;
                }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ void write_result(unsigned long long key, long long at, float* vals, int* idx) {
    vals[at] = high_score((unsigned int)(key >> 32));
    idx[at] = (int)(unsigned int)(key & 0xFFFFFFFFull);
}

// One block a row of n <= kSmallMax columns: sort all its 64-bit keys.
__global__ void topk_small(const float* __restrict__ scores, long long n, int k, int size,
                           float* __restrict__ vals, int* __restrict__ idx) {
    __shared__ unsigned long long s[kSmallMax];
    const long long row = blockIdx.x;
    for (int i = threadIdx.x; i < size; i += blockDim.x) {
        s[i] = i < n ? ((unsigned long long)score_high(scores[row * n + i]) << 32) | (unsigned int)i : kPad;
    }
    __syncthreads();
    bitonic_sort(s, size);
    for (int i = threadIdx.x; i < k; i += blockDim.x) write_result(s[i], row * k + i, vals, idx);
}

// A thread's share of one step over a block's columns: `groups` groups of
// E consecutive columns, group u starting at base + (u * kThreads + t) * E.
// E = 4 loads each group as one float4 (row and chunk 16-byte aligned, so
// a group lies wholly inside or outside the chunk), E = 1 as one float.
template <int E>
struct Step {
    static constexpr int groups = E == 4 ? 2 : 4;
    static constexpr long long width = (long long)groups * kThreads * E;
    float v[groups][E];
    __device__ static long long column(long long base, int u) {
        return base + ((long long)u * kThreads + threadIdx.x) * E;
    }
    __device__ void load(const float* __restrict__ x, long long base, long long hi) {
#pragma unroll
        for (int u = 0; u < groups; ++u) {
            long long c = column(base, u);
            if (E == 4) {
                float4 f = c < hi ? *reinterpret_cast<const float4*>(x + c) : make_float4(0.f, 0.f, 0.f, 0.f);
                v[u][0] = f.x;
                v[u][E > 1 ? 1 : 0] = f.y;
                v[u][E > 2 ? 2 : 0] = f.z;
                v[u][E > 3 ? 3 : 0] = f.w;
            } else {
                v[u][0] = c < hi ? x[c] : 0.0f;
            }
        }
    }
};

// Digit pass P over block (row, b)'s chunk of columns.
template <int P, int E>
__global__ void __launch_bounds__(kThreads) topk_digits(const float* __restrict__ scores, long long n,
                                                        int bpr, long long chunk, Workspace w) {
    __shared__ int h[Digit<P>::bins];
    const long long row = blockIdx.x / bpr;
    const int b = blockIdx.x % bpr;
    for (int i = threadIdx.x; i < Digit<P>::bins; i += blockDim.x) h[i] = 0;
    const unsigned int prefix = P == 0 ? 0u : (unsigned int)w.state[row * kState];
    __syncthreads();
    const float* x = scores + row * n;
    const long long lo = b * chunk;
    const long long hi = lo + chunk < n ? lo + chunk : n;
    for (long long base = lo; base < hi; base += Step<E>::width) {
        Step<E> step;
        step.load(x, base, hi);
#pragma unroll
        for (int u = 0; u < Step<E>::groups; ++u) {
            long long c = Step<E>::column(base, u);
#pragma unroll
            for (int e = 0; e < E; ++e) {
                unsigned int key = score_high(step.v[u][e]);
                if (c + e < hi && Digit<P>::matches(key, prefix)) atomicAdd(&h[Digit<P>::of(key)], 1);
            }
        }
    }
    __syncthreads();
    int* out = w.hist + (row * bpr + b) * (long long)kBins;
    for (int i = threadIdx.x; i < Digit<P>::bins; i += blockDim.x) out[i] = h[i];
}

// One block a row: the digit of pass P that holds the row's k-th key.
template <int P>
__global__ void __launch_bounds__(kScanThreads) topk_scan(int bpr, int k, Workspace w) {
    constexpr int per = Digit<P>::bins / kScanThreads;  // bins a thread
    __shared__ int warp_sums[33];
    __shared__ int s_digit, s_below;
    const long long row = blockIdx.x;
    const int* h = w.hist + row * bpr * (long long)kBins;
    int cnt[per];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < per; ++j) {
        int d = threadIdx.x * per + j;
        int s = 0;
        for (int b = 0; b < bpr; ++b) s += h[(long long)b * kBins + d];
        cnt[j] = s;
        mine += s;
    }
    const int need = P == 0 ? k : w.state[row * kState + 1];
    const unsigned int prefix = P == 0 ? 0u : (unsigned int)w.state[row * kState];
    int total;
    int run = block_exclusive_scan(mine, &total, warp_sums);
    // Exactly one bin has `run < need <= run + cnt`: the counts sum to at
    // least `need`, the keys that matched the digits so far.
#pragma unroll
    for (int j = 0; j < per; ++j) {
        if (run < need && need <= run + cnt[j]) {
            s_digit = threadIdx.x * per + j;
            s_below = run;
        }
        run += cnt[j];
    }
    __syncthreads();
    const int digit = s_digit;
    if (threadIdx.x == 0) {
        w.state[row * kState] = (int)(prefix | ((unsigned int)digit << Digit<P>::shift));
        w.state[row * kState + 1] = need - s_below;
        w.state[row * kState + 2] = 0;
    }
    if (P == 2) {
        // Ties at T before each block, in column order.
        int carry = 0;
        for (int b0 = 0; b0 < bpr; b0 += blockDim.x) {
            int b = b0 + threadIdx.x;
            int t = b < bpr ? h[(long long)b * kBins + digit] : 0;
            int sum;
            int before = block_exclusive_scan(t, &sum, warp_sums);
            if (b < bpr) w.tiebase[row * bpr + b] = carry + before;
            carry += sum;
        }
    }
}

// Block (row, b): keys below T to the candidate list in any order; the
// lowest-column `need` keys equal to T after them. A block all of whose
// ties are taken also places them in any order; only the block where the
// cut falls (one a row at most) ranks its ties in column order, and only
// in steps that hold one, until the cut is reached.
template <int E>
__global__ void __launch_bounds__(kThreads) topk_gather(const float* __restrict__ scores, long long n, int bpr,
                                                        long long chunk, int k, Workspace w) {
    __shared__ int warp_sums[33];
    __shared__ int tie_count;
    const long long row = blockIdx.x / bpr;
    const int b = blockIdx.x % bpr;
    const int lane = threadIdx.x & 31;
    const unsigned int lower = (1u << lane) - 1u;
    const unsigned int T = (unsigned int)w.state[row * kState];
    const int need = w.state[row * kState + 1];
    int* above_count = &w.state[row * kState + 2];
    const int above_total = k - need;
    const int my_ties = w.hist[(row * bpr + b) * (long long)kBins + (T & 0x3FFu)];
    int taken = w.tiebase[row * bpr + b];  // ties in the row's earlier blocks
    // The same in every thread of the block:
    const bool all_ties = my_ties > 0 && taken + my_ties <= need;  // every tie here is taken
    bool rank = my_ties > 0 && taken < need && !all_ties;          // the cut falls here
    unsigned long long* out = w.cand + row * k;
    unsigned long long* tie_out = out + above_total + taken;
    if (threadIdx.x == 0) tie_count = 0;
    __syncthreads();
    const float* x = scores + row * n;
    const long long lo = b * chunk;
    const long long hi = lo + chunk < n ? lo + chunk : n;
    for (long long base = lo; base < hi; base += Step<E>::width) {
        Step<E> step;
        step.load(x, base, hi);
#pragma unroll
        for (int u = 0; u < Step<E>::groups; ++u) {
            const long long c = Step<E>::column(base, u);
            unsigned int key[E];
#pragma unroll
            for (int e = 0; e < E; ++e) key[e] = c + e < hi ? score_high(step.v[u][e]) : kOutside;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                unsigned int above = __ballot_sync(0xFFFFFFFFu, key[e] < T);
                if (above) {
                    int leader = __ffs(above) - 1;
                    int slot = 0;
                    if (lane == leader) slot = atomicAdd(above_count, __popc(above));
                    slot = __shfl_sync(0xFFFFFFFFu, slot, leader);
                    if (key[e] < T) out[slot + __popc(above & lower)] = ((unsigned long long)key[e] << 32) | (unsigned int)(c + e);
                }
                if (all_ties) {
                    unsigned int ties = __ballot_sync(0xFFFFFFFFu, key[e] == T);
                    if (ties) {
                        int leader = __ffs(ties) - 1;
                        int slot = 0;
                        if (lane == leader) slot = atomicAdd(&tie_count, __popc(ties));
                        slot = __shfl_sync(0xFFFFFFFFu, slot, leader);
                        if (key[e] == T) tie_out[slot + __popc(ties & lower)] = ((unsigned long long)T << 32) | (unsigned int)(c + e);
                    }
                }
            }
            if (rank) {  // this group's ties in column order: thread, then element
                int mine = 0;
#pragma unroll
                for (int e = 0; e < E; ++e) mine += key[e] == T;
                if (__syncthreads_or(mine)) {
                    int sum;
                    int r = taken + block_exclusive_scan(mine, &sum, warp_sums);
#pragma unroll
                    for (int e = 0; e < E; ++e) {
                        if (key[e] == T) {
                            if (r < need) out[above_total + r] = ((unsigned long long)T << 32) | (unsigned int)(c + e);
                            ++r;
                        }
                    }
                    taken += sum;
                    rank = taken < need;
                }
            }
        }
    }
}

// One block a row: sort the k candidates and decode them.
__global__ void topk_sort(const unsigned long long* __restrict__ cand, int k, int size, float* __restrict__ vals,
                          int* __restrict__ idx) {
    __shared__ unsigned long long s[kMaxK];
    const long long row = blockIdx.x;
    for (int i = threadIdx.x; i < size; i += blockDim.x) s[i] = i < k ? cand[row * k + i] : kPad;
    __syncthreads();
    bitonic_sort(s, size);
    for (int i = threadIdx.x; i < k; i += blockDim.x) write_result(s[i], row * k + i, vals, idx);
}

int pow2_at_least(long long v) {
    int p = 1;
    while (p < v) p <<= 1;
    return p;
}

int sort_threads(int size) {
    int t = size / 2 < kThreads ? size / 2 : kThreads;
    return t < 32 ? 32 : t;
}

// The digit passes, their scans and the gather, with E columns a load.
template <int E>
void radix_select(const float* scores, long long q, long long n, int k, int bpr, long long chunk, Workspace w,
                  cudaStream_t s) {
    const unsigned int grid = (unsigned int)(q * bpr);
    topk_digits<0, E><<<grid, kThreads, 0, s>>>(scores, n, bpr, chunk, w);
    topk_scan<0><<<(unsigned int)q, kScanThreads, 0, s>>>(bpr, k, w);
    topk_digits<1, E><<<grid, kThreads, 0, s>>>(scores, n, bpr, chunk, w);
    topk_scan<1><<<(unsigned int)q, kScanThreads, 0, s>>>(bpr, k, w);
    topk_digits<2, E><<<grid, kThreads, 0, s>>>(scores, n, bpr, chunk, w);
    topk_scan<2><<<(unsigned int)q, kScanThreads, 0, s>>>(bpr, k, w);
    topk_gather<E><<<grid, kThreads, 0, s>>>(scores, n, bpr, chunk, k, w);
}

}  // namespace

extern "C" {

// Top k of every row of scores [q, n] into vals / idx [q, k] on `stream`.
// blocks_per_row == 0 takes the one-launch path (n <= 4096, no
// workspace); otherwise each row is split into blocks_per_row chunks of
// `chunk` columns (the last may be shorter, none empty) and `workspace`
// holds ops/topk.py::workspace_bytes(q, k, blocks_per_row) bytes.
// Returns the CUDA error of the launches (0 on success); 1000 + n for a
// bad argument n.
int hs_topk(const float* scores, long long q, long long n, int k, int blocks_per_row, long long chunk,
            void* workspace, float* vals, int* idx, void* stream) {
    if (q < 1) return 1002;
    if (n < 1 || n >= 0xFFFFFFFFLL) return 1003;
    if (k < 1 || k > kMaxK || k > n) return 1004;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaGetLastError();  // clear any stale error so the return is ours
    if (blocks_per_row == 0) {
        if (n > kSmallMax || q > 0x7FFFFFFFLL) return 1005;
        int size = pow2_at_least(n);
        topk_small<<<(unsigned int)q, sort_threads(size), 0, s>>>(scores, n, k, size, vals, idx);
        return (int)cudaGetLastError();
    }
    const int bpr = blocks_per_row;
    if (bpr < 1 || chunk < 1 || bpr * chunk < n || (bpr - 1) * chunk >= n) return 1006;
    if (q * bpr > 0x7FFFFFFFLL || workspace == nullptr) return 1007;
    Workspace w = carve(workspace, q, k, bpr);
    // float4 loads where every row and chunk starts on 16 bytes.
    const bool vec = n % 4 == 0 && chunk % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
    if (vec) {
        radix_select<4>(scores, q, n, k, bpr, chunk, w, s);
    } else {
        radix_select<1>(scores, q, n, k, bpr, chunk, w, s);
    }
    int size = pow2_at_least(k);
    topk_sort<<<(unsigned int)q, sort_threads(size), 0, s>>>(w.cand, k, size, vals, idx);
    return (int)cudaGetLastError();
}

}  // extern "C"
