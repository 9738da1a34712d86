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
// What bounds it on the H100: memory. The function reads pk and sk once
// and writes st and en once: 4*B*Lp + 4*B*Ls + 8*B*Lp bytes at 3.35 TB/s.
// The TPU kernel compared the whole sk[b] row with a 128-row tile of pk
// (O(Lp*Ls) work, affordable only under its Ls <= 8192 cap). This file's
// first version ran two binary searches a row, 2*log2(Ls) dependent loads
// each, and reached a third of the byte bound at best: latency held it,
// not bytes, and torch.searchsorted was as fast.
//
// The design: one windowed pass per tile of primary rows. A block takes a
// tile of T = 4*blockDim.x consecutive rows of one bucket (the grid is
// B x ceil((Lp + 3)/T) tiles, folded into a block loop past the grid
// limit), a thread 4 of them, starting on a 16-byte boundary:
//   1. each thread loads its 4 keys at once (edge rows one by one), and
//      the block reduces the minimum and maximum of its non-pad keys;
//   2. three warps search sk[b] in device memory, in parallel, 128 ways a
//      round (4 loads a lane, then ballots): the window [w0, w1) around
//      [lower_bound(min), upper_bound(max)), which holds every non-pad
//      row's st and en whether the tile is sorted or not, and, where the
//      tile has pads, lower_bound(INT32_MAX), the pads' st. The window may
//      hold kSlack keys more at each end, which saves rounds: 31k keys
//      take one round, 6M two;
//   3. a window that fits the shared-memory budget the launch gives
//      (about 1.25 T*Ls/Lp keys, what a sorted tile spans) is staged once
//      with 16-byte cp.async copies ("staged"); of a wider one (an
//      unsorted tile, or a run of equal keys longer than the budget) only
//      every stride-th key is, up to kDirectory of them, and a search ends
//      in device memory within the stride keys they leave ("device"). The
//      tile chooses by its own window;
//   4. a thread whose 4 keys are non-decreasing (every thread, where the
//      primary is sorted, as both joins give it) searches the window once
//      for its first row and walks forward for the rest, a few reads a
//      row; otherwise its 4 rows' searches run in lockstep;
//   5. st and en go out 16 bytes a thread, coalesced, where they lie on
//      pk's 16-byte phase (as fresh allocations beside a fresh pk do).
// So pk is read once, sk about once (neighbouring windows share at most
// their slack and a run of keys), st and en written once, and a row costs
// a few shared-memory reads instead of 2*log2(Ls) dependent device loads.
// What is left between it and the byte bound: each tile's chain of
// dependent steps (its keys, the search rounds, the staging, the rows),
// which the blocks of one wave run in step, so the card's memory idles
// while they search and walk.
// The kernel allocates nothing: the caller passes st and en.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 4;
constexpr int kPad = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kSlack = 512;  // keys a window may hold beyond each of its ends
constexpr int kWalk = 8;     // keys a row's bounds walk before they gallop
constexpr int kDirectory = 1024;  // keys of a window too wide to stage that are staged instead

// Whether key k lies before the answer of a search for v: the first key
// >= v (lower bound, st) or > v (upper bound, en).
template <bool kUpper>
__device__ __forceinline__ bool before(int k, int v) {
    return kUpper ? k <= v : k < v;
}

// First position in s[lo, hi) whose key is not before v, or hi: a
// binary search without branches, ceil(log2(hi - lo)) + 1 reads.
template <bool kUpper, class S>
__device__ __forceinline__ int bsearch(const S& s, int lo, int hi, int v) {
    int len = hi - lo;
    if (len <= 0) return lo;
    while (len > 1) {
        int half = len >> 1;
        lo += before<kUpper>(s[lo + half], v) ? half : 0;
        len -= half;
    }
    return lo + before<kUpper>(s[lo], v);
}

// The same, walking forward from lo for up to kWalk keys (a run of a few
// equal keys costs that many reads), then galloping: an answer d keys
// further costs about 2*log2(d) reads.
template <bool kUpper, class S>
__device__ __forceinline__ int advance(const S& s, int lo, int hi, int v) {
    const int stop = min(hi, lo + kWalk);
    while (lo < stop && before<kUpper>(s[lo], v)) ++lo;
    if (lo < stop) return lo;
    unsigned step = 1;
    while (lo < hi) {
        if (step > (unsigned)(hi - lo)) return bsearch<kUpper>(s, lo, hi, v);
        int i = lo + (int)step - 1;
        if (!before<kUpper>(s[i], v)) return bsearch<kUpper>(s, lo, i, v);
        lo = i + 1;
        step <<= 1;
    }
    return lo;
}

// Narrows [lo, hi] around the answer of a bsearch for v over s[0, n) in
// device memory until hi - lo <= slack (>= 128), by one whole warp: each
// round the lanes read 127 evenly spaced keys, 4 a lane at once, and the
// count of those before the answer keeps the one 128th of the range that
// holds it (to 512 keys, 31k keys take one round and 6M two). Every lane
// returns the range.
template <bool kUpper>
__device__ int2 warp_narrow(const int* __restrict__ s, int n, int v, int slack) {
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = n;
    while (hi - lo > slack) {
        const long long span = hi - lo;
        int c = 0;  // probes p = 0..126 at lo + span*(p + 1)/128; probes 0..c-1 lie before the answer
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int p = 32 * k + lane;  // p = 127 would be hi: not read
            const bool b = p < 127 && before<kUpper>(__ldg(s + lo + (int)(span * (p + 1) >> 7)), v);
            c += __popc(__ballot_sync(kFull, b));
        }
        const int left = lo + (int)(span * c >> 7), right = lo + (int)(span * (c + 1) >> 7);
        if (c > 0) lo = left + 1;
        if (c < 127) hi = right;
    }
    return make_int2(lo, hi);
}

// The exact answer: narrowed to 128 keys, then one round of 4 reads a
// lane.
template <bool kUpper>
__device__ int warp_search(const int* __restrict__ s, int n, int v) {
    const int lane = threadIdx.x & 31;
    const int2 r = warp_narrow<kUpper>(s, n, v, 128);
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i = r.x + 32 * k + lane;
        c += __popc(__ballot_sync(kFull, i < r.y && before<kUpper>(__ldg(s + i), v)));
    }
    return r.x + c;
}

// 16 bytes from device memory to shared memory, asynchronously (wait with
// cp.async.wait_group).
__device__ __forceinline__ void copy16(int4* dst, const int4* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// One thread's rows v[] (pads and rows past the tile are kPad) against
// the window s[0, n), which starts at w0 in sk[b]. dir[0, dn) in shared
// memory, where it is given, holds every stride-th key of the window
// (dir[i] = s[i*stride]): a search of it leaves stride keys of s to
// search. Without one, dn = 0 and stride = n. Writes absolute bounds.
template <class S>
__device__ __forceinline__ void thread_rows(const S& s, int n, const int* dir, int dn, int stride, int w0,
                                            int pads_st, int Ls, const int (&v)[kRowsPerThread],
                                            int (&a)[kRowsPerThread], int (&e)[kRowsPerThread]) {
    // Where v's lower bound lies at or after: [start, start + stride]
    // holds it.
    auto start = [&](int x) {
        const int c = dn > 0 ? bsearch<false>(dir, 0, dn, x) : 0;
        return c > 0 ? (c - 1) * stride + 1 : 0;
    };
    bool sorted = true;
#pragma unroll
    for (int j = 1; j < kRowsPerThread; ++j) sorted = sorted && v[j - 1] <= v[j];
    if (sorted) {
        // One search for the first row, then walks forward.
        int from = 0;  // every later row's bounds lie at or past it
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
            int x = v[j];
            if (x == kPad) {
                a[j] = pads_st;
                e[j] = Ls;
            } else if (j > 0 && x == v[j - 1]) {
                a[j] = a[j - 1];
                e[j] = e[j - 1];
            } else {
                int lo = from;
                if (j > 0) {
                    lo = advance<false>(s, from, n, x);
                } else {
                    lo = start(x);
                    lo = bsearch<false>(s, lo, lo + min(stride, n - lo), x);
                }
                int hi = advance<true>(s, lo, n, x);
                a[j] = w0 + lo;
                e[j] = w0 + hi;
                from = hi;
            }
        }
        return;
    }
    // Unsorted: every row's lower bound in lockstep, kRowsPerThread
    // independent reads a step (the stride keys left halve each step; keys
    // past the window count as above every row), then its upper bound
    // walking from there, in the keys just read.
    int lo[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) lo[j] = start(v[j]);
    for (int len = stride; len > 1;) {
        int half = len >> 1;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
            const unsigned i = (unsigned)lo[j] + half;
            lo[j] += i < (unsigned)n && before<false>(s[i], v[j]) ? half : 0;
        }
        len -= half;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
        lo[j] += lo[j] < n && before<false>(s[lo[j]], v[j]);
        if (v[j] == kPad) {
            a[j] = pads_st;
            e[j] = Ls;
        } else {
            a[j] = w0 + lo[j];
            e[j] = w0 + advance<true>(s, lo[j], n, v[j]);
        }
    }
}

// This thread's rows of tile t: 4 consecutive rows of one bucket b,
// counted from off rows before the bucket's row 0 (off = how far pk's
// row 0 of the bucket lies past a 16-byte boundary), so that they start on
// a boundary; tile k holds those counted rows [k*T, (k+1)*T). Rows outside
// [0, Lp) are not the tile's.
struct Rows {
    long long at;  // the first row's index in pk (b*Lp + r)
    int r;         // its row in the bucket (may be < 0)
    bool whole;    // all 4 rows lie in [0, Lp)
};

__device__ __forceinline__ Rows thread_rows_of(long long t, int tiles, int Lp, int lead) {
    const long long b = t / tiles;
    const int off = (int)((lead + b * Lp) & 3);
    const int r = (int)(t % tiles) * kRowsPerThread * (int)blockDim.x + kRowsPerThread * (int)threadIdx.x - off;
    return {b * Lp + r, r, r >= 0 && r + kRowsPerThread <= Lp};
}

// A block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... (one, below
// the grid limit). Dynamic shared memory: the window, window + 4 keys.
__global__ void __launch_bounds__(256, 8) run_bounds_tiles(const int* __restrict__ pk, const int* __restrict__ sk,
                                                        int* __restrict__ st, int* __restrict__ en, long long B,
                                                        int Lp, int Ls, int tiles, int window) {
    extern __shared__ __align__(16) int win[];
    __shared__ int red[3][32];  // a warp's minimum, maximum, any pad
    __shared__ int bounds[3];   // w0, w1, the pads' st
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
    const int lead = (int)((reinterpret_cast<unsigned long long>(pk) >> 2) & 3);
    const long long total = B * tiles;
    for (long long t = blockIdx.x; t < total; t += gridDim.x) {
        const Rows rows = thread_rows_of(t, tiles, Lp, lead);
        const int* skb = sk + (t / tiles) * Ls;

        // 1. This thread's keys, 16 bytes at once where all 4 are the
        // tile's, and the extent of the tile's non-pad keys.
        int v[kRowsPerThread];
        if (rows.whole) {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; j += 4) {
                int4 q = __ldg(reinterpret_cast<const int4*>(pk + rows.at + j));
                v[j] = q.x;
                v[j + 1] = q.y;
                v[j + 2] = q.z;
                v[j + 3] = q.w;
            }
        } else {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) {
                int r = rows.r + j;
                v[j] = r >= 0 && r < Lp ? pk[rows.at + j] : kPad;
            }
        }
        int lo_key = INT_MAX, hi_key = INT_MIN;
        unsigned pad = 0;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
            int r = rows.r + j;
            if (v[j] != kPad) {
                lo_key = min(lo_key, v[j]);
                hi_key = max(hi_key, v[j]);
            } else if (r >= 0 && r < Lp) {
                pad = 1;
            }
        }
        lo_key = __reduce_min_sync(kFull, lo_key);
        hi_key = __reduce_max_sync(kFull, hi_key);
        pad = __reduce_or_sync(kFull, pad);
        if (lane == 0) {
            red[0][warp] = lo_key;
            red[1][warp] = hi_key;
            red[2][warp] = (int)pad;
        }
        __syncthreads();

        // 2. Warps 0, 1 and 2 find the window and the pads' st in
        // parallel. The window need not be tight: w0 may lie up to
        // kSlack keys below lower_bound(min) and w1 as far above
        // upper_bound(max), which saves the searches their last rounds.
        if (warp < 3) {
            lo_key = __reduce_min_sync(kFull, lane < warps ? red[0][lane] : INT_MAX);
            hi_key = __reduce_max_sync(kFull, lane < warps ? red[1][lane] : INT_MIN);
            pad = __reduce_or_sync(kFull, lane < warps ? (unsigned)red[2][lane] : 0u);
            const bool real = lo_key <= hi_key;  // the tile has a non-pad row
            int r = 0;
            if (warp == 0) {
                if (real) r = warp_narrow<false>(skb, Ls, lo_key, kSlack).x;
            } else if (warp == 1) {
                if (real) r = warp_narrow<true>(skb, Ls, hi_key, kSlack).y;
            } else if (pad) {
                r = warp_search<false>(skb, Ls, kPad);
            }
            if (lane == 0) bounds[warp] = r;
        }
        __syncthreads();
        const int w0 = bounds[0], n = bounds[1] - bounds[0], pads_st = bounds[2];

        // 3. Stage the window when it fits: src[k] lands at s[k], with s
        // offset so that src's 16-byte chunks land on s's, which go by
        // cp.async (device memory to shared, no registers between).
        const bool staged = n <= window;
        const int* src = skb + w0;
        const int phase = (int)((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
        int* s = win + phase;
        int dn = 0, stride = n;  // a wider window's directory in win: dn keys, every stride-th
        if (staged) {
            const int head = min((4 - phase) & 3, n);
            const int nvec = (n - head) >> 2;
            if (tid < head) s[tid] = src[tid];
            const int4* src4 = reinterpret_cast<const int4*>(src + head);
            int4* dst4 = reinterpret_cast<int4*>(s + head);
#pragma unroll 4
            for (int j = tid; j < nvec; j += blockDim.x) copy16(dst4 + j, src4 + j);
            asm volatile("cp.async.commit_group;\n" ::);
            for (int j = head + 4 * nvec + tid; j < n; j += blockDim.x) s[j] = src[j];
            asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();
        } else if (window > 0) {
            const int cap = min(kDirectory, window);
            stride = (n + cap - 1) / cap;
            dn = (n + stride - 1) / stride;
            for (int i = tid; i < dn; i += blockDim.x) win[i] = __ldg(src + (long long)i * stride);
            __syncthreads();
        }

        // 4. This thread's bounds, and out: 16 bytes at once where the rows
        // are whole and st and en lie on pk's 16-byte phase.
        int a[kRowsPerThread], e[kRowsPerThread];
        if (staged) {
            thread_rows(s, n, nullptr, 0, n, w0, pads_st, Ls, v, a, e);
        } else {
            thread_rows(src, n, win, dn, stride, w0, pads_st, Ls, v, a, e);
        }
        int* sd = st + rows.at;
        int* ed = en + rows.at;
        if (rows.whole && ((reinterpret_cast<unsigned long long>(sd) | reinterpret_cast<unsigned long long>(ed)) & 15) == 0) {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; j += 4) {
                *reinterpret_cast<int4*>(sd + j) = make_int4(a[j], a[j + 1], a[j + 2], a[j + 3]);
                *reinterpret_cast<int4*>(ed + j) = make_int4(e[j], e[j + 1], e[j + 2], e[j + 3]);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) {
                int r = rows.r + j;
                if (r >= 0 && r < Lp) {
                    sd[j] = a[j];
                    ed[j] = e[j];
                }
            }
        }
        // The next tile's first two barriers keep its window and red
        // from this one's readers.
    }
}

}  // namespace

extern "C" {

// Launches run_bounds_tiles on `stream` for pk [B, Lp], sk [B, Ls] and
// st, en [B, Lp] (int32, row-major, contiguous; st and en written 16
// bytes at once where they lie on pk's 16-byte phase) with the geometry of
// ops/sortkeys.py::bounds_plan: `threads` (128 or 256) a block, `tiles` =
// ceil((Lp + 3) / (4*threads)) tiles a bucket, `grid` blocks, a window
// budget of `window` keys. `device` is the card the pointers lie on: the
// dynamic shared memory limit is raised once for it. Returns
// cudaGetLastError() after the launch (0 on success).
int hs_run_bounds(const void* pk, const void* sk, void* st, void* en, long long B, long long Lp, long long Ls,
                  int threads, long long tiles, long long grid, int window, int device, void* stream) {
    const long long rows = (long long)kRowsPerThread * threads;
    if (B < 0 || Lp < 0 || Ls < 0 || Lp > INT_MAX - 4096 || Ls > INT_MAX || (threads != 128 && threads != 256) ||
        tiles != (Lp + 3 + rows - 1) / rows || grid < 1 || grid > INT_MAX || window < 0 || window > (1 << 20)) {
        return (int)cudaErrorInvalidValue;
    }
    if (B == 0 || Lp == 0) return 0;
    const int smem = (int)(sizeof(int) * (window + 4));
    if (smem > 48 * 1024) {
        // The largest dynamic shared memory granted on each card so far.
        static int granted[kMaxDevices];
        bool known = device >= 0 && device < kMaxDevices;
        if (!known || granted[device] < smem) {
            cudaError_t err =
                cudaFuncSetAttribute(run_bounds_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return (int)err;
            if (known) granted[device] = smem;
        }
    }
    cudaGetLastError();  // clear any stale error so the return is ours
    run_bounds_tiles<<<(unsigned)grid, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pk), static_cast<const int*>(sk), static_cast<int*>(st), static_cast<int*>(en), B,
        (int)Lp, (int)Ls, (int)tiles, window);
    return (int)cudaGetLastError();
}

}  // extern "C"
