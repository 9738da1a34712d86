// Native host-runtime kernels of the PyTorch port (a copy of the JAX
// package's native/hashing.cpp; the entry points are the same).
//
// The host hot loops of the build and query pipeline:
//
//   - murmur3-fmix32 row hashing for bucket assignment (bit-identical to
//     ops/hashing.py's numpy implementation — bucket pruning and on-disk
//     indexes depend on the match),
//   - MD5 prefix hashes for string dictionaries (RFC 1321, replacing a
//     per-entry Python hashlib loop),
//   - the stable per-bucket key sort of the pooled build's workers,
//   - threaded row gather, and the host venues' counting sort by bucket
//     and merge-join helpers.
//
// Built at first use by hyperspace_tpu_torch/native/__init__.py with
// g++ -O3. A failed build raises; the numpy path runs only where the
// caller turned the library off (HYPERSPACE_TORCH_DISABLE_NATIVE).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

void parallel_for(int64_t n, int64_t grain, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = hw ? static_cast<int64_t>(hw) : 4;
  if (nthreads > (n + grain - 1) / grain) nthreads = (n + grain - 1) / grain;
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// ---- compact MD5 (RFC 1321) ------------------------------------------------

struct MD5 {
  uint32_t a0 = 0x67452301, b0 = 0xefcdab89, c0 = 0x98badcfe, d0 = 0x10325476;

  static constexpr uint32_t K[64] = {
      0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
      0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
      0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
      0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
      0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
      0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
      0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
      0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
      0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
      0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
      0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
  static constexpr int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                                7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                                5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                                4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                                6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                                6, 10, 15, 21};

  static uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }

  void block(const uint8_t* p) {
    uint32_t M[16];
    std::memcpy(M, p, 64);
    uint32_t A = a0, B = b0, C = c0, D = d0;
    for (int i = 0; i < 64; ++i) {
      uint32_t F;
      int g;
      if (i < 16) {
        F = (B & C) | (~B & D);
        g = i;
      } else if (i < 32) {
        F = (D & B) | (~D & C);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        F = B ^ C ^ D;
        g = (3 * i + 5) & 15;
      } else {
        F = C ^ (B | ~D);
        g = (7 * i) & 15;
      }
      F += A + K[i] + M[g];
      A = D;
      D = C;
      C = B;
      B += rotl(F, S[i]);
    }
    a0 += A;
    b0 += B;
    c0 += C;
    d0 += D;
  }

  // Digest prefix (first 4 bytes, little-endian) of one message.
  static uint32_t prefix32(const uint8_t* msg, uint64_t len) {
    MD5 m;
    uint64_t full = len / 64;
    for (uint64_t i = 0; i < full; ++i) m.block(msg + i * 64);
    uint8_t tail[128] = {0};
    uint64_t rem = len - full * 64;
    std::memcpy(tail, msg + full * 64, rem);
    tail[rem] = 0x80;
    uint64_t tail_len = (rem + 9 <= 64) ? 64 : 128;
    uint64_t bitlen = len * 8;
    std::memcpy(tail + tail_len - 8, &bitlen, 8);
    m.block(tail);
    if (tail_len == 128) m.block(tail + 64);
    return m.a0;  // little-endian word 0 == first 4 digest bytes LE
  }
};

constexpr uint32_t MD5::K[64];
constexpr int MD5::S[64];

// Fixed-width gather with software prefetch: the permutation is random
// over a working set far beyond cache, so each element load is a DRAM
// miss — prefetching the index stream ~16 ahead overlaps those misses
// (2-3x on the build's carve gather, which is this function's hot use).
template <typename T>
void take_fixed(const T* src, T* dst, const int64_t* idx, int64_t lo,
                int64_t hi) {
  constexpr int64_t kPrefetch = 16;
  int64_t i = lo;
  for (; i + kPrefetch < hi; ++i) {
    __builtin_prefetch(src + idx[i + kPrefetch], 0, 0);
    dst[i] = src[idx[i]];
  }
  for (; i < hi; ++i) dst[i] = src[idx[i]];
}

}  // namespace

extern "C" {

// out[i] = mix32(lo ^ (mix32(hi) * 0x9E3779B1)) — int64 lanes.
void hs_hash_i64(const int64_t* in, uint32_t* out, int64_t n) {
  parallel_for(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t v = static_cast<uint64_t>(in[i]);
      uint32_t l = static_cast<uint32_t>(v & 0xFFFFFFFFu);
      uint32_t h = static_cast<uint32_t>(v >> 32);
      out[i] = mix32(l ^ (mix32(h) * 0x9E3779B1u));
    }
  });
}

// out[i] = mix32(in[i]) — 32-bit lanes.
void hs_hash_i32(const int32_t* in, uint32_t* out, int64_t n) {
  parallel_for(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      out[i] = mix32(static_cast<uint32_t>(in[i]));
  });
}

// MD5-prefix hash per string: bytes in [offsets[i], offsets[i+1]).
void hs_md5_prefix(const uint8_t* bytes, const int64_t* offsets, uint32_t* out,
                   int64_t n) {
  parallel_for(n, 1 << 10, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      out[i] = MD5::prefix32(bytes + offsets[i],
                             static_cast<uint64_t>(offsets[i + 1] - offsets[i]));
  });
}

// dst[i, :] = src[idx[i], :] for row_bytes-wide rows (any dtype/2D shape).
void hs_take_rows(const uint8_t* src, uint8_t* dst, const int64_t* idx,
                  int64_t n_idx, int64_t row_bytes) {
  // The fixed-width fast paths reinterpret src/dst as wider lanes, which
  // is UB (and a SIGBUS on strict-alignment targets) unless both base
  // pointers are aligned to the lane width. Callers normally pass
  // allocator-aligned numpy buffers, but sliced/offset views can start
  // anywhere — route those through the memcpy loop.
  const bool aligned =
      row_bytes <= 1 ||
      (reinterpret_cast<uintptr_t>(src) % static_cast<uintptr_t>(row_bytes) == 0 &&
       reinterpret_cast<uintptr_t>(dst) % static_cast<uintptr_t>(row_bytes) == 0);
  parallel_for(n_idx, 1 << 14, [&](int64_t lo, int64_t hi) {
    switch (aligned ? row_bytes : int64_t{0}) {
      case 1:
        take_fixed(src, dst, idx, lo, hi);
        break;
      case 2:
        take_fixed(reinterpret_cast<const uint16_t*>(src),
                   reinterpret_cast<uint16_t*>(dst), idx, lo, hi);
        break;
      case 4:
        take_fixed(reinterpret_cast<const uint32_t*>(src),
                   reinterpret_cast<uint32_t*>(dst), idx, lo, hi);
        break;
      case 8:
        take_fixed(reinterpret_cast<const uint64_t*>(src),
                   reinterpret_cast<uint64_t*>(dst), idx, lo, hi);
        break;
      default:
        for (int64_t i = lo; i < hi; ++i)
          std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
  });
}

// acc = mix32(acc * 31 + h) column combine, in place on acc.
void hs_combine(uint32_t* acc, const uint32_t* h, int64_t n) {
  parallel_for(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) acc[i] = mix32(acc[i] * 31u + h[i]);
  });
}

// ---- bucket-grouped key sort ----------------------------------------------
// The host venue of the build's bucketize+sort, split in two so the Python
// side can PIPELINE each bucket's key sort with its parquet encode:
//
//   1. hs_bucket_perm: stable counting sort of row ids by bucket;
//   2. hs_sort_range: sort one bucket's slice of the permutation by the
//      order-preserving uint32 key lanes (original index as the final
//      tiebreak — deterministic, equal to the device path's stable
//      lexicographic order). lanes is [num_lanes, n] row-major.

void hs_bucket_perm(const int32_t* bucket, int64_t n, int64_t num_buckets,
                    int64_t* perm, int64_t* counts) {
  for (int64_t b = 0; b < num_buckets; ++b) counts[b] = 0;
  for (int64_t i = 0; i < n; ++i) ++counts[bucket[i]];
  std::vector<int64_t> cur(num_buckets, 0);
  for (int64_t b = 1; b < num_buckets; ++b) cur[b] = cur[b - 1] + counts[b - 1];
  for (int64_t i = 0; i < n; ++i) perm[cur[bucket[i]]++] = i;
}

void hs_sort_range(int64_t* perm, int64_t count, const uint32_t* lanes,
                   int64_t n, int64_t num_lanes) {
  if (num_lanes <= 2) {
    // Fast path (int32/int64/float keys = 1-2 lanes): pack into one u64
    // so the slice sorts contiguous 16-byte (key, idx) pairs instead of
    // gather-loading lanes in the comparator.
    std::vector<std::pair<uint64_t, int64_t>> buf(count);
    for (int64_t p = 0; p < count; ++p) {
      int64_t i = perm[p];
      uint64_t k = num_lanes ? (static_cast<uint64_t>(lanes[i]) << 32) : 0;
      if (num_lanes == 2) k |= lanes[n + i];
      buf[p] = {k, i};
    }
    std::sort(buf.begin(), buf.end());
    for (int64_t p = 0; p < count; ++p) perm[p] = buf[p].second;
    return;
  }
  std::sort(perm, perm + count, [&](int64_t a, int64_t c) {
    for (int64_t l = 0; l < num_lanes; ++l) {
      uint32_t x = lanes[l * n + a], y = lanes[l * n + c];
      if (x != y) return x < y;
    }
    return a < c;
  });
}

// ---- bucket-parallel sorted merge join ------------------------------------
// The host venue of the zero-exchange SMJ: both sides arrive as int32 key
// codes sorted within each bucket (the index file layout). On tunneled-TPU
// deployments device->host readback of the match pairs dominates the whole
// join; the pairs land on host either way, and the sorted runs are already
// host-resident, so an exact two-pass merge here beats the device round-trip
// whenever the link is slow (executor._join_venue decides by measured
// bandwidth).

// Pass 1: counts[b] = number of matches in bucket b.
void hs_mj_count(const int32_t* lk, const int64_t* lofs, const int32_t* rk,
                 const int64_t* rofs, int64_t nb, int64_t* counts) {
  parallel_for(nb, 1, [&](int64_t blo, int64_t bhi) {
    for (int64_t b = blo; b < bhi; ++b) {
      int64_t i = lofs[b], il = lofs[b + 1];
      int64_t j = rofs[b], jl = rofs[b + 1];
      int64_t c = 0;
      while (i < il && j < jl) {
        int32_t a = lk[i], v = rk[j];
        if (a < v) {
          ++i;
        } else if (a > v) {
          ++j;
        } else {
          int64_t i2 = i + 1;
          while (i2 < il && lk[i2] == a) ++i2;
          int64_t j2 = j + 1;
          while (j2 < jl && rk[j2] == a) ++j2;
          c += (i2 - i) * (j2 - j);
          i = i2;
          j = j2;
        }
      }
      counts[b] = c;
    }
  });
}

// Fused merge + accumulate (the host venue of Aggregate(Join)): instead
// of materializing match pairs, each equal-key run accumulates the
// secondary side's channel sums onto every primary row of the run, plus
// the per-primary-row match count. out is [a_r, n_l] row-major (indexed
// by SORTED primary position); counts is [n_l].
void hs_mj_accum(const int32_t* lk, const int64_t* lofs, const int32_t* rk,
                 const int64_t* rofs, int64_t nb, const double* rvals,
                 int64_t a_r, int64_t n_r, int64_t n_l, double* out,
                 double* counts) {
  parallel_for(nb, 1, [&](int64_t blo, int64_t bhi) {
    for (int64_t b = blo; b < bhi; ++b) {
      int64_t i = lofs[b], il = lofs[b + 1];
      int64_t j = rofs[b], jl = rofs[b + 1];
      while (i < il && j < jl) {
        int32_t a = lk[i], v = rk[j];
        if (a < v) {
          ++i;
        } else if (a > v) {
          ++j;
        } else {
          int64_t i2 = i + 1;
          while (i2 < il && lk[i2] == a) ++i2;
          int64_t j2 = j + 1;
          while (j2 < jl && rk[j2] == a) ++j2;
          double m = static_cast<double>(j2 - j);
          for (int64_t x = i; x < i2; ++x) counts[x] = m;
          for (int64_t c = 0; c < a_r; ++c) {
            double s = 0.0;
            const double* rv = rvals + c * n_r;
            for (int64_t y = j; y < j2; ++y) s += rv[y];
            double* ov = out + c * n_l;
            for (int64_t x = i; x < i2; ++x) ov[x] = s;
          }
          i = i2;
          j = j2;
        }
      }
    }
  });
}

// Pass 2: fill GLOBAL row indices; bucket b's matches occupy
// [oofs[b], oofs[b+1]) (oofs = prefix sum of pass-1 counts).
void hs_mj_fill(const int32_t* lk, const int64_t* lofs, const int32_t* rk,
                const int64_t* rofs, const int64_t* oofs, int64_t nb,
                int64_t* li, int64_t* ri) {
  parallel_for(nb, 1, [&](int64_t blo, int64_t bhi) {
    for (int64_t b = blo; b < bhi; ++b) {
      int64_t i = lofs[b], il = lofs[b + 1];
      int64_t j = rofs[b], jl = rofs[b + 1];
      int64_t o = oofs[b];
      while (i < il && j < jl) {
        int32_t a = lk[i], v = rk[j];
        if (a < v) {
          ++i;
        } else if (a > v) {
          ++j;
        } else {
          int64_t i2 = i + 1;
          while (i2 < il && lk[i2] == a) ++i2;
          int64_t j2 = j + 1;
          while (j2 < jl && rk[j2] == a) ++j2;
          for (int64_t x = i; x < i2; ++x)
            for (int64_t y = j; y < j2; ++y) {
              li[o] = x;
              ri[o] = y;
              ++o;
            }
          i = i2;
          j = j2;
        }
      }
    }
  });
}
}
