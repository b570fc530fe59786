// The online-softmax step that the port's three attention kernels share
// (decode_attn, fused_prefill, prefill_attn), and the pass that merges
// the partial results of a key range split across blocks. Header only;
// each kernel's .cu includes it.
//
// Work split inside a block (kThreads = 128, four warps): the block owns
// RB = 4 * RPW query rows; warp w owns rows w, w + 4, ..., so the running
// max m, sum l and accumulator of a row live in one warp's registers and
// the softmax needs only warp shuffles. Keys come in tiles of kTile = 32
// tokens, staged in shared memory as f32:
//   scores: lane t computes the RPW dot products of key t with the warp's
//           rows (float4 reads; the K tile's rows are padded by 4 floats
//           so a quarter-warp's 16-byte reads hit distinct banks);
//   P @ V:  lane owns channels 4*lane .. 4*lane+3 of every row of its warp
//           (so hd <= 128 and hd % 4 == 0).
// Staging loops give each thread one fixed channel (hd divides the 128
// threads), so the channel's offsets are computed once, not per element,
// and keep several loads in flight per thread (``staged``).
// All arithmetic is f32 FFMA on the CUDA cores; exp is expf (no fast
// math). The mask value is the reference's finite kNegInf = -1e30, so a
// row whose keys are all masked averages them uniformly, as the
// reference does; a key that does not exist (past the end of a ragged
// tile) scores -inf and weighs exactly 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;
constexpr int kMaxHd = 128;

// Shared memory of a block with RB rows and head dim hd, in floats:
// q_s (RB, hd) | k_s (kTile, hd + 4) | v_s (kTile, hd) | p_s (RB, kTile).
__host__ __device__ constexpr int smem_floats(int rb, int hd) {
  return rb * hd + kTile * (hd + 4) + kTile * hd + rb * kTile;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Running state of the RPW rows of one warp (every lane holds the same
// m and l; acc holds the lane's four channels).
template <int RPW>
struct Rows {
  float m[RPW], l[RPW];
  float4 acc[RPW];

  __device__ void init() {
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      m[j] = kNegInf;
      l[j] = 0.0f;
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// Row index, within the block, of the warp's j-th row.
__device__ __forceinline__ int row_of(int j) {
  return (threadIdx.x >> 5) + kWarps * j;
}

// Fold one staged tile of keys into the running state. ``mask(r, t, s)``
// gets the block row r, the tile column t and the scaled score s, and
// returns s, kNegInf (masked) or -INFINITY (no such key).
template <int RPW, class Mask>
__device__ __forceinline__ void tile_step(Rows<RPW>& st, const float* q_s,
                                          const float* k_s,
                                          const float* v_s, float* p_s,
                                          int hd, float scale, Mask mask) {
  const int lane = threadIdx.x & 31;
  float s[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) s[j] = 0.0f;
  const float* krow = k_s + lane * (hd + 4);
  for (int c = 0; c < hd; c += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(q_s + row_of(j) * hd + c);
      s[j] = fmaf(q4.x, k4.x, s[j]);
      s[j] = fmaf(q4.y, k4.y, s[j]);
      s[j] = fmaf(q4.z, k4.z, s[j]);
      s[j] = fmaf(q4.w, k4.w, s[j]);
    }
  }
  float* p_warp = p_s + (threadIdx.x >> 5) * RPW * kTile;
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const float x = mask(row_of(j), lane, s[j] * scale);
    const float m_new = fmaxf(st.m[j], warp_max(x));
    const float p = expf(x - m_new);
    const float alpha = expf(st.m[j] - m_new);
    st.l[j] = st.l[j] * alpha + warp_sum(p);
    st.m[j] = m_new;
    st.acc[j].x *= alpha;
    st.acc[j].y *= alpha;
    st.acc[j].z *= alpha;
    st.acc[j].w *= alpha;
    p_warp[j * kTile + lane] = p;
  }
  __syncwarp();
  if (4 * lane < hd) {
    for (int t = 0; t < kTile; t += 4) {
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = *reinterpret_cast<const float4*>(v_s + (t + i) * hd +
                                                4 * lane);
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_warp + j * kTile + t);
        const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st.acc[j].x = fmaf(pp[i], v[i].x, st.acc[j].x);
          st.acc[j].y = fmaf(pp[i], v[i].y, st.acc[j].y);
          st.acc[j].z = fmaf(pp[i], v[i].z, st.acc[j].z);
          st.acc[j].w = fmaf(pp[i], v[i].w, st.acc[j].w);
        }
      }
    }
  }
  __syncwarp();
}

// The head dims the kernels take: hd divides the block's threads, so a
// thread keeps one channel through every staging loop.
__host__ __device__ constexpr bool hd_ok(int hd) {
  return hd >= 4 && hd <= kMaxHd && hd % 4 == 0 && kThreads % hd == 0;
}

// Stage ``count`` rows of the thread's channel into shared memory: rows
// first, first + step, ..., U at a time. All U rows are loaded before any
// is stored, so U global loads are in flight per thread; a plain loop
// would wait out each load's latency in turn. ``load(i)`` returns row i's
// raw values (zeros for a row past the data) and ``store(i, raw)``
// converts and writes them.
template <int U, class Load, class Store>
__device__ __forceinline__ void staged(int first, int step, int count,
                                       Load load, Store store) {
  for (int i0 = first; i0 < count; i0 += U * step) {
    decltype(load(0)) raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = load(i0 + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * step < count) store(i0 + u * step, raw[u]);
  }
}

// Stage rows [r0, r0 + rb) of a (rows, hd) matrix whose row r starts at
// src + r * stride into q_s as f32; rows past ``rows`` are zero.
template <typename In>
__device__ __forceinline__ void load_rows(const In* src, int64_t stride,
                                          int r0, int rb, int rows, int hd,
                                          float* dst) {
  const int c = threadIdx.x % hd;
  staged<8>(threadIdx.x / hd, kThreads / hd, rb,
            [&](int r) {
              return r0 + r < rows
                         ? static_cast<float>(src[(r0 + r) * stride + c])
                         : 0.0f;
            },
            [&](int r, float x) { dst[r * hd + c] = x; });
}

// Stage tokens [t0, t0 + n) of dense (tokens, hd) K and V whose token t
// starts at k + t * stride (and v + t * stride) into the K and V tiles as
// f32; tile rows past n are zero.
template <typename In>
__device__ __forceinline__ void load_dense_tile(const In* k, const In* v,
                                                int64_t stride, int t0,
                                                int n, int hd, float* k_s,
                                                float* v_s) {
  const int c = threadIdx.x % hd;
  staged<8>(threadIdx.x / hd, kThreads / hd, kTile,
            [&](int t) {
              const int64_t g = static_cast<int64_t>(t0 + t) * stride + c;
              return t < n ? make_float2(static_cast<float>(k[g]),
                                         static_cast<float>(v[g]))
                           : make_float2(0.0f, 0.0f);
            },
            [&](int t, float2 kv) {
              k_s[t * (hd + 4) + c] = kv.x;
              v_s[t * hd + c] = kv.y;
            });
}

// The partial state of the warp's rows for one key split, unnormalised:
// m_ws, l_ws (P, n_splits, R) and acc_ws (P, n_splits, R, hd).
template <int RPW>
__device__ __forceinline__ void store_partial(const Rows<RPW>& st, int r0,
                                              int rows, int hd,
                                              int64_t base, float* m_ws,
                                              float* l_ws, float* acc_ws) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = r0 + row_of(j);
    if (r >= rows) continue;
    if (lane == 0) {
      m_ws[base + r] = st.m[j];
      l_ws[base + r] = st.l[j];
    }
    if (4 * lane < hd)
      *reinterpret_cast<float4*>(acc_ws + (base + r) * hd + 4 * lane) =
          st.acc[j];
  }
}

// The finished rows: acc / max(l, 1e-30), as the reference finalizes.
// Row r of the block goes to out + (r0 + r) * stride.
template <int RPW>
__device__ __forceinline__ void store_rows(const Rows<RPW>& st, int r0,
                                           int rows, int hd, float* out,
                                           int64_t stride) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = r0 + row_of(j);
    if (r >= rows || 4 * lane >= hd) continue;
    const float inv = 1.0f / fmaxf(st.l[j], 1e-30f);
    const float4 a = st.acc[j];
    *reinterpret_cast<float4*>(out + r * stride + 4 * lane) =
        make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

// Second pass of a split key range: one block per (row, plane), one
// thread per channel. Each split's state is weighted by exp(m_s - M), so
// a split whose keys were all masked (m_s = -1e30) counts only where
// every split was, which gives the uniform mean of the reference. The
// loops over the splits are unrolled so that several splits' loads are
// in flight at once; a thread walks up to a hundred splits.
__global__ void merge_splits(const float* __restrict__ m_ws,
                             const float* __restrict__ l_ws,
                             const float* __restrict__ acc_ws,
                             float* __restrict__ out, int n_splits, int rows,
                             int hd) {
  const int r = blockIdx.x, p = blockIdx.y, c = threadIdx.x;
  if (c >= hd) return;
  const int64_t base = static_cast<int64_t>(p) * n_splits * rows + r;
  float m_all = m_ws[base];
#pragma unroll 8
  for (int s = 1; s < n_splits; ++s)
    m_all = fmaxf(m_all, m_ws[base + s * rows]);
  float l_all = 0.0f, a = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const int64_t i = base + static_cast<int64_t>(s) * rows;
    const float w = expf(m_ws[i] - m_all);
    l_all = fmaf(l_ws[i], w, l_all);
    a = fmaf(acc_ws[i * hd + c], w, a);
  }
  out[(static_cast<int64_t>(p) * rows + r) * hd + c] =
      a / fmaxf(l_all, 1e-30f);
}

inline int rows_per_warp(int rows) {
  return rows <= kWarps ? 1 : rows <= 2 * kWarps ? 2 : 8;
}

// Raise a kernel's dynamic shared memory cap to what kMaxHd needs. Each
// launcher calls it once, from a function-local static, so no launch
// (nor a CUDA graph capturing one) makes this call again.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int rb) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(rb, kMaxHd) * static_cast<int>(sizeof(float)));
}

}  // namespace flash
