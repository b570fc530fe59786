// Flash-decode attention of Gq query rows per plane over KIVI-packed K/V,
// dequantized on the fly, for Hopper (sm_90a). Plain C interface, loaded
// with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel fused_decode_attention (body _decode_kernel) of
// src/repro/kernels/decode_attn/kernel.py:133. Per plane (batch x KV
// head): out = softmax(q k^T / sqrt(hd), tokens >= cur_len masked with
// -1e30) v, with K and V read in their packed layout (kivi_planes.cuh).
//
// What bounds it: bytes, and latency. A decode step does 4 Gq hd
// operations per token against about hd (bits/4 + 16/group) bytes, far
// below the card's f32 balance, so reading the packed plane sets the
// floor: at the main shape (P 8, Gq 4, T 4096, hd 128, groups of 64, 4
// bits) 5.27 MB, 1.6 us at 3.35 TB/s. At Gq 4 no tensor-core form pays:
// the work is the bytes and the chain of latencies in front of them.
//
// decode_ring<BITS, RPW>, one launch a call, for every layout that
// kivi_planes::layout_ok takes:
//  - grid (splits, row blocks, planes): a block takes RPW <= 8 rows (all Gq
//    rows at Gq <= 8; row blocks of 8 above) and one split of whole
//    64-token tiles, so that the grid is about one wave (kernel.py: 16
//    splits of 256 tokens at P 8);
//  - the packed bytes of each tile (K codes, V codes, the K groups the tile
//    touches, V's per-token scales and zeros) come through a ring of up to
//    3 stages, so tiles j + 1 and j + 2 are in flight while tile j is used.
//    A part of a stage is copied by 16-byte cp.async where its address and
//    length allow, else by 4-byte cp.async, else a byte at a time (a plane
//    that is not 16-byte aligned, T not a multiple of 16, a ragged last
//    tile); tiny groups, whose scales make a stage large, take 2 stages or
//    1 so that the block fits in shared memory;
//  - the block (8 warps, two on each scheduler) dequantizes a stage once
//    into f32 K and V tiles in shared memory, each value
//    __fmaf_rn(code, scale, zero) as the plain version computes it; then
//    each warp takes 8 tokens of the tile for all the block's rows (lane:
//    a token and a quarter of the channels), so every dequantized value
//    is read from shared memory once, and keeps its own online softmax
//    (m, l, acc) in registers;
//  - at the end of its split the block merges its eight warps' states in
//    shared memory and writes one (m, l, acc) a row to a workspace of
//    splits x rows x hd f32 a plane; the last block of a (plane, row block)
//    to arrive (an atomic ticket, __threadfence on both sides) merges the
//    splits in one pass, the splits' loads in flight together, writes the
//    output and resets its ticket for the next call. Both merges weight a
//    state by exp(m - M): a split whose tokens are all masked carries
//    m = -1e30 and l = its token count, so with cur_len = 0 every split
//    weighs 1 and the result is the uniform mean of all T values, as the
//    reference gives.
// The tickets are shared by the calls that use one buffer (kernel.py keeps
// one a device and stream), so those calls must run one after another.
#include "../../csrc/mma_sm90.cuh"
#include "kivi_planes.cuh"

namespace {

namespace ring {

constexpr int kThreadsR = 256;   // 8 warps
constexpr int kWarpsR = kThreadsR / 32;
constexpr int kTok = 64;         // tokens a tile
constexpr int kWarpTok = kTok / kWarpsR;   // 8 tokens a warp
constexpr int kMaxStages = 3;    // packed tiles in the ring, at most
constexpr int kMaxRows = 8;      // rows a block
constexpr int kMaxSmem = 232448 - 1024;   // a block's shared memory on an
                                          // H100, less the static part

// Byte offsets in the dynamic shared memory of a block:
//   stages x stage | K tile (kTok, hd + 4) f32 | V tile (kTok, hd) f32 |
//   q (rows, hd + 16) f32 | P (8 warps, rows, 8) f32,
// a stage = K codes (kTok / cpb, hd) | V codes (kTok, hd / cpb) | ks, kz
// (gr, hd) f32 | vs, vz (kTok, hd / vg) f32, where gr = 63 / kg + 2 bounds
// the K groups that 64 tokens touch. Every part is a multiple of 16 bytes.
// stages is the most, up to kMaxStages, that fit in kMaxSmem: 3 but for
// groups of a few tokens or channels; every layout that layout_ok takes
// fits with 1 (the most, hd 128 with groups of 1 at 8 bits, 221696 bytes
// at 8 rows). Once the tiles are done, the two merges reuse the memory
// from 0: the warps' states (8 x rows x (hd + 2) f32).
struct Layout {
  int kraw, vraw, ks, kz, vs, vz, stage, gr, stages;
  int k_f, v_f, q_f, p_f, total;
  __host__ __device__ Layout(int hd, int bits, int kg, int vg, int rows) {
    const int cpb = 8 / bits;
    gr = (kTok - 1) / kg + 2;
    kraw = 0;
    vraw = kTok / cpb * hd;
    ks = vraw + kTok * (hd / cpb);
    kz = ks + gr * hd * 4;
    vs = kz + gr * hd * 4;
    vz = vs + kTok * (hd / vg) * 4;
    stage = vz + kTok * (hd / vg) * 4;
    const int tiles = kTok * (hd + 4) * 4 + kTok * hd * 4 +
                      rows * (hd + 16) * 4 + kWarpsR * rows * kWarpTok * 4;
    stages = kMaxStages;
    while (stages > 1 && stages * stage + tiles > kMaxSmem) --stages;
    k_f = stages * stage;
    v_f = k_f + kTok * (hd + 4) * 4;
    q_f = v_f + kTok * hd * 4;
    p_f = q_f + rows * (hd + 16) * 4;
    total = p_f + kWarpsR * rows * kWarpTok * 4;
    const int merge = kWarpsR * rows * (hd + 2) * 4;
    total = total > merge ? total : merge;
  }
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// The block copies the first n_valid of n_cap bytes (n_cap a multiple of
// 16) at src to dst in shared memory, zeros past n_valid: 16-byte cp.async
// where src and n_valid are multiples of 16, else 4-byte cp.async where
// they are multiples of 4, else a byte at a time with plain loads and
// stores (done before the barrier in front of the tile's use).
__device__ __forceinline__ void copy_part(char* dst, const void* src,
                                          int n_valid, int n_cap) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | n_valid;
  const uint32_t d = sm90::smem_addr(dst);
  const char* s = static_cast<const char*>(src);
  if (a % 16 == 0) {
    sm90::copy_flat<kThreadsR>(d, src, n_valid, n_cap);
  } else if (a % 4 == 0) {
    for (int i = threadIdx.x * 4; i < n_cap; i += kThreadsR * 4) {
      const bool valid = i < n_valid;
      cp_async4(d + i, valid ? s + i : s, valid);
    }
  } else {
    for (int i = threadIdx.x; i < n_cap; i += kThreadsR)
      dst[i] = i < n_valid ? s[i] : 0;
  }
}

// Start the copies of tokens [t0, t0 + n) of a plane into the stage at st.
// Each part of a tile is contiguous in device memory: K's rows of cpb
// tokens, V's token rows, the K groups the tile touches, V's per-token
// scales.
template <int BITS>
__device__ __forceinline__ void load_stage(const kivi_planes::Plane& pl,
                                           const Layout& L, char* st,
                                           int t0, int n, int hd, int kg,
                                           int vg) {
  constexpr int CPB = 8 / BITS;
  const int vcols = hd / vg, g0 = t0 / kg;
  const int ng = (t0 + n - 1) / kg - g0 + 1;
  copy_part(st + L.kraw, pl.kp + static_cast<int64_t>(t0 / CPB) * hd,
            n / CPB * hd, kTok / CPB * hd);
  copy_part(st + L.vraw, pl.vp + static_cast<int64_t>(t0) * (hd / CPB),
            n * (hd / CPB), kTok * (hd / CPB));
  copy_part(st + L.ks, pl.ks + static_cast<int64_t>(g0) * hd, ng * hd * 4,
            L.gr * hd * 4);
  copy_part(st + L.kz, pl.kz + static_cast<int64_t>(g0) * hd, ng * hd * 4,
            L.gr * hd * 4);
  copy_part(st + L.vs, pl.vs + static_cast<int64_t>(t0) * vcols,
            n * vcols * 4, kTok * vcols * 4);
  copy_part(st + L.vz, pl.vz + static_cast<int64_t>(t0) * vcols,
            n * vcols * 4, kTok * vcols * 4);
}

__device__ __forceinline__ int log2i(int x) { return __ffs(x) - 1; }

// Dequantize a stage into the f32 K tile (rows padded by 4 floats) and V
// tile. hd, hd / 4 and vg are powers of two, and hd / 4 divides the
// block's threads, so a thread keeps its channels. K: a thread takes a
// 4-byte word of a packed row, 4 channels of cpb tokens in one group, with
// the group's scales as float4, read once a tile where the tile lies in
// one group (kg a multiple of 64). V: a thread takes a unit of 4 channels
// of a token, 4 / cpb packed bytes, with one scale and zero where vg >= 4,
// and stores it as one float4, so a warp's stores are contiguous.
template <int BITS>
__device__ __forceinline__ void dequant(const char* st, const Layout& L,
                                        int t0, int hd, int kg, int vg,
                                        float* k_f, float* v_f) {
  using kivi_planes::code_at;
  constexpr int CPB = 8 / BITS;
  const int n4 = hd / 4, n4_sh = log2i(n4), g0 = t0 / kg;
  const int c = 4 * (threadIdx.x & (n4 - 1));   // the thread's channels
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(st + L.kraw);
  const float* ksf = reinterpret_cast<const float*>(st + L.ks);
  const float* kzf = reinterpret_cast<const float*>(st + L.kz);
  const bool one_group = kg % kTok == 0;
  float4 s = *reinterpret_cast<const float4*>(ksf + c);
  float4 z = *reinterpret_cast<const float4*>(kzf + c);
  for (int i = threadIdx.x; i < kTok / CPB * n4; i += kThreadsR) {
    const int r = i >> n4_sh;
    const uint32_t x = kw[i];
    if (!one_group) {
      const int gi = ((t0 + r * CPB) / kg - g0) * hd + c;
      s = *reinterpret_cast<const float4*>(ksf + gi);
      z = *reinterpret_cast<const float4*>(kzf + gi);
    }
#pragma unroll
    for (int j = 0; j < CPB; ++j) {
      const int b = j * BITS;
      *reinterpret_cast<float4*>(k_f + (r * CPB + j) * (hd + 4) + c) =
          make_float4(__fmaf_rn(code_at<BITS>(x, b), s.x, z.x),
                      __fmaf_rn(code_at<BITS>(x, 8 + b), s.y, z.y),
                      __fmaf_rn(code_at<BITS>(x, 16 + b), s.z, z.z),
                      __fmaf_rn(code_at<BITS>(x, 24 + b), s.w, z.w));
    }
  }
  const int vcols = hd / vg, vg_sh = log2i(vg);
  const uint8_t* vraw = reinterpret_cast<const uint8_t*>(st + L.vraw);
  const float* vsf = reinterpret_cast<const float*>(st + L.vs);
  const float* vzf = reinterpret_cast<const float*>(st + L.vz);
  for (int u = threadIdx.x; u < kTok * n4; u += kThreadsR) {
    const int t = u >> n4_sh;
    const uint8_t* src = vraw + (t * hd + c) / CPB;
    uint32_t x;
    if constexpr (CPB == 1) {
      x = *reinterpret_cast<const uint32_t*>(src);
    } else if constexpr (CPB == 2) {
      x = *reinterpret_cast<const uint16_t*>(src);
    } else {
      x = *src;
    }
    float v[4];
    if (vg >= 4) {
      const int g = t * vcols + (c >> vg_sh);
      const float vsc = vsf[g], vze = vzf[g];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __fmaf_rn(code_at<BITS>(x, e * BITS), vsc, vze);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = t * vcols + ((c + e) >> vg_sh);
        v[e] = __fmaf_rn(code_at<BITS>(x, e * BITS), vsf[g], vzf[g]);
      }
    }
    *reinterpret_cast<float4*>(v_f + t * hd + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Max and sum over the 8 lanes of a quarter-warp.
__device__ __forceinline__ float max8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y),
                     fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
}

// q (P, rows, hd); packed planes as in kivi_planes.cuh; cur_len (P,);
// workspace m_ws, l_ws (P, splits, rows) and acc_ws (P, splits, rows, hd);
// tickets (P, row blocks), zero before the first call and left zero by
// every call; out (P, rows, hd).
template <int BITS, int RPW>
__global__ void __launch_bounds__(kThreadsR)
    decode_ring(const float* __restrict__ q, const uint8_t* __restrict__ kp,
                const float* __restrict__ ks, const float* __restrict__ kz,
                const uint8_t* __restrict__ vp, const float* __restrict__ vs,
                const float* __restrict__ vz,
                const int* __restrict__ cur_len, float* __restrict__ m_ws,
                float* __restrict__ l_ws, float* __restrict__ acc_ws,
                unsigned* __restrict__ tickets, float* __restrict__ out,
                int rows, int T, int hd, int kg, int vg, int split_len,
                float scale) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  __shared__ int last;
  const int n_splits = gridDim.x;
  const Layout L(hd, BITS, kg, vg, RPW);
  const int split = blockIdx.x, r0 = blockIdx.y * RPW, p = blockIdx.z;
  const kivi_planes::Plane pl = kivi_planes::plane_at<BITS>(
      kp, ks, kz, vp, vs, vz, p, T, hd, kg, vg);
  const int t_begin = split * split_len;
  const int t_end = min(T, t_begin + split_len);
  const int n_tiles = (t_end - t_begin + kTok - 1) / kTok;
  const int resident = cur_len[p];
  const int S = L.stages;
  auto load = [&](int j) {
    if (j < n_tiles) {
      const int t0 = t_begin + j * kTok;
      load_stage<BITS>(pl, L, smem + (j % S) * L.stage, t0,
                       min(kTok, t_end - t0), hd, kg, vg);
    }
    sm90::cp_async_commit();   // an empty group keeps the count in step
  };
  for (int j = 0; j < S - 1; ++j) load(j);

  float* k_f = reinterpret_cast<float*>(smem + L.k_f);
  float* v_f = reinterpret_cast<float*>(smem + L.v_f);
  float* q_f = reinterpret_cast<float*>(smem + L.q_f);
  // the block's rows of q (zeros past rows), row stride hd + 16; quarter
  // k of the channels 4 k floats further on, so that the quarter-warps'
  // reads of one row fall in different banks
  const int ld_q = hd + 16, n4 = hd / 4, q4 = (n4 + 3) / 4;
  for (int i = threadIdx.x; i < RPW * hd; i += kThreadsR) {
    const int r = i / hd, c = i % hd;
    q_f[r * ld_q + c + 4 * (c / 4 / q4)] =
        r0 + r < rows ? q[(static_cast<int64_t>(p) * rows + r0 + r) * hd + c]
                      : 0.0f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tl = lane & 7, qd = lane >> 3;
  const int tok = warp * kWarpTok + tl;   // the lane's token in a tile
  // the lane's channels in the scores: float4 columns [c4_0, c4_1)
  const int c4_0 = min(n4, qd * q4), c4_1 = min(n4, (qd + 1) * q4);
  const float* q_h = q_f + 4 * qd;
  float* p_w = reinterpret_cast<float*>(smem + L.p_f) +
               warp * RPW * kWarpTok;
  float m[RPW], l[RPW];
  float4 acc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = flash::kNegInf;
    l[r] = 0.0f;
    acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int j = 0; j < n_tiles; ++j) {
    // tile j is in and every warp is done with tile j - 1's stage (with
    // one stage, tile j is loaded here, after tile j - 1's dequantize)
    if (S == 1) load(j);
    if (S == kMaxStages) {
      sm90::cp_async_wait<kMaxStages - 2>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    if (S > 1) load(j + S - 1);   // into the stage tile j - 1 used
    const int t0 = t_begin + j * kTok;
    dequant<BITS>(smem + (j % S) * L.stage, L, t0, hd, kg, vg, k_f, v_f);
    __syncthreads();

    // scores of the lane's token: a quarter of the channels, then the
    // quarters summed
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.0f;
    const float* krow = k_f + tok * (hd + 4);
#pragma unroll 4
    for (int c4 = c4_0; c4 < c4_1; ++c4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + 4 * c4);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(q_h + r * ld_q + 4 * c4);
        s[r] = fmaf(q4.x, k4.x, s[r]);
        s[r] = fmaf(q4.y, k4.y, s[r]);
        s[r] = fmaf(q4.z, k4.z, s[r]);
        s[r] = fmaf(q4.w, k4.w, s[r]);
      }
    }
    // online softmax over the warp's 8 tokens: a token past the split
    // scores -inf and weighs exactly 0, one at or past cur_len -1e30
    const int t_abs = t0 + tok;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 8);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 16);
      const float x = t_abs >= t_end
                          ? -INFINITY
                          : (t_abs < resident ? s[r] * scale
                                              : flash::kNegInf);
      const float m_new = fmaxf(m[r], max8(x));
      const float pr = expf(x - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum8(pr);
      m[r] = m_new;
      acc[r] = make_float4(acc[r].x * alpha, acc[r].y * alpha,
                           acc[r].z * alpha, acc[r].w * alpha);
      if (qd == 0) p_w[r * kWarpTok + tl] = pr;
    }
    __syncwarp();
    // P V: the lane's 4 channels over the warp's 8 tokens
    if (4 * lane < hd) {
      const float* vcol = v_f + warp * kWarpTok * hd + 4 * lane;
#pragma unroll
      for (int t = 0; t < kWarpTok; t += 4) {
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = *reinterpret_cast<const float4*>(vcol + (t + i) * hd);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(p_w + r * kWarpTok + t);
          acc[r] = fma4(p4.x, v[0], acc[r]);
          acc[r] = fma4(p4.y, v[1], acc[r]);
          acc[r] = fma4(p4.z, v[2], acc[r]);
          acc[r] = fma4(p4.w, v[3], acc[r]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();   // the tiles are done: the merges reuse the memory

  // the eight warps' states of each row, merged into the block's
  float* a_s = reinterpret_cast<float*>(smem);   // (warps, RPW, hd)
  float* m_s = a_s + kWarpsR * RPW * hd;         // (warps, RPW)
  float* l_s = m_s + kWarpsR * RPW;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (4 * lane < hd)
      *reinterpret_cast<float4*>(a_s + (warp * RPW + r) * hd + 4 * lane) =
          acc[r];
    if (lane == 0) {
      m_s[warp * RPW + r] = m[r];
      l_s[warp * RPW + r] = l[r];
    }
  }
  __syncthreads();
  const int64_t ws_row = static_cast<int64_t>(p) * n_splits * rows;
  for (int i = threadIdx.x; i < RPW * n4; i += kThreadsR) {
    const int r = i / n4, c4 = i % n4;
    if (r0 + r >= rows) continue;
    float mm = m_s[r];
#pragma unroll
    for (int w = 1; w < kWarpsR; ++w) mm = fmaxf(mm, m_s[w * RPW + r]);
    float ll = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kWarpsR; ++w) {
      const float wt = expf(m_s[w * RPW + r] - mm);
      ll = fmaf(l_s[w * RPW + r], wt, ll);
      a = fma4(wt, *reinterpret_cast<const float4*>(
                       a_s + (w * RPW + r) * hd + 4 * c4), a);
    }
    const int64_t row = ws_row + static_cast<int64_t>(split) * rows + r0 + r;
    *reinterpret_cast<float4*>(acc_ws + row * hd + 4 * c4) = a;
    if (c4 == 0) {
      m_ws[row] = mm;
      l_ws[row] = ll;
    }
  }
  // every thread's writes reach the device before the ticket is taken
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + p * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_splits - 1);
  __syncthreads();
  if (!last) return;

  // the last block of this (plane, row block): every split's state is
  // written; merge them in one pass, each thread a row's 4 channels, the
  // splits' loads in flight together (through L2, never a stale L1 line)
  __threadfence();
  for (int i = threadIdx.x; i < RPW * n4; i += kThreadsR) {
    const int r = i / n4, c4 = i % n4;
    if (r0 + r >= rows) continue;
    float mm = flash::kNegInf, ll = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 16
    for (int sp = 0; sp < n_splits; ++sp) {
      const int64_t row = ws_row + static_cast<int64_t>(sp) * rows + r0 + r;
      const float ms = __ldcg(m_ws + row), ls = __ldcg(l_ws + row);
      const float4 as =
          __ldcg(reinterpret_cast<const float4*>(acc_ws + row * hd) + c4);
      const float m_new = fmaxf(mm, ms);
      const float w_old = expf(mm - m_new), w_new = expf(ms - m_new);
      ll = fmaf(ls, w_new, ll * w_old);
      a = fma4(w_new, as, make_float4(a.x * w_old, a.y * w_old,
                                      a.z * w_old, a.w * w_old));
      mm = m_new;
    }
    const float inv = 1.0f / fmaxf(ll, 1e-30f);
    *reinterpret_cast<float4*>(
        out + (static_cast<int64_t>(p) * rows + r0 + r) * hd + 4 * c4) =
        make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
  if (threadIdx.x == 0) *ticket = 0u;   // ready for the next call
}

template <int BITS, int RPW>
cudaError_t launch(const float* q, const uint8_t* kp, const float* ks,
                   const float* kz, const uint8_t* vp, const float* vs,
                   const float* vz, const int* cur_len, float* m_ws,
                   float* l_ws, float* acc_ws, unsigned* tickets, float* out,
                   int P, int rows, int T, int hd, int kg, int vg,
                   int split_len, float scale, cudaStream_t stream) {
  auto kernel = decode_ring<BITS, RPW>;
  // the most any layout takes, raised once (a function-local static)
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (smem_err != cudaSuccess) return smem_err;
  const Layout L(hd, BITS, kg, vg, RPW);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const int splits = (T + split_len - 1) / split_len;
  const dim3 grid(splits, (rows + RPW - 1) / RPW, P);
  kernel<<<grid, kThreadsR, L.total, stream>>>(
      q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws, acc_ws, tickets, out,
      rows, T, hd, kg, vg, split_len, scale);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const float* q, const uint8_t* kp, const float* ks,
                        const float* kz, const uint8_t* vp, const float* vs,
                        const float* vz, const int* cur_len, float* m_ws,
                        float* l_ws, float* acc_ws, unsigned* tickets,
                        float* out, int P, int rows, int rpb, int T, int hd,
                        int kg, int vg, int split_len, float scale,
                        cudaStream_t stream) {
  switch (rpb) {
    case 1:
      return launch<BITS, 1>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws,
                             acc_ws, tickets, out, P, rows, T, hd, kg, vg,
                             split_len, scale, stream);
    case 2:
      return launch<BITS, 2>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws,
                             acc_ws, tickets, out, P, rows, T, hd, kg, vg,
                             split_len, scale, stream);
    case 4:
      return launch<BITS, 4>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws, l_ws,
                             acc_ws, tickets, out, P, rows, T, hd, kg, vg,
                             split_len, scale, stream);
    default:
      return launch<BITS, kMaxRows>(q, kp, ks, kz, vp, vs, vz, cur_len, m_ws,
                                    l_ws, acc_ws, tickets, out, P, rows, T,
                                    hd, kg, vg, split_len, scale, stream);
  }
}

}  // namespace ring

}  // namespace

// q (P, rows, hd) f32; packed K/V planes as in kivi_planes.cuh, any
// alignment; cur_len (P,) i32; rows_per_block 1, 2, 4 or 8 rows a block;
// split_len a multiple of 64; workspace m_ws/l_ws (P, n_splits, rows) and
// acc_ws (P, n_splits, rows, hd) f32 with n_splits = ceil(T / split_len),
// acc_ws and out 16-byte aligned; tickets (P, row blocks) u32, zero,
// as every call leaves them; out (P, rows, hd) f32. One launch of
// decode_ring on ``stream``; returns cudaGetLastError()
// (cudaErrorInvalidValue, without launching, for what it does not take).
extern "C" int decode_attn(const void* q, const void* kp, const void* ks,
                           const void* kz, const void* vp, const void* vs,
                           const void* vz, const void* cur_len, void* m_ws,
                           void* l_ws, void* acc_ws, void* tickets, void* out,
                           int P, int rows, int rows_per_block, int T, int hd,
                           int bits, int k_group, int v_group, int split_len,
                           float scale, void* stream) {
  const int rpb = rows_per_block;
  if (!kivi_planes::layout_ok(T, hd, bits, k_group, v_group) || P <= 0 ||
      rows <= 0 || (rpb != 1 && rpb != 2 && rpb != 4 && rpb != 8) ||
      split_len <= 0 || split_len % ring::kTok != 0 || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kpb = static_cast<const uint8_t*>(kp);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* kzf = static_cast<const float*>(kz);
  const auto* vpb = static_cast<const uint8_t*>(vp);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* vzf = static_cast<const float*>(vz);
  const auto* cl = static_cast<const int*>(cur_len);
  auto* m = static_cast<float*>(m_ws);
  auto* l = static_cast<float*>(l_ws);
  auto* a = static_cast<float*>(acc_ws);
  auto* tk = static_cast<unsigned*>(tickets);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = ring::launch_bits<2>(qf, kpb, ksf, kzf, vpb, vsf, vzf, cl, m, l,
                                 a, tk, o, P, rows, rpb, T, hd, k_group,
                                 v_group, split_len, scale, st);
      break;
    case 4:
      err = ring::launch_bits<4>(qf, kpb, ksf, kzf, vpb, vsf, vzf, cl, m, l,
                                 a, tk, o, P, rows, rpb, T, hd, k_group,
                                 v_group, split_len, scale, st);
      break;
    default:
      err = ring::launch_bits<8>(qf, kpb, ksf, kzf, vpb, vsf, vzf, cl, m, l,
                                 a, tk, o, P, rows, rpb, T, hd, k_group,
                                 v_group, split_len, scale, st);
      break;
  }
  return static_cast<int>(err);
}
