// Causal flash attention for prefill, GQA, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel flash_attention (body _flash_kernel) of
// src/repro/kernels/prefill_attn/kernel.py:73 together with the GQA
// wrapper ops.causal_attention (src/repro/kernels/prefill_attn/ops.py),
// which repeats each KV head over its query heads in memory first. Here
// the kernels read the model layout directly: q (B, S, H, hd), k and v
// (B, S, Kv, hd), f32 or bf16; out (B, S, H, hd) f32. Query head h reads
// KV head h / (H / Kv), so no repeated copy exists. Scores are scaled by
// hd^-0.5, masked with the reference's finite -1e30 above the diagonal
// and -inf past S; out = acc / max(l, 1e-30).
//
// What bounds them: operations. Causal attention does 4 hd S(S+1)/2
// operations per (batch, head) against 3 S hd input values: at B = 1,
// S = 4096, H = 32, hd = 128 that is 1.375e11 operations, thousands a
// byte. The entry picks a kernel by type, shape and alignment:
//
// flash_fwd (hd not a multiple of 16, or a pointer not 16-byte aligned,
// in either type): f32 FFMA on the CUDA cores (no TF32, so the reference's
// tolerance holds), floor 67 TFLOP/s, about 2 ms at the shape above. One
// block per (32 query rows, head, batch), heaviest row blocks first; key
// tiles of 32 up to the block's last row only, staged in shared memory as
// f32 and shared by all 32 rows (flash_tile.cuh); the diagonal tile is
// masked.
//
// flash_fwd_mma<HD> (bf16 inputs, hd 16, 32, 64 or 128, 16-byte aligned):
// the bf16 tensor cores through mma.sync m16n8k16 with f32 accumulators.
// Bound: 1.375e11 operations at 989 TFLOP/s dense bf16 is 0.139 ms; the
// two-part P below does 1.5 times the MMA work, 0.208 ms. The design:
//  - one block of 4 warps per (64 query rows, head, batch), heaviest
//    first; each warp owns 16 rows, the MMA's m16. Q is copied once into
//    shared memory and each warp keeps its A fragments in registers
//    (ldmatrix.x4) for the whole key loop;
//  - K and V come in tiles of 64 keys through a ring of kStages shared
//    buffers filled by 16-byte cp.async.cg, so tile j + 1 is in flight
//    while tile j is computed; rows past S are zero-filled (src-size 0).
//    Shared rows are padded by 8 bf16, so the 8 row addresses of every
//    ldmatrix fall in distinct bank groups;
//  - S = Q K^T by MMA with K's B fragments from ldmatrix; the scale, the
//    mask (only on tiles that reach past a warp's first row) and the
//    online softmax stay in registers: a row lives in the 4 lanes of a
//    quad, so its max takes two shuffles. The scores are kept in base 2
//    (scaled by hd^-0.5 log2 e), so each exponential is one exp2f (2 ulp):
//    against the plain version it errs as little as expf (max abs 5.6e-6
//    against 5.5e-6 at the shape above) in 6 % less time on an H100;
//  - P V with a two-part P: p = hi + lo, hi = bf16(p), lo = bf16(p - hi),
//    both multiplied by V (B fragments from ldmatrix.trans) into one f32
//    accumulator. The pair keeps 16 significant bits of p; a single bf16
//    P errs by about 2e-3 and misses rtol 1e-4 / atol 2e-4 at every size
//    (tests/test_torch_prefill_attn.py emulates both). The scores'
//    accumulator layout is the next MMA's A layout, so P never touches
//    shared memory; l sums the f32 p;
//  - the finish divides by max(l, 1e-30) and, after one shuffle between
//    neighbouring lanes, stores 4 f32 of a row per lane (16 bytes).
//
// flash_fwd_mma_f32<HD> (f32 inputs, hd 16, 32, 64 or 128, 16-byte
// aligned): flash_fwd_mma's warps, softmax and finish on f32 inputs (the
// two kernels share softmax_tile, p_parts and store_out and differ only in
// how they stage and multiply Q, K and V), every product on the bf16
// tensor cores in parts. The scores take Q (scaled by
// hd^-0.5 log2 e) and K in three parts each (hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid): all 24 bits) and six products, hi hi +
// hi mid + mid hi + hi lo + mid mid + lo hi, which leave out less than
// 2^-24 of each product. P V takes P and V in two parts (hi + lo) and
// three products, hi hi + lo hi + hi lo, as fused_prefill's fused_mma
// does. Two parts and three products for the scores as well miss rtol
// 1e-4 / atol 2e-4: a peaked softmax (q scaled by 8) turns their 2^-16
// error in a score into 2.8e-4 of the output at (1, 1000, 32, 8, 64) on
// an H100 (PERF.md); the CPU emulation in tests/test_torch_prefill_attn.py
// shows two-part scores spending the tolerance that three-part ones keep.
// Bound: nine products at 989 TFLOP/s where the scores and P V each take
// half, 1.5 x 3 = 4.5 times the products' 0.139 ms: 0.625 ms at the shape
// above. The design:
//  - Q is read once from device memory straight into its A fragments and
//    split: hi and mid stay in registers (HD / 2 of each a lane) for the
//    whole key loop, lo goes to shared memory, 16 bytes a lane and 16
//    columns, read back by the lane that wrote it;
//  - K and V come as f32 tiles of kKeysF keys into one shared stage by
//    16-byte cp.async.cg (zeros past S); the block splits each tile once
//    into five bf16 tiles (K hi, mid, lo; V hi, lo; rows padded by 8
//    bf16) that all its warps read with ldmatrix, and the next tile's copy
//    is in flight while this one is multiplied. The stage, the parts and
//    Q's lo take 90.5 KB at hd 128, so two blocks share an SM.
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../csrc/flash_tile.cuh"
#include "../../csrc/mma_sm90.cuh"

namespace {

using flash::kThreads;
using flash::kTile;
using flash::kWarps;

constexpr int kRpw = 8;
constexpr int kRb = kWarps * kRpw;

template <typename In>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const In* __restrict__ q, const In* __restrict__ k,
              const In* __restrict__ v, float* __restrict__ out, int S,
              int H, int Kv, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kRb * hd;
  float* v_s = k_s + kTile * (hd + 4);
  float* p_s = v_s + kTile * hd;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRb;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / Kv);
  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * hd;
  const int64_t q_base = static_cast<int64_t>(b) * S * q_stride +
                         static_cast<int64_t>(h) * hd;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_stride +
                          static_cast<int64_t>(kvh) * hd;
  flash::load_rows(q + q_base, q_stride, r0, kRb, S, hd, q_s);
  flash::Rows<kRpw> st;
  st.init();
  const int t_end = min(S, r0 + kRb);
  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    const int n = min(kTile, S - t0);
    __syncthreads();
    flash::load_dense_tile(k + kv_base, v + kv_base, kv_stride, t0, n, hd,
                           k_s, v_s);
    __syncthreads();
    flash::tile_step<kRpw>(st, q_s, k_s, v_s, p_s, hd, scale,
                           [=](int r, int t, float s) {
                             return t >= n ? -INFINITY
                                           : (t0 + t <= r0 + r
                                                  ? s : flash::kNegInf);
                           });
  }
  flash::store_rows<kRpw>(st, r0, S, hd, out + q_base, q_stride);
}

template <typename In>
cudaError_t launch(const void* q, const void* k, const void* v, float* out,
                   int B, int S, int H, int Kv, int hd, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd<In>;
  static const cudaError_t smem_err = flash::allow_smem(kernel, kRb);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((S + kRb - 1) / kRb, H, B);
  const size_t smem = flash::smem_floats(kRb, hd) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), out, S, H, Kv, hd, scale);
  return cudaGetLastError();
}

namespace mma {

using namespace ::sm90;   // the shared helpers of mma_sm90.cuh
using bf16 = __nv_bfloat16;

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kRows = 16 * kWarpsMma;   // query rows a block, 16 a warp
constexpr int kKeys = 64;               // keys a K/V tile
constexpr int kStages = 2;              // K/V tiles in the ring
constexpr int kPad = 8;                 // bf16 of padding a shared row

// Shared memory of a block: Q (kRows rows) | kStages x (K tile, V tile),
// every row HD + kPad bf16.
template <int HD>
constexpr int smem_bytes() {
  return (kRows + 2 * kStages * kKeys) * (HD + kPad) *
         static_cast<int>(sizeof(bf16));
}

// Copy rows [t0, t0 + ROWS) of a (S, HD) matrix of T whose row t starts at
// src + t * stride into shared rows of LD elements at byte address dst,
// zeros past S. Each thread keeps one 16-byte column.
template <typename T, int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t stride, int t0, int S,
                                          uint32_t dst) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // a 16-byte chunk
  constexpr int kChunks = HD / kPer;                 // chunks a row
  constexpr int kStep = kThreadsMma / kChunks;       // rows a pass
  static_assert(ROWS % kStep == 0, "a pass covers whole rows");
  const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
  src += c * kPer;
  dst += sizeof(T) * (r0 * LD + c * kPer);
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i) {
    const int t = t0 + r0 + i * kStep;
    const bool valid = t < S;
    cp_async16(dst + sizeof(T) * i * kStep * LD,
               src + static_cast<int64_t>(valid ? t : 0) * stride, valid);
  }
}

// The helpers that flash_fwd_mma and flash_fwd_mma_f32 share. A warp holds
// 16 query rows starting at row0 in the accumulator layout of mma.sync: a
// lane holds rows g (elements 0, 1) and g + 8 (2, 3), columns 2 tq and the
// next of each n-tile of 8 columns; a row lives in the 4 lanes of a quad.

// The online softmax over one tile of KEYS base-2 scores starting at key
// t0: the reference's mask where the tile reaches past the warp's first
// row, the rows' new maxima (two shuffles in a quad), o and l rescaled,
// then p = exp2(s - m) in place of each score, summed into this lane's l.
template <int KEYS, int HD>
__device__ __forceinline__ void softmax_tile(float (&sc)[KEYS / 8][4],
                                             float (&o)[HD / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             int t0, int row0, int S, int g,
                                             int tq) {
  if (t0 + KEYS - 1 > row0) {   // a tile that reaches past a warp row
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * n + 2 * tq + (e & 1);
        const int r = row0 + g + 8 * (e >> 1);
        sc[n][e] = t >= S ? -INFINITY : (t > r ? flash::kNegInf : sc[n][e]);
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < KEYS / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    o[d][0] *= alpha[0];
    o[d][1] *= alpha[0];
    o[d][2] *= alpha[1];
    o[d][3] *= alpha[1];
  }
#pragma unroll
  for (int n = 0; n < KEYS / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[n][e] - m[e >> 1]);
      sc[n][e] = p;
      l[e >> 1] += p;
    }
  }
}

// P's A fragment for keys 16 kk .. 16 kk + 15 (the scores of n-tiles 2 kk
// and 2 kk + 1: the accumulator layout is the next MMA's A layout), as two
// bf16 parts.
template <int KEYS>
__device__ __forceinline__ void p_parts(const float (&sc)[KEYS / 8][4],
                                        int kk, uint32_t (&ph)[4],
                                        uint32_t (&pl)[4]) {
  split2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
  split2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
  split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
  split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
}

// The finish: l summed over the quad, out = o / max(l, 1e-30). An even
// lane of a pair stores row g, an odd one row g + 8: 4 columns each, the
// two it holds and the two its neighbour sends (16 bytes). out points at
// the head's column 0 of row 0; rows past S are not stored.
template <int HD>
__device__ __forceinline__ void store_out(const float (&o)[HD / 8][4],
                                           float (&l)[2], float* out,
                                           int64_t stride, int row0, int S,
                                           int g, int tq) {
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / fmaxf(l[i], 1e-30f);
  }
  const bool odd = tq & 1;
  const int r = row0 + g + (odd ? 8 : 0);
  const float w = odd ? inv[1] : inv[0];
  float* orow = out + static_cast<int64_t>(r) * stride + 2 * (tq & ~1);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const float s0 =
        __shfl_xor_sync(0xffffffffu, odd ? o[d][0] : o[d][2], 1);
    const float s1 =
        __shfl_xor_sync(0xffffffffu, odd ? o[d][1] : o[d][3], 1);
    const float4 val =
        odd ? make_float4(s0 * w, s1 * w, o[d][2] * w, o[d][3] * w)
            : make_float4(o[d][0] * w, o[d][1] * w, s0 * w, s1 * w);
    if (r < S) *reinterpret_cast<float4*>(orow + 8 * d) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsMma, 2)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, float* __restrict__ out,
                  int S, int H, int Kv, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  // byte address of the ring; stage s: K at tile 2s, V at tile 2s + 1
  const uint32_t kv_s = smem_addr(q_s + kRows * kLd);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / Kv);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t q_base = static_cast<int64_t>(b) * S * q_stride +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_stride +
                          static_cast<int64_t>(kvh) * HD;
  const bf16* kg = k + kv_base;
  const bf16* vg = v + kv_base;
  const int n_tiles = (min(S, r0 + kRows) + kKeys - 1) / kKeys;
  constexpr uint32_t kTileBytes = kKeys * kLd * sizeof(bf16);
  auto k_tile = [&](int s) { return kv_s + (2 * s) * kTileBytes; };
  auto v_tile = [&](int s) { return kv_s + (2 * s + 1) * kTileBytes; };
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int s = j % kStages;
      load_tile<bf16, HD, kLd, kKeys>(kg, kv_stride, j * kKeys, S,
                                      k_tile(s));
      load_tile<bf16, HD, kLd, kKeys>(vg, kv_stride, j * kKeys, S,
                                      v_tile(s));
    }
    cp_async_commit();   // an empty group keeps the count in step
  };

  // the first copy group holds Q and tile 0; kStages - 1 tiles in flight
  load_tile<bf16, HD, kLd, kRows>(q + q_base, q_stride, r0, S,
                                  smem_addr(q_s));
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // a quad shares a row
  const int row0 = r0 + 16 * warp;          // the warp's first row
  // scores in base 2, exp(x) = exp2(x log2 e): m holds base-2 maxima
  const float scale2 = scale * 1.4426950408889634f;

  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qf[HD / 16][4];
  {
    const bf16* base =
        q_s + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
        8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(smem_addr(base + 16 * kk), qf[kk]);
  }
  // the rows of a lane's accumulators: g (elements 0, 1) and g + 8 (2, 3)
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {flash::kNegInf, flash::kNegInf};
  float l[2] = {0.0f, 0.0f};   // this lane's part of the row sums

  // lane offsets of the ldmatrix row addresses within a tile, in bytes
  const uint32_t k_off =
      2 * (((lane & 7) + 8 * (lane >> 4)) * kLd + 8 * ((lane >> 3) & 1));
  const uint32_t v_off =
      2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4));

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();         // tile j is in; every warp is done with j - 1
    load_kv(j + kStages - 1);   // into the stage tile j - 1 used
    const uint32_t ks = k_tile(j % kStages) + k_off;
    const uint32_t vs = v_tile(j % kStages) + v_off;

    float sc[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; n += 2) {
        uint32_t kf[4];
        ldsm_x4(ks + 2 * (8 * n * kLd + 16 * kk), kf);
        mma_bf16(sc[n], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[n + 1], qf[kk], kf[2], kf[3]);
      }
    }

#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= scale2;
    }
    softmax_tile<kKeys, HD>(sc, o, m, l, j * kKeys, row0, S, g, tq);

    // P (16 x 64) V (64 x HD): 16 keys a step, P's A fragment from the
    // scores of n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      p_parts<kKeys>(sc, kk, ph, pl);
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vs + 2 * (16 * kk * kLd + 8 * d), vf);
        mma_bf16(o[d], ph, vf[0], vf[1]);
        mma_bf16(o[d], pl, vf[0], vf[1]);
        mma_bf16(o[d + 1], ph, vf[2], vf[3]);
        mma_bf16(o[d + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();   // no copy may outlive the block
  store_out<HD>(o, l, out + q_base, q_stride, row0, S, g, tq);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       float* out, int B, int S, int H, int Kv, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_mma<HD>;
  constexpr int smem = smem_bytes<HD>();
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreadsMma, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), out, S, H, Kv, scale);
  return cudaGetLastError();
}

// The f32 kernel's shared memory: one f32 stage of kKeysF keys (K, V);
// K's three parts and V's two (rows of HD + kPad bf16); the lo part of
// Q's A fragments, 16 bytes a lane and 16 columns.
constexpr int kKeysF = 32;

template <int HD>
struct F32Smem {
  static constexpr int kLd = HD + kPad;
  static constexpr int kStage = 2 * kKeysF * HD * 4;          // K, V f32
  static constexpr int kParts = 5 * kKeysF * kLd * 2;         // K 3, V 2
  static constexpr int kQLo = kWarpsMma * (HD / 16) * 32 * 16;
  static constexpr int kBytes = kStage + kParts + kQLo;
};

// Four f32 values at src as two bf16 parts, at hi and lo.
__device__ __forceinline__ void split_store4(const float* src, bf16* hi,
                                             bf16* lo) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  uint32_t h0, l0, h1, l1;
  split2(x.x, x.y, h0, l0);
  split2(x.z, x.w, h1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

// The same as three parts, at hi, mid and lo.
__device__ __forceinline__ void split3_store4(const float* src, bf16* hi,
                                              bf16* mid, bf16* lo) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  uint32_t h0, m0, l0, h1, m1, l1;
  split3(x.x, x.y, h0, m0, l0);
  split3(x.z, x.w, h1, m1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(mid) = make_uint2(m0, m1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

// flash_fwd_mma's layout, softmax and finish on f32 inputs, on the bf16
// tensor cores: the scores from three-part Q and K (six products), P V
// from two-part P and V (three products); only the staging and the
// products are its own.
template <int HD>
__global__ void __launch_bounds__(kThreadsMma, 2)
    flash_fwd_mma_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int S, int H, int Kv, float scale) {
  using L = F32Smem<HD>;
  constexpr int kLd = L::kLd;
  constexpr int kKeys = kKeysF;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const float* kf = reinterpret_cast<const float*>(smem);   // the stage
  const float* vf = kf + kKeys * HD;
  bf16* k_hi = reinterpret_cast<bf16*>(smem + L::kStage);
  bf16* k_mid = k_hi + kKeys * kLd;
  bf16* k_lo = k_mid + kKeys * kLd;
  bf16* v_hi = k_lo + kKeys * kLd;
  bf16* v_lo = v_hi + kKeys * kLd;
  uint4* q_lo = reinterpret_cast<uint4*>(smem + L::kStage + L::kParts);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / Kv);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t q_base = static_cast<int64_t>(b) * S * q_stride +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_stride +
                          static_cast<int64_t>(kvh) * HD;
  const float* kg = k + kv_base;
  const float* vg = v + kv_base;
  const int n_tiles = (min(S, r0 + kRows) + kKeys - 1) / kKeys;
  const uint32_t stage = smem_addr(smem);
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      load_tile<float, HD, HD, kKeys>(kg, kv_stride, j * kKeys, S, stage);
      load_tile<float, HD, HD, kKeys>(vg, kv_stride, j * kKeys, S,
                                      stage + kKeys * HD * 4);
    }
    cp_async_commit();
  };
  load_kv(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // a quad shares a row
  const int row0 = r0 + 16 * warp;          // the warp's first row
  const float scale2 = scale * 1.4426950408889634f;

  // Q's A fragments, straight from device memory: scaled to base-2 scores
  // and split in three, hi and mid kept in registers for the whole key
  // loop, lo in shared memory (each lane reads back its own). Fragment e
  // holds row g + 8 (e & 1), columns 2 tq + 8 (e >> 1) and the next; zeros
  // past S
  uint32_t qh[HD / 16][4], qm[HD / 16][4];
  uint4* my_q_lo = q_lo + warp * (HD / 16) * 32 + lane;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t ql[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e & 1);
      const float2 x =
          r < S ? *reinterpret_cast<const float2*>(
                      q + q_base + static_cast<int64_t>(r) * q_stride +
                      16 * kk + 2 * tq + 8 * (e >> 1))
                : make_float2(0.0f, 0.0f);
      split3(x.x * scale2, x.y * scale2, qh[kk][e], qm[kk][e], ql[e]);
    }
    my_q_lo[kk * 32] = make_uint4(ql[0], ql[1], ql[2], ql[3]);
  }
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {flash::kNegInf, flash::kNegInf};
  float l[2] = {0.0f, 0.0f};   // this lane's part of the row sums

  // the ldmatrix row addresses of the split tiles, in bytes
  const uint32_t k_off =
      2 * (((lane & 7) + 8 * (lane >> 4)) * kLd + 8 * ((lane >> 3) & 1));
  const uint32_t v_off =
      2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4));
  const uint32_t kh_a = smem_addr(k_hi) + k_off;
  const uint32_t km_a = smem_addr(k_mid) + k_off;
  const uint32_t kl_a = smem_addr(k_lo) + k_off;
  const uint32_t vh_a = smem_addr(v_hi) + v_off;
  const uint32_t vl_a = smem_addr(v_lo) + v_off;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j is in; every warp is done with j - 1
    // the block splits tile j once; every warp reads the parts
    static_assert(kKeys * HD % (4 * kThreadsMma) == 0, "whole passes");
#pragma unroll
    for (int it = 0; it < kKeys * HD / (4 * kThreadsMma); ++it) {
      const int i = threadIdx.x + it * kThreadsMma;
      const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
      split3_store4(kf + r * HD + c, k_hi + r * kLd + c, k_mid + r * kLd + c,
                    k_lo + r * kLd + c);
      split_store4(vf + r * HD + c, v_hi + r * kLd + c, v_lo + r * kLd + c);
    }
    __syncthreads();   // the parts are in; the stage is free
    load_kv(j + 1);    // in flight while tile j is computed

    // scores: q_hi k_hi + q_hi k_mid + q_mid k_hi + q_hi k_lo + q_mid k_mid
    // + q_lo k_hi; what is left out is below 2^-24 of the products
    float sc[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint4 t = my_q_lo[kk * 32];
      const uint32_t ql[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int n = 0; n < kKeys / 8; n += 2) {
        const uint32_t off = 2 * (8 * n * kLd + 16 * kk);
        uint32_t fh[4], fm[4], fl[4];
        ldsm_x4(kh_a + off, fh);
        ldsm_x4(km_a + off, fm);
        ldsm_x4(kl_a + off, fl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t h0 = fh[2 * e], h1 = fh[2 * e + 1];
          mma_bf16(sc[n + e], qh[kk], h0, h1);
          mma_bf16(sc[n + e], qh[kk], fm[2 * e], fm[2 * e + 1]);
          mma_bf16(sc[n + e], qm[kk], h0, h1);
          mma_bf16(sc[n + e], qh[kk], fl[2 * e], fl[2 * e + 1]);
          mma_bf16(sc[n + e], qm[kk], fm[2 * e], fm[2 * e + 1]);
          mma_bf16(sc[n + e], ql, h0, h1);
        }
      }
    }

    softmax_tile<kKeys, HD>(sc, o, m, l, j * kKeys, row0, S, g, tq);

    // P V: p_hi v_hi + p_lo v_hi + p_hi v_lo, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      p_parts<kKeys>(sc, kk, ph, pl);
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t fh[4], fl[4];
        ldsm_x4_trans(vh_a + 2 * (16 * kk * kLd + 8 * d), fh);
        ldsm_x4_trans(vl_a + 2 * (16 * kk * kLd + 8 * d), fl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma_bf16(o[d + e], ph, fh[2 * e], fh[2 * e + 1]);
          mma_bf16(o[d + e], pl, fh[2 * e], fh[2 * e + 1]);
          mma_bf16(o[d + e], ph, fl[2 * e], fl[2 * e + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy may outlive the block
  store_out<HD>(o, l, out + q_base, q_stride, row0, S, g, tq);
}

template <int HD>
cudaError_t launch_mma_f32(const void* q, const void* k, const void* v,
                           float* out, int B, int S, int H, int Kv,
                           float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_f32<HD>;
  constexpr int smem = F32Smem<HD>::kBytes;
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreadsMma, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), out, S, H, Kv, scale);
  return cudaGetLastError();
}

}  // namespace mma

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The kernel that this thread's last flash_attn call launched: 0 flash_fwd,
// 1 flash_fwd_mma, 2 flash_fwd_mma_f32; -1 where the call launched none.
thread_local int last_kernel = -1;

}  // namespace

// q (B, S, H, hd), k/v (B, S, Kv, hd), all f32 (dtype 0) or all bf16
// (dtype 1), contiguous; out (B, S, H, hd) f32. Inputs with hd a multiple
// of 16 and every pointer 16-byte aligned take a tensor-core kernel
// (flash_fwd_mma_f32 for f32, flash_fwd_mma for bf16), every other input
// the CUDA-core one; flash_attn_last_kernel says which ran. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape no kernel takes).
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int Kv, int hd,
                          int dtype, float scale, void* stream) {
  last_kernel = -1;
  if (B <= 0 || S <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 ||
      !flash::hd_ok(hd) || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int kernel;
  if (hd % 16 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out)) {
    err = dtype == 0
              ? launch<float>(q, k, v, o, B, S, H, Kv, hd, scale, st)
              : launch<__nv_bfloat16>(q, k, v, o, B, S, H, Kv, hd, scale, st);
    kernel = 0;
  } else {
    // hd_ok and hd % 16 == 0 leave 16, 32, 64 and 128
    using Launch = decltype(&mma::launch_mma<16>);
    const Launch launches[2][4] = {
        {&mma::launch_mma_f32<16>, &mma::launch_mma_f32<32>,
         &mma::launch_mma_f32<64>, &mma::launch_mma_f32<128>},
        {&mma::launch_mma<16>, &mma::launch_mma<32>, &mma::launch_mma<64>,
         &mma::launch_mma<128>}};
    const int i = hd == 16 ? 0 : hd == 32 ? 1 : hd == 64 ? 2 : 3;
    err = launches[dtype][i](q, k, v, o, B, S, H, Kv, scale, st);
    kernel = dtype == 0 ? 2 : 1;
  }
  if (err == cudaSuccess) last_kernel = kernel;
  return static_cast<int>(err);
}

extern "C" int flash_attn_last_kernel() { return last_kernel; }
