// Chunk-prefill attention of C query rows per plane over a KIVI-packed
// prefix plus the chunk's own causal block, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel fused_chunk_prefill (body _fused_chunk_kernel)
// of src/repro/kernels/fused_prefill/kernel.py:127. Per plane: the chunk's
// rows attend (a) the T-token packed prefix, every column visible unless
// it lies at or past cur_len (masked with -1e30), and (b) the chunk's own
// f32 keys under the causal mask, whose diagonal is always visible. One
// softmax runs over [prefix; chunk]; a key that does not exist scores
// -inf; out = acc / max(l, 1e-30).
//
// What bounds it, at the main shape (P 32, C 32, T 4096, hd 128, group 64,
// 4 bits): bytes. The packed prefix, its scales and zeros and the dense
// chunk are 23.1 MB, 0.0069 ms at 3.35 TB/s; the products are 2.16e9
// operations, 0.0022 ms at 989 TFLOP/s on the bf16 tensor cores (0.0066
// ms for the three products of the two-part operands below), 0.032 ms on
// the f32 CUDA cores.
//
// Both kernels split the prefix across blocks (flash-decoding, since
// planes are few) and make the chunk's own causal block one more split;
// flash::merge_splits combines the splits' (m, l, acc) in a second launch.
// The entry picks the kernel by shape:
//
// fused_mma<BITS, HD> (hd 16, 32, 64 or 128, both groups multiples of 8
// tokens or channels, 16-byte aligned pointers): the prefix's products on
// the bf16 tensor cores (mma.sync m16n8k16, f32 accumulators), in the
// "dequantize then split" form: each K and V value is dequantized in f32
// as the plain version does it, fma(code, scale, zero), and stored as two
// bf16 parts (hi + lo, 16 significant bits); q and P are split the same
// way, and each product is hi hi + lo hi + hi lo, three MMAs into one f32
// accumulator. A single bf16 operand misses rtol 1e-4 / atol 2e-4;
// tests/test_torch_fused_prefill.py emulates the form on the CPU. The
// "codes" form (the codes as exact bf16 B operands, the scale folded into
// a two-part A rebuilt at each group edge, the zero a separate f32 term)
// does two MMAs a product, not three, but its rebuilds and zero terms
// made a loop six times longer; it took 0.081 ms against this form's
// 0.054 at the main shape on an H100 (PERF.md). The design:
//  - a block of 4 warps takes 32 chunk rows and one split of 8 or so
//    64-token tiles: warp w owns rows 16 (w % 2) .. + 15 (the MMA's m16,
//    zero rows past C) and tokens 32 (w / 2) .. + 31 of every tile, and the
//    two warps of a row pair merge their (m, l, acc) in shared memory at
//    the end. Few splits (kernel.py aims at two blocks an SM) keep the
//    split workspace, which is written and read back, at a few MB;
//  - the packed K and V bytes and their scales and zeros come through a
//    ring of kStages stages filled by 16-byte cp.async.cg, so tile j + 1
//    is in flight while tile j is dequantized and computed; the block
//    dequantizes each tile once into bf16 hi and lo tiles laid out for
//    ldmatrix (K's as it lies, V's transposed), rows padded by 8 bf16;
//  - q is scaled by hd^-0.5 log2 e and split once, into shared memory, so
//    scores are in base 2 and each exponential is one exp2f; the online
//    softmax lives in registers, a row in the 4 lanes of a quad.
//
// fused_split<BITS> (every other layout): f32 FFMA on the CUDA cores. Each
// block unpacks a 32-token tile once into f32 shared memory and all its
// rows use it, so the dequantized prefix never reaches device memory; the
// prefix is cut into many short splits so that about 1056 blocks hide
// each tile's load. Its scores and P @ V loops read shared memory as
// float4 with each warp owning 8 rows, about 2.7 FFMA per wavefront.
//
// The chunk's own keys (one split of at most C keys a row block) go
// through the CUDA cores in both kernels (flash::tile_step, f32).
#include "../../csrc/mma_sm90.cuh"
#include "../../decode_attn/csrc/kivi_planes.cuh"

namespace {

using flash::kThreads;
using flash::kTile;
using flash::kWarps;

constexpr int kRpw = 8;
constexpr int kRb = kWarps * kRpw;

// The last split of a row block: the block's kRb rows against the
// chunk's own keys, causal (tiles past the block's last row are wholly
// masked and skipped), stored as that split's partial state.
__device__ __forceinline__ void chunk_split(
    const float* __restrict__ q, const float* __restrict__ kc,
    const float* __restrict__ vc, float* __restrict__ m_ws,
    float* __restrict__ l_ws, float* __restrict__ acc_ws, int C, int hd,
    float scale, float* smem) {
  const int r0 = blockIdx.y * kRb, p = blockIdx.z;
  const int64_t plane_rows = static_cast<int64_t>(p) * C * hd;
  flash::load_rows(q + plane_rows, hd, r0, kRb, C, hd, smem);
  flash::Rows<kRpw> st;
  st.init();
  float* k_s = smem + kRb * hd;
  float* v_s = k_s + kTile * (hd + 4);
  float* p_s = v_s + kTile * hd;
  const int t_end = min(C, r0 + kRb);
  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    const int n = min(kTile, C - t0);
    __syncthreads();
    flash::load_dense_tile(kc + plane_rows, vc + plane_rows, hd, t0, n, hd,
                           k_s, v_s);
    __syncthreads();
    flash::tile_step<kRpw>(st, smem, k_s, v_s, p_s, hd, scale,
                           [=](int r, int t, float s) {
                             return t >= n ? -INFINITY
                                           : (t0 + t <= r0 + r
                                                  ? s : flash::kNegInf);
                           });
  }
  const int64_t base =
      (static_cast<int64_t>(p) * gridDim.x + blockIdx.x) * C;
  flash::store_partial<kRpw>(st, r0, C, hd, base, m_ws, l_ws, acc_ws);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
    fused_split(const float* __restrict__ q, const uint8_t* __restrict__ kp,
                const float* __restrict__ ks, const float* __restrict__ kz,
                const uint8_t* __restrict__ vp, const float* __restrict__ vs,
                const float* __restrict__ vz, const float* __restrict__ kc,
                const float* __restrict__ vc,
                const int* __restrict__ cur_len, float* __restrict__ m_ws,
                float* __restrict__ l_ws, float* __restrict__ acc_ws, int C,
                int T, int hd, int kg, int vg, int split_len, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x, r0 = blockIdx.y * kRb, p = blockIdx.z;
  if (split + 1 == static_cast<int>(gridDim.x)) {
    chunk_split(q, kc, vc, m_ws, l_ws, acc_ws, C, hd, scale, smem);
    return;
  }
  // a split of the packed prefix
  const int64_t plane_rows = static_cast<int64_t>(p) * C * hd;
  flash::load_rows(q + plane_rows, hd, r0, kRb, C, hd, smem);
  flash::Rows<kRpw> st;
  st.init();
  const kivi_planes::Plane pl = kivi_planes::plane_at<BITS>(
      kp, ks, kz, vp, vs, vz, p, T, hd, kg, vg);
  const int t_begin = split * split_len;
  kivi_planes::attend_split<BITS, kRpw>(st, pl, t_begin,
                                        min(T, t_begin + split_len),
                                        cur_len[p], hd, kg, vg, scale, smem,
                                        kRb);
  const int64_t base = (static_cast<int64_t>(p) * gridDim.x + split) * C;
  flash::store_partial<kRpw>(st, r0, C, hd, base, m_ws, l_ws, acc_ws);
}

template <int BITS>
cudaError_t launch(const float* q, const uint8_t* kp, const float* ks,
                   const float* kz, const uint8_t* vp, const float* vs,
                   const float* vz, const float* kc, const float* vc,
                   const int* cur_len, float* m_ws, float* l_ws,
                   float* acc_ws, int P, int C, int T, int hd, int kg, int vg,
                   int split_len, float scale, cudaStream_t stream) {
  auto kernel = fused_split<BITS>;
  static const cudaError_t smem_err = flash::allow_smem(kernel, kRb);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((T + split_len - 1) / split_len + 1, (C + kRb - 1) / kRb,
                  P);
  const size_t smem = flash::smem_floats(kRb, hd) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(q, kp, ks, kz, vp, vs, vz, kc, vc,
                                           cur_len, m_ws, l_ws, acc_ws, C, T,
                                           hd, kg, vg, split_len, scale);
  return cudaGetLastError();
}

namespace fmma {

using namespace ::sm90;   // the shared helpers of mma_sm90.cuh
using kivi_planes::code_at;
using bf16 = __nv_bfloat16;

constexpr int kThreadsF = 128;   // 4 warps: 2 of rows x 2 of tokens
constexpr int kRows = 32;        // chunk rows a block, 16 a warp
constexpr int kTok = 64;         // tokens a tile, 32 a warp
constexpr int kStages = 2;       // packed tiles in the ring
constexpr int kPad = 8;          // bf16 of padding a shared row

// Byte offsets in the dynamic shared memory of a block:
//   q hi, q lo (kRows, hd + kPad) bf16 | K hi, K lo, V hi, V lo (kTok,
//   hd + kPad) bf16 | kStages x stage; stage = K bytes (kTok / cpb, hd) |
//   V bytes (kTok, hd / cpb) | ks, kz (gr, hd) f32 | vs, vz (kTok, hd /
//   vg) f32,
// where gr = 63 / kg + 2 bounds the K groups that 64 tokens touch. The
// chunk split's f32 tiles (flash::smem_floats) reuse the same memory.
struct Layout {
  int ql, kh, kl, vh, vl, ring, kraw, vraw, ks, kz, vs, vz, stage, gr, total;
  __host__ __device__ Layout(int hd, int bits, int kg, int vg) {
    const int cpb = 8 / bits, row = (hd + kPad) * 2;
    gr = (kTok - 1) / kg + 2;
    ql = kRows * row;
    kh = 2 * kRows * row;
    kl = kh + kTok * row;
    vh = kl + kTok * row;
    vl = vh + kTok * row;
    ring = vl + kTok * row;
    kraw = 0;
    vraw = kraw + kTok / cpb * hd;
    ks = vraw + kTok * (hd / cpb);
    kz = ks + gr * hd * 4;
    vs = kz + gr * hd * 4;
    vz = vs + kTok * (hd / vg) * 4;
    stage = vz + kTok * (hd / vg) * 4;
    const int chunk = flash::smem_floats(kRb, hd) * 4;
    total = ring + kStages * stage;
    total = total > chunk ? total : chunk;
  }
};

// Start the copies of tokens [t0, t0 + n) of a plane into the stage at
// shared byte address st. Each part of a tile is contiguous in device
// memory: K's rows of cpb tokens, V's token rows, the K groups the tile
// touches, V's per-token scales.
template <int BITS, int HD>
__device__ __forceinline__ void load_stage(const kivi_planes::Plane& pl,
                                           const Layout& L, uint32_t st,
                                           int t0, int n, int kg, int vg) {
  constexpr int CPB = 8 / BITS;
  const int vcols = HD / vg, g0 = t0 / kg;
  const int ng = (t0 + n - 1) / kg - g0 + 1;
  copy_flat<kThreadsF>(st + L.kraw,
                       pl.kp + static_cast<int64_t>(t0 / CPB) * HD,
                       n / CPB * HD, kTok / CPB * HD);
  copy_flat<kThreadsF>(st + L.vraw,
                       pl.vp + static_cast<int64_t>(t0) * (HD / CPB),
                       n * (HD / CPB), kTok * (HD / CPB));
  copy_flat<kThreadsF>(st + L.ks, pl.ks + static_cast<int64_t>(g0) * HD,
                       ng * HD * 4, L.gr * HD * 4);
  copy_flat<kThreadsF>(st + L.kz, pl.kz + static_cast<int64_t>(g0) * HD,
                       ng * HD * 4, L.gr * HD * 4);
  copy_flat<kThreadsF>(st + L.vs, pl.vs + static_cast<int64_t>(t0) * vcols,
                       n * vcols * 4, kTok * vcols * 4);
  copy_flat<kThreadsF>(st + L.vz, pl.vz + static_cast<int64_t>(t0) * vcols,
                       n * vcols * 4, kTok * vcols * 4);
}

// Dequantize a stage into the K and V tiles, each value fma(code, scale,
// zero) in f32 as the plain version computes it, stored as its two bf16
// parts. A thread keeps one 4-byte column of the packed K rows (4
// channels of cpb tokens) and one of the packed V rows (4 cpb channels of
// a token); v_col[i] is the V group of its channel pair i.
template <int BITS, int HD>
__device__ __forceinline__ void dequant(const char* st, const Layout& L,
                                        int t0, int kg, int vg,
                                        const int (&v_col)[16 / BITS],
                                        bf16* kh, bf16* kl, bf16* vh,
                                        bf16* vl) {
  constexpr int CPB = 8 / BITS;
  constexpr int kLd = HD + kPad;
  constexpr int kWords = HD / 4;             // K words a packed row
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(st + L.kraw);
  const float* ks = reinterpret_cast<const float*>(st + L.ks);
  const float* kz = reinterpret_cast<const float*>(st + L.kz);
  const int c = 4 * (threadIdx.x % kWords), g0 = t0 / kg;
  for (int r = threadIdx.x / kWords; r < kTok / CPB;
       r += kThreadsF / kWords) {
    const uint32_t x = kw[r * kWords + c / 4];
    const int gi = ((t0 + r * CPB) / kg - g0) * HD + c;
    const float4 s = *reinterpret_cast<const float4*>(ks + gi);
    const float4 z = *reinterpret_cast<const float4*>(kz + gi);
#pragma unroll
    for (int j = 0; j < CPB; ++j) {
      const int b = j * BITS;
      uint32_t h0, l0, h1, l1;
      split2(__fmaf_rn(code_at<BITS>(x, b), s.x, z.x),
             __fmaf_rn(code_at<BITS>(x, 8 + b), s.y, z.y), h0, l0);
      split2(__fmaf_rn(code_at<BITS>(x, 16 + b), s.z, z.z),
             __fmaf_rn(code_at<BITS>(x, 24 + b), s.w, z.w), h1, l1);
      const int off = (r * CPB + j) * kLd + c;
      *reinterpret_cast<uint2*>(kh + off) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(kl + off) = make_uint2(l0, l1);
    }
  }
  constexpr int vWords = HD / CPB / 4;       // V words a token
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(st + L.vraw);
  const float* vs = reinterpret_cast<const float*>(st + L.vs);
  const float* vz = reinterpret_cast<const float*>(st + L.vz);
  const int w0 = threadIdx.x % vWords, vcols = HD / vg;
  for (int t = threadIdx.x / vWords; t < kTok; t += kThreadsF / vWords) {
    const uint32_t x = vw[t * vWords + w0];
    uint32_t h[2 * CPB], l[2 * CPB];
#pragma unroll
    for (int i = 0; i < 2 * CPB; ++i) {
      const float s = vs[t * vcols + v_col[i]];
      const float z = vz[t * vcols + v_col[i]];
      split2(__fmaf_rn(code_at<BITS>(x, 2 * i * BITS), s, z),
             __fmaf_rn(code_at<BITS>(x, (2 * i + 1) * BITS), s, z), h[i],
             l[i]);
    }
    const int off = t * kLd + 4 * CPB * w0;
    if constexpr (CPB == 1) {
      *reinterpret_cast<uint2*>(vh + off) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(vl + off) = make_uint2(l[0], l[1]);
    } else {
#pragma unroll
      for (int i = 0; i < 2 * CPB; i += 4) {
        *reinterpret_cast<uint4*>(vh + off + 2 * i) =
            make_uint4(h[i], h[i + 1], h[i + 2], h[i + 3]);
        *reinterpret_cast<uint4*>(vl + off + 2 * i) =
            make_uint4(l[i], l[i + 1], l[i + 2], l[i + 3]);
      }
    }
  }
}

template <int BITS, int HD>
__global__ void __launch_bounds__(kThreadsF, 2)
    fused_mma(const float* __restrict__ q, const uint8_t* __restrict__ kp,
              const float* __restrict__ ks, const float* __restrict__ kz,
              const uint8_t* __restrict__ vp, const float* __restrict__ vs,
              const float* __restrict__ vz, const float* __restrict__ kc,
              const float* __restrict__ vc, const int* __restrict__ cur_len,
              float* __restrict__ m_ws, float* __restrict__ l_ws,
              float* __restrict__ acc_ws, int C, int T, int kg, int vg,
              int split_len, float scale) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  if (blockIdx.x + 1 == gridDim.x) {
    chunk_split(q, kc, vc, m_ws, l_ws, acc_ws, C, HD, scale,
                reinterpret_cast<float*>(smem));
    return;
  }
  constexpr int CPB = 8 / BITS;
  constexpr int kLd = HD + kPad;   // bf16 a shared row
  const Layout L(HD, BITS, kg, vg);
  const int split = blockIdx.x, r0 = blockIdx.y * kRows, p = blockIdx.z;
  const kivi_planes::Plane pl = kivi_planes::plane_at<BITS>(
      kp, ks, kz, vp, vs, vz, p, T, HD, kg, vg);
  const int t_begin = split * split_len;
  const int t_end = min(T, t_begin + split_len);
  const int n_tiles = (t_end - t_begin + kTok - 1) / kTok;
  const int resident = cur_len[p];
  const int lim = min(resident, t_end);
  bf16* q_hi = reinterpret_cast<bf16*>(smem);
  bf16* q_lo = reinterpret_cast<bf16*>(smem + L.ql);
  bf16* k_hi = reinterpret_cast<bf16*>(smem + L.kh);
  bf16* k_lo = reinterpret_cast<bf16*>(smem + L.kl);
  bf16* v_hi = reinterpret_cast<bf16*>(smem + L.vh);
  bf16* v_lo = reinterpret_cast<bf16*>(smem + L.vl);
  const uint32_t ring = smem_addr(smem + L.ring);
  auto load = [&](int j) {
    if (j < n_tiles) {
      const int t0 = t_begin + j * kTok;
      load_stage<BITS, HD>(pl, L, ring + (j % kStages) * L.stage, t0,
                           min(kTok, t_end - t0), kg, vg);
    }
    cp_async_commit();   // an empty group keeps the count in step
  };
  for (int j = 0; j < kStages - 1; ++j) load(j);

  // the block's rows of q, scaled so that scores come out in base 2, in
  // two bf16 parts; zero rows past C
  const float scale2 = scale * 1.4426950408889634f;
  const float* qp = q + static_cast<int64_t>(p) * C * HD;
  for (int i = threadIdx.x; i < kRows * HD / 4; i += kThreadsF) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < C)
      x = *reinterpret_cast<const float4*>(
          qp + static_cast<int64_t>(r0 + r) * HD + c);
    uint32_t h0, l0, h1, l1;
    split2(x.x * scale2, x.y * scale2, h0, l0);
    split2(x.z * scale2, x.w * scale2, h1, l1);
    *reinterpret_cast<uint2*>(q_hi + r * kLd + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(q_lo + r * kLd + c) = make_uint2(l0, l1);
  }
  // the V groups of this thread's channel pairs in dequant
  int v_col[2 * CPB];
#pragma unroll
  for (int i = 0; i < 2 * CPB; ++i)
    v_col[i] = (4 * CPB * (threadIdx.x % (HD / CPB / 4)) + 2 * i) / vg;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 1, kh = warp >> 1;   // row pair, token half
  const int g = lane >> 2, tq = lane & 3;    // a quad shares a row
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {flash::kNegInf, flash::kNegInf};
  float l[2] = {0.0f, 0.0f};   // this lane's part of the row sums
  // the ldmatrix row addresses, in bytes: the warp's 16 rows of q, its 32
  // tokens of K (as they lie) and of V (transposed)
  const uint32_t q_off =
      2 * ((16 * rw + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
           8 * (lane >> 4));
  const uint32_t k_off =
      2 * ((32 * kh + (lane & 7) + 8 * (lane >> 4)) * kLd +
           8 * ((lane >> 3) & 1));
  const uint32_t v_off =
      2 * ((32 * kh + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
           8 * (lane >> 4));
  const uint32_t qh_a = smem_addr(q_hi) + q_off;
  const uint32_t ql_a = smem_addr(q_lo) + q_off;
  const uint32_t kh_a = smem_addr(k_hi) + k_off;
  const uint32_t kl_a = smem_addr(k_lo) + k_off;
  const uint32_t vh_a = smem_addr(v_hi) + v_off;
  const uint32_t vl_a = smem_addr(v_lo) + v_off;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile j is in; every warp is done with j - 1
    load(j + kStages - 1);   // into the stage tile j - 1 used
    const int t0 = t_begin + j * kTok;
    dequant<BITS, HD>(smem + L.ring + (j % kStages) * L.stage, L, t0, kg,
                      vg, v_col, k_hi, k_lo, v_hi, v_lo);
    __syncthreads();

    // scores: q_hi k_hi + q_lo k_hi + q_hi k_lo
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qh[4], ql[4];
      ldsm_x4(qh_a + 32 * kk, qh);
      ldsm_x4(ql_a + 32 * kk, ql);
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t fh[4], fl[4];
        ldsm_x4(kh_a + 2 * (8 * n * kLd + 16 * kk), fh);
        ldsm_x4(kl_a + 2 * (8 * n * kLd + 16 * kk), fl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma_bf16(sc[n + e], qh, fh[2 * e], fh[2 * e + 1]);
          mma_bf16(sc[n + e], ql, fh[2 * e], fh[2 * e + 1]);
          mma_bf16(sc[n + e], qh, fl[2 * e], fl[2 * e + 1]);
        }
      }
    }
    const int tw = t0 + 32 * kh;   // the warp's first token
    if (tw + 32 > lim) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tw + 8 * n + 2 * tq + (e & 1);
          sc[n][e] = t >= t_end ? -INFINITY
                                : (t >= resident ? flash::kNegInf
                                                 : sc[n][e]);
        }
      }
    }

    // online softmax on base-2 scores, as flash_fwd_mma
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
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
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sc[n][e] - m[e >> 1]);
        sc[n][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // P V: p_hi v_hi + p_lo v_hi + p_hi v_lo, 16 tokens a step, P's A
    // fragment from the scores of n-tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ph[4], pq[4];
      split2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pq[0]);
      split2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pq[1]);
      split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pq[2]);
      split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pq[3]);
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t fh[4], fl[4];
        ldsm_x4_trans(vh_a + 2 * (16 * kk * kLd + 8 * d), fh);
        ldsm_x4_trans(vl_a + 2 * (16 * kk * kLd + 8 * d), fl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma_bf16(o[d + e], ph, fh[2 * e], fh[2 * e + 1]);
          mma_bf16(o[d + e], pq, fh[2 * e], fh[2 * e + 1]);
          mma_bf16(o[d + e], ph, fl[2 * e], fl[2 * e + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // the token halves of a row pair meet in shared memory (the K and V
  // tiles, which no warp reads any more): HD / 2 accumulators, m and l a
  // lane
  constexpr int kX = HD / 2 + 4;
  __syncthreads();
  float* xch = reinterpret_cast<float*>(smem + L.kh) + rw * kX * 32 + lane;
  if (kh == 1) {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 * d + e) * 32] = o[d][e];
    xch[(HD / 2) * 32] = m[0];
    xch[(HD / 2 + 1) * 32] = m[1];
    xch[(HD / 2 + 2) * 32] = l[0];
    xch[(HD / 2 + 3) * 32] = l[1];
  }
  __syncthreads();
  if (kh == 1) return;
  float a[2], b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mo = xch[(HD / 2 + i) * 32];
    const float mm = fmaxf(m[i], mo);
    a[i] = exp2f(m[i] - mm);
    b[i] = exp2f(mo - mm);
    l[i] = l[i] * a[i] + xch[(HD / 2 + 2 + i) * 32] * b[i];
    m[i] = mm;
  }
  // the split's partial state, m in natural units as merge_splits reads it
  const int64_t base = (static_cast<int64_t>(p) * gridDim.x + split) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * rw + g + 8 * i;
    if (r >= C) continue;
    if (tq == 0) {
      m_ws[base + r] = m[i] * 0.6931471805599453f;
      l_ws[base + r] = l[i];
    }
    float* acc = acc_ws + (base + r) * HD + 2 * tq;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(acc + 8 * d) = make_float2(
          o[d][2 * i] * a[i] + xch[(4 * d + 2 * i) * 32] * b[i],
          o[d][2 * i + 1] * a[i] + xch[(4 * d + 2 * i + 1) * 32] * b[i]);
  }
}

template <int BITS, int HD>
cudaError_t launch_mma(const float* q, const uint8_t* kp, const float* ks,
                       const float* kz, const uint8_t* vp, const float* vs,
                       const float* vz, const float* kc, const float* vc,
                       const int* cur_len, float* m_ws, float* l_ws,
                       float* acc_ws, int P, int C, int T, int /*hd: HD*/,
                       int kg, int vg, int split_len, float scale,
                       cudaStream_t stream) {
  auto kernel = fused_mma<BITS, HD>;
  // the most any layout takes: the smallest groups, 8 tokens and channels
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout(HD, BITS, 8, 8).total);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((T + split_len - 1) / split_len + 1,
                  (C + kRows - 1) / kRows, P);
  kernel<<<grid, kThreadsF, Layout(HD, BITS, kg, vg).total, stream>>>(
      q, kp, ks, kz, vp, vs, vz, kc, vc, cur_len, m_ws, l_ws, acc_ws, C, T,
      kg, vg, split_len, scale);
  return cudaGetLastError();
}

}  // namespace fmma

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Every launcher takes the entry's arguments.
using Launcher = cudaError_t (*)(const float*, const uint8_t*, const float*,
                                 const float*, const uint8_t*, const float*,
                                 const float*, const float*, const float*,
                                 const int*, float*, float*, float*, int,
                                 int, int, int, int, int, int, float,
                                 cudaStream_t);

template <int BITS>
Launcher pick(bool tensor_cores, int hd) {
  if (!tensor_cores) return launch<BITS>;
  return hd == 16   ? fmma::launch_mma<BITS, 16>
         : hd == 32 ? fmma::launch_mma<BITS, 32>
         : hd == 64 ? fmma::launch_mma<BITS, 64>
                    : fmma::launch_mma<BITS, 128>;
}

}  // namespace

// q, k_chunk, v_chunk (P, C, hd) f32; packed prefix planes as in
// kivi_planes.cuh; cur_len (P,) i32; workspace m_ws/l_ws (P, n_splits, C)
// and acc_ws (P, n_splits, C, hd) f32 with n_splits = ceil(T / split_len)
// + 1; out (P, C, hd) f32. hd 16, 32, 64 or 128 with both groups
// multiples of 8 and every pointer 16-byte aligned takes the tensor-core
// kernel (split_len a multiple of 64), every other layout the CUDA-core
// one (split_len a multiple of 32). Launches the split kernel and the
// merge kernel on ``stream`` and returns cudaGetLastError()
// (cudaErrorInvalidValue, without launching, for a layout the kernels do
// not take).
extern "C" int fused_prefill(const void* q, const void* kp, const void* ks,
                             const void* kz, const void* vp, const void* vs,
                             const void* vz, const void* k_chunk,
                             const void* v_chunk, const void* cur_len,
                             void* m_ws, void* l_ws, void* acc_ws, void* out,
                             int P, int C, int T, int hd, int bits,
                             int k_group, int v_group, int split_len,
                             float scale, void* stream) {
  if (!kivi_planes::layout_ok(T, hd, bits, k_group, v_group) || P <= 0 ||
      C <= 0 || split_len <= 0 || split_len % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tensor_cores =
      hd % 16 == 0 && k_group % 8 == 0 && v_group % 8 == 0 &&
      aligned16(q) && aligned16(kp) && aligned16(ks) && aligned16(kz) &&
      aligned16(vp) && aligned16(vs) && aligned16(vz) &&
      aligned16(k_chunk) && aligned16(v_chunk);
  if (tensor_cores && split_len % fmma::kTok != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kpb = static_cast<const uint8_t*>(kp);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* kzf = static_cast<const float*>(kz);
  const auto* vpb = static_cast<const uint8_t*>(vp);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* vzf = static_cast<const float*>(vz);
  const auto* kcf = static_cast<const float*>(k_chunk);
  const auto* vcf = static_cast<const float*>(v_chunk);
  const auto* cl = static_cast<const int*>(cur_len);
  auto* m = static_cast<float*>(m_ws);
  auto* l = static_cast<float*>(l_ws);
  auto* a = static_cast<float*>(acc_ws);
  auto st = static_cast<cudaStream_t>(stream);
  const Launcher run = bits == 2   ? pick<2>(tensor_cores, hd)
                       : bits == 4 ? pick<4>(tensor_cores, hd)
                                   : pick<8>(tensor_cores, hd);
  const cudaError_t err = run(qf, kpb, ksf, kzf, vpb, vsf, vzf, kcf, vcf, cl,
                              m, l, a, P, C, T, hd, k_group, v_group,
                              split_len, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_splits = (T + split_len - 1) / split_len + 1;
  flash::merge_splits<<<dim3(C, P), (hd + 31) / 32 * 32, 0, st>>>(
      m, l, a, static_cast<float*>(out), n_splits, C, hd);
  return static_cast<int>(cudaGetLastError());
}
