// KIVI group-wise asymmetric quantization with bit-packing, and its
// inverse, for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (see ../kernel.py).
//
// Replaces the TPU kernels quantize_pallas (body _quant_pack_kernel) and
// dequantize_pallas (body _dequant_kernel) of
// src/repro/kernels/kivi/kernel.py. The reference runs V-style grouping
// through a transpose around the same kernel; here each grouping has its
// own entry, so nothing is transposed and F needs no padding to 128 lanes.
//
// Math (x is (rows, cols) f32; a group is group_size consecutive values
// along the grouped axis; cpb = 8 / bits codes per byte):
//   zero  = min(group)
//   scale = (max(group) - zero) * inv_levels,  inv_levels = f32(1/(2^b-1))
//   code  = clip(rint((x - zero) / safe), 0, 2^b - 1),  safe = scale or 1
//   cpb consecutive codes along the grouped axis pack into one byte,
//   code j of the byte at bit offset j * bits
//   x'    = fma(code, scale, zero)
// Rounding is bit-equal to the reference as XLA compiles it: XLA folds the
// division by the constant 2^b-1 into a product with its f32 reciprocal
// and contracts code*scale+zero into one fused multiply-add. Every step
// uses an explicitly rounded intrinsic (__fsub_rn, __fmul_rn, __fdiv_rn,
// rintf = round half to even, __fmaf_rn), so neither -fmad nor the
// optimiser can change a bit. Never build with --use_fast_math.
//
// What bounds it: bytes. Quantize reads 4 B per f32 element and writes
// bits/8 B of codes plus 8 B of scale and zero per group; dequantize reads
// those and writes 4 B per element. At the main shape, a (16384, 1024)
// f32 matrix at 4 bits in groups of 64, quantize moves 77.6 MB, 0.0232 ms
// at 3.35 TB/s; a handful of operations per element is far below the
// card's ~20 f32 operations per byte. So each element is read from device
// memory once and the threads of a warp touch neighbouring addresses:
//   * quantize_cols (V-style, axis 1, groups of gs contiguous columns):
//     the matrix is read as one flat run of groups, each taken by L
//     neighbouring lanes (L a power of two up to 32) in units of U values
//     (U = 4 where 4 divides gs, else 2 or 1), lane l taking units l,
//     l + L, ... At the model's groups (64, and a state's 16) a lane takes
//     one unit of 4 values, so a warp reads 512 contiguous bytes. min and
//     max meet by xor shuffles within the L lanes; each lane quantizes
//     its first two units from registers (a larger group's further units
//     are read again) and stores each unit's codes as one 4-, 2- or
//     1-byte word, so a warp's stores are contiguous; the group's first
//     lane writes scale and zero.
//   * quantize_rows (K-style, axis 0, groups of gs rows): a block stages
//     up to 256 rows of a group times 128 columns in shared memory, a warp
//     reading a row's 512 contiguous bytes; two threads a column take min
//     and max over half the staged rows each, then each thread packs cpb
//     rows of a column into a byte from the stage, so a warp stores 32
//     contiguous bytes of a packed row. A group above 256 rows is staged
//     in pieces of 256 rows for min and max, then its pieces are packed
//     last first (the last is still staged; the others are staged again).
//   * A thread reads its values with 4-byte loads: on an H100 16-byte
//     loads (where alignment allows) took the same time at the main shape
//     (PERF.md), and 4-byte loads take any alignment and column count.
//   * Min and max are exact in any order, and every element takes the
//     same intrinsics in the same order, so the codes, scales and zeros
//     are bit-equal to the plain version at every layout.
//   * Dequantize writes 8 times what it reads at 4 bits, so its stores are
//     what must be wide: every warp store is 512 contiguous bytes, and no
//     element does a 64-bit division (each group is found once a unit, by
//     the grid for K and by a shift or a 32-bit division for V).
//     dequantize_cols (V-style) reads the output as a flat run: a thread
//     takes units of 4 values (4/cpb packed bytes in, one float4 out);
//     dequantize_rows (K-style) gives a thread 4 columns of a group, its
//     scales and zeros held as float4, and walks the group's packed rows,
//     one 4-byte load and cpb float4 stores a row. The stores stream
//     (__stcs, evict-first): the output is read by the next kernel at the
//     earliest, and on an H100 plain stores took 1.07-2.1 times as long at
//     (16384, 1024) (PERF.md). Layouts off those
//     paths (a V group not a multiple of 4, a K column count not a
//     multiple of 4, unaligned pointers) go a value at a time in the same
//     kernels. Every value is __fmaf_rn(code, scale, zero), bit-equal to
//     the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t quant_code(float v, float zero,
                                               float safe, float qmax) {
  float q = rintf(__fdiv_rn(__fsub_rn(v, zero), safe));
  return static_cast<uint32_t>(fminf(fmaxf(q, 0.0f), qmax));
}

constexpr int kHeld = 2;   // units a lane of quantize_cols keeps in registers

// V-style: x (rows, cols) read as n_groups = rows * cols / gs groups of gs
// contiguous values, group g taken by the 2^shift lanes of threads
// g * 2^shift ..., in units of U values (U divides gs; cpb divides U).
// packed (rows, cols/cpb) holds group g's codes from byte g * gs / cpb,
// scale/zero (rows, cols/gs) its scale and zero at g.
template <int BITS, int U>
__global__ void __launch_bounds__(kThreads)
    quantize_cols(const float* __restrict__ x, uint8_t* __restrict__ packed,
                  float* __restrict__ scale, float* __restrict__ zero,
                  int64_t n_groups, int gs, int shift, float inv_levels) {
  constexpr int CPB = 8 / BITS;
  constexpr float QMAX = static_cast<float>((1 << BITS) - 1);
  static_assert(U % CPB == 0, "a unit's codes fill whole bytes");
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int lanes = 1 << shift;
  const int lane = static_cast<int>(t & (lanes - 1));
  const int64_t g = t >> shift;
  // lanes past the end take part in the shuffles (whole groups of them,
  // since lanes divides 32) and store nothing
  const bool valid = g < n_groups;
  const int units = valid ? gs / U : 0;
  const float* xg = x + g * gs;

  float held[kHeld][U];
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int u = lane + k * lanes;
    if (u < units) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        held[k][j] = xg[u * U + j];
        mn = fminf(mn, held[k][j]);
        mx = fmaxf(mx, held[k][j]);
      }
    }
  }
  for (int u = lane + kHeld * lanes; u < units; u += lanes) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      mn = fminf(mn, xg[u * U + j]);
      mx = fmaxf(mx, xg[u * U + j]);
    }
  }
  for (int o = lanes / 2; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (!valid) return;
  const float s = __fmul_rn(__fsub_rn(mx, mn), inv_levels);
  const float safe = s > 0.0f ? s : 1.0f;
  uint8_t* pg = packed + g * (gs / CPB);
  // one unit's codes, U * BITS = 32, 16 or 8 bits, as one store
  const auto store = [&](int u, const float* v) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < U; ++j)
      word |= quant_code(v[j], mn, safe, QMAX) << (j * BITS);
    uint8_t* dst = pg + u * (U / CPB);
    if constexpr (U * BITS == 32) {
      *reinterpret_cast<uint32_t*>(dst) = word;
    } else if constexpr (U * BITS == 16) {
      *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(word);
    } else {
      *dst = static_cast<uint8_t>(word);
    }
  };
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int u = lane + k * lanes;
    if (u < units) store(u, held[k]);
  }
  for (int u = lane + kHeld * lanes; u < units; u += lanes) {
    float v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) v[j] = xg[u * U + j];
    store(u, v);
  }
  if (lane == 0) {
    scale[g] = s;
    zero[g] = mn;
  }
}

constexpr int kStageCols = 128;   // columns a block of quantize_rows
constexpr int kStageRows = 256;   // rows of a group staged at a time

// Shared memory of quantize_rows: the (rows, kStageCols) stage and the
// second half's min and max of each column.
inline int stage_bytes(int rows) {
  return (rows * kStageCols + 2 * kStageCols) *
         static_cast<int>(sizeof(float));
}

// K-style, staged: x (rows, cols), groups of gs rows. Block (group, column
// tile) stages up to kStageRows of the group's rows of kStageCols columns
// at a time (thread: a float4 column of every 8th row); thread (column,
// half) takes min and max over half of each staged piece, then packs bytes
// cpb rows at a time. packed (rows/cpb, cols), scale/zero (rows/gs, cols).
template <int BITS>
__global__ void __launch_bounds__(kThreads)
    quantize_rows(const float* __restrict__ x, uint8_t* __restrict__ packed,
                  float* __restrict__ scale, float* __restrict__ zero,
                  int64_t cols, int gs, float inv_levels) {
  constexpr int CPB = 8 / BITS;
  constexpr float QMAX = static_cast<float>((1 << BITS) - 1);
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);
  const int stage_rows = gs < kStageRows ? gs : kStageRows;
  float* half_mm = st + stage_rows * kStageCols;
  const int64_t grp = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kStageCols;
  const float* xg = x + grp * gs * cols + c0;
  const int64_t left = cols - c0;   // columns of this tile
  const int n = left < kStageCols ? static_cast<int>(left) : kStageCols;
  const int q = 4 * (threadIdx.x % 32);   // the thread's 4 staged columns
  const int col = threadIdx.x % kStageCols;
  const int half = threadIdx.x / kStageCols;   // kThreads = 2 kStageCols

  // rows [r0, r0 + pr) of the group into the stage
  const auto stage = [&](int r0, int pr) {
#pragma unroll 4
    for (int r = threadIdx.x / 32; r < pr; r += kThreads / 32) {
      const float* src = xg + (r0 + r) * cols + q;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < n) v.x = src[0];
      if (q + 1 < n) v.y = src[1];
      if (q + 2 < n) v.z = src[2];
      if (q + 3 < n) v.w = src[3];
      *reinterpret_cast<float4*>(st + r * kStageCols + q) = v;
    }
  };

  float mn = INFINITY, mx = -INFINITY;
  int last = 0;   // first row of the piece left in the stage
  for (int r0 = 0; r0 < gs; r0 += kStageRows) {
    const int pr = gs - r0 < kStageRows ? gs - r0 : kStageRows;
    if (r0 > 0) __syncthreads();   // the last piece is read
    stage(r0, pr);
    __syncthreads();
    for (int r = half ? pr / 2 : 0; r < (half ? pr : pr / 2); ++r) {
      const float v = st[r * kStageCols + col];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    last = r0;
  }
  if (half) {
    half_mm[col] = mn;
    half_mm[kStageCols + col] = mx;
  }
  __syncthreads();
  if (!half) {
    mn = fminf(mn, half_mm[col]);
    mx = fmaxf(mx, half_mm[kStageCols + col]);
    half_mm[col] = mn;
    half_mm[kStageCols + col] = mx;
    if (col < n) {
      scale[grp * cols + c0 + col] =
          __fmul_rn(__fsub_rn(mx, mn), inv_levels);
      zero[grp * cols + c0 + col] = mn;
    }
  }
  __syncthreads();
  mn = half_mm[col];
  mx = half_mm[kStageCols + col];
  const float s = __fmul_rn(__fsub_rn(mx, mn), inv_levels);
  const float safe = s > 0.0f ? s : 1.0f;
  uint8_t* pg = packed + grp * (gs / CPB) * cols + c0 + col;
  for (int r0 = last; r0 >= 0; r0 -= kStageRows) {
    const int pr = gs - r0 < kStageRows ? gs - r0 : kStageRows;
    if (r0 != last) {
      __syncthreads();   // the stage's piece is packed
      stage(r0, pr);
      __syncthreads();
    }
    if (col < n) {
      for (int pb = half; pb < pr / CPB; pb += 2) {
        uint32_t byte = 0;
#pragma unroll
        for (int j = 0; j < CPB; ++j)
          byte |= quant_code(st[(pb * CPB + j) * kStageCols + col], mn,
                             safe, QMAX)
                  << (j * BITS);
        pg[(r0 / CPB + pb) * cols] = static_cast<uint8_t>(byte);
      }
    }
  }
}

// The code at bit offset pos of a packed word, as f32: OR-ed into the
// mantissa of 2^23 and 2^23 taken away again, exactly.
template <int BITS>
__device__ __forceinline__ float code_at(uint32_t x, int pos) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  return __uint_as_float(0x4b000000u | ((x >> pos) & MASK)) - 8388608.0f;
}

constexpr int kDqCols = 128;     // columns a block of dequantize_rows
constexpr int kDqSlices = kThreads / (kDqCols / 4);   // 8 packed-row slices

// K-style inverse: packed (rows/cpb, cols), scale/zero (rows/gs, cols) ->
// out (rows, cols). Block (group, column tiles of kDqCols: blockIdx.y and
// every gridDim.y-th after it); thread (lane, slice) takes columns
// 4 lane .. 4 lane + 3 of a tile and the group's packed rows slice,
// slice + kDqSlices, ... With cols a multiple of 4 (wide) it holds the
// group's scales and zeros of its columns as float4, reads a packed row's
// 4 bytes as one word and stores each of its cpb rows of 4 values as one
// float4, so a warp reads 128 and stores 512 contiguous bytes; other
// column counts go a column at a time.
template <int BITS>
__device__ __forceinline__ void dequantize_rows_tile(
    const uint8_t* __restrict__ packed, const float* __restrict__ scale,
    const float* __restrict__ zero, float* __restrict__ out, int64_t cols,
    int gs, bool wide, int64_t grp, int64_t c, int slice) {
  constexpr int CPB = 8 / BITS;
  const int prows = gs / CPB;   // packed rows of the group
  const uint8_t* pg = packed + grp * prows * cols + c;
  float* og = out + grp * gs * cols + c;
  if (wide) {
    const float4 s = *reinterpret_cast<const float4*>(scale + grp * cols + c);
    const float4 z = *reinterpret_cast<const float4*>(zero + grp * cols + c);
#pragma unroll 4
    for (int pr = slice; pr < prows; pr += kDqSlices) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(pg + pr * cols);
#pragma unroll
      for (int j = 0; j < CPB; ++j) {
        const int b = j * BITS;
        __stcs(reinterpret_cast<float4*>(og + (pr * CPB + j) * cols),
            make_float4(__fmaf_rn(code_at<BITS>(x, b), s.x, z.x),
                        __fmaf_rn(code_at<BITS>(x, 8 + b), s.y, z.y),
                        __fmaf_rn(code_at<BITS>(x, 16 + b), s.z, z.z),
                        __fmaf_rn(code_at<BITS>(x, 24 + b), s.w, z.w)));
      }
    }
    return;
  }
  const int n = cols - c < 4 ? static_cast<int>(cols - c) : 4;
  for (int k = 0; k < n; ++k) {
    const float s = scale[grp * cols + c + k], z = zero[grp * cols + c + k];
    for (int pr = slice; pr < prows; pr += kDqSlices) {
      const uint32_t x = pg[pr * cols + k];
#pragma unroll
      for (int j = 0; j < CPB; ++j)
        og[(pr * CPB + j) * cols + k] =
            __fmaf_rn(code_at<BITS>(x, j * BITS), s, z);
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows(const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ out,
                    int64_t cols, int gs, bool wide) {
  const int64_t grp = blockIdx.x;
  const int slice = threadIdx.x / (kDqCols / 4);
  for (int64_t c = static_cast<int64_t>(blockIdx.y) * kDqCols +
                   4 * (threadIdx.x % (kDqCols / 4));
       c < cols; c += static_cast<int64_t>(gridDim.y) * kDqCols)
    dequantize_rows_tile<BITS>(packed, scale, zero, out, cols, gs, wide,
                               grp, c, slice);
}

constexpr int kDqUnits = 4;   // units of 4 values a thread of _cols

// V-style inverse: the (rows, cols) output read as one flat run of values,
// value e the code at bits (e % cpb) * bits of packed byte e / cpb, in
// group e / gs (groups never straddle rows). A thread takes kDqUnits units
// of 4 values, unit u = 4 values from e = 4 u: 4 / cpb packed bytes in
// (one load where the packed base is aligned to them, else a byte at a
// time) and one float4 store out; neighbouring lanes take neighbouring
// units, so a warp stores 512 contiguous bytes. Where 4 divides gs a unit
// lies in group u / (gs / 4) (a shift where gs / 4 is a power of two,
// upg_shift >= 0) and reads its scale and zero once; else each value finds
// its own group. The last n_values % 4 values take the same path a value
// at a time. Index I is uint32_t below 2^32 values, else uint64_t.
template <int BITS, typename I>
__global__ void __launch_bounds__(kThreads)
    dequantize_cols(const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ out,
                    I n_values, int gs, int upg_shift, bool aligned) {
  constexpr int CPB = 8 / BITS;
  constexpr int UB = 4 / CPB;   // packed bytes a unit
  const I n_units = (n_values + 3) / 4;
  const I u0 = static_cast<I>(blockIdx.x) * (kThreads * kDqUnits) +
               threadIdx.x;
  uint32_t x[kDqUnits];
#pragma unroll
  for (int k = 0; k < kDqUnits; ++k) {
    const I u = u0 + k * kThreads;
    x[k] = 0;
    if (u >= n_units) continue;
    const uint8_t* src = packed + u * UB;
    if (aligned && 4 * u + 4 <= n_values) {
      if constexpr (UB == 4) {
        x[k] = *reinterpret_cast<const uint32_t*>(src);
      } else if constexpr (UB == 2) {
        x[k] = *reinterpret_cast<const uint16_t*>(src);
      } else {
        x[k] = *src;
      }
    } else {
      const int nb = static_cast<int>((n_values - 4 * u + CPB - 1) / CPB);
      for (int i = 0; i < nb && i < UB; ++i)
        x[k] |= uint32_t(src[i]) << (8 * i);
    }
  }
#pragma unroll
  for (int k = 0; k < kDqUnits; ++k) {
    const I u = u0 + k * kThreads, e = 4 * u;
    if (u >= n_units) continue;
    if (e + 4 <= n_values && gs % 4 == 0) {
      const I g = upg_shift >= 0 ? u >> upg_shift : u / static_cast<I>(gs / 4);
      const float s = scale[g], z = zero[g];
      __stcs(reinterpret_cast<float4*>(out + e),
          make_float4(__fmaf_rn(code_at<BITS>(x[k], 0), s, z),
                      __fmaf_rn(code_at<BITS>(x[k], BITS), s, z),
                      __fmaf_rn(code_at<BITS>(x[k], 2 * BITS), s, z),
                      __fmaf_rn(code_at<BITS>(x[k], 3 * BITS), s, z)));
      continue;
    }
    for (int i = 0; i < 4 && e + i < n_values; ++i) {
      const I g = (e + i) / static_cast<I>(gs);
      out[e + i] = __fmaf_rn(code_at<BITS>(x[k], i * BITS), scale[g],
                             zero[g]);
    }
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <int BITS, int U>
void launch_cols(const float* x, uint8_t* packed, float* scale, float* zero,
                 int64_t n_groups, int gs, float inv_levels,
                 cudaStream_t stream) {
  // the least power of two of lanes that gives each a unit, up to a warp
  int shift = 0;
  while (shift < 5 && (1 << shift) < gs / U) ++shift;
  quantize_cols<BITS, U><<<blocks_for(n_groups << shift), kThreads, 0,
                           stream>>>(x, packed, scale, zero, n_groups, gs,
                                     shift, inv_levels);
}

template <int BITS>
cudaError_t launch_quantize(const float* x, uint8_t* packed, float* scale,
                            float* zero, int64_t rows, int64_t cols, int gs,
                            int axis, float inv_levels,
                            cudaStream_t stream) {
  if (axis == 0) {
    // the most any group takes, raised once (a function-local static)
    static const cudaError_t smem_err = cudaFuncSetAttribute(
        quantize_rows<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stage_bytes(kStageRows));
    if (smem_err != cudaSuccess) return smem_err;
    const dim3 grid(static_cast<unsigned>(rows / gs),
                    static_cast<unsigned>((cols + kStageCols - 1) /
                                          kStageCols));
    quantize_rows<BITS><<<grid, kThreads,
                          stage_bytes(gs < kStageRows ? gs : kStageRows),
                          stream>>>(x, packed, scale, zero, cols, gs,
                                    inv_levels);
    return cudaGetLastError();
  }
  // the unit: 4 values where 4 divides gs, else 2 or 1 (shape_ok makes cpb
  // divide gs, so cpb divides the unit)
  const int64_t n_groups = rows * (cols / gs);
  if (gs % 4 == 0) {
    launch_cols<BITS, 4>(x, packed, scale, zero, n_groups, gs, inv_levels,
                         stream);
  } else if constexpr (BITS != 2) {
    if (gs % 2 == 0) {
      launch_cols<BITS, 2>(x, packed, scale, zero, n_groups, gs, inv_levels,
                           stream);
    } else if constexpr (BITS == 8) {
      launch_cols<BITS, 1>(x, packed, scale, zero, n_groups, gs, inv_levels,
                           stream);
    }
  }
  return cudaGetLastError();
}

template <int BITS>
void launch_dequantize(const uint8_t* packed, const float* scale,
                       const float* zero, float* out, int64_t rows,
                       int64_t cols, int gs, int axis, cudaStream_t stream) {
  if (axis == 0) {
    const bool wide = cols % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(zero) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int64_t tiles = (cols + kDqCols - 1) / kDqCols;
    const dim3 grid(static_cast<unsigned>(rows / gs),
                    static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
    dequantize_rows<BITS><<<grid, kThreads, 0, stream>>>(packed, scale, zero,
                                                         out, cols, gs, wide);
    return;
  }
  const int64_t n_values = rows * cols;
  const int upg = gs / 4;   // units a group, where 4 divides gs
  // log2(upg) where that is a power of two, else -1
  const int upg_shift = gs % 4 == 0 && (upg & (upg - 1)) == 0
                            ? __builtin_ctz(static_cast<unsigned>(upg))
                            : -1;
  const bool aligned =
      reinterpret_cast<uintptr_t>(packed) % (4 / (8 / BITS)) == 0;
  const int64_t units = (n_values + 3) / 4;
  const unsigned blocks = static_cast<unsigned>(
      (units + kThreads * kDqUnits - 1) / (kThreads * kDqUnits));
  if (n_values < (int64_t{1} << 32)) {
    dequantize_cols<BITS, uint32_t><<<blocks, kThreads, 0, stream>>>(
        packed, scale, zero, out, static_cast<uint32_t>(n_values), gs,
        upg_shift, aligned);
  } else {
    dequantize_cols<BITS, uint64_t><<<blocks, kThreads, 0, stream>>>(
        packed, scale, zero, out, static_cast<uint64_t>(n_values), gs,
        upg_shift, aligned);
  }
}

bool shape_ok(int64_t rows, int64_t cols, int bits, int gs, int axis) {
  if (bits != 2 && bits != 4 && bits != 8) return false;
  if (axis != 0 && axis != 1) return false;
  const int cpb = 8 / bits;
  const int64_t grouped = axis == 0 ? rows : cols;
  return rows > 0 && cols > 0 && gs > 0 && gs % cpb == 0 &&
         grouped % gs == 0;
}

}  // namespace

// (rows, cols) is the shape of the f32 matrix x; the caller allocates the
// outputs at the shapes given above each kernel. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape or bit width the kernels do not take).
extern "C" int kivi_quantize(const void* x, void* packed, void* scale,
                             void* zero, int64_t rows, int64_t cols,
                             int bits, int group_size, int axis,
                             float inv_levels, void* stream) {
  if (!shape_ok(rows, cols, bits, group_size, axis))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* p = static_cast<uint8_t*>(packed);
  auto* s = static_cast<float*>(scale);
  auto* z = static_cast<float*>(zero);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2: err = launch_quantize<2>(xf, p, s, z, rows, cols, group_size,
                                     axis, inv_levels, st); break;
    case 4: err = launch_quantize<4>(xf, p, s, z, rows, cols, group_size,
                                     axis, inv_levels, st); break;
    default: err = launch_quantize<8>(xf, p, s, z, rows, cols, group_size,
                                      axis, inv_levels, st); break;
  }
  return static_cast<int>(err);
}

// (rows, cols) is the shape of the f32 output.
extern "C" int kivi_dequantize(const void* packed, const void* scale,
                               const void* zero, void* out, int64_t rows,
                               int64_t cols, int bits, int group_size,
                               int axis, void* stream) {
  if (!shape_ok(rows, cols, bits, group_size, axis))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  const auto* z = static_cast<const float*>(zero);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_dequantize<2>(p, s, z, o, rows, cols, group_size, axis,
                                 st); break;
    case 4: launch_dequantize<4>(p, s, z, o, rows, cols, group_size, axis,
                                 st); break;
    default: launch_dequantize<8>(p, s, z, o, rows, cols, group_size, axis,
                                  st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
