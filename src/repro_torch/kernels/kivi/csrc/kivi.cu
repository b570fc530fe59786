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
// those and writes 4 B per element. A handful of operations per element
// is far below the card's ~20 operations per byte of HBM bandwidth in
// f32, so 3.35 TB/s sets the floor. What the design does about it: each
// element is read from HBM once and each output written once; the threads
// of a warp touch neighbouring addresses wherever the layout allows:
//   * K-style (axis 0, grouped along rows): one thread per (group,
//     column). Each of its group_size row reads is coalesced across the
//     warp's 32 neighbouring columns; the second pass over the group
//     re-reads it from L1/L2, not from HBM.
//   * V-style (axis 1, grouped along contiguous columns): one thread per
//     (row, group), walking its group_size contiguous floats.
//   * Dequantize: one thread per packed byte, writing its cpb values.
// Vectorised loads, TMA and wider tiles are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t quant_code(float v, float zero,
                                               float safe, float qmax) {
  float q = rintf(__fdiv_rn(__fsub_rn(v, zero), safe));
  return static_cast<uint32_t>(fminf(fmaxf(q, 0.0f), qmax));
}

// K-style: x (rows, cols), groups of gs rows. packed (rows/cpb, cols),
// scale/zero (rows/gs, cols).
template <int BITS>
__global__ void quantize_rows(const float* __restrict__ x,
                              uint8_t* __restrict__ packed,
                              float* __restrict__ scale,
                              float* __restrict__ zero, int64_t n_groups,
                              int64_t cols, int gs, float inv_levels) {
  constexpr int CPB = 8 / BITS;
  constexpr float QMAX = static_cast<float>((1 << BITS) - 1);
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= n_groups * cols) return;
  const int64_t grp = idx / cols;
  const int64_t col = idx - grp * cols;
  const float* xg = x + grp * gs * cols + col;

  float mn = xg[0];
  float mx = mn;
  for (int r = 1; r < gs; ++r) {
    const float v = xg[r * cols];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  const float s = __fmul_rn(__fsub_rn(mx, mn), inv_levels);
  const float safe = s > 0.0f ? s : 1.0f;
  scale[grp * cols + col] = s;
  zero[grp * cols + col] = mn;

  uint8_t* pg = packed + grp * (gs / CPB) * cols + col;
  for (int r = 0; r < gs; r += CPB) {
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < CPB; ++j)
      byte |= quant_code(xg[(r + j) * cols], mn, safe, QMAX) << (j * BITS);
    pg[(r / CPB) * cols] = static_cast<uint8_t>(byte);
  }
}

// V-style: x (rows, cols), groups of gs contiguous columns. packed
// (rows, cols/cpb), scale/zero (rows, cols/gs).
template <int BITS>
__global__ void quantize_cols(const float* __restrict__ x,
                              uint8_t* __restrict__ packed,
                              float* __restrict__ scale,
                              float* __restrict__ zero, int64_t rows,
                              int64_t cols, int gs, float inv_levels) {
  constexpr int CPB = 8 / BITS;
  constexpr float QMAX = static_cast<float>((1 << BITS) - 1);
  const int64_t groups_per_row = cols / gs;
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= rows * groups_per_row) return;
  const int64_t row = idx / groups_per_row;
  const int64_t grp = idx - row * groups_per_row;
  const float* xg = x + row * cols + grp * gs;

  float mn = xg[0];
  float mx = mn;
  for (int c = 1; c < gs; ++c) {
    const float v = xg[c];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  const float s = __fmul_rn(__fsub_rn(mx, mn), inv_levels);
  const float safe = s > 0.0f ? s : 1.0f;
  scale[idx] = s;
  zero[idx] = mn;

  uint8_t* pg = packed + row * (cols / CPB) + grp * (gs / CPB);
  for (int c = 0; c < gs; c += CPB) {
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < CPB; ++j)
      byte |= quant_code(xg[c + j], mn, safe, QMAX) << (j * BITS);
    pg[c / CPB] = static_cast<uint8_t>(byte);
  }
}

// K-style inverse: one thread per packed byte (p, col) of (rows/cpb, cols).
template <int BITS>
__global__ void dequantize_rows(const uint8_t* __restrict__ packed,
                                const float* __restrict__ scale,
                                const float* __restrict__ zero,
                                float* __restrict__ out, int64_t rows,
                                int64_t cols, int gs) {
  constexpr int CPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= (rows / CPB) * cols) return;
  const int64_t p = idx / cols;
  const int64_t col = idx - p * cols;
  const int64_t grp = (p * CPB) / gs;
  const float s = scale[grp * cols + col];
  const float z = zero[grp * cols + col];
  const uint32_t byte = packed[idx];
#pragma unroll
  for (int j = 0; j < CPB; ++j) {
    const float q = static_cast<float>((byte >> (j * BITS)) & MASK);
    out[(p * CPB + j) * cols + col] = __fmaf_rn(q, s, z);
  }
}

// V-style inverse: one thread per packed byte (row, k) of (rows, cols/cpb).
template <int BITS>
__global__ void dequantize_cols(const uint8_t* __restrict__ packed,
                                const float* __restrict__ scale,
                                const float* __restrict__ zero,
                                float* __restrict__ out, int64_t rows,
                                int64_t cols, int gs) {
  constexpr int CPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int64_t bytes_per_row = cols / CPB;
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= rows * bytes_per_row) return;
  const int64_t row = idx / bytes_per_row;
  const int64_t k = idx - row * bytes_per_row;
  const int64_t g = row * (cols / gs) + (k * CPB) / gs;
  const float s = scale[g];
  const float z = zero[g];
  const uint32_t byte = packed[idx];
  float* o = out + row * cols + k * CPB;
#pragma unroll
  for (int j = 0; j < CPB; ++j) {
    const float q = static_cast<float>((byte >> (j * BITS)) & MASK);
    o[j] = __fmaf_rn(q, s, z);
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <int BITS>
void launch_quantize(const float* x, uint8_t* packed, float* scale,
                     float* zero, int64_t rows, int64_t cols, int gs,
                     int axis, float inv_levels, cudaStream_t stream) {
  if (axis == 0) {
    const int64_t n_groups = rows / gs;
    quantize_rows<BITS><<<blocks_for(n_groups * cols), kThreads, 0,
                          stream>>>(x, packed, scale, zero, n_groups, cols,
                                    gs, inv_levels);
  } else {
    quantize_cols<BITS><<<blocks_for(rows * (cols / gs)), kThreads, 0,
                          stream>>>(x, packed, scale, zero, rows, cols, gs,
                                    inv_levels);
  }
}

template <int BITS>
void launch_dequantize(const uint8_t* packed, const float* scale,
                       const float* zero, float* out, int64_t rows,
                       int64_t cols, int gs, int axis, cudaStream_t stream) {
  constexpr int CPB = 8 / BITS;
  if (axis == 0) {
    dequantize_rows<BITS><<<blocks_for((rows / CPB) * cols), kThreads, 0,
                            stream>>>(packed, scale, zero, out, rows, cols,
                                      gs);
  } else {
    dequantize_cols<BITS><<<blocks_for(rows * (cols / CPB)), kThreads, 0,
                            stream>>>(packed, scale, zero, out, rows, cols,
                                      gs);
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
  switch (bits) {
    case 2: launch_quantize<2>(xf, p, s, z, rows, cols, group_size, axis,
                               inv_levels, st); break;
    case 4: launch_quantize<4>(xf, p, s, z, rows, cols, group_size, axis,
                               inv_levels, st); break;
    default: launch_quantize<8>(xf, p, s, z, rows, cols, group_size, axis,
                                inv_levels, st); break;
  }
  return static_cast<int>(cudaGetLastError());
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
