// Device-side unpack and group expansion of a KIVI-packed KV plane, and
// the loop that attends one key split of such a plane. The counterpart of
// _unpack_rows, _unpack_cols and _expand_groups_rows/_cols in
// src/repro/kernels/decode_attn/kernel.py:44-74; decode_attn.cu and
// ../../fused_prefill/csrc/fused_prefill.cu include it.
//
// Layout of one plane (cpb = 8 / bits codes per byte, code j of a byte at
// bit offset j * bits):
//   K packed along tokens:   kp (T/cpb, hd) u8, ks/kz (T/k_group, hd) f32;
//                            byte (t / cpb, c) holds tokens t..t+cpb-1 of
//                            channel c.
//   V packed along channels: vp (T, hd/cpb) u8, vs/vz (T, hd/v_group) f32;
//                            byte (t, c / cpb) holds channels c..c+cpb-1.
//   value = fma(code, scale, zero) in f32, rounded once, as the port's
//   KIVI dequantize kernel (kivi.cu) computes it.
// A tile of kTile tokens is dequantized once into shared memory and then
// serves every query row of the block, so the packed bytes are read from
// device memory once per block and the dequantized values never are.
#pragma once

#include "../../csrc/flash_tile.cuh"

namespace kivi_planes {

struct Plane {
  const uint8_t* kp;
  const float* ks;
  const float* kz;
  const uint8_t* vp;
  const float* vs;
  const float* vz;
};

// Plane p of plane-major (P, ...) arrays.
template <int BITS>
__device__ __forceinline__ Plane plane_at(const uint8_t* kp, const float* ks,
                                          const float* kz, const uint8_t* vp,
                                          const float* vs, const float* vz,
                                          int p, int T, int hd, int kg,
                                          int vg) {
  constexpr int CPB = 8 / BITS;
  const int64_t pp = p;
  return Plane{kp + pp * (T / CPB) * hd, ks + pp * (T / kg) * hd,
               kz + pp * (T / kg) * hd,  vp + pp * T * (hd / CPB),
               vs + pp * T * (hd / vg),  vz + pp * T * (hd / vg)};
}

// The code at bit offset pos of a packed word, as f32: OR-ed into the
// mantissa of 2^23 and 2^23 taken away again, exactly.
template <int BITS>
__device__ __forceinline__ float code_at(uint32_t x, int pos) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  return __uint_as_float(0x4b000000u | ((x >> pos) & MASK)) - 8388608.0f;
}

// The packed bytes, scale and zero of one token of the thread's channel,
// for K and for V, as read from device memory.
struct Raw {
  uint32_t kb, vb;
  float ks, kz, vs, vz;
};

// Dequantize tokens [t0, t0 + n) into the block's K and V tiles (rows
// past n are zero). Neighbouring threads take neighbouring channels, so
// the packed bytes and the scales are read coalesced; a thread keeps its
// channel, so V's byte, shift and scale column are fixed for it. Four
// tokens' loads are in flight per thread (flash::staged).
template <int BITS>
__device__ __forceinline__ void load_tile(const Plane& pl, int t0, int n,
                                          int hd, int kg, int vg,
                                          float* k_s, float* v_s) {
  constexpr int CPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int c = threadIdx.x % hd;
  const int v_byte = c / CPB, v_shift = (c % CPB) * BITS, v_col = c / vg;
  const int v_bytes = hd / CPB, v_cols = hd / vg;
  flash::staged<4>(
      threadIdx.x / hd, flash::kThreads / hd, flash::kTile,
      [&](int t) {
        if (t >= n) return Raw{0u, 0u, 0.0f, 0.0f, 0.0f, 0.0f};
        const int tok = t0 + t;
        const int64_t kg_i = static_cast<int64_t>(tok / kg) * hd + c;
        const int64_t vg_i = static_cast<int64_t>(tok) * v_cols + v_col;
        return Raw{pl.kp[static_cast<int64_t>(tok / CPB) * hd + c],
                   pl.vp[static_cast<int64_t>(tok) * v_bytes + v_byte],
                   pl.ks[kg_i], pl.kz[kg_i], pl.vs[vg_i], pl.vz[vg_i]};
      },
      [&](int t, const Raw& r) {
        const uint32_t kq = (r.kb >> (((t0 + t) % CPB) * BITS)) & MASK;
        const uint32_t vq = (r.vb >> v_shift) & MASK;
        k_s[t * (hd + 4) + c] = __fmaf_rn(static_cast<float>(kq), r.ks, r.kz);
        v_s[t * hd + c] = __fmaf_rn(static_cast<float>(vq), r.vs, r.vz);
      });
}

// Attend the block's staged query rows to tokens [t_begin, t_end) of a
// packed plane, masking tokens at or past ``cur_len`` with kNegInf.
template <int BITS, int RPW>
__device__ __forceinline__ void attend_split(flash::Rows<RPW>& st,
                                             const Plane& pl, int t_begin,
                                             int t_end, int cur_len, int hd,
                                             int kg, int vg, float scale,
                                             float* smem, int rb) {
  float* q_s = smem;
  float* k_s = q_s + rb * hd;
  float* v_s = k_s + flash::kTile * (hd + 4);
  float* p_s = v_s + flash::kTile * hd;
  for (int t0 = t_begin; t0 < t_end; t0 += flash::kTile) {
    const int n = min(flash::kTile, t_end - t0);
    __syncthreads();                    // the previous tile is consumed
    load_tile<BITS>(pl, t0, n, hd, kg, vg, k_s, v_s);
    __syncthreads();
    flash::tile_step<RPW>(st, q_s, k_s, v_s, p_s, hd, scale,
                          [=](int, int t, float s) {
                            return t >= n ? -INFINITY
                                          : (t0 + t < cur_len
                                                 ? s : flash::kNegInf);
                          });
  }
}

inline bool layout_ok(int T, int hd, int bits, int kg, int vg) {
  if (bits != 2 && bits != 4 && bits != 8) return false;
  const int cpb = 8 / bits;
  return T > 0 && flash::hd_ok(hd) && kg > 0 && vg > 0 && T % kg == 0 &&
         kg % cpb == 0 && hd % vg == 0 && vg % cpb == 0;
}

}  // namespace kivi_planes
