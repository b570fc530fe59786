// Selective scan (the mamba-1 recurrence) for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel selective_scan (body _scan_kernel) of
// src/repro/kernels/mamba_scan/kernel.py:66. Per (batch b, channel d,
// state n), in f32:
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = sum_n C_t h_t
// dt, x (B, S, D); bs, cs (B, S, N); a (D, N), negative; h0 (B, D, N)
// -> y (B, S, D) and hT (B, D, N), all f32, contiguous. The operation
// order is the plain version's (ref.py); expf is the accurate one (no
// fast-math).
//
// What bounds it: bytes. The scan reads dt, x, bs, cs, a, h0 once and
// writes y and hT once: 4 (3 B S D + 2 B S N + D N + 2 B D N) bytes, 405 MB
// at B 1, S 4096, D 8192, N 16, which is 0.121 ms at 3.35 TB/s; its
// 7 B S D N f32 operations take 0.056 ms at 67 TFLOP/s. Every (t, d, n)
// also needs one exp: 537 M of them at that shape, about 0.14 ms on the
// SFUs (16 a clock on each of the 132 SMs), and the accurate expf costs
// some eight instructions around each, so instruction issue, not the
// bytes, is what this first kernel will meet.
//
// What the design does about it. The TPU kernel runs an associative scan
// within each time chunk because the TPU is slow at long serial loops;
// here the serial chain is one FMA a step (4096 steps, about 20 us), so
// each thread walks time in order. The work is to fill the card and keep
// loads in flight:
// - a thread owns P = min(N, 4) states of one channel, so a channel's N
//   states sit on N / P adjacent lanes; y_t is summed over them with
//   __shfl_xor_sync. A 128-thread block covers 128 P / N channels of one
//   batch row: 256 blocks at B 1, D 8192, N 16.
// - time goes in chunks of kChunk steps. A chunk's dt and x (for the
//   block's channels) and its B and C rows are staged in shared memory;
//   the next chunk's global loads are issued into registers before the
//   current chunk's recurrence runs, so they are in flight during it.
// - within a chunk, kSub = 8 steps at a time: their 8 P exps and input
//   terms first (none depends on h, so they overlap), then the chain of
//   FMAs over h, then the 8 sums over the lanes. Taken one step at a time,
//   each step's exp, FMA and shuffles run back to back, and with only
//   about 8 warps an SM at B 1 the card mostly waits (0.876 ms at
//   B 1, S 4096 in that form, against 0.121 ms of bytes).
// - any S (the last chunk runs only its valid steps), any D (channels past
//   D compute on zeros and store nothing), any B; N must divide 32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kStaged = 1024;   // dt (and x) values a block stages a chunk
constexpr int kSub = 8;         // time steps whose exps are taken together

template <int N>
struct Tile {
  static constexpr int kP = N < 4 ? N : 4;          // states a thread owns
  static constexpr int kLanes = N / kP;             // lanes a channel spans
  static constexpr int kCh = kThreads / kLanes;     // channels a block owns
  static constexpr int kChunk = kStaged / kCh;      // time steps a chunk
  static constexpr int kDx = kStaged / kThreads;    // dt values a thread stages
  static constexpr int kBc = (kChunk * N + kThreads - 1) / kThreads;
  static_assert(kChunk % kSub == 0, "a chunk holds whole groups of steps");
};

template <int P>
__device__ __forceinline__ void load_states(const float* s, float (&v)[P]) {
  if constexpr (P == 4) {
    const float4 q = *reinterpret_cast<const float4*>(s);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = s[p];
  }
}

struct Src {
  const float* __restrict__ dt;
  const float* __restrict__ x;
  const float* __restrict__ bs;
  const float* __restrict__ cs;
  int64_t row0;   // (b, t = 0) row of dt, x, bs, cs
  int d0, S, D;
};

// One chunk's global loads into registers, all issued before any is
// stored; rows past S and channels past D read as 0.
template <int N>
__device__ __forceinline__ void fetch(const Src& g, int t0, int tid,
                                      float (&r_dt)[Tile<N>::kDx],
                                      float (&r_x)[Tile<N>::kDx],
                                      float (&r_b)[Tile<N>::kBc],
                                      float (&r_c)[Tile<N>::kBc]) {
  using T = Tile<N>;
#pragma unroll
  for (int k = 0; k < T::kDx; ++k) {
    const int e = tid + k * kThreads;
    const int t = t0 + e / T::kCh, dd = g.d0 + e % T::kCh;
    const bool ok = t < g.S && dd < g.D;
    const int64_t off = (g.row0 + t) * g.D + dd;
    r_dt[k] = ok ? g.dt[off] : 0.f;
    r_x[k] = ok ? g.x[off] : 0.f;
  }
  const int n_valid = (g.S - t0 < T::kChunk ? g.S - t0 : T::kChunk) * N;
#pragma unroll
  for (int k = 0; k < T::kBc; ++k) {
    const int e = tid + k * kThreads;
    const bool ok = e < n_valid;
    const int64_t off = (g.row0 + t0) * N + e;
    r_b[k] = ok ? g.bs[off] : 0.f;
    r_c[k] = ok ? g.cs[off] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_fwd(const float* __restrict__ dt, const float* __restrict__ x,
             const float* __restrict__ bs, const float* __restrict__ cs,
             const float* __restrict__ a, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ hT, int S, int D) {
  using T = Tile<N>;
  constexpr int kP = T::kP, kLanes = T::kLanes, kCh = T::kCh;
  constexpr int kChunk = T::kChunk, kDx = T::kDx, kBc = T::kBc;
  __shared__ float s_dt[kStaged];
  __shared__ float s_x[kStaged];
  __shared__ __align__(16) float s_b[kChunk * N];
  __shared__ __align__(16) float s_c[kChunk * N];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int c = tid / kLanes, n0 = (tid % kLanes) * kP;
  const int d = d0 + c;
  const bool live = d < D;
  const int64_t row0 = static_cast<int64_t>(b) * S;      // (b, t = 0)

  float h[kP], av[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    h[p] = live ? h0[(static_cast<int64_t>(b) * D + d) * N + n0 + p] : 0.f;
    av[p] = live ? a[static_cast<int64_t>(d) * N + n0 + p] : 0.f;
  }

  float r_dt[kDx], r_x[kDx], r_b[kBc], r_c[kBc];
  const Src src{dt, x, bs, cs, row0, d0, S, D};
  fetch<N>(src, 0, tid, r_dt, r_x, r_b, r_c);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    __syncthreads();                 // the last chunk's reads are done
#pragma unroll
    for (int k = 0; k < kDx; ++k) {
      s_dt[tid + k * kThreads] = r_dt[k];
      s_x[tid + k * kThreads] = r_x[k];
    }
#pragma unroll
    for (int k = 0; k < kBc; ++k) {
      const int e = tid + k * kThreads;
      if (e < kChunk * N) {
        s_b[e] = r_b[k];
        s_c[e] = r_c[k];
      }
    }
    __syncthreads();
    if (t0 + kChunk < S)             // in flight during the steps below
      fetch<N>(src, t0 + kChunk, tid, r_dt, r_x, r_b, r_c);

    // kSub steps at a time: first every exp and input term of the group
    // (independent of h, so they overlap), then the FMA chain over h, then
    // the y sums. Rows past S were staged as zeros: dt = 0 gives da = 1
    // and no input, so h is unchanged; their y is not stored.
    const int steps = S - t0 < kChunk ? S - t0 : kChunk;
    for (int r0 = 0; r0 < steps; r0 += kSub) {
      float da[kSub][kP], u[kSub][kP], cv[kSub][kP], acc[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = r0 + i;
        const float dtv = s_dt[r * kCh + c];
        const float dx = dtv * s_x[r * kCh + c];
        float bv[kP];
        load_states<kP>(&s_b[r * N + n0], bv);
        load_states<kP>(&s_c[r * N + n0], cv[i]);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          da[i][p] = expf(dtv * av[p]);
          u[i][p] = dx * bv[p];
        }
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        acc[i] = 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          h[p] = h[p] * da[i][p] + u[i][p];
          acc[i] += h[p] * cv[i][p];
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
      if (live && n0 == 0) {
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          if (r0 + i < steps) y[(row0 + t0 + r0 + i) * D + d] = acc[i];
      }
    }
  }

  if (live) {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      hT[(static_cast<int64_t>(b) * D + d) * N + n0 + p] = h[p];
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bs,
                   const float* cs, const float* a, const float* h0,
                   float* y, float* hT, int B, int S, int D,
                   cudaStream_t stream) {
  constexpr int kCh = Tile<N>::kCh;
  const dim3 grid((D + kCh - 1) / kCh, B);
  scan_fwd<N><<<grid, kThreads, 0, stream>>>(dt, x, bs, cs, a, h0, y, hT, S,
                                             D);
  return cudaGetLastError();
}

}  // namespace

// dt, x (B, S, D); bs, cs (B, S, N); a (D, N); h0 (B, D, N); y (B, S, D);
// hT (B, D, N); all f32 and contiguous. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue, without launching, for a shape the
// kernel does not take: N must divide 32).
extern "C" int selective_scan(const void* dt, const void* x, const void* bs,
                              const void* cs, const void* a, const void* h0,
                              void* y, void* hT, int B, int S, int D, int N,
                              void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<1>) fn = nullptr;
  switch (N) {
    case 1: fn = launch<1>; break;
    case 2: fn = launch<2>; break;
    case 4: fn = launch<4>; break;
    case 8: fn = launch<8>; break;
    case 16: fn = launch<16>; break;
    case 32: fn = launch<32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  return static_cast<int>(fn(in(dt), in(x), in(bs), in(cs), in(a), in(h0),
                             static_cast<float*>(y), static_cast<float*>(hT),
                             B, S, D, static_cast<cudaStream_t>(stream)));
}
