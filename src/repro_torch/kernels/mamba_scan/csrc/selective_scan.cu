// Selective scan (the mamba-1 recurrence) for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel selective_scan (body _scan_kernel) of
// src/repro/kernels/mamba_scan/kernel.py:66. Per (batch b, channel d,
// state n), in f32:
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = sum_n C_t h_t
// dt, x (B, S, D); bs, cs (B, S, N); a (D, N), negative; h0 (B, D, N)
// -> y (B, S, D) and hT (B, D, N), all f32, contiguous. The operation
// order is the plain version's (ref.py), expf included.
//
// What bounds it. Three floors, at B 1, D 8192, N 16 (S 640 / S 4096):
// - bytes: dt, x, bs, cs, a, h0 read once, y and hT written once,
//   4 (3 B S D + 2 B S N + D N + 2 B D N) bytes: 0.0193 / 0.121 ms at
//   3.35 TB/s;
// - the SFU: every (t, d, n) step needs one exponential, B S D N of them,
//   and each SM's special-function units take 16 a clock: 0.020 / 0.128 ms
//   at 1.98 GHz, already above the bytes;
// - instruction issue, which is what this kernel meets: four
//   warp-instructions a clock on each SM. A group of kSub steps of P = 4
//   states takes 478 instructions, 15 a (t, d, n) step, of which the
//   accurate expf is 8 (a floor-based range reduction in FMAs around one
//   SFU exponential) and the recurrence 4 (PERF.md).
//
// What the design does about each. The TPU kernel runs an associative
// scan within each time chunk because the TPU is slow at long serial
// loops; here the serial chain is one FMA a step, so each thread walks
// time in order and the work is to spend as few instructions a step as
// the accurate exponential allows:
// - the decay factor stays the plain version's expf(dt a). Taking it as one
//   ex2.approx of dt a log2 e (the public Mamba CUDA kernel's form, one
//   instruction) or with a floor reduction around it (seven) is 10-22 %
//   faster, and no further from an f64 recurrence than the plain version
//   is; but such factors differ from expf's by an ulp or two, which 4096
//   slowly decaying steps compound to 6e-4 - 2e-3 of y, beyond the
//   rtol = atol = 1e-4 that the plain version is held to (PERF.md).
// - a thread owns kStatesPerThread (P) states of one channel, so a
//   channel's N states sit on N / P adjacent lanes. Fewer states a thread
//   means more warps at B 1 (D N / P threads) but more instructions a
//   state; P = 4 was the fastest of 1, 2 and 4 on the card (PERF.md).
// - y_t is summed over a channel's lanes by a reduce-scatter: kSub steps'
//   partial sums at a time, each shuffle level swaps half of the remaining
//   sums with the partner lane and adds the other half, so log2(kLanes)
//   levels cost kSub - 1 shuffles in all (not kSub a level) and leave each
//   step's sum on one lane, which stores it.
// - time goes in chunks of kChunk steps. A chunk's dt and x (for the
//   block's channels) and its B and C rows are copied into shared memory
//   with cp.async, 16 bytes a copy where the shapes and pointers allow it
//   (4 bytes otherwise; that path alone is 28 % slower at B 1, S 640,
//   PERF.md), kStages chunks ahead: no registers hold them in flight, a thread
//   spends a few instructions a chunk on them, and one barrier a chunk
//   suffices. Rows past S and channels past D are zero-filled by the copy
//   (dt = 0 gives a factor of 1 and no input, so h is unchanged).
// - within a chunk, kSub steps at a time: their exps and input terms first
//   (none depends on h, so they overlap), then the FMA chain over h, then
//   the sums. (Unrolling a chunk's groups and issuing the next group's
//   exps before this group's chain did not help: the kernel is bound by
//   issue, not by latency; PERF.md.)
// - any S, any D and any B; N must divide 32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSub = 8;               // time steps whose exps go together
constexpr int kStages = 3;            // chunks in shared memory at once
constexpr int kStatesPerThread = 4;   // P, measured on the card (PERF.md)

template <int N, int P>
struct Tile {
  static_assert(32 % N == 0 && N % P == 0, "N divides 32, P divides N");
  static constexpr int kLanes = N / P;                 // lanes a channel spans
  static constexpr int kCh = kThreads / kLanes;        // channels a block owns
  static constexpr int kChunk = kCh > 32 ? 1024 / kCh : 32;  // steps a chunk
  static constexpr int kOut = kSub > kLanes ? kSub / kLanes : 1;  // sums a lane keeps
  static constexpr int kCopies = kLanes > kSub ? kLanes / kSub : 1;  // lanes holding each
  static_assert(kChunk % kSub == 0, "a chunk holds whole groups of steps");
  static_assert(kCh % 4 == 0 && kChunk * N % 4 == 0, "16-byte copies");
};

// One chunk in shared memory; every array is a multiple of 16 bytes.
template <int N, int P>
struct Stage {
  float dt[Tile<N, P>::kChunk * Tile<N, P>::kCh];
  float x[Tile<N, P>::kChunk * Tile<N, P>::kCh];
  float b[Tile<N, P>::kChunk * N];
  float c[Tile<N, P>::kChunk * N];
};

// cp.async of W floats (W = 4 or 1) from global to shared; of them, the
// first `bytes` are read and the rest are zero-filled.
template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of this thread's copy groups are in flight.
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

struct Src {
  const float* __restrict__ dt;
  const float* __restrict__ x;
  const float* __restrict__ bs;
  const float* __restrict__ cs;
  int64_t row0;   // (b, t = 0) row of dt, x, bs, cs
  int d0, S, D;
};

// Starts the copies of the chunk at t0 into `s`, W floats a copy (W = 4
// needs D and S N to be multiples of 4 and 16-byte aligned pointers).
// Copies wholly past S or D read nothing and point at row 0.
template <int N, int P, int W>
__device__ __forceinline__ void issue(Stage<N, P>& s, const Src& g, int t0,
                                      int tid) {
  using T = Tile<N, P>;
  constexpr int kRowPieces = T::kCh / W;
  constexpr int kPieces = T::kChunk * kRowPieces;
#pragma unroll
  for (int k = 0; k < (kPieces + kThreads - 1) / kThreads; ++k) {
    const int q = tid + k * kThreads;
    if (kPieces % kThreads == 0 || q < kPieces) {
      const int row = q / kRowPieces, col = (q % kRowPieces) * W;
      const int t = t0 + row, dd = g.d0 + col;
      const bool ok = t < g.S && dd < g.D;
      const int64_t off = ok ? (g.row0 + t) * g.D + dd : g.row0 * g.D;
      const int bytes = ok ? 4 * W : 0;
      copy_async<W>(&s.dt[row * T::kCh + col], g.dt + off, bytes);
      copy_async<W>(&s.x[row * T::kCh + col], g.x + off, bytes);
    }
  }
  constexpr int kBcPieces = T::kChunk * N / W;
  const int n_valid = (g.S - t0 < T::kChunk ? g.S - t0 : T::kChunk) * N;
#pragma unroll
  for (int k = 0; k < (kBcPieces + kThreads - 1) / kThreads; ++k) {
    const int q = tid + k * kThreads;
    if (kBcPieces % kThreads == 0 || q < kBcPieces) {
      const int left = n_valid - q * W;              // valid floats from here
      const int bytes = left <= 0 ? 0 : 4 * (left < W ? left : W);
      const int64_t off = bytes ? (g.row0 + t0) * N + q * W : g.row0 * N;
      copy_async<W>(&s.b[q * W], g.bs + off, bytes);
      copy_async<W>(&s.c[q * W], g.cs + off, bytes);
    }
  }
}

// P consecutive states' values from shared memory in one load.
template <int P>
__device__ __forceinline__ void load_states(const float* s, float (&v)[P]) {
  if constexpr (P == 4) {
    const float4 q = *reinterpret_cast<const float4*>(s);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (P == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = s[p];
  }
}

// Sums acc over a channel's lanes (offsets Off, Off / 2, ..., 1). While a
// lane holds more than one partial sum, a level swaps half of them with
// the partner lane: the lane whose Off bit is set keeps the upper half,
// the other the lower, and each adds what it receives; after that, plain
// butterfly levels. On return acc[0 .. kOut) are the full sums of steps
// base + j.
template <int Cnt, int Off, int K>
__device__ __forceinline__ void reduce_scatter(float (&acc)[K], int lane,
                                               int& base) {
  if constexpr (Off > 0) {
    if constexpr (Cnt > 1) {
      constexpr int kHalf = Cnt / 2;
      const bool up = (lane & Off) != 0;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float send = up ? acc[j] : acc[j + kHalf];
        const float keep = up ? acc[j + kHalf] : acc[j];
        acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
      }
      base += up ? kHalf : 0;
      reduce_scatter<kHalf, Off / 2>(acc, lane, base);
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], Off);
      reduce_scatter<1, Off / 2>(acc, lane, base);
    }
  }
}

template <int N, int P, int W>
__global__ void __launch_bounds__(kThreads)
    scan_fwd(const float* __restrict__ dt, const float* __restrict__ x,
             const float* __restrict__ bs, const float* __restrict__ cs,
             const float* __restrict__ a, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ hT, int S, int D) {
  using T = Tile<N, P>;
  constexpr int kLanes = T::kLanes, kCh = T::kCh, kChunk = T::kChunk;
  __shared__ __align__(16) Stage<N, P> st[kStages];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int c = tid / kLanes, lane = tid % kLanes, n0 = lane * P;
  const int d = d0 + c;
  const bool live = d < D;
  const bool owner = live && lane % T::kCopies == 0;   // stores its sums
  const int64_t row0 = static_cast<int64_t>(b) * S;      // (b, t = 0)
  float* const y_d = y + row0 * D + d;

  const Src src{dt, x, bs, cs, row0, d0, S, D};
  issue<N, P, W>(st[0], src, 0, tid);
  commit_copies();
  if (kChunk < S) issue<N, P, W>(st[1], src, kChunk, tid);
  commit_copies();

  float h[P], av[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    h[p] = live ? h0[(static_cast<int64_t>(b) * D + d) * N + n0 + p] : 0.f;
    av[p] = live ? a[static_cast<int64_t>(d) * N + n0 + p] : 0.f;
  }

  int stage = 0;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    wait_copies<1>();                // this chunk's copies have landed
    __syncthreads();                 // everyone's, and the last chunk is read
    if (t0 + 2 * kChunk < S)         // into the stage read the last chunk
      issue<N, P, W>(st[stage == 0 ? kStages - 1 : stage - 1], src,
                     t0 + 2 * kChunk, tid);
    commit_copies();
    const Stage<N, P>& s = st[stage];
    stage = stage == kStages - 1 ? 0 : stage + 1;

    // kSub steps at a time: first every exp and input term of the group
    // (independent of h, so they overlap), then the FMA chain over h, then
    // the y sums. Rows past S hold zeros: their y is not stored.
    const int steps = S - t0 < kChunk ? S - t0 : kChunk;
    for (int r0 = 0; r0 < steps; r0 += kSub) {
      float da[kSub][P], u[kSub][P], cv[kSub][P], acc[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = r0 + i;
        const float dtv = s.dt[r * kCh + c];
        const float w = dtv * s.x[r * kCh + c];
        float bv[P];
        load_states<P>(&s.b[r * N + n0], bv);
        load_states<P>(&s.c[r * N + n0], cv[i]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          da[i][p] = expf(dtv * av[p]);
          u[i][p] = w * bv[p];
        }
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        acc[i] = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          h[p] = h[p] * da[i][p] + u[i][p];
          acc[i] += h[p] * cv[i][p];
        }
      }
      int base = 0;
      reduce_scatter<kSub, kLanes / 2>(acc, lane, base);
      if (owner) {
#pragma unroll
        for (int j = 0; j < T::kOut; ++j)
          if (r0 + base + j < steps)
            y_d[static_cast<int64_t>(t0 + r0 + base + j) * D] = acc[j];
      }
    }
  }

  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      hT[(static_cast<int64_t>(b) * D + d) * N + n0 + p] = h[p];
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bs,
                   const float* cs, const float* a, const float* h0,
                   float* y, float* hT, int B, int S, int D, bool wide,
                   cudaStream_t stream) {
  constexpr int kP = N < kStatesPerThread ? N : kStatesPerThread;
  constexpr int kCh = Tile<N, kP>::kCh;
  const dim3 grid((D + kCh - 1) / kCh, B);
  if (wide)
    scan_fwd<N, kP, 4><<<grid, kThreads, 0, stream>>>(dt, x, bs, cs, a, h0,
                                                      y, hT, S, D);
  else
    scan_fwd<N, kP, 1><<<grid, kThreads, 0, stream>>>(dt, x, bs, cs, a, h0,
                                                      y, hT, S, D);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  // 16-byte copies where every row and chunk starts on a 16-byte boundary
  const bool wide = D % 4 == 0 && static_cast<int64_t>(S) * N % 4 == 0 &&
                    aligned16(dt) && aligned16(x) && aligned16(bs) &&
                    aligned16(cs);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  return static_cast<int>(fn(in(dt), in(x), in(bs), in(cs), in(a), in(h0),
                             static_cast<float*>(y), static_cast<float*>(hT),
                             B, S, D, wide,
                             static_cast<cudaStream_t>(stream)));
}
