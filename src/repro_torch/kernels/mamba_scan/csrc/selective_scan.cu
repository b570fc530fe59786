// Selective scan (the mamba-1 recurrence) for Hopper (sm_90a). Plain C
// interface, loaded with ctypes (see ../kernel.py).
//
// Replaces the TPU kernel selective_scan (body _scan_kernel) of
// src/repro/kernels/mamba_scan/kernel.py:66. Per (batch b, channel d,
// state n), in f32:
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = sum_n C_t h_t
// dt, x (B, S, D); bs, cs (B, S, N); a (D, N), negative; h0 (B, D, N)
// -> y (B, S, D) and hT (B, D, N), all f32, contiguous. The operation
// order is the plain version's (ref.py), expf included. Under training the
// forward also writes the state entering each segment of kSeg steps, and
// the backward (scan_bwd, further down) recomputes each segment's states
// from it.
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

// P for state size N: kStatesPerThread, or N where N is smaller
template <int N>
constexpr int states_per_thread() {
  return N < kStatesPerThread ? N : kStatesPerThread;
}

template <int N, int P>
struct Tile {
  static_assert(32 % N == 0 && N % P == 0, "N divides 32, P divides N");
  static constexpr int kLanes = N / P;                 // lanes a channel spans
  static constexpr int kCh = kThreads / kLanes;        // channels a block owns
  static constexpr int kChunk = kCh > 32 ? 1024 / kCh : 32;  // steps a chunk
  // steps between the training forward's checkpoints: a segment of the
  // backward, whose states and decay factors a thread keeps in registers
  static constexpr int kSeg = 8;
  static constexpr int kOut = kSub > kLanes ? kSub / kLanes : 1;  // sums a lane keeps
  static constexpr int kCopies = kLanes > kSub ? kLanes / kSub : 1;  // lanes holding each
  static_assert(kChunk % kSub == 0, "a chunk holds whole groups of steps");
  static_assert(kChunk % kSeg == 0 && kSeg % kSub == 0,
                "a chunk holds whole segments, a segment whole groups");
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

// Starts the copies of rows [t0, t0 + ROWS) into shared memory, W floats
// a copy (W = 4 needs D and S N to be multiples of 4 and 16-byte aligned
// pointers): of each (B, S, D) array src[k] the block's CH columns into
// dst[k] (ROWS, CH), of bs and cs (B, S, N) the rows into b and c
// (ROWS, N). Copies wholly past S or D read nothing, point at row 0 and
// zero-fill.
template <int N, int ROWS, int CH, int W, int K>
__device__ __forceinline__ void issue_rows(float* const (&dst)[K],
                                           const float* const (&src)[K],
                                           float* b, float* c, const Src& g,
                                           int t0, int tid) {
  constexpr int kRowPieces = CH / W;
  constexpr int kPieces = ROWS * kRowPieces;
#pragma unroll
  for (int k = 0; k < (kPieces + kThreads - 1) / kThreads; ++k) {
    const int q = tid + k * kThreads;
    if (kPieces % kThreads == 0 || q < kPieces) {
      const int row = q / kRowPieces, col = (q % kRowPieces) * W;
      const int t = t0 + row, dd = g.d0 + col;
      const bool ok = t < g.S && dd < g.D;
      const int64_t off = ok ? (g.row0 + t) * g.D + dd : g.row0 * g.D;
      const int bytes = ok ? 4 * W : 0;
#pragma unroll
      for (int a = 0; a < K; ++a)
        copy_async<W>(&dst[a][row * CH + col], src[a] + off, bytes);
    }
  }
  constexpr int kBcPieces = ROWS * N / W;
  const int n_valid = (g.S - t0 < ROWS ? g.S - t0 : ROWS) * N;
#pragma unroll
  for (int k = 0; k < (kBcPieces + kThreads - 1) / kThreads; ++k) {
    const int q = tid + k * kThreads;
    if (kBcPieces % kThreads == 0 || q < kBcPieces) {
      const int left = n_valid - q * W;              // valid floats from here
      const int bytes = left <= 0 ? 0 : 4 * (left < W ? left : W);
      const int64_t off = bytes ? (g.row0 + t0) * N + q * W : g.row0 * N;
      copy_async<W>(&b[q * W], g.bs + off, bytes);
      copy_async<W>(&c[q * W], g.cs + off, bytes);
    }
  }
}

// The forward's chunk at t0 into `s`.
template <int N, int P, int W>
__device__ __forceinline__ void issue(Stage<N, P>& s, const Src& g, int t0,
                                      int tid) {
  using T = Tile<N, P>;
  float* const dst[2] = {s.dt, s.x};
  const float* const src[2] = {g.dt, g.x};
  issue_rows<N, T::kChunk, T::kCh, W>(dst, src, s.b, s.c, g, t0, tid);
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

// Sums acc over lanes Off, Off / 2, ..., Last apart (a channel's lanes
// in the forward, Last = 1). While a lane holds more than one partial sum,
// a level swaps half of them with the partner lane: the lane whose Off bit
// is set keeps the upper half, the other the lower, and each adds what it
// receives; after that, plain butterfly levels. On return acc[0 .. Cnt
// >> levels) are the full sums of entries base + j (base counts from 0).
template <int Cnt, int Off, int Last = 1, int K>
__device__ __forceinline__ void reduce_scatter(float (&acc)[K], int lane,
                                               int& base) {
  if constexpr (Off >= Last && Off > 0) {
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
      reduce_scatter<kHalf, Off / 2, Last>(acc, lane, base);
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], Off);
      reduce_scatter<1, Off / 2, Last>(acc, lane, base);
    }
  }
}

// With kCkpt, the state entering each segment of kSeg steps (h0 for the
// first) is also written to ckpt (B, ceil(S / kSeg), D, N): what the
// backward recomputes a segment's states from. Without it, ckpt is not
// touched.
template <int N, int P, int W, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
    scan_fwd(const float* __restrict__ dt, const float* __restrict__ x,
             const float* __restrict__ bs, const float* __restrict__ cs,
             const float* __restrict__ a, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ hT,
             float* __restrict__ ckpt, int S, int D) {
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
      if constexpr (kCkpt) {
        if (live && r0 % T::kSeg == 0) {
          const int64_t nck = (S + T::kSeg - 1) / T::kSeg;
          float* const ck = ckpt + ((b * nck + (t0 + r0) / T::kSeg) * D + d) *
                                       static_cast<int64_t>(N);
#pragma unroll
          for (int p = 0; p < P; ++p) ck[n0 + p] = h[p];
        }
      }
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
                   float* y, float* hT, float* ckpt, int B, int S, int D,
                   bool wide, cudaStream_t stream) {
  constexpr int kP = states_per_thread<N>();
  constexpr int kCh = Tile<N, kP>::kCh;
  const dim3 grid((D + kCh - 1) / kCh, B);
  decltype(&scan_fwd<N, kP, 4, false>) kernel;
  if (ckpt)
    kernel = wide ? &scan_fwd<N, kP, 4, true> : &scan_fwd<N, kP, 1, true>;
  else
    kernel = wide ? &scan_fwd<N, kP, 4, false> : &scan_fwd<N, kP, 1, false>;
  kernel<<<grid, kThreads, 0, stream>>>(dt, x, bs, cs, a, h0, y, hT, ckpt, S,
                                        D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward: the scan's vector-Jacobian product (what jax.grad derives
// from the reference's lax.scan at src/repro/models/mamba.py:121; the TPU
// package has no backward kernel). ref.py's selective_scan_bwd_ref is its
// plain version. With g_t the gradient of h_t and e_t = exp(dt_t a):
//   g_{S-1} = dhT + dy_{S-1} C_{S-1},  g_t = g_{t+1} e_{t+1} + dy_t C_t
//   dx_t = dt_t sum_n g_t B_t,  ddt_t = sum_n g_t a e_t h_{t-1} + x_t sum_n g_t B_t
//   dB_t = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t
//   da = sum_{b,t} g_t e_t h_{t-1} dt_t,  dh0 = g_0 e_0
//
// What bounds it. At B 2, S 512, D 8192, N 16 (the training shape): bytes,
// dt, x, dy, B, C, a and h0 read and the six gradients written, about
// 171 MB, 0.051 ms at 3.35 TB/s (the checkpoints this design reads on top
// are 67 MB more); the SFU, one
// exponential a (b, t, d, n), 0.032 ms at 1.98 GHz; and instruction issue,
// which is what it meets: the accurate expf, the reverse recurrence and
// the sums over channels take over a hundred instructions a thread and
// step.
//
// The design (PERF.md has the forms measured against each other):
// - one block per (batch b, kCh channels), the forward's thread layout: a
//   thread owns P states of one channel, a channel's N states on N / P
//   lanes. Registers are capped so that four blocks share an SM: at the
//   training shape the 512 blocks then run in one wave.
// - it walks segments of kSeg = 8 steps last to first, the training
//   forward's checkpoint interval (67 MB of checkpoints a layer at the
//   training shape). A segment's
//   dt, x, dy, B and C come through a ring of kStages shared stages filled
//   by cp.async, two segments ahead (zeros past S and D); the next
//   segment's checkpoint is loaded while this one is computed.
// - a segment's states h_{t-1} and decay factors e_t are recomputed from
//   its checkpoint with the forward's arithmetic into registers (2 kSeg P
//   a thread, the loops unrolled), then the reverse recurrence runs over
//   them, g and the da partials in registers; h_t is the next step's
//   h_{t-1}. Keeping e_t spends each exponential once; at 16-step
//   segments only the states fit, and recomputing e_t was slower.
// - dx_t and ddt_t are sums over a channel's lanes, taken kSub steps at a
//   time by reduce-scatter, as the forward sums y. dB_t and dC_t (2 P
//   values a thread and step) are sums over every channel: a reduce-scatter
//   over the warp's channels (2 P - 1 shuffles, against 2 P a level for a
//   butterfly) leaves one value a lane, the block's warps are then added in
//   order through shared memory and written as one partial a block; da
//   sums over B, one partial a batch row. A second launch (sum_parts) adds
//   the partials in a fixed order. No float atomics: two calls give
//   bit-equal gradients.
// - the decay factor is expf, as in the forward.

constexpr int kWarps = kThreads / 32;
constexpr int kBwdBlocksPerSm = 4;   // the register cap of scan_bwd

template <int N, int P>
struct BwdStage {
  using T = Tile<N, P>;
  float dt[T::kSeg * T::kCh];
  float x[T::kSeg * T::kCh];
  float dy[T::kSeg * T::kCh];
  float b[T::kSeg * N];
  float c[T::kSeg * N];
};

// dt, x, dy (B, S, D); bs, cs (B, S, N); a (D, N); ckpt (B, ceil(S /
// kSeg), D, N); dhT (B, D, N) or null -> ddt, dx (B, S, D); the partials
// dbs_part, dcs_part (gridDim.x, B, S, N) and da_part (B, D, N); dh0
// (B, D, N) unless null.
template <int N, int P, int W>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    scan_bwd(const float* __restrict__ dt, const float* __restrict__ x,
             const float* __restrict__ bs, const float* __restrict__ cs,
             const float* __restrict__ a, const float* __restrict__ ckpt,
             const float* __restrict__ dy, const float* __restrict__ dhT,
             float* __restrict__ ddt, float* __restrict__ dx,
             float* __restrict__ dbs_part, float* __restrict__ dcs_part,
             float* __restrict__ da_part, float* __restrict__ dh0, int S,
             int D) {
  using T = Tile<N, P>;
  constexpr int kLanes = T::kLanes, kCh = T::kCh, kSeg = T::kSeg;
  // the sums over a warp's channels: lanes kLanes, 2 kLanes, ... 16 apart;
  // a reduce-scatter of the 2 P values leaves kOutC on each lane, on
  // kCopiesC lanes each
  constexpr int kChanLanes = 32 / kLanes;
  constexpr int kOutC = 2 * P > kChanLanes ? 2 * P / kChanLanes : 1;
  constexpr int kCopiesC = kChanLanes > 2 * P ? kChanLanes / (2 * P) : 1;
  // the sums over a channel's lanes, kSub steps at a time: 2 kSub values
  constexpr int kOutX = 2 * kSub > kLanes ? 2 * kSub / kLanes : 1;
  static_assert(2 * kSub >= kLanes, "each lane keeps a sum");
  __shared__ __align__(16) BwdStage<N, P> st[kStages];
  __shared__ __align__(16) float red[kWarps][kSeg][2 * N];   // dB | dC

  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const int b = blockIdx.y, B = gridDim.y;
  const int d0 = blockIdx.x * kCh;
  const int c = tid / kLanes, lane = tid % kLanes, n0 = lane * P;
  const int d = d0 + c;
  const bool live = d < D;
  const int64_t row0 = static_cast<int64_t>(b) * S;      // (b, t = 0)
  const int64_t state0 = (static_cast<int64_t>(b) * D + d) * N + n0;
  const int nseg = (S + kSeg - 1) / kSeg;
  auto ckpt_of = [&](int k, float (&h)[P]) {
    const float* ck = ckpt + ((static_cast<int64_t>(b) * nseg + k) * D + d) *
                                 N + n0;
#pragma unroll
    for (int p = 0; p < P; ++p) h[p] = live ? ck[p] : 0.f;
  };

  const Src src{dt, x, bs, cs, row0, d0, S, D};
  auto issue_seg = [&](BwdStage<N, P>& sg, int k) {
    float* const dst[3] = {sg.dt, sg.x, sg.dy};
    const float* const from[3] = {dt, x, dy};
    issue_rows<N, kSeg, kCh, W>(dst, from, sg.b, sg.c, src, k * kSeg, tid);
  };
  issue_seg(st[0], nseg - 1);
  commit_copies();
  if (nseg > 1) issue_seg(st[1], nseg - 2);
  commit_copies();

  float g[P], av[P], da_acc[P], h_next[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    g[p] = live && dhT ? dhT[state0 + p] : 0.f;
    av[p] = live ? a[static_cast<int64_t>(d) * N + n0 + p] : 0.f;
    da_acc[p] = 0.f;
  }
  ckpt_of(nseg - 1, h_next);

  int stage = 0;
  for (int k = nseg - 1; k >= 0; --k) {
    const int t0 = k * kSeg;
    const int steps = S - t0 < kSeg ? S - t0 : kSeg;
    wait_copies<1>();                // this segment's copies have landed
    __syncthreads();                 // everyone's; the last segment is done
    if (k >= 2)                      // into the stage the last segment used
      issue_seg(st[stage == 0 ? kStages - 1 : stage - 1], k - 2);
    commit_copies();
    const BwdStage<N, P>& sg = st[stage];
    stage = stage == kStages - 1 ? 0 : stage + 1;

    // the segment's states from its checkpoint, as the forward computes
    // them: hs[r] is h_{t-1} of step r, es[r] its decay factor e_t, h_end
    // the state after the last.
    // Rows past S hold zeros (dt = 0: a factor of 1 and no input), which
    // leave h and g unchanged and add nothing to any gradient, so both
    // loops run the whole segment.
    float hs[kSeg][P], es[kSeg][P], h_end[P];
#pragma unroll
    for (int p = 0; p < P; ++p) h_end[p] = h_next[p];
    if (k > 0) ckpt_of(k - 1, h_next);
#pragma unroll
    for (int r = 0; r < kSeg; ++r) {
      const float dtv = sg.dt[r * kCh + c];
      const float w = dtv * sg.x[r * kCh + c];
      float bv[P];
      load_states<P>(&sg.b[r * N + n0], bv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        hs[r][p] = h_end[p];
        es[r][p] = expf(dtv * av[p]);
        const float u = w * bv[p];
        h_end[p] = h_end[p] * es[r][p] + u;
      }
    }

    // the reverse recurrence, kSub steps at a time
#pragma unroll
    for (int r0 = kSeg - kSub; r0 >= 0; r0 -= kSub) {
      float sums[2 * kSub];          // dx / dt_t, then ddt, of each step
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int r = r0 + i;
        const float dtv = sg.dt[r * kCh + c], xv = sg.x[r * kCh + c];
        const float dyv = sg.dy[r * kCh + c];
        const float w = dtv * xv;
        float bv[P], cv[P], bc[2 * P];
        load_states<P>(&sg.b[r * N + n0], bv);
        load_states<P>(&sg.c[r * N + n0], cv);
        float sum_gb = 0.f, sum_gaq = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float e = es[r][p];
          const float gt = g[p] + dyv * cv[p];           // g_t
          const float gq = gt * (e * hs[r][p]);          // g_t e_t h_{t-1}
          const float ht = r + 1 < kSeg ? hs[r + 1][p] : h_end[p];
          bc[p] = gt * w;                                // toward dB_t
          bc[P + p] = dyv * ht;                          // toward dC_t
          sum_gb += gt * bv[p];
          sum_gaq += gq * av[p];
          da_acc[p] += gq * dtv;
          g[p] = gt * e;                                 // toward g_{t-1}
        }
        sums[i] = sum_gb;
        sums[kSub + i] = sum_gaq + xv * sum_gb;
        // dB_t and dC_t over the warp's channels
        int base = 0;
        reduce_scatter<2 * P, 16, kLanes>(bc, wl, base);
        if ((wl / kLanes) % kCopiesC == 0) {
#pragma unroll
          for (int j = 0; j < kOutC; ++j) {
            const int v = base + j;
            red[warp][r][v < P ? n0 + v : N + n0 + v - P] = bc[j];
          }
        }
      }
      // dx and ddt over the channel's lanes
      int base = 0;
      reduce_scatter<2 * kSub, kLanes / 2>(sums, lane, base);
      if (live) {
#pragma unroll
        for (int j = 0; j < kOutX; ++j) {
          const int v = base + j, i = v % kSub, r = r0 + i;
          if (r < steps) {
            const int64_t o = (row0 + t0 + r) * D + d;
            const float dtv = sg.dt[r * kCh + c];
            if (v < kSub)
              dx[o] = dtv * sums[j];
            else
              ddt[o] = sums[j];
          }
        }
      }
    }
    __syncthreads();
    // the block's dB and dC partials: its warps added in order
    for (int q = tid; q < steps * 2 * N; q += kThreads) {
      const int r = q / (2 * N), n = q % (2 * N);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][n];
      const int64_t o =
          ((static_cast<int64_t>(blockIdx.x) * B + b) * S + t0 + r) * N;
      if (n < N)
        dbs_part[o + n] = sum;
      else
        dcs_part[o + n - N] = sum;
    }
  }

  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      da_part[state0 + p] = da_acc[p];
      if (dh0) dh0[state0 + p] = g[p];
    }
  }
}

// out[i] = sum over k = 0 .. parts - 1 of part[k * len + i], in that
// order, for each of three (part, out, parts, len); blockIdx.y picks one.
struct Parts {
  const float* part[3];
  float* out[3];
  int parts[3];
  int64_t len[3];
};

__global__ void __launch_bounds__(256) sum_parts(Parts p) {
  const int j = blockIdx.y;
  const int64_t len = p.len[j];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    float s = 0.f;
    for (int k = 0; k < p.parts[j]; ++k) s += p.part[j][k * len + i];
    p.out[j][i] = s;
  }
}

template <int N>
cudaError_t launch_bwd(const float* dt, const float* x, const float* bs,
                       const float* cs, const float* a, const float* ckpt,
                       const float* dy, const float* dhT, float* ddt,
                       float* dx, float* dbs, float* dcs, float* da,
                       float* dh0, float* work, int B, int S, int D,
                       bool wide, cudaStream_t stream) {
  constexpr int kP = states_per_thread<N>();
  constexpr int kCh = Tile<N, kP>::kCh;
  const int blocks = (D + kCh - 1) / kCh;
  const int64_t sel = static_cast<int64_t>(B) * S * N;
  float* const dbs_part = work;
  float* const dcs_part = dbs_part + blocks * sel;
  float* const da_part = dcs_part + blocks * sel;
  const auto kernel = wide ? &scan_bwd<N, kP, 4> : &scan_bwd<N, kP, 1>;
  kernel<<<dim3(blocks, B), kThreads, 0, stream>>>(
      dt, x, bs, cs, a, ckpt, dy, dhT, ddt, dx, dbs_part, dcs_part, da_part,
      dh0, S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Parts p{{dbs_part, dcs_part, da_part}, {dbs, dcs, da}, {blocks, blocks, B},
          {sel, sel, static_cast<int64_t>(D) * N}};
  const int64_t most = sel > p.len[2] ? sel : p.len[2];
  const int64_t want = (most + 255) / 256;
  sum_parts<<<dim3(static_cast<unsigned>(want < 1024 ? want : 1024), 3), 256,
              0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}


}  // namespace

// Time steps between the training forward's checkpoints and channels a
// block at state size N (0 for an N the kernels do not take): the
// checkpoints hold ceil(S / steps) states a batch row, the backward's
// partials ceil(D / channels) blocks.
extern "C" int selective_scan_checkpoint_steps(int N) {
  switch (N) {
    case 1: return Tile<1, states_per_thread<1>()>::kSeg;
    case 2: return Tile<2, states_per_thread<2>()>::kSeg;
    case 4: return Tile<4, states_per_thread<4>()>::kSeg;
    case 8: return Tile<8, states_per_thread<8>()>::kSeg;
    case 16: return Tile<16, states_per_thread<16>()>::kSeg;
    case 32: return Tile<32, states_per_thread<32>()>::kSeg;
    default: return 0;
  }
}

extern "C" int selective_scan_channels(int N) {
  switch (N) {
    case 1: return Tile<1, states_per_thread<1>()>::kCh;
    case 2: return Tile<2, states_per_thread<2>()>::kCh;
    case 4: return Tile<4, states_per_thread<4>()>::kCh;
    case 8: return Tile<8, states_per_thread<8>()>::kCh;
    case 16: return Tile<16, states_per_thread<16>()>::kCh;
    case 32: return Tile<32, states_per_thread<32>()>::kCh;
    default: return 0;
  }
}

// dt, x (B, S, D); bs, cs (B, S, N); a (D, N); h0 (B, D, N); y (B, S, D);
// hT (B, D, N); ckpt null or (B, ceil(S / selective_scan_checkpoint_steps(
// N)), D, N); all f32 and contiguous. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without launching, for a shape the kernel does
// not take: N must divide 32).
extern "C" int selective_scan(const void* dt, const void* x, const void* bs,
                              const void* cs, const void* a, const void* h0,
                              void* y, void* hT, void* ckpt, int B, int S,
                              int D, int N, void* stream) {
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
                             static_cast<float*>(ckpt), B, S, D, wide,
                             static_cast<cudaStream_t>(stream)));
}

// The backward. dt, x, dy (B, S, D); bs, cs (B, S, N); a (D, N); ckpt the
// forward's checkpoints; dhT (B, D, N) or null (a zero gradient) -> ddt, dx
// (B, S, D); dbs, dcs (B, S, N); da (D, N); dh0 (B, D, N) unless null.
// work: 2 ceil(D / selective_scan_channels(N)) B S N + B D N floats of
// scratch for the partial sums. All f32 and contiguous. Two launches, the
// backward and the sum of its partials; returns cudaGetLastError().
extern "C" int selective_scan_bwd(const void* dt, const void* x,
                                  const void* bs, const void* cs,
                                  const void* a, const void* ckpt,
                                  const void* dy, const void* dhT, void* ddt,
                                  void* dx, void* dbs, void* dcs, void* da,
                                  void* dh0, void* work, int B, int S, int D,
                                  int N, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch_bwd<1>) fn = nullptr;
  switch (N) {
    case 1: fn = launch_bwd<1>; break;
    case 2: fn = launch_bwd<2>; break;
    case 4: fn = launch_bwd<4>; break;
    case 8: fn = launch_bwd<8>; break;
    case 16: fn = launch_bwd<16>; break;
    case 32: fn = launch_bwd<32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = D % 4 == 0 && static_cast<int64_t>(S) * N % 4 == 0 &&
                    aligned16(dt) && aligned16(x) && aligned16(bs) &&
                    aligned16(cs) && aligned16(dy);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(fn(in(dt), in(x), in(bs), in(cs), in(a), in(ckpt),
                             in(dy), in(dhT), out(ddt), out(dx), out(dbs),
                             out(dcs), out(da), out(dh0), out(work), B, S, D,
                             wide, static_cast<cudaStream_t>(stream)));
}
