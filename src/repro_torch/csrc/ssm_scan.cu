// Selective scan (Mamba-style SSM) for Hopper (sm_90a):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t * C_t
// per (batch b, channel d), with h (N,) starting at 0; x, dt (B, S, D);
// B, C (B, S, N); A (D, N) float32; y (B, S, D) in x's type; optionally the
// final state h_S (B, D, N) float32.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel (body `_kernel`,
//   kernel.py:33-59; pallas_call at kernel.py:73)
// and computes its function in its arithmetic: x, dt, B, C cast to float32
// first, then dt*A, exp, the state update and the dot with C, all float32.
// The TPU kernel's grid carries h across a sequential chunk axis in VMEM
// scratch and its wrapper (ops.py) pads S and D to the chunk and d_block;
// here the time loop runs inside one thread, which holds h in registers
// from the first step to the last, and ragged S and D are loop bounds: no
// padding, no chunk or d_block (the reference's
// test_ssm_scan_chunk_invariance shows they do not change the result).
//
// Rounding. The state update is written with __fmul_rn / __fadd_rn, so nvcc
// cannot contract it into an FMA: dt*A, exp, exp*h, (dt*x)*B and their sum
// are each rounded once, as the plain PyTorch version (ref.py) rounds them.
// expf (not __expf), and no --use_fast_math: 2048 serial steps must stay
// within 1e-4 of the plain version in float32. Only the dot with C (an FMA
// chain here, a reduction in torch) sums in another order.
//
// What bounds it on the card: the exponentials. Per call it must read x, dt
// (B*S*D each), B, C (B*S*N each), A (D*N, float32) and write y (B*S*D): at
// hymba-1.5b's prefill (4, 2048, 3200, 16) in bf16 that is 0.158 GB, 0.047
// ms at 3.35 TB/s. It computes B*S*D*N = 4.19e8 exponentials, one ex2 each
// on the special-function units: 16 per clock per SM (CUDA C Programming
// Guide, compute capability 9.0) x 132 SMs x 1.98 GHz (H100 SXM boost) =
// 4.18e12 per second, 0.100 ms; and about 6 float32 flops per (t, d, n) =
// 2.5e9 flops, 0.038 ms at 67 TFLOP/s. So the bound is 0.100 ms, operations.
//
// Design (simple and right first):
//   * one thread per (b, d) channel, holding h[N] and A[d, :] in registers
//     (N a template parameter in {4, 8, 16, 32, 64}); a block covers kThreads
//     consecutive d of one b; grid (ceil(D / kThreads), B);
//   * the block stages B_t and C_t for a tile of kTile time steps in shared
//     memory (every thread of the block reads them), then each thread walks
//     the tile; x and dt are read coalesced along d, y written coalesced;
//   * offsets are 64-bit; the final state is written only when asked for.
// The N exponentials of a step are independent, which gives each thread N
// instructions in flight to hide the special-function units' latency; the
// parallelism across threads is only B*D (12,800 channels at hymba's
// shape, about 3 warps per SM), which is what a faster design (a thread
// per (d, n) with a shuffle reduction over n, or a chunked parallel scan)
// would raise.
//
// C interface (bound with ctypes): ssm_scan_fwd returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for an N it was not built for);
// the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bf16)
}

// time steps per shared-memory tile: 2 * kTile * N * 4 B <= 32 KB
template <int N>
struct TimeTile {
  static constexpr int value = N <= 16 ? 128 : 4096 / N;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_out, int S, int D) {
  constexpr int kTile = TimeTile<N>::value;
  __shared__ float bs[kTile][N];
  __shared__ float cs[kTile][N];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;
  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = active ? a[int64_t(d) * N + n] : 0.0f;
    h[n] = 0.0f;
  }
  const int64_t xbase = int64_t(b) * S * D + d;   // x/dt/y at (b, t=0, d)
  const int64_t bbase = int64_t(b) * S * N;       // B/C at (b, t=0, 0)

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = S - t0 < kTile ? S - t0 : kTile;
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int64_t off = bbase + int64_t(t0) * N + i;
      bs[i / N][i % N] = load_f32(bm + off);
      cs[i / N][i % N] = load_f32(cm + off);
    }
    __syncthreads();
    if (active) {
      for (int tt = 0; tt < nt; ++tt) {
        const int64_t off = xbase + int64_t(t0 + tt) * D;
        const float dv = load_f32(dt + off);
        const float dbx = __fmul_rn(dv, load_f32(x + off));
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float da = expf(__fmul_rn(dv, av[n]));
          h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(dbx, bs[tt][n]));
          acc = fmaf(h[n], cs[tt][n], acc);
        }
        store_f32(y + off, acc);
      }
    }
  }
  if (h_out != nullptr && active) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[(int64_t(b) * D + d) * N + n] = h[n];
  }
}

template <typename T, int N>
void launch(const void* x, const void* dt, const void* bm, const void* cm,
            const float* a, void* y, float* h_out, int B, int S, int D,
            cudaStream_t s) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), a,
      static_cast<T*>(y), h_out, S, D);
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const void* bm, const void* cm,
               const float* a, void* y, float* h_out, int B, int S, int D,
               int N, cudaStream_t s) {
  switch (N) {
    case 4: launch<T, 4>(x, dt, bm, cm, a, y, h_out, B, S, D, s); break;
    case 8: launch<T, 8>(x, dt, bm, cm, a, y, h_out, B, S, D, s); break;
    case 16: launch<T, 16>(x, dt, bm, cm, a, y, h_out, B, S, D, s); break;
    case 32: launch<T, 32>(x, dt, bm, cm, a, y, h_out, B, S, D, s); break;
    case 64: launch<T, 64>(x, dt, bm, cm, a, y, h_out, B, S, D, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); A and h_out are
// float32; h_out may be null. B (batch) must be at most 65535 (gridDim.y).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* bm,
                            const void* cm, const float* a, void* y,
                            float* h_out, int dtype, int B, int S, int D,
                            int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(x, dt, bm, cm, a, y, h_out, B, S, D, N, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, bm, cm, a, y, h_out, B, S, D, N,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}
