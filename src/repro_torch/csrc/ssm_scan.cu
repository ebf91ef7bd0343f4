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
// here the time loop runs inside the lanes, which hold h in registers from
// the first step to the last, and ragged S and D are loop bounds: no
// padding, no chunk or d_block (the reference's
// test_ssm_scan_chunk_invariance shows they do not change the result).
//
// Rounding. The state update is written with __fmul_rn / __fadd_rn, so nvcc
// cannot contract it into an FMA: dt*A, exp, exp*h, (dt*x)*B and their sum
// are each rounded once, as the plain PyTorch version (ref.py) rounds them,
// so h is bitwise the plain version's. expf (not __expf), and no
// --use_fast_math. Only the dot with C sums in another order: each lane
// adds its states' h*C, then the channel's lanes add in a fixed shuffle
// tree (deterministic: no atomics, the same bits on every call).
//
// What bounds it on the card: the exponentials. Per call it must read x, dt
// (B*S*D each), B, C (B*S*N each), A (D*N, float32) and write y (B*S*D): at
// hymba-1.5b's prefill (4, 2048, 3200, 16) in bf16 that is 0.158 GB, 0.047
// ms at 3.35 TB/s. It computes B*S*D*N = 4.19e8 exponentials, one ex2 each
// on the special-function units: 16 per clock per SM (CUDA C Programming
// Guide, compute capability 9.0) x 132 SMs x 1.98 GHz (H100 SXM boost) =
// 4.18e12 per second, 0.100 ms; and about 6 float32 flops per (t, d, n) =
// 2.5e9 flops, 0.038 ms at 67 TFLOP/s. So the bound is 0.100 ms, operations.
// Instruction issue is the next limit: expf alone is 8 instructions, and
// with the state update, the dot with C, the shuffle tree and the staging
// a (t, d, n) costs about 18, which at 32 lanes and 4 warp instructions per
// clock per SM is about 0.22 ms.
//
// Design: a lane per (channel, state pair).
//   * L = N / PER lanes serve one channel d, PER = 2 states per lane (1 at
//     N = 4); lane j holds h[n] and A[d, n] in registers for n = j + L*i,
//     so B*D*N/2 lanes run the scan (102,400 at hymba's shape, against
//     12,800 threads for a thread per channel); a block of 128 threads
//     covers 128 / L channels of one batch row; grid (ceil(D / channels),
//     B);
//   * the block stages a tile of 64 time steps in shared memory: x and dt
//     read along d and stored per channel along time, B and C per state
//     along time (16-byte vector loads where the rows are aligned, scalar
//     at a ragged edge), so each lane reads 4 steps with one 16-byte shared
//     load; y goes back through shared memory and out along d (16-byte
//     stores where aligned);
//   * each lane computes its h*C for T = min(L, 8) steps, then the channel's
//     lanes reduce them in one shuffle tree: log2(T) halving stages (each
//     lane keeps half of the steps, sends the other half) and log2(L / T)
//     plain stages, about one shuffle per step, after which lane j holds
//     y for step j mod T;
//   * exp(dt*A) does not depend on h, so the unrolled steps issue their
//     exponentials ahead of the serial multiply-add chain;
//   * offsets are 64-bit; the final state is written only when asked for.
//
// C interface (bound with ctypes): ssm_scan_fwd returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for an N it was not built for);
// the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // time steps staged in shared memory
constexpr int kPitch = kTile + 4;  // row pitch: 16-byte rows, no bank clash

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bf16)
}

// 16-byte vectors of T: element e as float, and W floats packed (bf16
// rounded to nearest even, as torch's .to(bf16))
template <typename T>
struct Vec {
  static constexpr int W = 16 / sizeof(T);
};
__device__ __forceinline__ float elem(const uint4& v, int e, const float*) {
  return __uint_as_float((&v.x)[e]);
}
__device__ __forceinline__ float elem(const uint4& v, int e,
                                      const __nv_bfloat16*) {
  const uint32_t w = (&v.x)[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int N>
struct Layout {
  static constexpr int PER = N >= 8 ? 2 : 1;  // states per lane
  static constexpr int L = N / PER;           // lanes per channel (<= 32)
  static constexpr int CH = kThreads / L;     // channels per block
  static constexpr int T = L < 8 ? L : 8;     // steps per shuffle reduction
};

// T steps of one lane from step ts of the staged tile; p[u] = its h*C of
// step ts + u (0 past the tile's last step when CHECK)
template <int N, bool CHECK>
__device__ __forceinline__ void scan_steps(
    float (&p)[Layout<N>::T], float (&h)[Layout<N>::PER],
    const float (&av)[Layout<N>::PER], const float* xrow, const float* drow,
    const float (*bs)[kPitch], const float (*cs)[kPitch], int j, int ts,
    int nt) {
  using Lo = Layout<N>;
#pragma unroll
  for (int u4 = 0; u4 < Lo::T; u4 += 4) {
    const float4 dv4 = *reinterpret_cast<const float4*>(drow + ts + u4);
    const float4 xv4 = *reinterpret_cast<const float4*>(xrow + ts + u4);
    float4 b4[Lo::PER], c4[Lo::PER];
#pragma unroll
    for (int i = 0; i < Lo::PER; ++i) {
      b4[i] = *reinterpret_cast<const float4*>(&bs[j + Lo::L * i][ts + u4]);
      c4[i] = *reinterpret_cast<const float4*>(&cs[j + Lo::L * i][ts + u4]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = u4 + e;
      if (CHECK && ts + u >= nt) {
        p[u] = 0.0f;
        continue;
      }
      const float dv = part(dv4, e);
      const float dbx = __fmul_rn(dv, part(xv4, e));
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < Lo::PER; ++i) {
        const float da = expf(__fmul_rn(dv, av[i]));
        h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dbx, part(b4[i], e)));
        acc = i == 0 ? __fmul_rn(h[i], part(c4[i], e))
                     : fmaf(h[i], part(c4[i], e), acc);
      }
      p[u] = acc;
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 8)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_out, int S, int D) {
  using Lo = Layout<N>;
  constexpr int L = Lo::L, PER = Lo::PER, CH = Lo::CH, TS = Lo::T;
  __shared__ __align__(16) float xs[CH][kPitch];  // x per channel, along t
  __shared__ __align__(16) float ds[CH][kPitch];  // dt
  __shared__ __align__(16) float bs[N][kPitch];   // B per state, along t
  __shared__ __align__(16) float cs[N][kPitch];   // C
  __shared__ float ys[kTile][CH];                 // y along d

  const int b = blockIdx.y;
  const int c = threadIdx.x / L;  // channel in the block
  const int j = threadIdx.x % L;  // lane in the channel
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool active = d < D;
  float av[PER], h[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    av[i] = active ? a[int64_t(d) * N + j + L * i] : 0.0f;
    h[i] = 0.0f;
  }
  const int64_t row0 = int64_t(b) * S;  // (b, t = 0) row of x / dt / y / B / C

  // whole tiles move as 16-byte vectors where the rows allow it: x, dt and
  // y rows of the block's CH channels, and the block's B / C rows
  constexpr int W = Vec<T>::W;
  constexpr int CV = CH / W > 0 ? CH / W : 1;  // vectors per x row
  const bool vec_x = CH % W == 0 && D % W == 0 && d0 + CH <= D &&
                     aligned16(x) && aligned16(dt) && aligned16(y);
  const bool vec_bc = (row0 * N) % W == 0 && aligned16(bm) && aligned16(cm);

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = S - t0 < kTile ? S - t0 : kTile;
    __syncthreads();  // the previous tile is no longer read
    if (vec_x && nt == kTile) {
      for (int i = threadIdx.x; i < kTile * CV; i += kThreads) {
        const int tt = i / CV;
        const int v = i - tt * CV;
        const int64_t off = (row0 + t0 + tt) * D + d0 + v * W;
        const uint4 xv = *reinterpret_cast<const uint4*>(x + off);
        const uint4 dv = *reinterpret_cast<const uint4*>(dt + off);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          xs[v * W + e][tt] = elem(xv, e, x);
          ds[v * W + e][tt] = elem(dv, e, x);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
        const int tt = i / CH;
        const int cc = i - tt * CH;
        float xv = 0.0f, dv = 0.0f;
        if (tt < nt && d0 + cc < D) {
          const int64_t off = (row0 + t0 + tt) * D + d0 + cc;
          xv = load_f32(x + off);
          dv = load_f32(dt + off);
        }
        xs[cc][tt] = xv;
        ds[cc][tt] = dv;
      }
    }
    if (vec_bc && nt == kTile) {
      for (int i = threadIdx.x; i < kTile * N / W; i += kThreads) {
        const int64_t off = (row0 + t0) * N + i * W;
        const uint4 bv = *reinterpret_cast<const uint4*>(bm + off);
        const uint4 cv = *reinterpret_cast<const uint4*>(cm + off);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int tt = (i * W + e) / N;
          const int n = (i * W + e) % N;
          bs[n][tt] = elem(bv, e, x);
          cs[n][tt] = elem(cv, e, x);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
        const int tt = i / N;
        const int n = i - tt * N;
        float bv = 0.0f, cv = 0.0f;
        if (tt < nt) {
          const int64_t off = (row0 + t0) * N + i;
          bv = load_f32(bm + off);
          cv = load_f32(cm + off);
        }
        bs[n][tt] = bv;
        cs[n][tt] = cv;
      }
    }
    __syncthreads();

    for (int ts = 0; ts < nt; ts += TS) {
      float p[TS];
      if (ts + TS <= nt)
        scan_steps<N, false>(p, h, av, xs[c], ds[c], bs, cs, j, ts, nt);
      else
        scan_steps<N, true>(p, h, av, xs[c], ds[c], bs, cs, j, ts, nt);
      // halving stages: lane bit w picks which half of the steps it keeps
#pragma unroll
      for (int w = TS / 2; w >= 1; w /= 2) {
        const bool upper = (j & w) != 0;
#pragma unroll
        for (int u = 0; u < w; ++u) {
          const float send = upper ? p[u] : p[u + w];
          const float keep = upper ? p[u + w] : p[u];
          p[u] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      // plain stages over the lanes above T
#pragma unroll
      for (int w = TS; w < L; w *= 2)
        p[0] += __shfl_xor_sync(0xffffffffu, p[0], w);
      if (j < TS && ts + j < nt) ys[ts + j][c] = p[0];
    }
    __syncthreads();
    if (vec_x && nt == kTile) {
      for (int i = threadIdx.x; i < kTile * CV; i += kThreads) {
        const int tt = i / CV;
        const int v = i - tt * CV;
        *reinterpret_cast<uint4*>(y + (row0 + t0 + tt) * D + d0 + v * W) =
            pack(&ys[tt][v * W], y);
      }
    } else {
      for (int i = threadIdx.x; i < nt * CH; i += kThreads) {
        const int tt = i / CH;
        const int cc = i - tt * CH;
        if (d0 + cc < D) store_f32(y + (row0 + t0 + tt) * D + d0 + cc, ys[tt][cc]);
      }
    }
  }
  if (h_out != nullptr && active) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      h_out[(int64_t(b) * D + d) * N + j + L * i] = h[i];
  }
}

template <typename T, int N>
void launch(const void* x, const void* dt, const void* bm, const void* cm,
            const float* a, void* y, float* h_out, int B, int S, int D,
            cudaStream_t s) {
  constexpr int CH = Layout<N>::CH;
  const dim3 grid((D + CH - 1) / CH, B);
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
