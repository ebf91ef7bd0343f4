// PSGF-Fed downlink mix for Hopper (sm_90a): for every client k
//   mixed[k, i] = m[k, i] * g[i] + (1 - m[k, i]) * w[k, i]
// and the gate count sum(m) over all clients, in one pass over the mask.
//
// Replaces the TPU kernels
//   src/repro/kernels/psgf_mix/kernel.py::psgf_mix_batch_kernel (body
//   `_batch_kernel`, kernel.py:59-62) and ::psgf_mix_kernel (body `_kernel`,
//   kernel.py:27-30), the K = 1 case of the same launch here.
// The TPU wrappers pad D to (rows, 128) lanes with 8-row aligned blocks
// (ops.py:16-30); none of that applies here: D is walked as it is, with a
// ragged tail handled by bounds.
//
// Exactness. The lerp is computed with __fmul_rn / __fsub_rn / __fadd_rn, so
// nvcc cannot contract it into an FMA: m*g, 1-m, (1-m)*w and the sum are each
// rounded once, as the plain PyTorch version (and the reference's jnp) round
// them. The mix is therefore bitwise equal to the plain version for any float
// mask. The count is deterministic: each block sums its slice of one client's
// mask in float32 in a fixed order (per-thread running sums, warp shuffles,
// then shared memory) and writes one partial to a (K, nblocks) buffer; no
// float atomics. The caller sums the partials (as the reference's wrapper
// sums its per-block counts). For 0/1 masks with a total under 2^24 every
// partial sum is an exact integer, so the count equals sum(m) bitwise.
//
// What bounds it on the card: bytes. Per call it must read w and m (K*D
// floats each) and g (D), and write the mixed matrix (K*D): (3*K*D + D) * 4
// bytes, 2 flops per element. At K = 27, D = 273,284 that is 89.6 MB, 26.7 us
// at 3.35 TB/s, against ~15 MFLOP (0.2 us at 67 TFLOP/s fp32).
//
// Design: grid (ceil(D / kBlockElems), min(K, 65535)); each block owns
// kBlockElems = 4096 consecutive elements of one client row (256 threads x
// 4 float4) and loops over clients k = blockIdx.y, + gridDim.y, ... when
// K > 65535. Offsets are 64-bit, so K * D may pass 2^31. When D % 4 == 0 and
// the pointers are 16-byte aligned (the wrapper checks) every row is walked
// with 16-byte loads and stores; otherwise a scalar path runs. Each block
// reads its slice of g once per client row; g (D * 4 bytes, 1.1 MB at full
// width) stays in the 50 MB L2 across clients, so device memory sees it about
// once. w and m are read once and the output written once, with streaming
// cache hints (they are not reused).
//
// C interface (bound with ctypes): psgf_mix_fwd returns cudaGetLastError()
// after the launch; the caller raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                                  // float4 per thread
constexpr int64_t kBlockElems = int64_t(kThreads) * kItems * 4;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float mix1(float m, float g, float w) {
  return __fadd_rn(__fmul_rn(m, g), __fmul_rn(__fsub_rn(1.0f, m), w));
}

__device__ __forceinline__ float block_sum(float x, float* smem) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  float s = 0.0f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? smem[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
  }
  __syncthreads();            // smem is reused by the next client row
  return s;                   // valid in thread 0
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
psgf_mix_kernel(const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ m, float* __restrict__ out,
                float* __restrict__ partials, int64_t D, int K) {
  __shared__ float smem[kThreads / 32];
  const int64_t start = int64_t(blockIdx.x) * kBlockElems;
  const int64_t stop = start + kBlockElems < D ? start + kBlockElems : D;
  for (int k = blockIdx.y; k < K; k += gridDim.y) {
    const int64_t row = int64_t(k) * D;
    float count = 0.0f;
    if (kVector) {
      // D % 4 == 0, so start, stop and row are multiples of 4
      const float4* g4 = reinterpret_cast<const float4*>(g + start);
      const float4* w4 = reinterpret_cast<const float4*>(w + row + start);
      const float4* m4 = reinterpret_cast<const float4*>(m + row + start);
      float4* o4 = reinterpret_cast<float4*>(out + row + start);
      const int n4 = int((stop - start) >> 2);
      float4 gv[kItems], wv[kItems], mv[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < n4) {
          gv[j] = __ldg(g4 + i);
          wv[j] = __ldcs(w4 + i);
          mv[j] = __ldcs(m4 + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < n4) {
          float4 r;
          r.x = mix1(mv[j].x, gv[j].x, wv[j].x);
          r.y = mix1(mv[j].y, gv[j].y, wv[j].y);
          r.z = mix1(mv[j].z, gv[j].z, wv[j].z);
          r.w = mix1(mv[j].w, gv[j].w, wv[j].w);
          __stcs(o4 + i, r);
          count += mv[j].x;
          count += mv[j].y;
          count += mv[j].z;
          count += mv[j].w;
        }
      }
    } else {
      for (int64_t i = start + threadIdx.x; i < stop; i += kThreads) {
        const float mi = m[row + i];
        out[row + i] = mix1(mi, __ldg(g + i), w[row + i]);
        count += mi;
      }
    }
    const float s = block_sum(count, smem);
    if (threadIdx.x == 0) partials[int64_t(k) * gridDim.x + blockIdx.x] = s;
  }
}

}  // namespace

extern "C" int psgf_mix_blocks(long long D) {
  return int((D + kBlockElems - 1) / kBlockElems);
}

extern "C" int psgf_mix_fwd(const float* g, const float* w, const float* m,
                            float* out, float* partials, long long D, int K,
                            int vector, void* stream) {
  if (D <= 0 || K <= 0) return 0;
  const dim3 grid(psgf_mix_blocks(D), K < kMaxGridY ? K : kMaxGridY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector)
    psgf_mix_kernel<true><<<grid, kThreads, 0, s>>>(g, w, m, out, partials,
                                                    D, K);
  else
    psgf_mix_kernel<false><<<grid, kThreads, 0, s>>>(g, w, m, out, partials,
                                                     D, K);
  return static_cast<int>(cudaGetLastError());
}
