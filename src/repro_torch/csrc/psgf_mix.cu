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
// mask. The count is deterministic: each block sums its slices of the mask
// in float32 in a fixed order (per-thread running sums, warp shuffles, then
// shared memory) into one partial; the last block to finish sums the
// partials in index order (lane l of one warp takes partials l, l + 32, ...,
// then a fixed shuffle tree) into the one-element count. No float atomics.
// For 0/1 masks with a total under 2^24 every partial sum is an exact
// integer, so the count equals sum(m) bitwise.
//
// What bounds it on the card: bytes. Per call it must read w and m (K*D
// floats each) and g (D), and write the mixed matrix (K*D): (3*K*D + D) * 4
// bytes, 2 flops per element. At K = 27, D = 273,284 that is 89.6 MB, 26.7 us
// at 3.35 TB/s, against ~15 MFLOP (0.2 us at 67 TFLOP/s fp32); at K = 1 it
// is 4.4 MB, 1.3 us, about the cost of one launch.
//
// Design: the work is cut into slices of 256 threads x kItems float4 of one
// client row. kItems (4, 2 or 1: 4,096, 2,048 or 1,024 elements) is the
// largest that still makes two slices per SM: 4,096 at the engine's K =
// 10-27 (1,809 slices at K = 27), 1,024 at K = 1 (267 slices for 132 SMs,
// where 4,096 left half the card idle with 67). The grid is one block per
// slice, capped at the blocks the card holds at once (4 per SM at 4,096):
// each block walks its slices blockIdx.x, + gridDim.x, ..., so the count's
// per-block cost below is paid once per resident block, not once per slice
// (at K = 27, 528 blocks for 1,809 slices). Offsets are 64-bit, so K * D may
// pass 2^31. When D % 4 == 0 and the pointers are 16-byte aligned (the
// wrapper checks) every row is walked with 16-byte loads and stores;
// otherwise a scalar path runs. g (D * 4 bytes, 1.1 MB at full width) stays
// in the 50 MB L2 across clients, so device memory sees it about once. w and
// m are read once and the output written once, with streaming cache hints
// (they are not reused).
// One launch per call: a block writes its partial and takes a ticket with
// one release-acquire atomic add on an unsigned counter (the fence and the
// atomicAdd of the classic last-block reduction in one instruction: the
// release orders the partial before the ticket, the acquire orders the last
// block's reads after every other ticket). The block that draws the last ticket
// sums every partial into the count and sets the counter back to 0, so the
// next launch and every replay of a CUDA graph start clean. The counter
// belongs to the caller (one zeroed word per device, see
// kernels/psgf_mix/ops.py): two launches that run at the same time must not
// share one.
//
// C interface (bound with ctypes): psgf_mix_blocks gives the grid (and the
// partials' length) of a launch over (K, D) on the current device;
// psgf_mix_fwd returns cudaGetLastError() after the launch; the caller
// raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlicesPerSm = 2;        // the least fill of the card, per SM

__device__ __forceinline__ float mix1(float m, float g, float w) {
  return __fadd_rn(__fmul_rn(m, g), __fmul_rn(__fsub_rn(1.0f, m), w));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;                   // valid in lane 0
}

__device__ __forceinline__ float block_sum(float x, float* smem) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  float s = 0.0f;
  if (warp == 0) s = warp_sum(lane < kThreads / 32 ? smem[lane] : 0.0f);
  return s;                   // valid in thread 0
}

// the ticket: release (this thread's writes before it) and acquire (every
// earlier ticket's writes before what follows), at device scope
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned prev;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(prev) : "l"(counter) : "memory");
  return prev;
}

__device__ __forceinline__ float load_relaxed(const float* p) {
  float x;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(x) : "l"(p) : "memory");
  return x;
}

// at most 64 registers, so four blocks fit each SM (528 at K = 27; left to
// itself the compiler took 76 registers and three)
template <bool kVector, int kItems>
__global__ void __launch_bounds__(kThreads, 4)
psgf_mix_kernel(const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ m, float* __restrict__ out,
                float* __restrict__ partials, float* __restrict__ count,
                unsigned* __restrict__ counter, int64_t D, unsigned per_row,
                unsigned slices) {
  constexpr int64_t kSliceElems = int64_t(kThreads) * kItems * 4;
  __shared__ float smem[kThreads / 32];
  __shared__ bool last;
  float c = 0.0f;
  for (unsigned sl = blockIdx.x; sl < slices; sl += gridDim.x) {
    const unsigned k = sl / per_row;        // 32-bit: the host checks slices
    const int64_t start = int64_t(sl - k * per_row) * kSliceElems;
    const int64_t stop = start + kSliceElems < D ? start + kSliceElems : D;
    const int64_t row = k * D;
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
          c += mv[j].x;
          c += mv[j].y;
          c += mv[j].z;
          c += mv[j].w;
        }
      }
    } else {
      for (int64_t i = start + threadIdx.x; i < stop; i += kThreads) {
        const float mi = m[row + i];
        out[row + i] = mix1(mi, __ldg(g + i), w[row + i]);
        c += mi;
      }
    }
  }
  const float s = block_sum(c, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    last = take_ticket(counter) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the last block: one warp sums the partials in index order
  float t = 0.0f;
#pragma unroll 8
  for (int i = threadIdx.x; i < int(gridDim.x); i += 32)
    t += load_relaxed(partials + i);
  t = warp_sum(t);
  if (threadIdx.x == 0) {
    *count = t;
    *counter = 0u;            // the next launch (or graph replay) starts at 0
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return sms;
}

// float4 per thread: the largest of 4, 2, 1 that still makes kSlicesPerSm
// slices per SM (1 when none does)
int items_for(long long D, int K) {
  const long long want = static_cast<long long>(kSlicesPerSm) * sm_count();
  for (int items = 4; items > 1; items /= 2) {
    const long long elems = static_cast<long long>(kThreads) * items * 4;
    if ((D + elems - 1) / elems * K >= want) return items;
  }
  return 1;
}

template <bool kVector>
auto kernel_for(int items) {
  return items == 4 ? psgf_mix_kernel<kVector, 4>
                    : (items == 2 ? psgf_mix_kernel<kVector, 2>
                                  : psgf_mix_kernel<kVector, 1>);
}

long long slices_per_row(long long D, int items) {
  const long long elems = static_cast<long long>(kThreads) * items * 4;
  return (D + elems - 1) / elems;
}

// one block per slice, at most as many as the card holds at once
int grid_for(long long D, int K, int items) {
  const long long slices = slices_per_row(D, items) * K;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_for<true>(items), kThreads, 0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long most = static_cast<long long>(per_sm) * sm_count();
  return static_cast<int>(slices < most ? slices : most);
}

}  // namespace

// blocks of a launch over (K, D) on the current device: the partials
// buffer holds as many floats
extern "C" int psgf_mix_blocks(long long D, int K) {
  return grid_for(D, K, items_for(D, K));
}

// counter: a zeroed unsigned word that no other launch uses at the same
// time; count: one float
extern "C" int psgf_mix_fwd(const float* g, const float* w, const float* m,
                            float* out, float* partials, float* count,
                            unsigned* counter, long long D, int K, int vector,
                            void* stream) {
  if (D <= 0 || K <= 0) return 0;
  const int items = items_for(D, K);
  const long long per_row = slices_per_row(D, items);
  if (per_row * K > 0xffffffffLL)       // 2^32 slices: 2^42 elements
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_for(D, K, items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = vector ? kernel_for<true>(items) : kernel_for<false>(items);
  kernel<<<grid, kThreads, 0, s>>>(g, w, m, out, partials, count, counter, D,
                                   static_cast<unsigned>(per_row),
                                   static_cast<unsigned>(per_row * K));
  return static_cast<int>(cudaGetLastError());
}
