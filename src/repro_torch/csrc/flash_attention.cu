// Flash attention forward for Hopper (sm_90a): GQA, causal / sliding-window,
// kv_len padding mask, online softmax in fp32.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (body `_kernel`, kernel.py:35-85) and computes exactly its function:
//   s = (q . k) * scale, scale = 1/sqrt(hd), fp32 arithmetic;
//   mask = (key < kv_len) [& key <= q if causal] [& key > q - window];
//   masked probabilities are exactly 0; out = acc / max(l, 1e-30), so a
//   query row with no valid key returns 0; query head h reads kv head
//   h / (H / KV).
// Unlike the TPU wrapper (ops.py:30-44) nothing is padded: ragged Sq and Skv
// are handled here by bounds, so the caller passes the tensors as they are.
//
// Which calls reach it (ops.kernel_route): the ones no other route takes.
// Short sequences at hd 8-32 (the LoGTST forecaster's 15-63 tokens x 16
// heads) go to flash_attention_short.cu, which stages a whole batch row
// per block and serves every head of it; bf16 at hd 64 / 128 goes to
// flash_attention_tc.cu. This kernel keeps long sequences (past the short
// kernel's thread and shared-memory envelope) and fp32 at hd 64 / 128,
// such as hymba-1.5b's float32 check at 2,048 tokens.
//
// What bounds it on the card. At the forecaster's serving shape (q, k, v,
// o each (96, 15, 16, 8) fp32 = 737,280 B) the call must move 2.95 MB, which
// is ~0.88 us at 3.35 TB/s, and does ~11 MFLOP (QK^T and PV at 15x15 per
// head, 0.17 us at 67 TFLOP/s fp32): it is memory- and launch-bound, never
// compute-bound. At hd = 8 the contractions are far too thin for wgmma (64
// rows x >= 16 deep), so plain fp32 FMAs on CUDA cores are the right unit.
// There this kernel took 0.0088-0.0094 ms in chip_smoke.py (NVIDIA H100
// 80GB HBM3, 700.00 W: 1,536 one-warp blocks with 15 of 32 lanes live, each
// restaging its head's K/V in 32-byte pieces), the short kernel about half.
//
// Design (simple and right first):
//   * grid (ceil(Sq / threads), H, min(B, 65535)), the z blocks striding over
//     the batch; one thread owns one query row and keeps
//     q and its fp32 accumulator acc[HD] in registers (HD is a template
//     parameter in {8, 16, 32, 64, 128});
//   * the block walks the keys any of its rows can see in tiles of BK keys,
//     staged once per block in static shared memory as fp32
//     (2 * BK * HD * 4 B <= 32 KB), so every k/v element is read from device
//     memory once per block of queries;
//   * online softmax per key: the running max m only moves up, and the
//     accumulator is rescaled by expf(m_old - m_new) only when it does;
//   * expf, not __expf, and IEEE division: the port's tolerance against the
//     dense plain version is 1e-5 (do not build with --use_fast_math).
//
// C interface (bound with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 128;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bf16)
}

// keys per shared-memory tile: 2 * BK * HD * 4 B stays at or below 32 KB
template <int HD>
struct KeyTile {
  static constexpr int BK = HD <= 64 ? 64 : 32;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int B, int Sq,
                 int Skv, int H, int KV, int kv_len, int causal,
                 int has_window, long long window, float scale) {
  constexpr int BK = KeyTile<HD>::BK;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  // grid-stride over the batch: gridDim.z stops at 65535, and the FL
  // engine's vmap folds clients into B (K * batch rows), which can pass it
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const int h = blockIdx.y;
    const int kvh = h / (H / KV);
    const int q0 = blockIdx.x * blockDim.x;  // first query row of the block
    const int qi = q0 + threadIdx.x;
    const bool active = qi < Sq;

    float qr[HD];
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = 0.f;
      acc[d] = 0.f;
    }
    if (active) {
      const T* qrow = q + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) qr[d] = load_f32(qrow + d);
    }
    float m = kNegInf;
    float l = 0.f;

    // the keys some row of this block may attend to: [k_begin, k_end)
    const int q_last = min(Sq, q0 + static_cast<int>(blockDim.x)) - 1;
    long long k_end = kv_len;
    if (causal) k_end = min(k_end, static_cast<long long>(q_last) + 1);
    long long k_begin = 0;
    if (has_window) k_begin = max(0LL, static_cast<long long>(q0) - window + 1);

    const size_t key_stride = static_cast<size_t>(KV) * HD;
    const size_t head_off =
        (static_cast<size_t>(b) * Skv * KV + kvh) * static_cast<size_t>(HD);
    const T* kbase = k + head_off;
    const T* vbase = v + head_off;

    for (long long t0 = k_begin; t0 < k_end; t0 += BK) {
      const int nk = static_cast<int>(min(static_cast<long long>(BK), k_end - t0));
      __syncthreads();  // every thread is done with the previous tile / row
      for (int idx = threadIdx.x; idx < nk * HD; idx += blockDim.x) {
        const int j = idx / HD;
        const int d = idx - j * HD;
        const size_t off = static_cast<size_t>(t0 + j) * key_stride + d;
        ks[j][d] = load_f32(kbase + off);
        vs[j][d] = load_f32(vbase + off);
      }
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < nk; ++j) {
        const long long key = t0 + j;  // < kv_len by construction of k_end
        if (causal && key > qi) continue;
        if (has_window && key <= qi - window) continue;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], ks[j][d], s);
        s *= scale;
        if (s > m) {
          const float corr = expf(m - s);
          l *= corr;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] *= corr;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
    }

    if (active) {
      const float denom = fmaxf(l, 1e-30f);
      T* orow = o + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) store_f32(orow + d, acc[d] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int hd, int kv_len, int causal,
           int has_window, long long window, float scale,
           cudaStream_t stream) {
  const int threads = Sq <= 32 ? 32 : (Sq <= 64 ? 64 : kMaxThreads);
  const dim3 grid((Sq + threads - 1) / threads, H, B < 65535 ? B : 65535);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define REPRO_FA_CASE(HD)                                                      \
  case HD:                                                                     \
    flash_fwd_kernel<T, HD><<<grid, threads, 0, stream>>>(                     \
        qp, kp, vp, op, B, Sq, Skv, H, KV, kv_len, causal, has_window,         \
        window, scale);                                                        \
    break;
  switch (hd) {
    REPRO_FA_CASE(8)
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous (B, S, heads, hd).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Sq, int Skv,
                                   int H, int KV, int hd, int kv_len,
                                   int causal, int has_window,
                                   long long window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                         has_window, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len,
                                 causal, has_window, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
