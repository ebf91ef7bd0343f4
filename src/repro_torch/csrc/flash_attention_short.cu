// Flash attention forward for short sequences on Hopper (sm_90a): the
// LoGTST forecaster's attention (15-63 tokens, 16 heads of 8, fp32), GQA,
// causal / sliding-window, kv_len padding mask, exact two-pass softmax in
// fp32.
//
// Replaces, inside the envelope below, the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (body `_kernel`, kernel.py:35-85); flash_attention.cu (scalar) keeps the
// long sequences and fp32 at hd 64 / 128, flash_attention_tc.cu bf16 at hd
// 64 / 128. The function is the scalar kernel's:
//   s = (q . k) * scale, scale = 1/sqrt(hd), fp32 arithmetic;
//   mask = (key < kv_len) [& key <= q if causal] [& key > q - window];
//   masked probabilities are exactly 0; out = acc / max(l, 1e-30), so a
//   query row with no valid key returns 0; query head h reads kv head
//   h / (H / KV).
//
// What bounds it on the card. At the serving bucket (96, 15, 16, 8) fp32,
// q, k, v and o are 737,280 B each: 2.95 MB, 0.88 us at 3.35 TB/s, below
// the cost of one launch. At training's K x 32 rows (864, 15, 16, 8) they
// are 26.5 MB, 7.9 us. The flops (4 * B * H * hd * Sq * Skv: 11 MFLOP at
// the bucket) are ~1/20 of that at 67 TFLOP/s fp32. So bytes bound it, and
// at small batches the launch does. hd 8 is far below any tensor-core tile.
//
// Design (from the forecaster's shapes, not from the scalar kernel):
//   * one block per batch row b (grid B; the blocks stride over the batch,
//     so the grid never limits B). q[b], k[b] and v[b] are each ONE
//     contiguous slab ((Sq, H, hd) and (Skv, KV, hd): 7,680 B each at
//     (15, 16, 8) fp32). The block stages all three into shared memory with
//     16-byte cp.async copies, all issued before the first wait: q and k in
//     one group, v in a second that lands while the scores are computed.
//     Every byte is read once, coalesced, and no block restages another's
//     K/V. Only the first kv_len keys are staged;
//   * one thread per (query, head) pair, or two lanes per pair for a small
//     batch (below): pair p = head * Sq + query, so the pairs of a warp
//     share a head and their k / v row reads are shared-memory broadcasts
//     (q is transposed to this head-major order on the way in, and back on
//     the way out). 240 of 256 threads at the forecast shape, 480 of 480 at
//     two lanes. A pair's keys are one contiguous range [lo, hi) (kv_len,
//     causal and window bounds), so nothing is masked key by key;
//   * every key is on chip, so the softmax is exact and two-pass: the max,
//     then expf(s - m), the sum and P.V: one expf per kept key, no
//     rescaling. When kv_len <= 16 the scores stay in registers between the
//     passes (the loops unroll fully); otherwise the second pass recomputes
//     them in the same FMA order (bitwise the same scores);
//   * two lanes a pair (chosen when the grid at two lanes still fits in half
//     the card's warp slots: the serving buckets, not training's 864 rows)
//     take alternate keys, combine max, sum and P.V with one shuffle each,
//     and split a score into two FMA chains: the dependent chain per lane
//     halves, which is what bounds a small batch. Their k / v rows carry 16
//     bytes of padding per key, so two lanes reading neighbouring keys hit
//     different banks. One lane a pair does the least work per key, which
//     is what bounds a large batch (it is issue-bound);
//   * the output row goes into the pair's own q slot in shared memory, and
//     the block writes the (Sq, H, hd) slab back with 16-byte stores;
//   * expf, not __expf, and IEEE division (no --use_fast_math): the route
//     is held to the plain version within FLASH_ATTN_TOL = 1e-5. bf16
//     inputs are staged as bf16, computed in fp32 and the output rounded to
//     bf16 (nearest even) once, as the scalar kernel does.
// Envelope (ops.kernel_route): hd in {8, 16, 32}; Sq * H pairs at most
// 1024 threads at hd 8, 512 at hd 16, 256 at hd 32 (the launch bounds: a
// 1024-thread block has 64 registers a thread, which hold q, acc and 16
// cached scores only at hd 8; two lanes are taken up to 512 threads, 128
// registers); and the staged slabs, (Sq * H + 2 * Skv * KV) * hd *
// sizeof(T), at most kSmemBudget = 112 KiB, so two blocks of the largest
// fit one SM's 228 KB. That covers every LoGTST preset: up to 63 tokens x
// 16 heads = 1,008 threads, 96,768 B.
//
// C interface (bound with ctypes): flash_attention_short_fwd returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// outside the envelope; the caller raises if it is not 0.
// flash_attention_short_empty launches an empty kernel: the floor under any
// launch, which chip_smoke.py times beside the serving bucket.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kScoreCache = 16;           // scores kept in registers
constexpr int kSmemBudget = 112 * 1024;   // staged bytes per block
constexpr int kWarpSlotsPerSm = 64;       // resident warps an SM holds

template <int HD>
struct ShortLimits {
  static constexpr int kMaxThreads = HD == 8 ? 1024 : (HD == 16 ? 512 : 256);
  // two lanes a pair: at most 512 threads, so a lane has 128 registers
  static constexpr int kTwoLaneThreads = kMaxThreads < 512 ? kMaxThreads : 512;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// HD elements of one row in shared memory, as fp32
template <int HD>
__device__ __forceinline__ void load_row(const float* p, float* r) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 x = p4[i];
    r[4 * i] = x.x;
    r[4 * i + 1] = x.y;
    r[4 * i + 2] = x.z;
    r[4 * i + 3] = x.w;
  }
}

template <int HD>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* r) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    uint4 x = p4[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      r[8 * i + 2 * j] = f.x;
      r[8 * i + 2 * j + 1] = f.y;
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* p, const float* r) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i)
    p4[i] = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}

template <int HD>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* r) {
  uint4* p4 = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // round to nearest even, as torch's .to(bf16)
      h[j] = __floats2bfloat162_rn(r[8 * i + 2 * j], r[8 * i + 2 * j + 1]);
    p4[i] = x;
  }
}

// q . k in kChains FMA chains (d mod kChains) summed at the end: two
// chains halve a score's dependent chain, one needs the fewest registers
template <int HD, int kChains>
__device__ __forceinline__ float dot(const float* qr, const float* kr) {
  float part[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) part[c] = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d)
    part[d % kChains] = fmaf(qr[d], kr[d], part[d % kChains]);
  float s = part[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) s += part[c];
  return s;
}

// the sum / max over the L adjacent lanes of one (query, head) pair, in a
// fixed order (every lane of the warp takes part)
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int L>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// L lanes per (query, head) pair, each taking every L-th key; kCache:
// kv_len <= kScoreCache, the scores stay in registers
template <typename T, int HD, int L, bool kCache>
__global__ void __launch_bounds__(L == 1 ? ShortLimits<HD>::kMaxThreads
                                         : ShortLimits<HD>::kTwoLaneThreads)
flash_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int B, int Sq,
                   int Skv, int H, int KV, int kv_len, int causal,
                   int has_window, long long window, float scale) {
  constexpr int kRow16 = HD * static_cast<int>(sizeof(T)) / 16;  // per row
  constexpr int kPer = kScoreCache / L;  // cached scores per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = Sq * H;
  // k and v: (kv_len, KV, HD) as in memory; with two lanes a pair, each
  // key's KV rows are followed by 16 bytes of padding, so the lanes that
  // read neighbouring keys of one head hit different banks (one lane reads
  // broadcasts and keeps the registers the padding's indexing would take)
  constexpr int kPad16 = L > 1 ? 1 : 0;
  const int key16 = KV * kRow16;        // 16-byte chunks of one key
  const int kpad = (key16 + kPad16) * 16 / static_cast<int>(sizeof(T));
  T* qs = reinterpret_cast<T*>(smem);   // (H, Sq, HD): head-major
  T* ks = qs + pairs * HD;
  T* vs = ks + kv_len * kpad;
  uint4* sq4 = reinterpret_cast<uint4*>(qs);
  uint4* sk4 = reinterpret_cast<uint4*>(ks);
  uint4* sv4 = reinterpret_cast<uint4*>(vs);
  const int q16 = pairs * kRow16;
  const int kv16 = kv_len * key16;

  // lane r of pair p = h * Sq + i (head h, query i): the pairs of a warp
  // share a head, so their k / v row reads are shared-memory broadcasts
  const int p = threadIdx.x / L;
  const int r = threadIdx.x - p * L;
  const bool active = p < pairs;
  const int h = p / Sq;
  const int qi = p - h * Sq;
  const int kvh = h / (H / KV);
  // the keys this pair attends to: [lo, hi); this lane takes lo + r, + L, ...
  int hi = active ? kv_len : 0;
  if (causal) hi = min(hi, qi + 1);
  int lo = 0;
  if (has_window)
    lo = static_cast<int>(min(max(0LL, static_cast<long long>(qi) - window + 1),
                              static_cast<long long>(Skv)));
  lo += r;
  const int kstride = kpad;
  const T* krow = ks + kvh * HD;
  const T* vrow = vs + kvh * HD;
  T* qrow = qs + p * HD;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    // q[b] transposed to head-major on the way in; k[b] and v[b] as they lie
    const size_t q_off = static_cast<size_t>(b) * pairs * HD;
    const uint4* gq = reinterpret_cast<const uint4*>(q + q_off);
    const size_t kv_off = static_cast<size_t>(b) * Skv * KV * HD;
    const uint4* gk = reinterpret_cast<const uint4*>(k + kv_off);
    const uint4* gv = reinterpret_cast<const uint4*>(v + kv_off);
    for (int c = threadIdx.x; c < q16; c += blockDim.x) {
      const int row = c / kRow16;           // row = query * H + head
      const int qq = row / H;
      cp_async16(sq4 + ((row - qq * H) * Sq + qq) * kRow16 + (c - row * kRow16),
                 gq + c);
    }
    for (int c = threadIdx.x; c < kv16; c += blockDim.x)
      cp_async16(sk4 + c + kPad16 * (c / key16), gk + c);
    cp_async_commit();                     // group 0: q and k
    for (int c = threadIdx.x; c < kv16; c += blockDim.x)
      cp_async16(sv4 + c + kPad16 * (c / key16), gv + c);
    cp_async_commit();                     // group 1: v, in flight during pass 1
    cp_async_wait<1>();
    __syncthreads();

    float qr[HD], acc[HD];
    if (active) load_row<HD>(qrow, qr);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    float m = -INFINITY;
    float l = 0.f;
    if constexpr (kCache) {
      float s[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = lo + u * L;
        if (j < hi) {
          float kr[HD];
          load_row<HD>(krow + j * kstride, kr);
          s[u] = dot<HD, L>(qr, kr) * scale;
          m = fmaxf(m, s[u]);
        }
      }
      m = group_max<L>(m);
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = lo + u * L;
        if (j < hi) {
          const float pj = expf(s[u] - m);
          l += pj;
          float vr[HD];
          load_row<HD>(vrow + j * kstride, vr);
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] = fmaf(pj, vr[d], acc[d]);
        }
      }
    } else {
      for (int j = lo; j < hi; j += L) {
        float kr[HD];
        load_row<HD>(krow + j * kstride, kr);
        m = fmaxf(m, dot<HD, L>(qr, kr) * scale);
      }
      m = group_max<L>(m);
      cp_async_wait<0>();
      __syncthreads();
      for (int j = lo; j < hi; j += L) {
        float kr[HD], vr[HD];
        load_row<HD>(krow + j * kstride, kr);
        const float pj = expf(dot<HD, L>(qr, kr) * scale - m);
        l += pj;
        load_row<HD>(vrow + j * kstride, vr);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(pj, vr[d], acc[d]);
      }
    }
    if constexpr (L > 1) {
      l = group_sum<L>(l);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = group_sum<L>(acc[d]);
    }
    if (active && r == 0) {
      const float denom = fmaxf(l, 1e-30f);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = acc[d] / denom;
      store_row<HD>(qrow, acc);  // the pair's own q slot
    }
    __syncthreads();
    // back to (query, head) order: one contiguous run of 16-byte stores
    uint4* go = reinterpret_cast<uint4*>(o + q_off);
    for (int c = threadIdx.x; c < q16; c += blockDim.x) {
      const int row = c / kRow16;
      const int qq = row / H;
      go[c] = sq4[((row - qq * H) * Sq + qq) * kRow16 + (c - row * kRow16)];
    }
    __syncthreads();  // the slabs are restaged for the next batch row
  }
}

__global__ void empty_kernel() {}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return sms;
}

template <typename T, int HD, int L, bool kCache>
int launch_one(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int kv_len, int causal,
               int has_window, long long window, float scale, int threads,
               cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(Sq) * H + 2LL * kv_len * KV) * HD *
                      sizeof(T) + (L > 1 ? 2 * 16 * static_cast<size_t>(kv_len) : 0);
  auto kernel = flash_short_kernel<T, HD, L, kCache>;
  if (smem > 48 * 1024) {  // allow up to the device's opt-in limit
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), B, Sq, Skv, H, KV, kv_len,
      causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int L>
int launch_lanes(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Skv, int H, int KV, int kv_len, int causal,
                 int has_window, long long window, float scale,
                 cudaStream_t stream) {
  const int threads = (Sq * H * L + 31) / 32 * 32;
  if (kv_len <= kScoreCache)
    return launch_one<T, HD, L, true>(q, k, v, o, B, Sq, Skv, H, KV, kv_len,
                                      causal, has_window, window, scale,
                                      threads, stream);
  return launch_one<T, HD, L, false>(q, k, v, o, B, Sq, Skv, H, KV, kv_len,
                                     causal, has_window, window, scale,
                                     threads, stream);
}

// lanes per pair: 2 when the blocks at 2 lanes still fit in half the card's
// warp slots at once, else 1. A small batch (the serving buckets) then
// splits each pair's keys over two lanes and its dependent chain of keys
// halves; a large one (training's 864 rows) is bound by instruction issue
// and keeps one lane, which does the least work per key. (4 lanes were
// slower than 2 at every batch we built them for: their shuffles and extra
// warps cost more than the shorter chain saves.)
template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int H, int KV, int kv_len, int causal,
              int has_window, long long window, float scale,
              cudaStream_t stream) {
  const long long pairs = static_cast<long long>(Sq) * H;
  const long long staged = (pairs + 2LL * Skv * KV) * HD * sizeof(T);
  if (pairs > ShortLimits<HD>::kMaxThreads || staged > kSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = kWarpSlotsPerSm / 2 * static_cast<long long>(sm_count());
  const long long warps2 = (pairs * 2 + 31) / 32;
  if (pairs * 2 <= ShortLimits<HD>::kTwoLaneThreads && B * warps2 <= slots)
    return launch_lanes<T, HD, 2>(q, k, v, o, B, Sq, Skv, H, KV, kv_len,
                                  causal, has_window, window, scale, stream);
  return launch_lanes<T, HD, 1>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,
                                has_window, window, scale, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int hd, int kv_len, int causal,
           int has_window, long long window, float scale,
           cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch_hd<T, 8>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,
                             has_window, window, scale, stream);
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,
                              has_window, window, scale, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,
                              has_window, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous (B, S, heads, hd)
// with 16-byte aligned bases.
extern "C" int flash_attention_short_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int B, int Sq, int Skv, int H, int KV,
                                         int hd, int kv_len, int causal,
                                         int has_window, long long window,
                                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || kv_len < 0 ||
      kv_len > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                         has_window, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len,
                                 causal, has_window, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_short_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
