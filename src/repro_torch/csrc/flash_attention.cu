// Flash attention forward for Hopper (sm_90a), the general route: GQA,
// causal / sliding-window, kv_len padding mask, online softmax in fp32, on
// the tensor cores in 3xTF32.
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
// The route's name, "scalar" (ops.kernel_route, ops.ROUTE_LAUNCHES), is
// historical: it named this file's first design, one thread per query row
// doing fp32 FMAs. The name is kept so that every route check still reads.
//
// Which calls reach it: the ones no other route takes. bf16 at hd 64 / 128
// goes to flash_attention_tc.cu; short sequences at hd 8-32 (the LoGTST
// forecaster) to flash_attention_short.cu. This kernel takes fp32 at every
// hd (8-128), and bf16 at hd 8-32 outside the short kernel's envelope. Its
// main calls are the float32 prefills of the zoo (configs with
// dtype="float32", as the reference's examples/long_context_decode.py and
// its fp32 parity checks build them): hymba-1.5b (4, 2048, 25/5, 64),
// causal, window 1,024, and qwen2-1.5b (4, 2048, 12/2, 128), causal.
//
// What bounds it on the card. hymba's call keeps 1,573,376 (query, key)
// pairs a head: 4.03e10 flops over 125.8 MB; qwen2's keeps 2,098,176:
// 5.16e10 flops over 117.4 MB. Both are bound by operations: 0.601 / 0.770
// ms at the fp32 CUDA-core rate (67 TFLOP/s), 0.244 / 0.313 ms as 3xTF32 on
// the tensor cores (3 x flops at 495 TFLOP/s); bytes take 0.038 / 0.035 ms.
//
// Design (the limits of the design before it, and what this one does):
//   * products on the tensor cores in 3xTF32 (mma.sync m16n8k8 tf32; wgmma's
//     tf32 wants both operands K-major, which P.V's V tile is not). Each
//     fp32 operand is split into a TF32 high part (rounded to nearest) and
//     the rest, a = hi + lo, and a.b ~ hi.hi + hi.lo + lo.hi, accumulated in
//     fp32: what is dropped is ~2^-21 relative, far inside the route's 1e-5.
//     bf16 inputs are exact in TF32: q.k takes one product, P.V two (P is
//     fp32). Before: one thread a query row, its dot product a serial chain
//     of hd dependent FMAs;
//   * registers: a warp owns MW m-tiles of 16 query rows, which share each
//     K and V fragment and its split; its S tile (16 MW x BN) and its output
//     (16 MW x hd) are mma fragments spread over 32 lanes (MW x hd / 2
//     accumulators a thread), so nothing spills at hd 128 (Cfg). Before: q
//     and acc (2 x hd floats) in each thread's registers, over the 255 a
//     thread may have at hd 128;
//   * K/V staging: a ring of STAGES tiles in dynamic shared memory filled by
//     16-byte cp.async (zero-filled past the block's last key), tile i + 1
//     in flight while tile i is multiplied, one __syncthreads a tile. Rows
//     are padded so that every fragment load is free of bank conflicts.
//     Before: scalar loads, two barriers a tile, no overlap;
//   * GQA and grid order: a block takes one (batch row, kv head) and 16 x
//     warps rows of the flattened (position, head of the group) axis, as
//     flash_attention_tc.cu does, so each K/V tile is read once for the G
//     query heads. The query tiles run in reverse (gridDim.y is the slowest
//     axis of the launch order), so under a causal mask the longest tiles
//     start first; tiles wholly outside the mask are never loaded. Before:
//     one block a query head (K/V staged G times), shortest first;
//   * softmax once a tile: the rows' maxima by quad shuffles, one rescale of
//     the accumulator a tile, the row sums kept per lane and reduced by quad
//     shuffles at the end; masks are evaluated only in the tiles that cross
//     a mask edge. expf, and an IEEE division at the end (do not build with
//     --use_fast_math). Before: a rescale behind a branch at every key.
//
// C interface (bound with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch (or the error of the set-up); the
// caller raises if it is not 0. q, k, v and o are contiguous and 16-byte
// aligned (the wrapper copies a view that is not).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kMaxDevices = 64;
constexpr int kGridYLimit = 65535;

// Tile shapes, chosen by timing variants on the H100 at the two fp32
// prefill calls: MW 16-row m-tiles a warp share each K and V fragment (and
// its split), BN keys a tile. At hd 64 two m-tiles of 64 keys (~240
// registers, two blocks an SM) beat one m-tile; at hd 128 two m-tiles need
// 128 accumulators a thread, so the S tile shrinks to 16 keys (one m-tile
// of 32 keys was slower, two of 32 spilled). A third stage cost a block an
// SM and was slower at both.
template <int HD>
struct Cfg {
  static constexpr int MW = HD >= 64 ? 2 : 1;
  static constexpr int BN = HD >= 128 ? 16 : HD == 64 ? 64 : 32;
  static constexpr int STAGES = 2;  // the K/V ring
};

// Row strides in shared memory, in elements. Q and K are read as pairs
// (dims 2t, 2t + 1 of an 8-dim step): a stride of hd + 8 keeps the 8-byte
// (fp32) or 4-byte (bf16) pairs of a quarter / half warp on distinct banks.
// V is read one element at a time from rows 2t and 2t + 1: hd + 4 (fp32) or
// hd + 8 (bf16). Every stride keeps a row a multiple of 16 bytes (cp.async).
template <typename T, int HD>
struct Stride {
  static constexpr int K = HD % 16 == 0 ? HD + 8 : HD;
  static constexpr int V = sizeof(T) == 4 ? HD + 4 : HD + 8;
};

template <typename T, int HD>
constexpr size_t smem_bytes(int rows) {
  return (static_cast<size_t>(Cfg<HD>::STAGES) * Cfg<HD>::BN *
              (Stride<T, HD>::K + Stride<T, HD>::V) +
          static_cast<size_t>(rows) * Stride<T, HD>::K) *
         sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = fill ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 high part, rounded to nearest (ties away), and the remainder, which
// is exact in fp32; the tensor cores read the top 19 bits of each operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// D += A . B, A 16 x 8 (row), B 8 x 8 (col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  // round to nearest even, as torch's .to(bf16)
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Grid: x = B * KV (a batch row's kv head), y = query tiles, taken in
// reverse. Block: 32 x warps threads; warp w owns rows [16 MW w, 16 MW (w +
// 1)) of the block's tile of the flattened (position, head of the group)
// axis, as MW m-tiles of 16; lane (g, t) holds rows g and g + 8 of each.
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int kv_len, int causal, int has_window,
                 int window, float scale, int n_qtiles) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BN = Cfg<HD>::BN;
  constexpr int ST = Cfg<HD>::STAGES;
  constexpr int MW = Cfg<HD>::MW;
  constexpr int R = 2 * MW;  // rows a lane holds
  constexpr int PK = Stride<T, HD>::K;
  constexpr int PV = Stride<T, HD>::V;
  constexpr int EL = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int CH = HD / EL;         // 16-byte copies a row
  const float kInf = __int_as_float(0x7f800000);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // ST x BN x PK
  T* vs = ks + ST * BN * PK;               // ST x BN x PV
  T* qs = vs + ST * BN * PV;               // BM x PK

  const int nthreads = blockDim.x;
  const int BM = nthreads / 2 * MW;  // 16 MW rows a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // mma fragment row (and B column)
  const int tig = lane & 3;   // mma fragment column pair
  const int G = H / KV;
  const int rows = Sq * G;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const size_t key_stride = static_cast<size_t>(KV) * HD;
  const T* kbase = k + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const T* vbase = v + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;

  for (int qt = n_qtiles - 1 - static_cast<int>(blockIdx.y); qt >= 0;
       qt -= static_cast<int>(gridDim.y)) {
    const int r0 = qt * BM;
    const int r_last = min(r0 + BM, rows) - 1;
    const int p_first = r0 / G;
    const int p_last = r_last / G;
    // the keys some row of the block may attend to: [k_begin, k_end)
    int k_end = kv_len;
    if (causal) k_end = min(k_end, p_last + 1);
    int k_begin = 0;
    if (has_window) k_begin = max(0, p_first - window + 1);
    const int n_tiles = k_begin < k_end ? (k_end - k_begin + BN - 1) / BN : 0;

    __syncthreads();  // the previous query tile is done with shared memory
    // Q tile: rows past the last one are zero-filled
    for (int c = threadIdx.x; c < BM * CH; c += nthreads) {
      const int row = c / CH;
      const int part = c - row * CH;
      const int r = r0 + row;
      const bool live = r < rows;
      const int p = live ? r / G : 0;
      const int h = kvh * G + (live ? r - p * G : 0);
      const T* src = q + ((static_cast<size_t>(b) * Sq + p) * H + h) * HD +
                     part * EL;
      cp_async16(qs + row * PK + part * EL, src, live);
    }
    auto load_tile = [&](int i) {
      const int t0 = k_begin + i * BN;
      T* kd = ks + (i % ST) * BN * PK;
      T* vd = vs + (i % ST) * BN * PV;
      for (int c = threadIdx.x; c < BN * CH; c += nthreads) {
        const int j = c / CH;
        const int part = c - j * CH;
        const int key = t0 + j;
        const bool live = key < k_end;
        const size_t off = (live ? key * key_stride : 0) + part * EL;
        cp_async16(kd + j * PK + part * EL, kbase + off, live);
        cp_async16(vd + j * PV + part * EL, vbase + off, live);
      }
    };
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_tiles) load_tile(i);
      cp_async_commit();  // group 0 also holds the Q tile
    }

    const int wr = warp * 16 * MW;  // the warp's first row in the tile
    int pos[R];                     // the positions of the lane's rows
#pragma unroll
    for (int j = 0; j < R; ++j) pos[j] = (r0 + wr + 8 * j + gid) / G;
    const int wp_first = (r0 + wr) / G;
    const int wp_last = (r0 + wr + 16 * MW - 1) / G;
    const bool warp_live = r0 + wr < rows;
    float acc[MW][HD / 8][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.f;
    float m[R], l[R];  // running maxima (quad-uniform), this lane's sums
#pragma unroll
    for (int j = 0; j < R; ++j) {
      m[j] = -kInf;
      l[j] = 0.f;
    }

    // the A fragments of Q's 8-dim step kk for m-tile mt: dims 2t, 2t + 1
    // of rows g and g + 8, split into TF32 high and low parts
    auto load_q = [&](int kk, int mt, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
      const T* qrow = qs + (wr + 16 * mt + gid) * PK + kk * 8 + 2 * tig;
      const float2 qa = load_pair(qrow);
      const float2 qb = load_pair(qrow + 8 * PK);
      if constexpr (kF32) {
        split_tf32(qa.x, hi[0], lo[0]);
        split_tf32(qb.x, hi[1], lo[1]);
        split_tf32(qa.y, hi[2], lo[2]);
        split_tf32(qb.y, hi[3], lo[3]);
      } else {  // bf16 is exact in tf32
        hi[0] = __float_as_uint(qa.x);
        hi[1] = __float_as_uint(qb.x);
        hi[2] = __float_as_uint(qa.y);
        hi[3] = __float_as_uint(qb.y);
        lo[0] = lo[1] = lo[2] = lo[3] = 0u;
      }
    };

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<ST - 2>();  // tile i (and the Q tile) has landed
      __syncthreads();          // ... for every thread; tile i - 1 is free
      if (i + ST - 1 < n_tiles) load_tile(i + ST - 1);
      cp_async_commit();
      if (!warp_live) continue;
      const int t0 = k_begin + i * BN;
      const T* kt = ks + (i % ST) * BN * PK;
      const T* vt = vs + (i % ST) * BN * PV;

      // S = Q K^T. k-slot t of an 8-dim step is dim 2t, slot t + 4 dim
      // 2t + 1, in A and B alike, so each lane loads pairs.
      float s[MW][BN / 8][4];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ahi[MW][4], alo[MW][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) load_q(kk, mt, ahi[mt], alo[mt]);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          const float2 kb = load_pair(kt + (n * 8 + gid) * PK + kk * 8 + 2 * tig);
          if constexpr (kF32) {
            uint32_t bhi0, blo0, bhi1, blo1;
            split_tf32(kb.x, bhi0, blo0);
            split_tf32(kb.y, bhi1, blo1);
#pragma unroll
            for (int mt = 0; mt < MW; ++mt) {
              mma_tf32(s[mt][n], alo[mt], bhi0, bhi1);
              mma_tf32(s[mt][n], ahi[mt], blo0, blo1);
              mma_tf32(s[mt][n], ahi[mt], bhi0, bhi1);
            }
          } else {
#pragma unroll
            for (int mt = 0; mt < MW; ++mt)
              mma_tf32(s[mt][n], ahi[mt], __float_as_uint(kb.x),
                       __float_as_uint(kb.y));
          }
        }
      }

      // scale and mask; s[mt][n][0..1] are row 2 mt's keys t0 + 8n + 2 tig
      // (+1), s[mt][n][2..3] row 2 mt + 1's. Only tiles that cross a mask
      // edge test keys.
      const bool edge = t0 + BN > kv_len ||
                        (causal && t0 + BN - 1 > wp_first) ||
                        (has_window && t0 <= wp_last - window);
      float base[R], corr[R], sum[R];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        float xA = -kInf, xB = -kInf;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][n][e] * scale;
            if (edge) {
              const int key = t0 + n * 8 + 2 * tig + (e & 1);
              const int p = pos[2 * mt + (e >> 1)];
              const bool keep = key < kv_len && (!causal || key <= p) &&
                                (!has_window || key > p - window);
              x = keep ? x : -kInf;
            }
            s[mt][n][e] = x;
          }
          xA = fmaxf(xA, fmaxf(s[mt][n][0], s[mt][n][1]));
          xB = fmaxf(xB, fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
        xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
        xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
        xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
        const float x2[2] = {xA, xB};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * mt + h;
          const float nm = fmaxf(m[j], x2[h]);
          // a row with no valid key so far keeps max -inf: subtract 0
          // instead, so every probability is exactly 0 and acc stays 0
          base[j] = nm == -kInf ? 0.f : nm;
          corr[j] = expf(m[j] - base[j]);
          m[j] = nm;
          sum[j] = 0.f;
        }
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * mt + (e >> 1);
            s[mt][n][e] = expf(s[mt][n][e] - base[j]);
            sum[j] += s[mt][n][e];
          }
        }
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          acc[mt][d][0] *= corr[2 * mt];
          acc[mt][d][1] *= corr[2 * mt];
          acc[mt][d][2] *= corr[2 * mt + 1];
          acc[mt][d][3] *= corr[2 * mt + 1];
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) l[j] = l[j] * corr[j] + sum[j];

      // O += P V. k-slot t of key step n is key 8n + 2t, slot t + 4 key
      // 8n + 2t + 1: then P's A fragment is S's accumulator as it lies.
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        uint32_t phi[MW][4], plo[MW][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) {
          split_tf32(s[mt][n][0], phi[mt][0], plo[mt][0]);
          split_tf32(s[mt][n][2], phi[mt][1], plo[mt][1]);
          split_tf32(s[mt][n][1], phi[mt][2], plo[mt][2]);
          split_tf32(s[mt][n][3], phi[mt][3], plo[mt][3]);
        }
        const T* v0 = vt + (n * 8 + 2 * tig) * PV + gid;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const float x0 = load_one(v0 + d * 8);
          const float x1 = load_one(v0 + PV + d * 8);
          if constexpr (kF32) {
            uint32_t bhi0, blo0, bhi1, blo1;
            split_tf32(x0, bhi0, blo0);
            split_tf32(x1, bhi1, blo1);
#pragma unroll
            for (int mt = 0; mt < MW; ++mt) {
              mma_tf32(acc[mt][d], plo[mt], bhi0, bhi1);
              mma_tf32(acc[mt][d], phi[mt], blo0, blo1);
              mma_tf32(acc[mt][d], phi[mt], bhi0, bhi1);
            }
          } else {
#pragma unroll
            for (int mt = 0; mt < MW; ++mt) {
              mma_tf32(acc[mt][d], plo[mt], __float_as_uint(x0),
                       __float_as_uint(x1));
              mma_tf32(acc[mt][d], phi[mt], __float_as_uint(x0),
                       __float_as_uint(x1));
            }
          }
        }
      }
    }
    cp_async_wait<0>();  // no copy may land after the next tile's barrier

    if (warp_live) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float lj = l[j];
        lj += __shfl_xor_sync(0xffffffffu, lj, 1);
        lj += __shfl_xor_sync(0xffffffffu, lj, 2);
        const float den = fmaxf(lj, 1e-30f);
        const int r = r0 + wr + 8 * j + gid;
        if (r < rows) {
          const int p = pos[j];
          T* out = o + ((static_cast<size_t>(b) * Sq + p) * H + kvh * G +
                        (r - p * G)) * HD + 2 * tig;
          const int mt = j >> 1;
          const int e = 2 * (j & 1);
#pragma unroll
          for (int d = 0; d < HD / 8; ++d)
            store_pair(out + d * 8, acc[mt][d][e] / den,
                       acc[mt][d][e + 1] / den);
        }
      }
    }
  }
}

// per device and instantiation, once: allow the dynamic shared memory of a
// block of kMaxWarps warps
template <typename T, int HD>
int prepare() {
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    const size_t bytes = smem_bytes<T, HD>(kMaxWarps * 16 * Cfg<HD>::MW);
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  return 0;
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int H, int KV, int kv_len, int causal,
              int has_window, long long window, float scale,
              cudaStream_t stream) {
  int err = prepare<T, HD>();
  if (err != 0) return err;
  const long long rows = static_cast<long long>(Sq) * (H / KV);
  const long long blocks_x = static_cast<long long>(B) * KV;
  if (rows + 1024 > INT_MAX || blocks_x > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int wrows = 16 * Cfg<HD>::MW;  // rows a warp
  const int warps = static_cast<int>(
      rows >= kMaxWarps * wrows ? kMaxWarps : (rows + wrows - 1) / wrows);
  const int bm = warps * wrows;
  const int n_qtiles = static_cast<int>((rows + bm - 1) / bm);
  // keys k > q - window: a window above Sq + 1 keeps every key, one below
  // -(Skv + 1) none, so the clamp changes no mask and fits an int
  const int win = static_cast<int>(
      window > Sq + 1LL ? Sq + 1LL : window < -(Skv + 1LL) ? -(Skv + 1LL) : window);
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  n_qtiles < kGridYLimit ? n_qtiles : kGridYLimit);
  flash_fwd_kernel<T, HD><<<grid, warps * 32, smem_bytes<T, HD>(bm), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, kv_len,
      causal, has_window, win, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int hd, int kv_len, int causal,
           int has_window, long long window, float scale,
           cudaStream_t stream) {
#define REPRO_FA_CASE(HD)                                                      \
  case HD:                                                                     \
    return launch_hd<T, HD>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,     \
                            has_window, window, scale, stream);
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
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous (B, S, heads, hd)
// and 16-byte aligned; H % KV == 0.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Sq, int Skv,
                                   int H, int KV, int hd, int kv_len,
                                   int causal, int has_window,
                                   long long window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                         has_window, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len,
                                 causal, has_window, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
