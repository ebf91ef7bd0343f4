// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 inputs,
// head dim 64 or 128, GQA, causal / sliding-window, kv_len padding mask.
//
// Replaces, for bf16 at hd 64 and 128, the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (body `_kernel`, kernel.py:35-85); flash_attention_short.cu and
// flash_attention.cu keep every other case (float32, hd 8-32) on CUDA
// cores. The function is the same:
//   s = (q . k) * scale, scale = 1/sqrt(hd);
//   mask = (key < kv_len) [& key <= q if causal] [& key > q - window], in
//   absolute positions from 0 (Sq != Skv allowed);
//   masked probabilities are exactly 0; out = acc / max(l, 1e-30), so a row
//   with no valid key returns 0; query head h reads kv head h / (H / KV).
//
// Rounding. Q.K^T is a bf16 x bf16 product with fp32 accumulation (exact
// products); the scores, the running max m, the row sum l and the output
// accumulator stay fp32. P = 2^(s*c - m*c), c = scale * log2(e), one FFMA
// and one ex2.approx (relative error 2^-22; no --use_fast_math). The one
// change against the fp32 kernel: P is rounded to bf16 (nearest even)
// before the P.V product, which the tensor cores take in bf16; l sums the
// unrounded fp32 P. The output is rounded to bf16 (nearest even) once, at
// the end. The port holds this route to |got - want| <= 2^-7 |want| + 2^-8
// of the fp32 plain version (FLASH_BF16_RTOL / FLASH_BF16_ATOL in ops.py,
// with their reason).
//
// What bounds it on the card. At hymba-1.5b's prefill (4, 2048, 25/5, 64),
// causal with window 1024, the mask keeps 1,573,376 (query, key) pairs per
// (batch, head): 4 * B * H * hd * pairs = 4.03e10 flops, 0.041 ms at 989
// TFLOP/s (bf16 tensor cores); q and o (26.2 MB each), k and v (5.2 MB
// each) move 62.9 MB once, 0.019 ms at 3.35 TB/s; the exponentials (one per
// pair, 1.57e8) 0.038 ms on the special-function units. So the tensor cores
// bound it: operations.
//
// Design:
//   * a block is two consumer warpgroups (256 threads); each owns 64 query
//     rows, the wgmma M. Rows are the (position, head) pairs of ONE kv
//     head's group, flattened as r = position * G + g (G = H / KV): so the
//     G query heads that read the same kv head share every K/V tile the
//     block loads. grid (ceil(Sq * G / 128), KV, min(B, 65535)), the z
//     blocks striding over the batch; two blocks per SM at hd 64;
//   * Q rows are loaded once per (block, batch) by the threads, into shared
//     memory in the 128-byte swizzle wgmma reads; ragged rows are zero;
//   * K and V tiles of 64 keys x hd go through a ring of 3 stages in shared
//     memory, filled by TMA (cp.async.bulk.tensor over a rank-4 (B, S, KV,
//     hd) tensor map, 128-byte swizzle) and tracked by mbarriers: "full"
//     (transaction bytes) and "empty" (every consumer thread arrives). The
//     ragged key edge past Skv is zero-filled by the hardware and masked by
//     kv_len. Thread 0 refills a stage once both warpgroups released it;
//   * S = Q.K^T: hd/16 wgmma m64n64k16 (A and B from shared memory,
//     K-major). Online softmax on the accumulator registers (each thread
//     holds 2 rows x 16 keys; row max over the 4 threads of a quad); P is
//     packed to bf16 in registers and feeds O += P.V as the A operand from
//     registers: 4 wgmma m64n{hd}k16 with V read N-major (transposed) from
//     the same tile;
//   * a block visits only the key tiles that intersect [first position -
//     window + 1, last position] (and kv_len); a warpgroup skips the tiles
//     none of its rows sees, and masks (by each row's key range [lo, hi))
//     only the tiles its rows see in part: the edge and the diagonal;
//   * the output is normalised, rounded to bf16, staged through the
//     warpgroup's Q buffer and stored as 16-byte rows.
// Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: no link to libcuda) and passed
// as __grid_constant__ parameters, so a CUDA graph capture keeps them.
//
// C interface (bound with ctypes): flash_attention_tc_fwd returns
// cudaGetLastError() after the launch, or an error code for what it does
// not take (hd outside {64, 128}, a failed tensor-map encode); the caller
// raises if it is not 0.

#include <cuda.h>  // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 64;                 // query rows per warpgroup (wgmma M)
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kGroups = 2;                // consumer warpgroups per block
constexpr int kThreads = 128 * kGroups;
constexpr int kAtomBytes = 64 * 128;      // [64 rows][128 B], 128-byte swizzle
constexpr int kSwizzleRow = 128;          // bytes per row of an atom
constexpr int kBatchGrid = 65535;         // gridDim.z; the blocks stride over B
constexpr int kMaxDevices = 64;

template <int HD>
struct Cfg {
  static constexpr int kAtoms = HD / 64;             // 64-column atoms per row
  static constexpr int kTileBytes = kKeys * HD * 2;  // one K or V tile
  static constexpr int kQBytes = kRows * HD * 2;     // one warpgroup's Q / O
  static constexpr int kStages = 3;
  // 2 blocks per SM at hd 64 (128 registers a thread), 1 at hd 128
  static constexpr int kMinBlocks = HD == 64 ? 2 : 1;
  // Q buffers, K and V rings, 2 * kStages mbarriers, 1024 B for alignment
  static constexpr int kSmemBytes =
      kGroups * kQBytes + 2 * kStages * kTileBytes + 16 * kStages + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of the given parity to complete; a wait of more than
// 2^33 clocks (seconds) traps, so a protocol fault is a launch error and not
// a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > (1LL << 33)) __trap();
  }
}

// one box {64 columns, 1 head, 64 keys, 1 batch} of a (B, S, KV, hd) tensor
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int key, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(key), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous wgmma (it cannot see that the instruction owns them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit (relative error 2^-22, far below the
// bf16 rounding P takes next); exp2(-inf) = +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, N-major)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, N-major)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64_tb(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128_tb(acc, a, db);
}

// byte offset of 16-byte chunk `chunk` (of hd / 8) in row `row` of a
// [64 rows][hd] bf16 tile stored as hd / 64 swizzled atoms
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return (chunk >> 3) * kAtomBytes + row * kSwizzleRow +
         (((chunk & 7) ^ (row & 7)) << 4);
}

// -inf for the keys outside [lo, hi) of each of the thread's two rows;
// sc[4 * n8 + e] holds key key0 + 8 * n8 + e % 2 of row e / 2
__device__ __forceinline__ void mask_tile(float (&sc)[32], int key0,
                                          const int (&lo)[2],
                                          const int (&hi)[2]) {
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * n8 + (e & 1);
      const int h = e >> 1;
      if (static_cast<unsigned>(key - lo[h]) >=
          static_cast<unsigned>(max(hi[h] - lo[h], 0)))
        sc[4 * n8 + e] = -INFINITY;
    }
  }
}

// online softmax of one tile of raw scores: the running max m, the rescale
// of l and acc, and P = exp2(s * c - m * c), c = scale * log2(e), summed
// into l in fp32 and packed to bf16 as the A fragments of P.V
template <int HD>
__device__ __forceinline__ void softmax_tile(const float (&sc)[32],
                                             float (&acc)[HD / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pf)[4][4],
                                             float scale_log2) {
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
      mx = fmaxf(mx, fmaxf(sc[4 * n8 + 2 * h], sc[4 * n8 + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row that has seen no valid key yet: P = exp2(-inf) = 0, and its
    // (zero) l and acc need no correction
    const float corr =
        mx == -INFINITY ? 1.f : exp2_approx((m[h] - mx) * scale_log2);
    base[h] = mx == -INFINITY ? 0.f : mx * scale_log2;
    m[h] = mx;
    l[h] *= corr;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      acc[4 * n8 + 2 * h] *= corr;
      acc[4 * n8 + 2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[e] = exp2_approx(fmaf(sc[4 * n8 + e], scale_log2, -base[e >> 1]));
      l[e >> 1] += pv[e];
    }
    pf[n8 >> 1][2 * (n8 & 1) + 0] = pack_bf16(pv[0], pv[1]);
    pf[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(pv[2], pv[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Cfg<HD>::kMinBlocks)
flash_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ o, int B, int Sq, int H, int KV,
                int kv_len, int causal, int has_window, int window,
                float scale_log2) {
  using C = Cfg<HD>;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem + kGroups * C::kQBytes;
  uint8_t* vs = ks + C::kStages * C::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kTileBytes);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + C::kStages);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wt = tid % 128;
  const int warp = wt / 32;
  const int lane = tid % 32;
  const int quad_row = lane / 4;  // row within the warp's 8-row half
  const int quad_col = lane % 4;  // column pair within an 8-column block
  uint8_t* qs = smem + wg * C::kQBytes;
  const uint32_t qs_addr = smem_u32(qs);

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long r_block = static_cast<long long>(blockIdx.x) * kGroups * kRows;
  const long long r_wg = r_block + wg * kRows;
  const bool wg_live = r_wg < rows;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // keys some row of the block may see: [k_begin, k_end)
  // (positions, keys and the window are int: the host clamps the window to
  // [-(Skv + 1), Sq + 1], which keeps every mask as it is)
  const long long r_block_last = min(r_block + kGroups * kRows, rows) - 1;
  const int p_first = static_cast<int>(r_block / G);
  const int p_last = static_cast<int>(r_block_last / G);
  const int k_end = causal ? min(kv_len, p_last + 1) : kv_len;
  const int k_begin = has_window ? max(0, p_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;
  // positions of the warpgroup's live rows, and of this thread's two rows
  const int wp_min = static_cast<int>(r_wg / G);
  const int wp_max = static_cast<int>((min(r_wg + kRows, rows) - 1) / G);
  // this thread's two rows see the keys [lo, hi)
  const long long row_a = r_wg + warp * 16 + quad_row;
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = static_cast<int>((row_a + 8 * h) / G);
    lo[h] = has_window ? max(0, p - window + 1) : 0;
    hi[h] = causal ? min(kv_len, p + 1) : kv_len;
  }

  // thread 0 fills stage (i mod kStages) with tile j of batch b; i counts
  // every tile the block has loaded, so it gives the stage and the phase
  auto load_tile = [&](uint32_t i, int j, int b) {
    const int s = i % C::kStages;
    if (i >= C::kStages) mbar_wait(empty0 + 8 * s, ((i / C::kStages) - 1) & 1);
    mbar_expect_tx(full0 + 8 * s, 2 * C::kTileBytes);
    const int key = k_begin + j * kKeys;
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
      tma_load(smem_u32(ks + s * C::kTileBytes + a * kAtomBytes), &kmap,
               full0 + 8 * s, 64 * a, kvh, key, b);
      tma_load(smem_u32(vs + s * C::kTileBytes + a * kAtomBytes), &vmap,
               full0 + 8 * s, 64 * a, kvh, key, b);
    }
  };

  uint32_t it = 0;  // tiles the block loaded before this batch
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    if (tid == 0) {
      for (int j = 0; j < n_tiles && j < C::kStages; ++j) load_tile(it + j, j, b);
    }
    // this warpgroup's 64 query rows, swizzled; rows past Sq * G are zero
    for (int c = wt; c < kRows * kChunks; c += 128) {
      const int rr = c / kChunks;
      const int ch = c % kChunks;
      const long long r = r_wg + rr;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows) {
        const long long p = r / G;
        const int h = kvh * G + static_cast<int>(r - p * G);
        val = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * Sq + p) * H + h) * HD + ch * 8);
      }
      *reinterpret_cast<uint4*>(qs + swizzled(rr, ch)) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j) {
      const uint32_t ij = it + j;
      const int s = ij % C::kStages;
      mbar_wait(full0 + 8 * s, (ij / C::kStages) & 1);
      const int kt0 = k_begin + j * kKeys;
      const bool any = wg_live && (!causal || kt0 <= wp_max) &&
                       (!has_window || kt0 + kKeys - 1 > wp_min - window);
      if (any) {
        // S = Q . K^T (64 rows x 64 keys, fp32, raw scores)
        float sc[32];
        const uint32_t k_addr = smem_u32(ks + s * C::kTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
          wgmma_ss_n64(sc, smem_desc(qs_addr + off, 16, 1024),
                       smem_desc(k_addr + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // the mask, only on tiles some row of the warpgroup sees in part
        const bool whole = kt0 + kKeys <= kv_len &&
                           (!causal || kt0 + kKeys - 1 <= wp_min) &&
                           (!has_window || kt0 > wp_max - window);
        if (!whole) mask_tile(sc, kt0 + 2 * quad_col, lo, hi);

        uint32_t pf[4][4];
        softmax_tile<HD>(sc, acc, m, l, pf, scale_log2);

        // O += P . V (64 rows x hd, fp32); V read N-major from the tile
        const uint32_t v_addr = smem_u32(vs + s * C::kTileBytes);
        fence_regs(acc);
        fence_regs(pf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_pv<HD>(acc, pf[kk],
                       smem_desc(v_addr + kk * 16 * kSwizzleRow, kAtomBytes,
                                 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(empty0 + 8 * s);
      if (tid == 0 && j + C::kStages < n_tiles) {
        load_tile(ij + C::kStages, j + C::kStages, b);
      }
    }
    it += n_tiles;

    // out = acc / max(l, 1e-30) in bf16, staged in this warpgroup's Q buffer
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
    warpgroup_sync(wg);  // every warp is done reading Q
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = warp * 16 + quad_row + 8 * h;
        const uint32_t v =
            pack_bf16(acc[4 * n8 + 2 * h] / l[h], acc[4 * n8 + 2 * h + 1] / l[h]);
        *reinterpret_cast<uint32_t*>(qs + swizzled(rr, n8) + 4 * quad_col) = v;
      }
    }
    warpgroup_sync(wg);
    for (int c = wt; c < kRows * kChunks; c += 128) {
      const int rr = c / kChunks;
      const int ch = c % kChunks;
      const long long r = r_wg + rr;
      if (r < rows) {
        const long long p = r / G;
        const int h = kvh * G + static_cast<int>(r - p * G);
        *reinterpret_cast<uint4*>(
            o + ((static_cast<size_t>(b) * Sq + p) * H + h) * HD + ch * 8) =
            *reinterpret_cast<const uint4*>(qs + swizzled(rr, ch));
      }
    }
    warpgroup_sync(wg);  // the buffer is read before the next batch's Q
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a rank-4 map over a contiguous (B, S, KV, hd) bf16 tensor whose box is one
// 64-key x 64-column atom of one head, 128-byte swizzled; reads past S fill
// with zeros
int encode_kv_map(CUtensorMap* map, const void* base, int B, int S, int KV,
                  int hd) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * KV, row * KV * S};
  const cuuint32_t box[4] = {64, 1, kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int kv_len, int causal, int has_window,
           long long window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap kmap, vmap;
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  if (Skv > 0) {  // Skv == 0 means kv_len == 0: no tile is ever loaded
    int err = encode_kv_map(&kmap, k, B, Skv, KV, HD);
    if (err == 0) err = encode_kv_map(&vmap, v, B, Skv, KV, HD);
    if (err != 0) return err;
  }
  // more than 48 KB of dynamic shared memory: allowed once per device
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(flash_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  // keys k > q - window: a window above Sq + 1 keeps every key, one below
  // -(Skv + 1) none, so the clamp changes no mask and fits an int
  const int win = static_cast<int>(
      window > Sq + 1LL ? Sq + 1LL : window < -(Skv + 1LL) ? -(Skv + 1LL) : window);
  const long long rows = static_cast<long long>(Sq) * (H / KV);
  const dim3 grid(static_cast<unsigned>((rows + kGroups * kRows - 1) /
                                        (kGroups * kRows)),
                  KV, B < kBatchGrid ? B : kBatchGrid);
  flash_tc_kernel<HD><<<grid, kThreads, C::kSmemBytes, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), B, Sq, H, KV, kv_len, causal,
      has_window, win, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 tensors, contiguous (B, S, heads, hd) with hd 64 or 128, each
// 16-byte aligned; H % KV == 0.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int kv_len, int causal, int has_window,
                                      long long window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,
                      has_window, window, scale, s);
  if (hd == 128)
    return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, kv_len, causal,
                       has_window, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
