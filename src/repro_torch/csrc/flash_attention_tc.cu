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
// unrounded fp32 P. The output is acc times the reciprocal of max(l, 1e-30)
// rounded to nearest (__frcp_rn; within two fp32 roundings of the quotient,
// and a row of zeros stays 0), rounded to bf16 (nearest even) once, at the
// end. The port holds this route to |got - want| <= 2^-7 |want| + 2^-8
// of the fp32 plain version (FLASH_BF16_RTOL / FLASH_BF16_ATOL in ops.py,
// with their reason).
//
// What bounds each shape on this card (bf16 tensor cores 989 TFLOP/s, HBM
// 3.35 TB/s, ex2 on the special-function units ~4.2e12/s). The work is
// 4 * B * H * hd flops per (query, key) pair the mask keeps, one ex2 per
// pair, and q, k, v, o moved once. At 2,048 tokens the tensor cores bound
// it (phi3.5-moe's prefill (4, 2048, 32/8, 128) causal: 1.4e11 flops,
// 0.139 ms; hymba's (4, 2048, 25/5, 64) window 1024: 0.041 ms, its ex2s
// 0.038 ms just below). At 512 tokens and below the bytes bound it
// ((4, 512, 32/8, 128): 41.9 MB, 0.0125 ms), and what a call really pays
// there is latency: a block's pipeline fill, its Q load, its epilogue and
// the last partial wave. At hd 64 the ex2s of a key tile take as long as
// its two GEMMs; at hd 128 half as long.
//
// Design, and what each part does about that:
//   1. warp specialisation: a block is 3 warpgroups (384 threads, one block
//      per SM) entered at 168 registers a thread. Warpgroup 0 drops to 40
//      (setmaxnreg.dec) and one thread of it issues every TMA load: Q, and
//      the K/V ring. Warpgroups 1 and 2 (the consumers) take the registers
//      it frees, 232 each (setmaxnreg.inc; 128 x 40 + 256 x 232 = 65,536),
//      and do only the math. So no refill waits behind a consumer's math.
//      (ptxas still allocates the consumer code within the 168 it enters
//      with; it fits without spills: the O staging is written through
//      32-bit shared addresses, and no array is indexed by the consumer's
//      runtime index, which would put it in local memory);
//   2. softmax overlapped with the GEMMs. Inside a consumer, key tile j
//      issues S_j = Q.K_j^T and O += P_{j-1}.V_{j-1} together, waits with
//      wgmma.wait_group 1 (S_j done, the P.V still running), runs the mask
//      and online softmax of S_j under that P.V, then waits 0 and rescales
//      O. Between the two consumers, named barriers (1, 2) hand the tensor
//      cores over in turn (ping-pong): each issues its GEMMs only after the
//      other has issued, so one consumer's softmax runs under the other's
//      GEMMs;
//   3. Q by the producer. A consumer's 64 rows are the (position, head)
//      pairs of ONE kv head's group, r = position * G + g (G = H / KV): the
//      G query heads of a kv head read each K/V tile the block loads once.
//      Q and O go through a rank-5 tensor map (hd, G, KV, Sq, B) whose box
//      is {64 columns, Gb heads, 1, Pb positions, 1}: Gb = min(G, 64),
//      Pb = 64 / G positions when G <= 64 (G = 5 or 6: 12 or 10 positions,
//      60 of the 64 rows; the rows past Pb * Gb are zero and never stored),
//      one position and ceil(G / 64) head chunks a position when G > 64.
//      Positions past Sq and heads past G read as zeros and are not written.
//      Each consumer has two Q buffers: the producer loads tile t+1's Q
//      while tile t runs. The output is normalised into a staging buffer
//      and written by a TMA store that overlaps the next tile;
//   4. a persistent grid: min(SMs, work tiles) blocks (the SM count is read
//      once per device). A work tile is (batch, kv head, row block of two
//      consumers' rows); tiles are ranked with the row blocks that see the
//      most key tiles first (the last row blocks under a causal mask) and
//      dealt to the blocks in a snake order (rank k * grid + i for block i
//      in even rounds, k * grid + grid - 1 - i in odd ones), so the long
//      tiles start first and a block's long and short tiles pair up. The
//      schedule is static: no tile counter, no memset under a graph
//      capture, each row computed by one warpgroup in one order (repeated
//      calls are bitwise equal). B is not a grid dimension, so any batch
//      fits;
//   5. tiles per hd: hd 64 takes 128-key tiles (its ex2s cost as much as
//      its GEMMs, so the per-tile costs, a barrier wait, two quad shuffles
//      per row max and the O rescale, are halved; S 64 + P 32 + O 32
//      registers a thread), 4 stages; hd 128 takes 64-key tiles, 4 stages:
//      128-key tiles would leave room for only 2 stages of K/V (64 KB each)
//      beside the two consumers' double Q (64 KB) and O staging (32 KB) in
//      the 227 KB, too shallow to hide a load under one tile, and S 64 + P
//      32 + O 64 registers would not fit the 168 ptxas allocates.
// A key tile is visited only if it intersects [first position - window + 1,
// last position] of the work tile (and kv_len); both consumers visit the
// same tiles (the ping-pong hands over once per tile), and the mask is
// applied only to tiles some row of the consumer sees in part: the edge and
// the diagonal.
// Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: no link to libcuda) and passed
// as __grid_constant__ parameters, so a CUDA graph capture keeps them.
//
// C interface (bound with ctypes): flash_attention_tc_fwd returns
// cudaGetLastError() after the launch, or an error code for what it does
// not take (hd outside {64, 128}, a failed tensor-map encode, a kernel not
// compiled to the register count the setmaxnreg split assumes); the caller
// raises if it is not 0.

#include <cuda.h>  // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 64;                  // query rows per consumer (wgmma M)
constexpr int kConsumers = 2;              // consumer warpgroups per block
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kEntryRegs = 168;            // 65,536 / 384, a multiple of 8
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;         // 128 x 40 + 256 x 232 = 65,536
constexpr int kSwizzleRow = 128;           // bytes per row of a swizzled atom
constexpr int kQAtomBytes = kRows * kSwizzleRow;  // [64 rows][64 columns]
constexpr int kMaxDevices = 64;

template <int HD>
struct Cfg {
  static constexpr int kKeys = HD == 64 ? 128 : 64;    // keys per K/V tile
  static constexpr int kStages = 4;
  static constexpr int kAtoms = HD / 64;               // 64-column atoms per row
  static constexpr int kKVAtomBytes = kKeys * kSwizzleRow;
  static constexpr int kTileBytes = kKeys * HD * 2;    // one K or V tile
  static constexpr int kQBytes = kRows * HD * 2;       // one consumer's Q / O
  static constexpr int kS = kKeys / 2;                 // score registers a thread
  // mbarriers: K/V full and empty per stage, Q full and empty per
  // (consumer, buffer)
  static constexpr int kBarriers = 2 * kStages + 4 * kConsumers;
  // Q (2 buffers a consumer), O staging, the K and V rings, the barriers,
  // 1024 B for alignment
  static constexpr int kSmemBytes = 3 * kConsumers * kQBytes +
                                    2 * kStages * kTileBytes + 8 * kBarriers +
                                    1024;
  static_assert(kSmemBytes <= 232448, "shared memory above 227 KB");
};

// what the kernel needs besides the tensor maps (host-computed)
struct Params {
  int Sq, KV, kv_len, causal, has_window, window;
  int Gb;       // heads of a row block's position (min(G, 64))
  int Pb;       // positions of a consumer's row block
  int nC;       // head chunks a position (1 when G <= 64)
  int M;        // work tiles per (batch, kv head)
  int BKV;      // B * KV
  int T;        // work tiles
  int q_bytes;  // bytes of one consumer's Q box, all atoms
  float scale_log2;
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

// one box {64 columns, 1 head, kKeys keys, 1 batch} of a (B, S, KV, hd) tensor
__device__ __forceinline__ void tma_load_kv(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int head,
                                            int key, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(key), "r"(batch)
      : "memory");
}

// one box {64 columns, Gb heads, 1 kv head, Pb positions, 1 batch} of the
// (hd, G, KV, Sq, B) view of q
__device__ __forceinline__ void tma_load_q(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int col, int g,
                                           int kvh, int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(g),
      "r"(kvh), "r"(pos), "r"(batch)
      : "memory");
}

// the same box of the output, from shared memory; writes past the tensor's
// edges are dropped by the hardware
__device__ __forceinline__ void tma_store_o(const CUtensorMap* map, uint32_t src,
                                            int col, int g, int kvh, int pos,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(g), "r"(kvh), "r"(pos), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores issued so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barriers: 1 + c hands the tensor cores to consumer c (256 threads:
// its own sync and the other consumer's arrive); 3 + c is consumer c alone
__device__ __forceinline__ void pingpong_sync(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void pingpong_arrive(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous wgmma (it cannot see that the instruction owns them), and
// from reusing an operand's registers before the wgmma that reads them is
// done
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
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
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

// D (64 x 128, fp32) (+)= A (64 x 16, smem) * B (128 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
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
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
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

// S = Q . K^T: hd / 16 wgmmas over a consumer's Q buffer and a K tile
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<HD>::kS],
                                         uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss(sc, smem_desc(q_addr + (kk >> 2) * kQAtomBytes + col, 16, 1024),
             smem_desc(k_addr + (kk >> 2) * Cfg<HD>::kKVAtomBytes + col, 16,
                       1024),
             kk > 0);
  }
}

// O += P . V: kKeys / 16 wgmmas, P from registers, V read N-major from its tile
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pf)[Cfg<HD>::kKeys / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < Cfg<HD>::kKeys / 16; ++kk)
    wgmma_rs(acc, pf[kk],
             smem_desc(v_addr + kk * 16 * kSwizzleRow, Cfg<HD>::kKVAtomBytes,
                       1024));
}

// byte offset of 16-byte chunk `chunk` (of hd / 8) in row `row` of a
// [64 rows][hd] bf16 tile stored as hd / 64 swizzled atoms
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return (chunk >> 3) * kQAtomBytes + row * kSwizzleRow +
         (((chunk & 7) ^ (row & 7)) << 4);
}

// -inf for the keys outside [lo, hi) of each of the thread's two rows;
// sc[4 * n8 + e] holds key key0 + 8 * n8 + e % 2 of row e / 2
template <int NS>
__device__ __forceinline__ void mask_tile(float (&sc)[NS], int key0,
                                          const int (&lo)[2],
                                          const int (&hi)[2]) {
#pragma unroll
  for (int n8 = 0; n8 < NS / 4; ++n8) {
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

// online softmax of one tile of raw scores, in place: the new running max
// m, the factor `corr` that rescales the earlier l and O (l now, O once the
// P.V in flight is done), and P = exp2(s * c - m * c), c = scale * log2(e),
// summed into l in fp32
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2) {
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n8 = 0; n8 < NS / 4; ++n8)
      mx = fmaxf(mx, fmaxf(sc[4 * n8 + 2 * h], sc[4 * n8 + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row that has seen no valid key yet: P = exp2(-inf) = 0, and its
    // (zero) l and O need no correction
    corr[h] = mx == -INFINITY ? 1.f : exp2_approx((m[h] - mx) * scale_log2);
    base[h] = mx == -INFINITY ? 0.f : mx * scale_log2;
    m[h] = mx;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int n8 = 0; n8 < NS / 4; ++n8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n8 + e] = exp2_approx(fmaf(sc[4 * n8 + e], scale_log2, -base[e >> 1]));
      l[e >> 1] += sc[4 * n8 + e];
    }
  }
}

// P rounded to bf16 as the A fragments of P.V: fragment kk holds keys
// 16 kk .. 16 kk + 15, i.e. score blocks n8 = 2 kk and 2 kk + 1
template <int NS>
__device__ __forceinline__ void pack_p(const float (&sc)[NS],
                                       uint32_t (&pf)[NS / 8][4]) {
#pragma unroll
  for (int n8 = 0; n8 < NS / 4; ++n8) {
    pf[n8 >> 1][2 * (n8 & 1) + 0] = pack_bf16(sc[4 * n8 + 0], sc[4 * n8 + 1]);
    pf[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(sc[4 * n8 + 2], sc[4 * n8 + 3]);
  }
}

template <int NA>
__device__ __forceinline__ void rescale(float (&acc)[NA], const float (&corr)[2]) {
#pragma unroll
  for (int n8 = 0; n8 < NA / 4; ++n8) {
    acc[4 * n8 + 0] *= corr[0];
    acc[4 * n8 + 1] *= corr[0];
    acc[4 * n8 + 2] *= corr[1];
    acc[4 * n8 + 3] *= corr[1];
  }
}

// one work tile: batch b, kv head kvh, row block pair mi of (b, kvh), and
// the key tiles [k_begin, k_begin + n * kKeys) the block visits
struct Tile {
  int b, kvh, mi, k_begin, n;
};

// consumer c's row block of work tile pair mi: its first position p0 and
// first head g0
__device__ __forceinline__ void row_block(const Params& p, int mi, int c,
                                          int& p0, int& g0) {
  const int u = kConsumers * mi + c;  // row block of (batch, kv head)
  const int pb = u / p.nC;
  p0 = pb * p.Pb;
  g0 = (u - pb * p.nC) * 64;
}

// the w-th work tile in longest-first order: the last row blocks (which,
// under a causal mask, see the most keys) of every (batch, kv head) first
template <int HD>
__device__ __forceinline__ Tile work_tile(const Params& p, int w) {
  Tile t;
  const int rank = w / p.BKV;
  const int bk = w - rank * p.BKV;
  t.mi = p.M - 1 - rank;
  t.b = bk / p.KV;
  t.kvh = bk - t.b * p.KV;
  int p_first, p_last, g;
  row_block(p, t.mi, 0, p_first, g);
  row_block(p, t.mi, kConsumers - 1, p_last, g);
  p_last = min(p_last + p.Pb - 1, p.Sq - 1);
  // (positions, keys and the window are int: the host clamps the window
  // to [-(Skv + 1), Sq + 1], which keeps every mask as it is)
  const int k_end = p.causal ? min(p.kv_len, p_last + 1) : p.kv_len;
  t.k_begin = p.has_window ? max(0, p_first - p.window + 1) : 0;
  t.n = k_end > t.k_begin
            ? (k_end - t.k_begin + Cfg<HD>::kKeys - 1) / Cfg<HD>::kKeys
            : 0;
  return t;
}

// the block's k-th work tile in snake order, or -1 past the end
__device__ __forceinline__ int dealt(const Params& p, int k) {
  const int i = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int w = k * gridDim.x + i;
  return w < p.T ? w : -1;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap omap, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Q of consumer c, buffer q: (2 c + q); O of consumer c: 2 kConsumers + c
  uint8_t* ks = smem + 3 * kConsumers * C::kQBytes;
  uint8_t* vs = ks + C::kStages * C::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kTileBytes);
  const uint32_t kv_full0 = smem_u32(bars);
  const uint32_t kv_empty0 = kv_full0 + 8 * C::kStages;
  const uint32_t q_full0 = kv_empty0 + 8 * C::kStages;       // + 8 (2 c + q)
  const uint32_t q_empty0 = q_full0 + 8 * 2 * kConsumers;    // + 8 (2 c + q)

  const int tid = threadIdx.x;
  // broadcast from lane 0 (as CUTLASS does), so the role is uniform in
  // each warp by construction
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(kv_full0 + 8 * s, 1);
      mbar_init(kv_empty0 + 8 * s, kConsumerThreads);
    }
#pragma unroll
    for (int i = 0; i < 2 * kConsumers; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      uint32_t it = 0;  // K/V tiles loaded so far: stage and phase
      int t = 0;        // work tiles loaded so far: Q buffer and phase
      for (int k = 0; k * static_cast<int>(gridDim.x) < p.T; ++k) {
        const int w = dealt(p, k);
        if (w < 0) continue;
        const Tile tl = work_tile<HD>(p, w);
        const int qb = t & 1;
#pragma unroll
        for (int c = 0; c < kConsumers; ++c) {
          const int i = 2 * c + qb;
          int p0, g0;
          row_block(p, tl.mi, c, p0, g0);
          if (t >= 2) mbar_wait(q_empty0 + 8 * i, ((t >> 1) - 1) & 1);
          mbar_expect_tx(q_full0 + 8 * i, p.q_bytes);
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a)
            tma_load_q(smem_u32(smem + i * C::kQBytes + a * kQAtomBytes), &qmap,
                       q_full0 + 8 * i, 64 * a, g0, tl.kvh, p0, tl.b);
        }
        for (int j = 0; j < tl.n; ++j, ++it) {
          const int s = it % C::kStages;
          if (it >= C::kStages)
            mbar_wait(kv_empty0 + 8 * s, ((it / C::kStages) - 1) & 1);
          mbar_expect_tx(kv_full0 + 8 * s, 2 * C::kTileBytes);
          const int key = tl.k_begin + j * C::kKeys;
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a) {
            tma_load_kv(smem_u32(ks + s * C::kTileBytes + a * C::kKVAtomBytes),
                        &kmap, kv_full0 + 8 * s, 64 * a, tl.kvh, key, tl.b);
            tma_load_kv(smem_u32(vs + s * C::kTileBytes + a * C::kKVAtomBytes),
                        &vmap, kv_full0 + 8 * s, 64 * a, tl.kvh, key, tl.b);
          }
        }
        ++t;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int wt = tid % 128;
    const int warp = wt / 32;
    const int lane = tid % 32;
    const int quad_row = lane / 4;  // row within the warp's 8-row half
    const int quad_col = lane % 4;  // column pair within an 8-column block
    constexpr int kChunks = HD / 8;  // 16-byte chunks per row
    uint8_t* os = smem + (2 * kConsumers + c) * C::kQBytes;

    // the rows past Pb * Gb of both Q buffers are never loaded: zero them
    const int live = p.Pb * p.Gb;
    for (int i = wt; i < 2 * (kRows - live) * kChunks; i += 128) {
      const int qb = i / ((kRows - live) * kChunks);
      const int r = live + (i / kChunks) % (kRows - live);
      *reinterpret_cast<uint4*>(smem + (2 * c + qb) * C::kQBytes +
                                swizzled(r, i % kChunks)) =
          make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
    consumer_sync(c);
    if (c == 1) pingpong_arrive(0);  // consumer 0 takes the tensor cores first

    uint32_t it = 0;
    int t = 0;
    for (int k = 0; k * static_cast<int>(gridDim.x) < p.T; ++k) {
      const int w = dealt(p, k);
      if (w < 0) continue;
      const Tile tl = work_tile<HD>(p, w);
      const int qb = t & 1;
      const uint32_t q_addr = smem_u32(smem + (2 * c + qb) * C::kQBytes);
      const uint32_t q_empty = q_empty0 + 8 * (2 * c + qb);

      // positions of the consumer's rows, and of this thread's two rows,
      // which see the keys [lo, hi)
      int p0, g0;
      row_block(p, tl.mi, c, p0, g0);
      const int wp_min = p0;
      const int wp_max = p0 + p.Pb - 1;
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = p0 + (warp * 16 + quad_row + 8 * h) / p.Gb;
        lo[h] = p.has_window ? max(0, pos - p.window + 1) : 0;
        hi[h] = p.causal ? min(p.kv_len, pos + 1) : p.kv_len;
      }
      // key tile j needs the mask unless every row sees all of it
      auto whole = [&](int kt0) {
        return kt0 + C::kKeys <= p.kv_len &&
               (!p.causal || kt0 + C::kKeys - 1 <= wp_min) &&
               (!p.has_window || kt0 > wp_max - p.window);
      };

      float acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
      float l[2] = {0.f, 0.f};

      mbar_wait(q_full0 + 8 * (2 * c + qb), (t >> 1) & 1);
      if (tl.n == 0) {
        mbar_arrive(q_empty);
      } else {
        float sc[C::kS];
        uint32_t pf[C::kKeys / 16][4];
        float corr[2];
        // key tile 0: S alone
        {
          const int s = it % C::kStages;
          mbar_wait(kv_full0 + 8 * s, (it / C::kStages) & 1);
          pingpong_sync(c);
          wgmma_fence();
          issue_qk<HD>(sc, q_addr, smem_u32(ks + s * C::kTileBytes));
          wgmma_commit();
          pingpong_arrive(1 - c);
          wgmma_wait<0>();
          fence_regs(sc);
          if (tl.n == 1) mbar_arrive(q_empty);
          if (!whole(tl.k_begin)) mask_tile(sc, tl.k_begin + 2 * quad_col, lo, hi);
          softmax_tile(sc, m, l, corr, p.scale_log2);
          pack_p(sc, pf);
        }
        // key tile j: S_j and P_{j-1}.V_{j-1} in flight together, the
        // softmax of S_j under the P.V
        for (int j = 1; j < tl.n; ++j) {
          const uint32_t ij = it + j;
          const int s = ij % C::kStages;
          const int s_prev = (ij - 1) % C::kStages;
          mbar_wait(kv_full0 + 8 * s, (ij / C::kStages) & 1);
          pingpong_sync(c);
          wgmma_fence();
          issue_qk<HD>(sc, q_addr, smem_u32(ks + s * C::kTileBytes));
          wgmma_commit();
          issue_pv<HD>(acc, pf, smem_u32(vs + s_prev * C::kTileBytes));
          wgmma_commit();
          pingpong_arrive(1 - c);
          wgmma_wait<1>();
          fence_regs(sc);
          if (j == tl.n - 1) mbar_arrive(q_empty);
          const int kt0 = tl.k_begin + j * C::kKeys;
          if (!whole(kt0)) mask_tile(sc, kt0 + 2 * quad_col, lo, hi);
          softmax_tile(sc, m, l, corr, p.scale_log2);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(pf);
          mbar_arrive(kv_empty0 + 8 * s_prev);
          rescale(acc, corr);
          pack_p(sc, pf);
        }
        // the last P.V
        const int s_last = (it + tl.n - 1) % C::kStages;
        wgmma_fence();
        issue_pv<HD>(acc, pf, smem_u32(vs + s_last * C::kTileBytes));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pf);
        mbar_arrive(kv_empty0 + 8 * s_last);
        it += tl.n;
      }

      // out = acc * (1 / max(l, 1e-30)) in bf16, staged in the consumer's O
      // buffer (once the previous tile's store has read it) and stored by TMA
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = __frcp_rn(fmaxf(l[h], 1e-30f));
      }
      if (wt == 0) bulk_wait_read();
      consumer_sync(c);
      // this thread's row, made opaque per tile so the compiler keeps no
      // addresses live across the tile loop; rows 8 apart share a swizzle
      uint32_t row_addr = smem_u32(os) + (warp * 16 + quad_row) * kSwizzleRow +
                          4 * quad_col;
      asm volatile("" : "+r"(row_addr));
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const uint32_t addr = row_addr + (n8 >> 3) * kQAtomBytes +
                              (((n8 & 7) ^ quad_row) << 4);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st_shared(addr + 8 * h * kSwizzleRow,
                    pack_bf16(acc[4 * n8 + 2 * h] * l[h],
                              acc[4 * n8 + 2 * h + 1] * l[h]));
      }
      fence_async_smem();
      consumer_sync(c);
      if (wt == 0) {
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_store_o(&omap, smem_u32(os + a * kQAtomBytes), 64 * a, g0, tl.kvh,
                      p0, tl.b);
        bulk_commit();
      }
      ++t;
    }
    if (wt == 0) bulk_wait();
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

// a bf16 tensor map with 128-byte swizzle whose reads past the edges fill
// with zeros (and whose stores there are dropped)
int encode_map(CUtensorMap* map, const void* base, cuuint32_t rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a contiguous (B, S, KV, hd) k or v; the box is one 64-column atom of
// `keys` keys of one head
int encode_kv_map(CUtensorMap* map, const void* base, int B, int S, int KV,
                  int hd, int keys) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * KV, row * KV * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(keys), 1};
  return encode_map(map, base, 4, dims, strides, box);
}

// a contiguous (B, Sq, H, hd) q or o seen as (hd, G, KV, Sq, B); the box is
// one 64-column atom of Gb heads at Pb positions of one kv head's group
int encode_q_map(CUtensorMap* map, const void* base, int B, int Sq, int H,
                 int KV, int hd, int Gb, int Pb) {
  const cuuint64_t G = static_cast<cuuint64_t>(H / KV);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(hd), G,
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(Sq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;  // bytes
  const cuuint64_t strides[4] = {row, row * G, row * H, row * H * Sq};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(Gb), 1,
                             static_cast<cuuint32_t>(Pb), 1};
  return encode_map(map, base, 5, dims, strides, box);
}

// per device, once: the SM count, and the kernel's shared-memory limit and
// register count checked (setmaxnreg's split assumes kEntryRegs at entry)
template <int HD>
int prepare(int* sms) {
  static int sm_count[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[device] == 0) {
    err = cudaFuncSetAttribute(flash_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<HD>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_tc_kernel<HD>);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs != kEntryRegs) return static_cast<int>(cudaErrorInvalidKernelImage);
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[device] = n;
  }
  *sms = sm_count[device];
  return 0;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int kv_len, int causal, int has_window,
           long long window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  int sms = 0;
  int err = prepare<HD>(&sms);
  if (err != 0) return err;
  const int G = H / KV;
  Params p;
  p.Sq = Sq;
  p.KV = KV;
  p.kv_len = kv_len;
  p.causal = causal;
  p.has_window = has_window;
  // keys k > q - window: a window above Sq + 1 keeps every key, one below
  // -(Skv + 1) none, so the clamp changes no mask and fits an int
  p.window = static_cast<int>(
      window > Sq + 1LL ? Sq + 1LL : window < -(Skv + 1LL) ? -(Skv + 1LL) : window);
  p.Gb = G < 64 ? G : 64;
  p.Pb = G <= 64 ? 64 / G : 1;
  p.nC = (G + 63) / 64;
  const long long blocks = (static_cast<long long>(Sq) + p.Pb - 1) / p.Pb * p.nC;
  const long long M = (blocks + kConsumers - 1) / kConsumers;
  const long long T = M * B * KV;
  // tile indices, and k * grid + grid, stay ints
  if (T > INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  p.M = static_cast<int>(M);
  p.BKV = B * KV;
  p.T = static_cast<int>(T);
  p.q_bytes = p.Pb * p.Gb * kSwizzleRow * C::kAtoms;
  p.scale_log2 = scale * 1.4426950408889634f;

  CUtensorMap kmap, vmap, qmap, omap;
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  if (Skv > 0) {  // Skv == 0 means kv_len == 0: no K/V tile is ever loaded
    err = encode_kv_map(&kmap, k, B, Skv, KV, HD, C::kKeys);
    if (err == 0) err = encode_kv_map(&vmap, v, B, Skv, KV, HD, C::kKeys);
    if (err != 0) return err;
  }
  err = encode_q_map(&qmap, q, B, Sq, H, KV, HD, p.Gb, p.Pb);
  if (err == 0) err = encode_q_map(&omap, o, B, Sq, H, KV, HD, p.Gb, p.Pb);
  if (err != 0) return err;
  const int grid = p.T < sms ? p.T : sms;
  flash_tc_kernel<HD><<<grid, kThreads, C::kSmemBytes, stream>>>(kmap, vmap, qmap,
                                                                 omap, p);
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
