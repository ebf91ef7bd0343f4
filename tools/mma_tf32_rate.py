#!/usr/bin/env python3
"""The rate of ``mma.sync.m16n8k8`` in TF32 on one GPU: the ceiling of the
general flash kernel (``src/repro_torch/csrc/flash_attention.cu``), whose
products are 3xTF32 on this instruction.

    python3 tools/mma_tf32_rate.py

It compiles a kernel in which every warp issues ``mma.sync`` on NACC
independent accumulators (no loads, no other work), with ``nvcc`` and the
port's flags, into ``build/tools/``, launches it at several grids (blocks
and threads a block) and prints one JSON line per launch with its TFLOP/s
(2 flops a multiply-add, CUDA events around a second launch), then a last
line with the best rate and the card's name and power limit. It needs a
CUDA GPU and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int NACC>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i) & 0xffffe000u;
  const uint32_t b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  float acc[NACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 12345.f) out[0] = s;  // keeps the loop
}
extern "C" float mma_ms(int nacc, int blocks, int threads, int iters) {
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(e0);
    if (nacc == 4) mma_loop<4><<<blocks, threads>>>(out, iters);
    else if (nacc == 8) mma_loop<8><<<blocks, threads>>>(out, iters);
    else mma_loop<16><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""
ITERS = 2048
GRIDS = ((132, 128), (264, 128), (132, 256), (528, 128), (264, 256))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    build = os.path.join(ROOT, "build", "tools")
    os.makedirs(build, exist_ok=True)
    src, lib = os.path.join(build, "mma_tf32_rate.cu"), os.path.join(build, "mma_tf32_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).mma_ms
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_float
    best = 0.0
    for nacc in (4, 8, 16):
        for blocks, threads in GRIDS:
            ms = fn(nacc, blocks, threads, ITERS)
            if ms <= 0:
                raise RuntimeError(f"mma_loop failed at {nacc}, {blocks} x {threads}")
            flops = blocks * threads // 32 * ITERS * nacc * 2 * 16 * 8 * 8
            tflops = flops / ms / 1e9
            best = max(best, tflops)
            print(json.dumps({"nacc": nacc, "blocks": blocks, "threads": threads,
                              "ms": ms, "tflops": tflops}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"mma_sync_tf32_best_tflops": best, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
