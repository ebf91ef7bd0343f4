"""Hardware constants of the port's target, one NVIDIA H100 SXM (80 GB).

Counterpart of ``repro.common.hw``, which holds the reference's TPU
constants; none of those is copied. These are published peaks: the dry run
(``launch.dryrun``) turns FLOP and byte counts into roofline seconds with
them, and ``chip_smoke.py`` computes each kernel's ``bound_ms`` from them.
They assume the card's full 700 W power limit; a card set lower runs slower
under load, so a measurement is reported beside its card's name and limit.
"""

# HBM3: 80 GB at 3.35 TB/s (NVIDIA H100 data sheet, SXM).
HBM_BYTES = 80e9
HBM_BYTES_PER_S = 3.35e12

# float32 outside the tensor cores, FMA counted as 2 FLOPs (data sheet).
FP32_FLOP_PER_S = 67e12

# dense bf16 (and fp16) on the tensor cores, without sparsity (data sheet).
BF16_FLOP_PER_S = 989e12

# dense TF32 on the tensor cores, without sparsity (data sheet). A float32
# product done as 3xTF32 (three TF32 products of split operands) takes
# three times its flops at this rate.
TF32_FLOP_PER_S = 495e12

# the special-function units' ex2: 16 per clock per SM (CUDA C Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x the 1.98 GHz boost clock (data sheet).
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# NVLink 4: 18 links, 900 GB/s both ways, 450 GB/s each way (data sheet).
NVLINK_BYTES_PER_S = 450e9

# shared memory: 228 KB per SM, of which one block may take 227 KB (CUDA C
# Programming Guide, compute capability 9.0).
SMEM_BYTES_PER_SM = 228 * 1024
SMEM_BYTES_PER_BLOCK = 227 * 1024
