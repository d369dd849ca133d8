"""Target-hardware constants: one NVIDIA H100 SXM, the card the port runs on.

``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reports it
as ``NVIDIA H100 80GB HBM3, 700.00 W``.  The rates are NVIDIA's published
peaks for that part (data sheet and the Hopper architecture white paper,
dense, no sparsity) at the full 700 W power limit; a card set below it runs
slower under load.  The reference module's names are kept where
a counterpart exists (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``HBM_BYTES``).
"""

PEAK_FLOPS_BF16 = 989e12       # tensor cores, bf16 (and fp16), FLOP/s
PEAK_FLOPS_F32 = 67e12         # CUDA cores, float32 FMA counted as 2, FLOP/s
# the data sheet gives no int32 rate of the CUDA cores; the f32 rate bounds
# it from above, so a roofline bound taken with it is never too high
PEAK_OPS_INT32 = 67e12
HBM_BW = 3.35e12               # bytes/s of device memory
HBM_BYTES = 80 * 2**30         # device memory, five HBM3 stacks of 16 GiB
SM_COUNT = 132                 # streaming multiprocessors
SMEM_PER_SM = 228 * 2**10      # shared memory (with L1) a multiprocessor holds
SMEM_PER_BLOCK = 232_448       # the most dynamic shared memory one block may opt in to
L2_BYTES = 50 * 2**20          # L2 cache
NVLINK_BW = 450e9              # bytes/s each way to the other cards of the host (900 GB/s both)
POWER_LIMIT_W = 700.0          # the limit these peaks assume
