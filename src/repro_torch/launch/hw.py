"""NVIDIA H100 SXM hardware model: the dry run's target and the smoke's bounds.

Port of ``repro/launch/hw.py`` with the H100's constants in place of the
TPU v5e's, under the reference's names where the two share a meaning, so
a cell's rows line up with the reference's.  Sources: NVIDIA's H100 data
sheet (SXM part, dense rates without sparsity, at the full 700 W power
limit) and the Hopper architecture white paper, except where a line says
otherwise.
"""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, bf16 tensor cores, dense
TC_TF32_FLOPS = 494.7e12        # FLOP/s per card, TF32 tensor cores, dense
OPS_PER_S = 67e12               # float32 operations/s outside the tensor
                                # cores (the data sheet has no separate
                                # 32-bit integer rate)
HBM_BW = 3.35e12                # device-memory bytes/s per card
HBM_BYTES = 80 * 10**9          # device memory per card, the data sheet's
                                # 80 GB; ``chip_smoke.py`` phase 3k prints
                                # it beside ``total_memory`` of the card

NVLINK_BW = 450e9               # bytes/s each way to the other cards of
                                # a node, all to all
NODE_CARDS = 8                  # cards a node (DGX H100 / HGX H100 8-GPU)
NET_BW = 50e9                   # bytes/s per card across nodes: one 400
                                # Gb/s port a GPU, a DGX H100's published
                                # fabric; a deployment figure, not a
                                # measurement

# One dependent row gather's latency: the whole-walk kernel (B1) over
# the populated one-rank share of FULL (163,840 rows, C = 1024, mean
# degree 35) with two walkers an SM (264), L = 80: 0.14067 ms / 80.
# Measured by ``chip_smoke.py`` phase 3k (``dma_latency``) on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit; the smoke prints the card's
# value beside this one on every run.
DMA_LATENCY = 1.7584e-6         # seconds

SINGLE_POD_CHIPS = 256          # 16 x 16 ranks
MULTI_POD_CHIPS = 512           # 2 x 16 x 16 ranks
