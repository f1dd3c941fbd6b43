"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536, MoE 16e top-2 every
other layer.  Jamba block: 8 layers with attention at index 4 (1:7
attn:mamba), Mamba d_state=16 d_conv=4 expand=2.  Decode state is
O(1)-dominated (28/32 layers Mamba) — the long_500k flagship.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    stage_period=8,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    num_experts=16, top_k=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    stage_period=8,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    num_experts=4, top_k=2,
    mamba_d_state=8, mamba_d_conv=4, mamba_expand=2, dtype="float32",
)
