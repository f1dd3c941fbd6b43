"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000, MoE 8e top-2 on every
layer, sliding-window attention 4096 (which bounds decode KV and makes
long_500k a *run* cell).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    num_experts=8, top_k=2, moe_pattern=(True,),
    sliding_window=4096,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    num_experts=4, top_k=2, moe_pattern=(True,),
    sliding_window=8,
    rope_theta=1_000_000.0, dtype="float32",
)
