"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048.  Attention is chunked
local (8192) with a global NoPE layer every 4th (stage slot 3); MoE top-1
of 16 on every layer.  long_500k runs: local layers' KV is chunk-bounded,
global layers keep the full cache (3/4 of layers bounded; noted in
DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    stage_period=4, block_pattern=("attn",) * 4,
    moe_pattern=(True,) * 4,
    num_experts=16, top_k=1,
    chunk_attn=8192, global_attn_slots=(3,),
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    stage_period=4, block_pattern=("attn",) * 4,
    moe_pattern=(True,) * 4,
    num_experts=4, top_k=1,
    chunk_attn=8, global_attn_slots=(3,),
    rope_theta=500_000.0, dtype="float32",
)
