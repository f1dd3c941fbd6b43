"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone only (per spec): the mistral-7B transformer — 32L d_model=4096
32H (kv=8) d_ff=14336 vocab=32000.  The anyres vision frontend is a STUB:
``input_specs()`` feeds precomputed patch embeddings (B, S, d_model)
through a learned projector.  Trained with mixed token+patch context.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    frontend="vision",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="llava-next-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    frontend="vision",
    rope_theta=1_000_000.0, dtype="float32",
)
