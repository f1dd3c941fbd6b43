"""glm4-9b [dense] — RoPE (partial, half-dim), GQA [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552, rotary on half the
head dims (GLM's partial-rotary convention).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    rope_fraction=0.5,
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    rope_fraction=0.5, dtype="float32",
)
