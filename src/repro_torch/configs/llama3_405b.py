"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783].

126L d_model=16384 128H (kv=8) d_ff=53248 vocab=128256, rope theta 500k.
The memory-pressure anchor of the dry-run matrix (≈405B params).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    rope_theta=500_000.0, dtype="float32",
)
