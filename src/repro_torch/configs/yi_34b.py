"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000, rope theta 5M.
56 heads do not divide the 16-way model axis — attention falls back to
sequence-parallel sharding (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense",
    num_layers=2, d_model=56, num_heads=7, num_kv_heads=1,
    d_ff=96, vocab_size=128,
    rope_theta=5_000_000.0, dtype="float32",
)
