"""qwen2-0.5b [dense] — GQA with QKV bias [arXiv:2407.10671].

24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936; tied embeddings
(the 0.5B variant ties), rope theta 1M.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    num_layers=2, d_model=56, num_heads=7, num_kv_heads=1,
    d_ff=96, vocab_size=128,
    qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0, dtype="float32",
)
