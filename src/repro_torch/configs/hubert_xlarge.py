"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447].

48L d_model=1280 16H (kv=16, MHA) d_ff=5120 vocab=504 (cluster targets).
Encoder-only: non-causal attention, no decode path (decode cells are
skipped per spec).  The CNN waveform frontend is a STUB: ``input_specs()``
feeds precomputed frame embeddings.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, encoder_only=True, frontend="audio",
    rope_fraction=0.0,          # hubert uses conv positional embeddings;
                                # the stub frontend bakes positions in
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
    d_ff=128, vocab_size=32,
    causal=False, encoder_only=True, frontend="audio",
    rope_fraction=0.0, dtype="float32",
)
