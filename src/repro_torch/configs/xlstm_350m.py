"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  Layer mix follows the
xLSTM[7:1] recipe (best in the paper): one sLSTM slot per 8-layer stage,
seven mLSTM.  d_ff=0 — the compute lives in the blocks' internal pf=2
(mLSTM) / pf=4/3 (sLSTM) projections.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    stage_period=8,
    block_pattern=("slstm",) + ("mlstm",) * 7,
    xlstm_pf=2.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="ssm",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=128,
    stage_period=8,
    block_pattern=("slstm",) + ("mlstm",) * 7,
    xlstm_pf=2.0,
    tie_embeddings=True, dtype="float32",
)
