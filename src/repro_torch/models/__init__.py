"""Model zoo: every assigned architecture family as composable blocks.

Port of ``repro/models``.  Families: dense GQA transformers
(yi/qwen2/llama3/glm4), MoE (mixtral, llama4-scout), hybrid
Mamba+attention+MoE (jamba), recurrent xLSTM (sLSTM/mLSTM), encoder-only
audio (hubert), VLM backbone (llava).  One unified ``ModelConfig`` +
functional init/apply on nested dicts of tensors; each stage slot's
layers are stacked over the repeats.  ``params_from_jax`` carries the
reference's weights across; ``loss_fn`` (with the reference's ``remat``
policies) is what ``repro_torch.train`` differentiates.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, init_decode_cache,
                                      init_model, loss_fn, params_from_jax)

__all__ = ["ModelConfig", "init_model", "forward", "loss_fn", "decode_step",
           "init_decode_cache", "params_from_jax"]
