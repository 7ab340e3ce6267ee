"""Gemma 7B.

[arXiv:2403.08295] — 28 layers, d_model 3072, 16 heads with head_dim 256
(kv=16 i.e. full MHA on the 7B; MQA is the 2B variant), FFN 24576 GeGLU,
vocab 256000, tied + scaled embeddings.  Identical to the reference's
``repro/configs/gemma_7b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256_000,
    head_dim=256,
    rope_theta=10_000.0,
    mlp_activation="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    scale_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma-7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
