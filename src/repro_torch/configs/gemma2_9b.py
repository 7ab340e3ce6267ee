"""Gemma 2 9B.

[arXiv:2408.00118] — 42 layers, d_model 3584, 16 heads (GQA kv=8,
head_dim 256), FFN 14336 GeGLU, vocab 256000.  Local (window 4096) and
global attention alternate per layer; attention-logit softcap 50.0 and
final-logit softcap 30.0; tied embeddings scaled by sqrt(d_model).

``subquadratic_decode=True``: the local layers are natively windowed and
the global layers are served with a 32k cap beyond that length.  Identical
to the reference's ``repro/configs/gemma2_9b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256_000,
    head_dim=256,
    rope_theta=10_000.0,
    sliding_window=4096,
    local_global_alternating=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    scale_embeddings=True,
    subquadratic_decode=True,
    long_context_window=32_768,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
    )
