"""StarCoder2-3B.

[arXiv:2402.19173] — 30 layers, d_model 3072, 24 heads (GQA kv=2), FFN 12288
non-gated GELU ("MLP" style, not SwiGLU), vocab 49152, RoPE.  Identical to
the reference's ``repro/configs/starcoder2_3b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    rope_theta=100_000.0,
    mlp_activation="gelu_plain",
    gated_mlp=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
