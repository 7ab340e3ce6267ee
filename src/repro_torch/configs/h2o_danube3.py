"""H2O-Danube3 4B.

[arXiv:2401.16818 (danube series)] — llama/mistral-style decoder: 24 layers,
d_model 3840, 32 heads (GQA kv=8), FFN 10240 SwiGLU, vocab 32000, sliding-
window attention (mistral-style, window 4096) -> sub-quadratic decode.
Identical to the reference's ``repro/configs/h2o_danube3.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    rope_theta=10_000.0,
    sliding_window=4096,
    mlp_activation="silu",
    gated_mlp=True,
    subquadratic_decode=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="danube3-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
    )
