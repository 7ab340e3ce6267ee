"""Phi-3.5-MoE-instruct (42B total / 6.6B active).

[hf:microsoft/Phi-3.5-MoE-instruct] — 32 layers, d_model 4096, 32 heads with
GQA kv=8 (head_dim 128), per-expert FFN 6400 SwiGLU, vocab 32064, 16
experts top-2 on every layer.  Identical to the reference's
``repro/configs/phi35_moe.py``, which builds it with RMSNorm and without
the published model's LayerNorm and biases; so does the port.

At full depth the bf16 weights are ~78 GiB, which leaves one 80 GB card no
room for caches; ``chip_smoke.py`` serves it at a cut depth.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    rope_theta=10_000.0,
    mlp_activation="silu",
    gated_mlp=True,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, every=1),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="phi3.5-moe-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, every=1),
    )
