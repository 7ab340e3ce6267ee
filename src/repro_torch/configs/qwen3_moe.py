"""Qwen3-MoE 235B-A22B-class config (family per hf:Qwen/Qwen3-30B-A3B).

94 layers, d_model 4096, 64 heads (GQA kv=4, head_dim 128), per-expert FFN
1536 SwiGLU, vocab 151936, 128 experts top-8 on every layer, RoPE theta
1e6.  Identical to the reference's ``repro/configs/qwen3_moe.py``, which
builds it without the published model's QK-norm; so does the port.

At full depth the bf16 weights are ~438 GiB; one 80 GB card holds the
published widths at a cut depth (see ``chip_smoke.py``).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    gated_mlp=True,
    moe=MoEConfig(num_experts=128, num_experts_per_tok=8, every=1),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, every=1),
    )
