"""Jamba 1.5 Large (398B total) — the hybrid Mamba + MoE stack.

[arXiv:2403.19887] — 72 layers, d_model 8192, attention layers with 64
heads (GQA, 8 KV heads) of 128, FFN 24576 SwiGLU, vocab 65536.
Mamba:attention interleave 7:1 (one attention layer per 8-layer block),
MoE (16 experts, top-2) on every other layer; Mamba state 16, conv 4,
expand 2 (d_in 16384, 256 SSD heads of 64).  Identical to the reference's
``repro/configs/jamba_15_large.py``.

On one 80 GB card the port serves it at these widths with the depth cut to
4 layers (``CONFIG.replace(num_layers=4)``: mamba+MLP, mamba+MoE,
mamba+MLP, attn+MoE, the first four of the real pattern).  One 8-layer
period holds 4 MoE layers of 19.33 GB each, ~90 GB of bf16 weights in all;
four layers hold ~23.0 B parameters (~46.0 GB).  Every kind of layer is
present; the 7:1 Mamba:attention ratio is not.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

# one attention layer per 8, placed mid-block as in the Jamba paper
_PATTERN = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, every=2),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    block_pattern=_PATTERN,
    subquadratic_decode=True,
    long_context_window=32_768,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-smoke",
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, every=2),
        block_pattern=("mamba", "attn"),
    )
