"""OpenVLA-7B — the paper's own VLA backbone.

[arXiv:2406.09246] — Prismatic VLM on Llama-2-7B: 32 layers, d_model 4096,
32 heads MHA, FFN 11008 SwiGLU, vocab 32000 with the top 256 token ids
remapped as discretized action bins.  The vision frontend is a stub
projector, as in the reference.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="openvla-7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    head_dim=128,
    rope_theta=10_000.0,
    modality="vision",
    num_modality_tokens=256,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="openvla-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        num_modality_tokens=16,
    )
