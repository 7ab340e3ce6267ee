"""Phi-3-vision 4.2B.

[hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini language backbone:
32 layers, d_model 3072, 32 heads (MHA, kv=32), FFN 8192, vocab 32064, with a
CLIP ViT-L/14 vision frontend.  The frontend is a stub, as in the
reference: the caller supplies precomputed patch embeddings (576 tokens for
a 336px image) beside the text tokens, which the model's projector maps to
d_model.  Identical to the reference's ``repro/configs/phi3_vision.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    rope_theta=10_000.0,
    mlp_activation="silu",
    gated_mlp=True,
    modality="vision",
    num_modality_tokens=576,  # CLIP ViT-L/14 @336px -> 24x24 patches
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="phi3-vision-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        num_modality_tokens=16,
    )
