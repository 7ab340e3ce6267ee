"""SeamlessM4T-medium text/speech translation backbone.

[arXiv:2308.11596] — encoder-decoder transformer: 12 encoder + 12 decoder
layers, d_model 1024, 16 heads (MHA), FFN 4096 (non-gated GELU), vocab
256206.  The speech frontend (mel-spectrogram and conv feature extractor) is
a stub, as in the reference: the caller supplies precomputed frame
embeddings (``"frontend"``) to the encoder.  Decode runs decoder steps that
cross-attend the encoder's output.  The vocab pads to 256256 and the logits
past 256206 are masked.  Identical to the reference's
``repro/configs/seamless_m4t.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    head_dim=64,
    rope_theta=10_000.0,
    mlp_activation="gelu_plain",
    gated_mlp=False,
    encoder_decoder=True,
    num_encoder_layers=12,
    modality="audio",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-smoke",
        num_layers=2,
        num_encoder_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=514,  # not a multiple of 256: exercises the vocab padding
    )
