"""xLSTM-125M.

[arXiv:2405.04517] — 12 blocks, d_model 768, 4 heads, vocab 50304 (GPT-NeoX
tokenizer padding), d_ff=0 (xLSTM blocks carry their own up/down
projections; there is no separate transformer MLP).  Blocks alternate mLSTM
and sLSTM (a 1:1 mix at this scale).  Fully recurrent: O(1) decode state.
Identical to the reference's ``repro/configs/xlstm_125m.py``.
"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    xlstm=XLSTMConfig(slstm_every=2),
    block_pattern=("mlstm", "slstm"),
    subquadratic_decode=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke",
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        head_dim=64,
        vocab_size=512,
        block_pattern=("mlstm", "slstm"),
    )
