"""Model config for the port: the fields the attention-only stack reads.

An own copy of the subset of ``repro.configs.base.ModelConfig`` that the
dense-attention path needs (the port imports nothing of ``repro``).  Field
names and defaults match the reference, so a config built here describes
the same model as its reference twin.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """A pre-norm decoder of identical layers: RoPE attention (every layer
    windowed when ``sliding_window`` is set), a SwiGLU MLP, and a stub
    vision projector in front, as openvla-7b is built in the reference."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = global attention
    attn_logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"  # activations and parameters

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Total parameters (untied embedding and head, SwiGLU MLP)."""

        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (2 * self.num_heads + 2 * self.num_kv_heads)
        return self.num_layers * (attn + 3 * d * self.d_ff) + 2 * self.vocab_size * d

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_MODULE_FOR = {"openvla-7b": "openvla"}


def _module(arch_id: str):
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; the port knows {sorted(_MODULE_FOR)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
