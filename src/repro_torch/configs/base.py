"""Model config for the port: the fields its served stacks read.

An own copy of the subset of ``repro.configs.base.ModelConfig`` that the
dense-attention, the MoE, the hybrid Mamba/MoE, the xLSTM and the
encoder-decoder paths need (the port imports nothing of ``repro``).  Field
names and defaults match the reference, so a config built here describes
the same model as its reference twin.  ``INPUT_SHAPES`` are the dry run's
workloads (``launch/dryrun.py``), the reference's four.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class InputShape:
    """A dry-run workload: ``global_batch`` sequences of ``seq_len`` tokens,
    trained, prefilled, or decoded one token against a cache of ``seq_len``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # MoE layers replace the dense MLP every ``every`` layers (1 = all)
    every: int = 1
    # slots an expert holds under the capacity dispatch, as a multiple of
    # its even share of the tokens (``models.moe.moe_forward_capacity``)
    capacity_factor: float = 1.25
    # weight of the router's load-balance loss in ``Model.loss_fn``
    router_aux_loss: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba block dims (SSD heads of ``models.ssm.HEAD_P`` channels)."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16); read only by the parameter counts


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block dims (sLSTM + mLSTM mix, arXiv:2405.04517)."""

    # every ``slstm_every``-th block is an sLSTM in the published mix; the
    # layers themselves follow ``block_pattern``
    slstm_every: int = 2
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3334


@dataclass(frozen=True)
class ModelConfig:
    """A pre-norm decoder: each layer's mixer is RoPE attention (windowed
    when ``sliding_window`` is set, on the even layers only when
    ``local_global_alternating``), a Mamba block, or an mLSTM or sLSTM
    block (``xlstm``), as ``block_pattern`` tiles them, and its FFN is an
    MLP (gated or plain, ``mlp_activation``) or, on the layers ``moe``
    selects, a top-k mixture of SwiGLU experts; ``d_ff == 0`` (xLSTM) means
    no FFN.  The head is its own matrix or the embedding table
    (``tie_embeddings``); embeddings may be scaled by sqrt(d_model) and the
    logits softcapped.  Vision and audio decoders carry a stub frontend
    projector in front, as openvla-7b is built in the reference; an
    encoder-decoder stack (``encoder_decoder``) instead runs the frames
    through ``num_encoder_layers`` non-causal encoder layers, which every
    decoder layer cross-attends."""

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
    # alternating local/global (gemma2): the window applies on even layers only
    local_global_alternating: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    mlp_activation: str = "silu"  # silu (swiglu) | gelu (geglu) | gelu_plain
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma style sqrt(d_model) scaling
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # per-layer mixers ("attn" | "mamba" | "mlstm" | "slstm"), tiled over the
    # layers; None -> all "attn"
    block_pattern: Optional[Tuple[str, ...]] = None
    modality: str = "text"  # text | vision | audio
    num_modality_tokens: int = 0  # stub frontend tokens a prompt carries
    dtype: str = "bfloat16"  # activations and parameters
    # global attention layers take ``long_context_window`` beyond that length
    subquadratic_decode: bool = False
    long_context_window: int = 32_768
    # encoder-decoder stacks (seamless-m4t): frames feed the encoder, text
    # tokens the decoder
    encoder_decoder: bool = False
    num_encoder_layers: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern is None:
            return ("attn",) * self.num_layers
        pat = self.block_pattern
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None or self.moe.num_experts == 0:
            return False
        return (i % self.moe.every) == (self.moe.every - 1)

    def param_count(self) -> int:
        """Total parameters the port's ``Model`` holds: the embedding and,
        unless tied to it, the head (vocab padded to 256), the stub
        projector of a vision/audio decoder, per layer its mixer, norms and
        its MLP (3 d d_ff gated, 2 d d_ff plain) or experts (none when
        ``d_ff == 0``) and, on an enc-dec stack, its cross-attention, and
        the encoder's layers and final norm."""

        d = self.d_model
        vpad = -(-self.vocab_size // 256) * 256
        heads = 1 if self.tie_embeddings else 2
        front = self.modality in ("vision", "audio") and not self.encoder_decoder
        total = heads * vpad * d + d + (d * d if front else 0)
        attn = self._attn_params()
        for i, blk in enumerate(self.blocks):
            total += d  # norm1
            if blk == "attn":
                total += attn
                if self.encoder_decoder:
                    total += d + attn  # xnorm, xattn
            elif blk == "mamba":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                nh = max(d_in // 64, 1)  # SSD heads of models.ssm.HEAD_P channels
                total += (3 * d * d_in + s.conv_width * d_in + d_in * nh
                          + d_in * 2 * s.state_dim + 3 * nh)
            elif blk == "mlstm":
                x, nh = self.xlstm or XLSTMConfig(), self.num_heads
                d_in = int(x.proj_factor_mlstm * d)
                total += d * 2 * d_in + 3 * d_in * d_in + d_in * 2 * nh + 2 * nh + d_in * d
            else:
                d_up = int((self.xlstm or XLSTMConfig()).proj_factor_slstm * d)
                total += 8 * d * d + 4 * d + 2 * d * d_up + d_up * d
            if self.d_ff > 0:
                ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
                if self.is_moe_layer(i):
                    ffn = self.moe.num_experts * ffn + d * self.moe.num_experts
                total += d + ffn  # norm2
        if self.encoder_decoder:
            mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
            total += self.num_encoder_layers * (2 * d + attn + mlp) + d
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        return d * hd * (2 * self.num_heads + 2 * self.num_kv_heads)

    # --- the reference's parameter accounting (configs/base.py:147-231),
    # the unit the partition graph and its cost model cut between.  It
    # counts the reference's own layouts (a Mamba x_proj / dt_proj of rank
    # ``dt_rank``, no norms), so it differs from ``param_count``, which
    # counts the port's ``Model``.
    def block_param_counts(self, i: int) -> dict:
        """Layer ``i``'s {total, active} parameters: its mixer, its MLP or
        MoE (active: the top-k experts and the router) and, on enc-dec
        stacks, the decoder cross-attention."""

        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        blk = self.blocks[i]
        if blk == "attn":
            p = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        elif blk == "mamba":
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            dtr = s.dt_rank or -(-d // 16)
            p = (d * 2 * d_in + d_in * s.conv_width + d_in * (dtr + 2 * s.state_dim)
                 + dtr * d_in + d_in * s.state_dim + d_in + d_in * d)
        elif blk in ("slstm", "mlstm"):
            x = self.xlstm or XLSTMConfig()
            if blk == "mlstm":
                # up projection (x and z branches), q/k/v over the inner
                # width, the out projection
                d_in = int(x.proj_factor_mlstm * d)
                p = d * 2 * d_in + 3 * d_in * d_in + d_in * d
            else:
                # four gates' input and recurrent weights, the GLU up / down
                d_up = int(x.proj_factor_slstm * d)
                p = 8 * d * d + 2 * d * d_up
        else:
            raise ValueError(blk)
        if self.encoder_decoder:
            p += d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        # an MLP or MoE rides a layer iff d_ff > 0 (xLSTM: none)
        mlp_active = mlp_total = 0
        if self.d_ff > 0:
            per = (3 if self.gated_mlp else 2) * d * self.d_ff
            if self.is_moe_layer(i):
                m = self.moe
                mlp_total = m.num_experts * per + d * m.num_experts
                mlp_active = m.num_experts_per_tok * per + d * m.num_experts
            else:
                mlp_total = mlp_active = per
        return {"total": p + mlp_total, "active": p + mlp_active}

    def encoder_param_counts(self) -> int:
        """Encoder-stack parameters (enc-dec only; 0 otherwise)."""

        if not self.encoder_decoder:
            return 0
        d, hd = self.d_model, self.resolved_head_dim
        return self.num_encoder_layers * (
            d * (self.num_heads * hd) * 2 + 2 * d * (self.num_kv_heads * hd)
            + (3 if self.gated_mlp else 2) * d * self.d_ff)

    def param_counts(self) -> dict:
        """{total, active} parameters: the embedding (not active: a lookup),
        the head (active even when tied: the logits read it) and the layers."""

        emb = self.vocab_size * self.d_model
        total = emb + (0 if self.tie_embeddings else emb)
        active = emb
        for i in range(len(self.blocks)):
            c = self.block_param_counts(i)
            total += c["total"]
            active += c["active"]
        enc = self.encoder_param_counts()
        return {"total": total + enc, "active": active + enc}

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# the archs the port serves, in the reference's ARCH_IDS order
ARCH_IDS = (
    "phi3.5-moe-42b-a6.6b",
    "gemma2-9b",
    "qwen3-moe-235b-a22b",
    "gemma-7b",
    "jamba-1.5-large-398b",
    "phi-3-vision-4.2b",
    "h2o-danube-3-4b",
    "seamless-m4t-medium",
    "starcoder2-3b",
    "xlstm-125m",
    "openvla-7b",
)

_MODULE_FOR = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "gemma2-9b": "gemma2_9b",
    "qwen3-moe-235b-a22b": "qwen3_moe",
    "gemma-7b": "gemma_7b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "phi-3-vision-4.2b": "phi3_vision",
    "h2o-danube-3-4b": "h2o_danube3",
    "seamless-m4t-medium": "seamless_m4t",
    "starcoder2-3b": "starcoder2_3b",
    "xlstm-125m": "xlstm_125m",
    "openvla-7b": "openvla",
}


def _module(arch_id: str):
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; the port knows {sorted(_MODULE_FOR)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def registry() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether (arch, shape) is a dry-run combination: ``long_500k`` needs
    sub-quadratic decode (an SSM, a hybrid or a sliding window)."""

    return not (shape.name == "long_500k" and not cfg.subquadratic_decode)
