"""Analytic executed-FLOPs and HBM-bytes model (counterpart of
``repro/roofline/costmodel.py``): the per-layer terms the partition graph
prices (``block_flops``, ``block_decode_bytes``, ``head_flops``,
``encoder_flops``), their sum over the stack (``forward_flops``,
``_decode_cache_bytes``) and a whole workload's count (``estimate``), the
work a roofline divides by (``roofline/analysis.py``, ``launch/dryrun.py``).

Counts follow the reference's baseline implementation and its waste:
attention over the full masked rectangle unless ``sparse_attn``, the dense
MoE dispatch evaluating every expert unless ``dense_dispatch=False``, the
full cache read at decode unless ``windowed``, remat's extra forward in
training; ``estimate(optimized=True)`` counts the optimized variant.
Every block kind of the reference is priced: attention (with the
cross-attention of an enc-dec decoder layer), Mamba, mLSTM and sLSTM, and
the encoder stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import InputShape, ModelConfig, SSMConfig, XLSTMConfig

VOCAB_PAD = 256


@dataclass
class CostEstimate:
    flops: float        # executed FLOPs, whole program, all devices
    hbm_bytes: float    # HBM traffic, whole program, all devices
    flops_model: float  # useful FLOPs: 6 N_active D to train, 2 N_active D to infer


def _causal_kv_sum(s: int, window: int, sparse: bool) -> float:
    """Sum over queries of the keys attention computes: the full [S, S]
    rectangle (masked) unless ``sparse``, else the causal (windowed) part."""

    if not sparse:
        return float(s) * s
    if window and window < s:
        w = window
        return w * (w + 1) / 2 + (s - w) * w
    return s * (s + 1) / 2


def _attn_flops_per_seq(cfg: ModelConfig, s: int, window: int, sparse: bool) -> float:
    hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    d = cfg.d_model
    proj = 2.0 * s * d * (nh * hd) * 2 + 2.0 * s * d * (nkv * hd) * 2  # q, o, k, v
    return proj + 2.0 * 2.0 * nh * hd * _causal_kv_sum(s, window, sparse)  # QK^T + PV


def _mlp_flops_per_tok(cfg: ModelConfig) -> float:
    return 2.0 * (3 if cfg.gated_mlp else 2) * cfg.d_model * cfg.d_ff


def _moe_flops_per_tok(cfg: ModelConfig, dense_dispatch: bool = True) -> float:
    m = cfg.moe
    experts = m.num_experts if dense_dispatch else m.num_experts_per_tok
    return 2.0 * cfg.d_model * m.num_experts + experts * _mlp_flops_per_tok(cfg)


def _mamba_flops_per_seq(cfg: ModelConfig, s: int, chunk: int = 256) -> float:
    from repro_torch.models.ssm import HEAD_P

    ssm = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in = ssm.expand * d
    p = HEAD_P if d_in >= HEAD_P else d_in
    nh = max(d_in // HEAD_P, 1)
    n = ssm.state_dim
    l = min(chunk, s)  # noqa: E741
    nc = max(s // l, 1)
    per_tok = (2.0 * d * 2 * d_in              # in_proj
               + 2.0 * ssm.conv_width * d_in   # conv
               + 2.0 * d_in * (nh + 2 * n)     # dt / bc projections
               + 2.0 * d_in * d)               # out_proj
    per_chunk = (2.0 * l * l * n               # G = C B^T
                 + 3.0 * l * l * nh            # decay kernel (exp, mask, mul)
                 + 2.0 * l * l * nh * p        # intra-chunk y
                 + 4.0 * l * nh * p * n)       # carry in / out, state update
    return s * per_tok + nc * per_chunk


def _mlstm_flops_per_seq(cfg: ModelConfig, s: int, chunk: int = 256) -> float:
    x = cfg.xlstm or XLSTMConfig()
    d = cfg.d_model
    d_in = int(x.proj_factor_mlstm * d)
    l = min(chunk, s)  # noqa: E741
    nc = max(s // l, 1)
    per_tok = 2.0 * d * 2 * d_in + 3 * 2.0 * d_in * d_in + 2.0 * d_in * d
    dh = d_in // cfg.num_heads
    per_chunk = 2.0 * 2.0 * l * l * d_in + 4.0 * l * cfg.num_heads * dh * dh
    return s * per_tok + nc * per_chunk


def _slstm_flops_per_seq(cfg: ModelConfig, s: int) -> float:
    x = cfg.xlstm or XLSTMConfig()
    d = cfg.d_model
    d_up = int(x.proj_factor_slstm * d)
    per_tok = 2.0 * d * 4 * d * 2 + 2.0 * d * 2 * d_up + 2.0 * d_up * d
    return s * per_tok


def _vpad(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def block_flops(cfg: ModelConfig, spec, batch: int, s: int, *, decode: bool = False,
                kv_len: int = 0, sparse_attn: bool = False,
                dense_dispatch: bool = True, cached_cross_kv: bool = False) -> float:
    """Executed FLOPs of one layer (its mixer, MLP or MoE and, on enc-dec
    stacks, its cross-attention).  ``spec`` is a ``layer_specs`` entry
    ``(block type, is_moe, is_local)``."""

    blk, is_moe, local = spec
    total = 0.0
    window = 0
    if local and cfg.sliding_window:
        window = cfg.sliding_window
    elif (kv_len or s) > cfg.long_context_window and cfg.subquadratic_decode:
        window = cfg.long_context_window
    if blk == "attn":
        if decode:
            hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
            d = cfg.d_model
            eff = (min(kv_len, window) if window else kv_len) if sparse_attn else kv_len
            total += batch * (2.0 * d * (nh * hd) * 2 + 2.0 * d * (nkv * hd) * 2
                              + 2.0 * 2.0 * nh * hd * eff)
        else:
            total += batch * _attn_flops_per_seq(cfg, s, window, sparse=sparse_attn)
    elif blk == "mamba":
        total += batch * _mamba_flops_per_seq(cfg, 1 if decode else s)
    elif blk == "mlstm":
        total += batch * _mlstm_flops_per_seq(cfg, 1 if decode else s)
    elif blk == "slstm":
        total += batch * _slstm_flops_per_seq(cfg, 1 if decode else s)
    toks = batch * (1 if decode else s)
    if cfg.d_ff > 0:
        total += toks * (_moe_flops_per_tok(cfg, dense_dispatch=dense_dispatch)
                         if is_moe else _mlp_flops_per_tok(cfg))
    if blk == "attn" and cfg.encoder_decoder:
        hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        d = cfg.d_model
        enc_len = kv_len if decode else s
        total += toks * (2.0 * d * (nh * hd) * 2 + 2.0 * 2.0 * nh * hd * enc_len)
        if not (decode and cached_cross_kv):
            total += batch * 2.0 * enc_len * d * (nkv * hd) * 2
    return total


def head_flops(cfg: ModelConfig, batch: int, s: int, *, decode: bool = False) -> float:
    """The logits matmul's FLOPs over the padded vocab."""

    return batch * (1 if decode else s) * 2.0 * cfg.d_model * _vpad(cfg)


def encoder_flops(cfg: ModelConfig, batch: int, s: int) -> float:
    """Encoder-stack FLOPs (enc-dec only; 0 otherwise)."""

    if not cfg.encoder_decoder:
        return 0.0
    hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    d = cfg.d_model
    enc_attn = (2.0 * s * d * (nh * hd) * 2 + 2.0 * s * d * (nkv * hd) * 2
                + 2.0 * 2.0 * nh * hd * s * s)
    return cfg.num_encoder_layers * batch * (enc_attn + s * _mlp_flops_per_tok(cfg))


def block_decode_bytes(cfg: ModelConfig, spec, b: int, s: int, windowed: bool = False) -> float:
    """KV-cache or recurrent-state bytes one layer reads and writes a
    decode step."""

    from repro_torch.models.ssm import HEAD_P, ssm_dims

    blk, _, local = spec
    total = 0.0
    if blk == "attn":
        window = cfg.sliding_window if (local and cfg.sliding_window) else (
            cfg.long_context_window
            if s > cfg.long_context_window and cfg.subquadratic_decode else 0)
        eff = (min(s, window) if window else s) if windowed else s
        total += 2.0 * b * eff * cfg.num_kv_heads * cfg.resolved_head_dim * 2
        if cfg.encoder_decoder:
            total += 2.0 * b * s * cfg.d_model
    elif blk == "mamba":
        d_in, nh, n = ssm_dims(cfg)
        p = HEAD_P if d_in >= HEAD_P else d_in
        total += 4.0 * b * nh * p * n * 2
    elif blk == "mlstm":
        x = cfg.xlstm or XLSTMConfig()
        d_in = int(x.proj_factor_mlstm * cfg.d_model)
        dh = d_in // cfg.num_heads
        total += 4.0 * b * cfg.num_heads * dh * dh * 2
    elif blk == "slstm":
        total += 8.0 * b * cfg.d_model * 4
    return total


def forward_flops(cfg: ModelConfig, batch: int, s: int, *, decode: bool = False,
                  kv_len: int = 0, optimized: bool = False,
                  sparse_attn: Optional[bool] = None,
                  cached_cross_kv: Optional[bool] = None) -> float:
    """Executed forward FLOPs of ``batch`` sequences of ``s`` tokens, or
    with ``decode`` of one new token each against a ``kv_len`` cache:
    ``block_flops`` over ``layer_specs``, the head and (enc-dec, not at
    decode) the encoder.  ``optimized`` (default for ``sparse_attn`` and
    ``cached_cross_kv``) counts flash attention's causal and windowed
    blocks only and the top-k experts only."""

    from repro_torch.models.model import layer_specs

    if sparse_attn is None:
        sparse_attn = optimized
    if cached_cross_kv is None:
        cached_cross_kv = optimized
    total = sum(block_flops(cfg, spec, batch, s, decode=decode, kv_len=kv_len,
                            sparse_attn=sparse_attn, dense_dispatch=not optimized,
                            cached_cross_kv=cached_cross_kv)
                for spec in layer_specs(cfg))
    total += head_flops(cfg, batch, s, decode=decode)
    if not decode:
        total += encoder_flops(cfg, batch, s)
    return total


def estimate(cfg: ModelConfig, shape: InputShape, *, remat: bool = True,
             optimized: bool = False) -> CostEstimate:
    """Executed FLOPs, HBM bytes and useful FLOPs of one step of ``shape``
    over bf16 weights (the reference's ``estimate``, term for term).

    train: forward over the masked rectangle in both variants, backward 2x,
    remat one more forward; bytes: weights 3x, the layer boundaries stored
    and loaded, AdamW's reads of p, m, v and writes of m, v (bf16 moments).
    prefill: one forward, weights and boundaries once.  decode: one token a
    sequence against a ``seq_len`` cache, the weights (active ones only for
    an optimized MoE) and ``_decode_cache_bytes``."""

    b, s = shape.global_batch, shape.seq_len
    counts = cfg.param_counts()
    p_active, p_total = counts["active"], counts["total"]
    param_bytes = 2.0 * p_total
    if shape.kind == "train":
        fwd = forward_flops(cfg, b, s, optimized=optimized, sparse_attn=False)
        flops = fwd * (4.0 if remat else 3.0)
        act_bytes = 2.0 * 2.0 * b * s * cfg.d_model * cfg.num_layers * 2
        hbm = 3.0 * param_bytes + act_bytes + 5.0 * param_bytes
        model_flops = 6.0 * p_active * b * s
    elif shape.kind == "prefill":
        flops = forward_flops(cfg, b, s, optimized=optimized)
        hbm = param_bytes + 2.0 * 2.0 * b * s * cfg.d_model * cfg.num_layers
        model_flops = 2.0 * p_active * b * s
    else:
        flops = forward_flops(cfg, b, 1, decode=True, kv_len=s, optimized=optimized)
        pb = param_bytes if not (optimized and cfg.moe) else 2.0 * p_active
        hbm = pb + _decode_cache_bytes(cfg, b, s, windowed=optimized)
        model_flops = 2.0 * p_active * b
    return CostEstimate(flops=flops, hbm_bytes=hbm, flops_model=model_flops)


def _decode_cache_bytes(cfg: ModelConfig, b: int, s: int, windowed: bool = False) -> float:
    """KV-cache and recurrent-state bytes one decode step reads and writes
    (the memory wall): the full cache unless ``windowed`` (ring caches,
    only each window resident)."""

    from repro_torch.models.model import layer_specs

    return sum(block_decode_bytes(cfg, spec, b, s, windowed=windowed)
               for spec in layer_specs(cfg))
