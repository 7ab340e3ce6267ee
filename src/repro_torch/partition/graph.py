"""Linear block-level inference graph for partition planning (the port's
own copy of ``repro/partition/graph.py``; the port imports nothing of the
reference).

Lowering: a ``ModelConfig`` becomes ``[stem] + [layer_0 .. layer_{L-1}] +
[head]``.  Every node carries the four quantities the planner trades off:

  * ``param_bytes``  — bf16 bytes RESIDENT on whichever side holds the node
    (MoE: all experts; tied embeddings: counted once, at the stem);
  * ``exec_bytes``   — bytes actually TOUCHED per action-chunk inference
    (MoE: router + top-k experts only; embedding: the rows looked up, not
    the table — this is what makes the planner *compatibility*-aware: a
    235B-total/22B-active MoE partitions completely differently from a
    dense 9B even at equal resident size);
  * ``flops_prefill`` / ``flops_decode`` — executed FLOPs from the analytic
    roofline cost model (``roofline/costmodel.block_flops``);
  * ``hbm_bytes_decode`` — KV/state traffic per decode step;
  * ``cut_act_bytes`` — activation bytes PER TOKEN shipped over the channel
    if the graph is cut immediately after this node (d_model @ bf16 for
    every interior cut; cut 0 — nothing on the edge — is instead priced by
    the planner as a raw-observation upload via the channel's ``obs_bytes``).

Block families covered: attention (MHA/GQA, windowed), MoE MLPs, Mamba/SSM,
xLSTM (sLSTM/mLSTM), the vision/audio stem projector, the encoder stack
(enc-dec models, folded into the stem), and the LM head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig

BYTES_PER_PARAM = 2.0  # bf16 residency, matching the latency model's GB

# serving shapes: one observation (proprioceptive state tokens + any
# modality-frontend tokens) in, one k-step action chunk out
DEFAULT_STATE_TOKENS = 14   # 2 x 7 joint qd/tau bins (EpisodeTokenizer)
DEFAULT_CHUNK_TOKENS = 56   # 8-step chunk x 7 joints


@dataclass(frozen=True)
class BlockNode:
    index: int                  # position in the linear graph
    kind: str                   # stem | attn | mamba | mlstm | slstm | head
    layer: Optional[int]        # model layer index (None for stem/head)
    is_moe: bool
    param_bytes: float          # resident bytes on the owning side
    exec_bytes: float           # bytes touched per chunk inference
    flops_prefill: float        # executed FLOPs over the prompt
    flops_decode: float         # executed FLOPs per decode token
    hbm_bytes_decode: float     # cache/state traffic per decode step
    cut_act_bytes: float        # activation bytes/token if cut after this node
    # 2-D planning: the expert sub-block of an MoE layer, separable from
    # the attention + router part.  ``expert_param_bytes`` is ALL experts'
    # residency (E x per-expert FFN), ``expert_exec_bytes`` the top-k slice
    # actually touched per token; both zero on non-MoE nodes.  Offloading a
    # layer's experts moves ``expert_param_bytes`` off the edge budget and
    # ``expert_exec_bytes`` into the cloud's executed bytes, at the price of
    # a gather/scatter channel leg per decode token.
    expert_param_bytes: float = 0.0
    expert_exec_bytes: float = 0.0
    moe_top_k: int = 0


@dataclass(frozen=True)
class InferenceGraph:
    arch: str
    nodes: Tuple[BlockNode, ...]
    prompt_len: int             # observation tokens entering the stack
    chunk_tokens: int           # autoregressive action tokens per chunk
    d_model: int
    tie_embeddings: bool
    embed_bytes: float          # table bytes (tied-embedding duplication)
    # vision/audio-encoder-as-a-stage: the modality frontend's bytes, kept
    # INSIDE the stem node's totals above but recorded separately so the
    # 2-D planner can place the encoder independently of the cut.  With the
    # encoder edge-side at cut 0, the uplink ships ``encoder_out_bytes``
    # (the encoded modality tokens) instead of the channel's raw
    # ``obs_bytes``; all three fields are zero on text-only configs.
    encoder_param_bytes: float = 0.0
    encoder_exec_bytes: float = 0.0
    encoder_out_bytes: float = 0.0

    @property
    def n_cuts(self) -> int:
        """Valid cut indices are 0..len(nodes): nodes[:c] live on the edge."""

        return len(self.nodes) + 1

    @property
    def total_param_bytes(self) -> float:
        return sum(n.param_bytes for n in self.nodes)

    @property
    def total_exec_bytes(self) -> float:
        return sum(n.exec_bytes for n in self.nodes)

    def cut_layers(self, cut: int) -> int:
        """Transformer layers resident on the edge for node-cut ``cut``."""

        return min(max(cut - 1, 0), len(self.nodes) - 2)


def build_graph(
    cfg: ModelConfig,
    prompt_len: Optional[int] = None,
    chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
) -> InferenceGraph:
    """Lower ``cfg`` into the linear partition graph.

    ``prompt_len`` defaults to the VLA serving observation: state tokens plus
    any modality-frontend tokens (vision patches ride the prompt on VLM
    configs, so cutting after the stem ships patch activations, not pixels).
    """

    from repro_torch.models.model import layer_specs
    from repro_torch.roofline.costmodel import (
        block_decode_bytes,
        block_flops,
        encoder_flops,
        head_flops,
    )

    d = cfg.d_model
    if prompt_len is None:
        prompt_len = DEFAULT_STATE_TOKENS + (
            cfg.num_modality_tokens if cfg.modality != "text" else 0
        )
    kv_len = prompt_len + chunk_tokens
    act_tok = d * BYTES_PER_PARAM  # bf16 activations at every layer boundary

    emb_bytes = cfg.vocab_size * d * BYTES_PER_PARAM
    nodes = []

    # --- stem: embedding table, modality projector, encoder stack ---------
    stem_param = emb_bytes
    stem_exec = kv_len * d * BYTES_PER_PARAM  # rows looked up, not the table
    stem_flops_prefill = 0.0
    enc_param = enc_exec = enc_out = 0.0
    if cfg.modality != "text" and not cfg.encoder_decoder:
        stem_param += d * d * BYTES_PER_PARAM
        stem_exec += d * d * BYTES_PER_PARAM
        stem_flops_prefill += 2.0 * cfg.num_modality_tokens * d * d
        # the modality projector IS the placeable encoder stage: its output
        # is num_modality_tokens bf16 activation rows
        enc_param = enc_exec = d * d * BYTES_PER_PARAM
        enc_out = cfg.num_modality_tokens * d * BYTES_PER_PARAM
    if cfg.encoder_decoder:
        enc_bytes = cfg.encoder_param_counts() * BYTES_PER_PARAM
        stem_param += enc_bytes
        stem_exec += enc_bytes
        stem_flops_prefill += encoder_flops(cfg, 1, prompt_len)
        # enc-dec: the whole encoder stack is the stage; its output is the
        # encoded prompt (prompt_len rows of d_model)
        enc_param = enc_exec = enc_bytes
        enc_out = prompt_len * d * BYTES_PER_PARAM
    nodes.append(
        BlockNode(
            index=0,
            kind="stem",
            layer=None,
            is_moe=False,
            param_bytes=stem_param,
            exec_bytes=stem_exec,
            flops_prefill=stem_flops_prefill,
            flops_decode=0.0,
            hbm_bytes_decode=0.0,
            cut_act_bytes=act_tok,
        )
    )

    # --- transformer layers ------------------------------------------------
    for i, spec in enumerate(layer_specs(cfg)):
        counts = cfg.block_param_counts(i)
        exp_param = exp_exec = 0.0
        top_k = 0
        if spec[1] and cfg.d_ff > 0 and cfg.moe is not None:
            # the separable expert sub-block: per-expert FFN weights only
            # (the d*E router stays with the attention part on the edge)
            per_exp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
            exp_param = cfg.moe.num_experts * per_exp * BYTES_PER_PARAM
            exp_exec = cfg.moe.num_experts_per_tok * per_exp * BYTES_PER_PARAM
            top_k = cfg.moe.num_experts_per_tok
        nodes.append(
            BlockNode(
                index=i + 1,
                kind=spec[0],
                layer=i,
                is_moe=spec[1],
                param_bytes=counts["total"] * BYTES_PER_PARAM,
                exec_bytes=counts["active"] * BYTES_PER_PARAM,
                flops_prefill=block_flops(cfg, spec, 1, prompt_len),
                flops_decode=block_flops(cfg, spec, 1, 1, decode=True, kv_len=kv_len),
                hbm_bytes_decode=block_decode_bytes(cfg, spec, 1, kv_len),
                cut_act_bytes=act_tok,
                expert_param_bytes=exp_param,
                expert_exec_bytes=exp_exec,
                moe_top_k=top_k,
            )
        )

    # --- LM head (tied embeddings: table resident at the stem, but the
    # logits matmul still reads it — exec counts it on whichever side holds
    # the head; the planner duplicates the table when the cut separates them)
    head_param = 0.0 if cfg.tie_embeddings else emb_bytes
    nodes.append(
        BlockNode(
            index=len(nodes),
            kind="head",
            layer=None,
            is_moe=False,
            param_bytes=head_param,
            exec_bytes=emb_bytes,
            flops_prefill=head_flops(cfg, 1, prompt_len),
            flops_decode=head_flops(cfg, 1, 1, decode=True),
            hbm_bytes_decode=emb_bytes,
            cut_act_bytes=act_tok,
        )
    )

    return InferenceGraph(
        arch=cfg.name,
        nodes=tuple(nodes),
        prompt_len=prompt_len,
        chunk_tokens=chunk_tokens,
        d_model=d,
        tie_embeddings=cfg.tie_embeddings,
        embed_bytes=emb_bytes,
        encoder_param_bytes=enc_param,
        encoder_exec_bytes=enc_exec,
        encoder_out_bytes=enc_out,
    )
