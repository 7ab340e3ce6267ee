"""The port's model (counterpart of ``repro/models/model.py``) for every
stack of the reference: the dense attention stacks (openvla-7b, gemma,
gemma2 with local and global layers alternating, h2o-danube3, starcoder2,
phi-3-vision), the MoE stacks (qwen3-moe, phi3.5-moe; the dispatch is
``Model(moe_impl=...)``), the Jamba hybrid of Mamba and attention, the
xLSTM stack of mLSTM and sLSTM blocks (xlstm-125m; ``d_ff == 0``, so its
blocks have no FFN half), and the encoder-decoder stack (seamless-m4t): a
non-causal encoder over stub frame embeddings, whose output every decoder
layer cross-attends (K/V projected each token, or cached at prefill with
``Model(cache_cross_kv=True)``).

Where the reference stacks parameters over repeats of a repeating unit and
scans, the port keeps an ``nn.ModuleList`` of per-layer blocks and loops;
``checkpoint/bridge.py`` maps layer ``i`` to ``unit/{i % period}/...[i //
period]``, the unit being ``unit_period(layer_specs(cfg))`` layers long
(the encoder's layer ``i`` to ``enc_unit/0/...[i]``).  Caches hold each
kind of layer state in one tensor with a leading axis over the layers of
that kind, and are updated in place.  The recurrent state keys
(``Model.state_names``, row axis 1; absent for kinds the stack lacks) are
Mamba ``h`` / ``conv``, mLSTM ``mC`` / ``mn`` / ``mm`` and sLSTM ``sc`` /
``sn`` / ``sh`` / ``sm``, all O(1) a row and dense in both cache kinds:

  dense  {"k", "v": [La, B, S, KV, Dh], "len": int or [B] int32,
          "h": [Lm, B, H, P, N] f32, "conv": [Lm, B, K-1, d_in],
          "mC": [Lx, B, H, Dh, Dh] f32, "mn": [Lx, B, H, Dh] f32,
          "mm": [Lx, B, H] f32, "sc", "sn", "sh", "sm": [Ls, B, D] f32}
         (``windowed_cache``: "k", "v" are lists of per-layer [B, S_l, KV,
         Dh] rings, S_l = min(S, the layer's window); a stack without
         attention layers has no "k" / "v")
  paged  {"kp", "vp": [La, P+1, page, KV, Dh] (last page is trash; none
          without attention layers), "len": [B] int32, "pt": [B, MAXP]
          int32, "cap": [B] int32, the recurrent state as in the dense cache}
  enc-dec, both kinds: + "enc_out": [B, S_enc, D] (the encoder's output)
          and, with ``cache_cross_kv``, "xk", "xv": [La, B, S_enc, KV, Dh]

Entry points: ``prefill``, ``decode_step``, ``decode_chunk``, ``forward``,
``init_cache``, ``init_paged_cache``, ``cache_to_paged``,
``merge_prefill_into_paged`` (serving, all under ``torch.no_grad``), and
``loss_fn`` (training: autograd runs through it).  Each runs the per-layer block functions
(``_block_seq`` / ``_block_step``, each a mixer half and an FFN half, as
the reference's), over per-layer views of these caches
(``layer_cache``); the partition executor runs the same functions over its
own per-layer caches.

**The mesh's model axis.**  ``Model(cfg, device, group=g)`` with a
``launch.dist.ModelGroup`` of M > 1 ranks is one rank of a
tensor-parallel model (the reference's GSPMD placement over
``param_logical()``): every parameter holds the rank's block of its
global tensor by the logical rules (``launch.sharding.local_index``;
attention weights by whole heads, Mamba's ``in_proj`` by halves),
drawn from the global tensor in the one-rank model's order, so the M
blocks put together are the one-rank weights bit for bit.  A fused
parameter of equal parts laid end to end holds its block of each part
(``_PARTS``: Mamba's and the mLSTM's x | z, the mLSTM's i | f gates, the
sLSTM's four gates and its GLU's gate | val).  The MLP, the MoE layer
(every expert's ``d_ff`` block; all E experts on every rank), the
attention output (self, the encoder's and the cross-attention's), Mamba's
and the mLSTM's ``out_proj`` and the sLSTM's ``down`` sum their partial
products over the ranks, a Mamba layer its ``dt`` / B / C projections
too; an mLSTM layer gathers its xi once, an sLSTM layer its h once a
token; the embedding looks up by vocab block and sums, and the logits
gather their vocab blocks (``models/layers.py``, ``models/attention.py``,
``models/moe.py``, ``models/ssm.py``, ``models/xlstm.py``).  The caches
hold the rank's KV heads (the cross K/V's too), Mamba heads and channels,
mLSTM heads and sLSTM units (h whole); an enc-dec stack's ``enc_out`` is
whole on every rank.  Heads, Mamba heads or sLSTM widths that do not
divide over the ranks, and training, raise ``NotImplementedError``
(ROADMAP queue I).  ``param_logical``, ``abstract_params`` and
``cache_logical`` keep the reference's global layout.

**The data axis.**  ``Model(data_group=d)`` with a data group of D > 1
ranks (``launch.dist.RankGrid``): the MoE layers hold the rank's block of
the ``expert`` axis (E / D experts, where E divides over D, by the
``"expert": ("data",)`` rule; all E otherwise), drawn in the one-rank
order, and exchange their tokens over the data ranks
(``models/moe.py``).  Every other parameter is the model group's block,
whole over data.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.launch.dist import all_gather_cat
from repro_torch.launch.sharding import index_extent, local_index, logical_to_pspec
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    MLP,
    Dense,
    Embedding,
    Norm,
    _param,
    dense,
    embed_lookup,
    embed_scale,
    global_shape,
    logits_from_embedding,
    mask_padded_vocab,
    mlp,
    rms_norm,
    sinusoidal_positions,
)
from repro_torch.runtime.kv_cache import PagedSpec, scatter_prompt_into_pool


# positions of the cross-entropy a chunk: one chunk's logits [B, CE_CHUNK,
# V] in float32 exist at a time (repro/models/model.py:51)
CE_CHUNK = 512
# Model(moe_impl=...): the MoE layers' dispatch
MOE_IMPLS = {"dense": moe_lib.moe_forward, "capacity": moe_lib.moe_forward_capacity}
# the recurrent state a layer of each kind keeps, by its cache names
STATE_NAMES = {"mamba": ("h", "conv"), "mlstm": ("mC", "mn", "mm"),
               "slstm": ("sc", "sn", "sh", "sm")}


# each parameter's logical axes (``launch/sharding.py``), the reference's
# names (repro/models/{layers,attention,moe,ssm,xlstm}.py): by the name
# inside a block for block parameters, by the full name otherwise
_QKV_IN = ("embed", "qkv_features")
_BLOCK_AXES = {
    "attn.wq": _QKV_IN, "attn.wk": _QKV_IN, "attn.wv": _QKV_IN,
    "attn.wo": ("qkv_features", "embed"),
    "xattn.wq": _QKV_IN, "xattn.wk": _QKV_IN, "xattn.wv": _QKV_IN,
    "xattn.wo": ("qkv_features", "embed"),
    "norm1.scale": (None,), "norm2.scale": (None,), "xnorm.scale": (None,),
    "mlp.up.w": ("embed", "mlp"), "mlp.gate.w": ("embed", "mlp"), "mlp.down.w": ("mlp", "embed"),
    "moe.router": ("embed", None), "moe.up": ("expert", "embed", "mlp"),
    "moe.gate": ("expert", "embed", "mlp"), "moe.down": ("expert", "mlp", "embed"),
    "mamba.in_proj": ("embed", "state"), "mamba.conv_w": ("conv", "state"),
    "mamba.dt_proj": ("state", "heads"), "mamba.bc_proj": ("state", None),
    "mamba.dt_bias": ("heads",), "mamba.a_log": ("heads",), "mamba.d_skip": ("heads",),
    "mamba.out_proj": ("state", "embed"),
    "mlstm.up_proj": ("embed", "state"), "mlstm.wq": ("state", "qkv_features"),
    "mlstm.wk": ("state", "qkv_features"), "mlstm.wv": ("state", "qkv_features"),
    "mlstm.w_if": ("state", None), "mlstm.if_bias": (None,), "mlstm.out_proj": ("state", "embed"),
    "slstm.w_in": ("embed", "state"), "slstm.w_rec": ("embed", "state"), "slstm.bias": (None,),
    "slstm.up": ("embed", "mlp"), "slstm.down": ("mlp", "embed"),
}
# the logical axes of each recurrent state tensor [L_kind, B, ...]
# (repro/models/model.py:871-902)
_STATE_AXES = {
    "h": (None, "batch", "heads", None, None), "conv": (None, "batch", None, "state"),
    "mC": (None, "batch", None, None, None), "mn": (None, "batch", None, None),
    "mm": (None, "batch", None),
    **{name: (None, "batch", "state") for name in ("sc", "sn", "sh", "sm")},
}
# the axis of each recurrent state tensor [L_kind, B, ...] that a rank of
# the model axis holds a block of (Mamba heads and channels, mLSTM heads,
# sLSTM units; the sLSTM's h is whole)
_STATE_BLOCK = {"h": 2, "conv": 3, "mC": 2, "mn": 2, "mm": 2, "sc": 2, "sn": 2, "sm": 2}
_TOP_AXES = {
    "embed.table": ("vocab", "embed"), "mod_proj.w": ("embed", "embed"),
    "final_norm.scale": (None,), "enc_norm.scale": (None,), "lm_head.w": ("embed", "vocab"),
}


# block parameters of equal parts laid end to end, each part cut over the
# ranks (``launch.sharding.local_index``'s ``parts``, dim by dim)
_PARTS = {"mamba.in_proj": (1, 2), "mlstm.up_proj": (1, 2), "mlstm.w_if": (1, 2),
          "mlstm.if_bias": (2,), "slstm.w_in": (1, 4), "slstm.w_rec": (1, 4),
          "slstm.bias": (4,), "slstm.up": (1, 2)}


def check_model_axis(cfg: ModelConfig, ranks: int) -> None:
    """Refuse a stack that ``ranks`` tensor-parallel ranks cannot run:
    attention heads (the decoder's, which are the encoder's, the
    cross-attention's and the mLSTM's), Mamba heads, or the sLSTM's hidden
    units or GLU width that do not divide over them."""

    blocks = set(cfg.blocks)
    why = []
    nh = ssm_lib.ssm_dims(cfg)[1]
    if "mamba" in blocks and nh % ranks:
        why.append(f"{nh} Mamba heads (ROADMAP queue I, item 2: Mamba heads must divide)")
    if "slstm" in blocks:
        d_up = int((cfg.xlstm or XLSTMConfig()).proj_factor_slstm * cfg.d_model)
        for what, n in (("hidden units d_model", cfg.d_model), ("GLU width d_up", d_up)):
            if n % ranks:
                why.append(f"the sLSTM's {what} {n} (ROADMAP queue I, item 3: the sLSTM's "
                           "widths must divide)")
    if cfg.num_heads % ranks:
        why.append(f"{cfg.num_heads} heads (ROADMAP queue I: heads must divide)")
    elif cfg.num_kv_heads % ranks and ranks % cfg.num_kv_heads:
        why.append(f"{cfg.num_kv_heads} KV heads, neither dividing the ranks nor divided by "
                   "them (ROADMAP queue I: heads must divide)")
    if why:
        raise NotImplementedError(f"{cfg.name} over a model axis of {ranks} ranks: "
                                  + "; ".join(why))


def layer_specs(cfg: ModelConfig) -> List[Tuple[str, bool, bool]]:
    """Per-layer (block type, is_moe, is_local_window): with
    ``local_global_alternating`` the even layers are local (gemma2)."""

    return [(blk, cfg.is_moe_layer(i),
             bool(cfg.sliding_window) and (i % 2 == 0 or not cfg.local_global_alternating))
            for i, blk in enumerate(cfg.blocks)]


def unit_period(specs: List[Tuple[str, bool, bool]]) -> int:
    """Length of the shortest unit whose repeats give ``specs``."""

    n = len(specs)
    for p in range(1, n + 1):
        if n % p == 0 and all(specs[i] == specs[i % p] for i in range(n)):
            return p
    return n


def _is_cut(p) -> bool:
    """Whether ``p`` holds a rank's block of a larger global tensor."""

    return tuple(p.shape) != global_shape(p)


class Block(nn.Module):
    """One layer: ``norm1`` and its mixer (``attn``, ``mamba``, ``mlstm`` or
    ``slstm``; a ``cross`` attention layer also ``xnorm`` and ``xattn``),
    then, when ``d_ff > 0``, ``norm2`` and its ``mlp`` or ``moe`` (the
    reference's ``_init_block``)."""

    def __init__(self, cfg: ModelConfig, spec: Tuple[str, bool, bool], dtype, device,
                 cross: bool = False):
        super().__init__()
        self.spec = spec
        blk, is_moe, _ = spec
        self.norm1 = Norm(cfg.d_model, dtype, device)
        if blk == "attn":
            self.attn = attn.Attention(cfg, dtype, device)
            if cross:
                self.xnorm = Norm(cfg.d_model, dtype, device)
                self.xattn = attn.Attention(cfg, dtype, device)
        elif blk == "mamba":
            self.mamba = ssm_lib.Mamba(cfg, dtype, device)
        elif blk == "mlstm":
            self.mlstm = xlstm_lib.MLSTM(cfg, dtype, device)
        elif blk == "slstm":
            self.slstm = xlstm_lib.SLSTM(cfg, dtype, device)
        else:
            raise ValueError(f"no {blk!r} block: the kinds are attn, mamba, mlstm and slstm")
        if cfg.d_ff > 0:
            self.norm2 = Norm(cfg.d_model, dtype, device)
            if is_moe:
                self.moe = moe_lib.MoE(cfg, dtype, device)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, gated=cfg.gated_mlp)

    def init(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.init(generator)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None, windowed_cache: bool = False,
                 moe_impl: str = "dense", cache_cross_kv: bool = False, group=None,
                 data_group=None, batch_group=None):
        """Build ``cfg`` on ``device`` with weights drawn from ``generator``
        (default: a generator on ``device`` seeded with 0).  On
        ``device="meta"`` the model is abstract (the reference's
        ``abstract_params``): every parameter has its shape and dtype, and
        nothing is drawn or allocated; ``init_cache`` then gives meta
        tensors too (the dry run, ``launch/dryrun.py``).

        ``windowed_cache``: dense decode caches are rings sized to each
        attention layer's window (the reference's ``Model(windowed_cache=
        True)``); a ring's writes wrap and its decode masks no window.  The
        paged caches are unchanged.

        ``moe_impl``: the MoE layers' dispatch, ``"dense"`` (every expert on
        every token, ``moe_lib.moe_forward``) or ``"capacity"`` (top-k
        tokens gathered to each expert's ``cap`` slots, overflow dropped,
        ``moe_lib.moe_forward_capacity``), as the reference's switch.

        ``cache_cross_kv`` (enc-dec stacks): prefill caches each decoder
        layer's cross-attention K/V (``xk`` / ``xv``), which decode then
        reads; without it decode projects them from ``enc_out`` every token
        (the reference's baseline).

        ``group`` (a ``launch.dist.ModelGroup`` of M > 1 ranks): this model
        is the group's rank ``group.rank`` of a tensor-parallel model (see
        the module's docstring); every rank builds it with the same
        ``generator`` seed and calls its entry points in the same order.
        ``data_group`` (a ``ModelGroup`` of the data axis, D > 1 ranks): the
        MoE layers spread their experts over it (see the module's
        docstring); a stack without MoE layers holds the same blocks on
        every data rank.  ``batch_group`` (default ``data_group``): the
        ranks the engine blocks its rows over (``RankGrid.batch_group``),
        over which the capacity dispatch gathers its table."""

        super().__init__()
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {moe_impl!r}: one of {sorted(MOE_IMPLS)}")
        self.cfg = cfg
        self.windowed_cache = windowed_cache
        self.moe_impl = moe_impl
        self.cache_cross_kv = cache_cross_kv
        self.device = torch.device(device)
        self.group = group if group is not None and group.size > 1 else None
        self.data_group = data_group if data_group is not None and data_group.size > 1 else None
        self.batch_group = (batch_group if batch_group is not None and batch_group.size > 1
                            else self.data_group)
        if self.group is not None:
            check_model_axis(cfg, self.group.size)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.specs = layer_specs(cfg)
        self.period = unit_period(self.specs)
        # layer i's index among the layers of its kind (its row in the caches)
        kinds = [spec[0] for spec in self.specs]
        self.n_kind = {kind: kinds.count(kind) for kind in ("attn", *STATE_NAMES)}
        self.n_attn, self.n_mamba = self.n_kind["attn"], self.n_kind["mamba"]
        self.slot = [kinds[:i].count(kind) for i, kind in enumerate(kinds)]
        # the recurrent state's cache keys (row axis 1), kind by kind
        self.state_names = tuple(name for kind, names in STATE_NAMES.items()
                                 if self.n_kind[kind] for name in names)
        # a rank's modules are laid out on the meta device at their global
        # shapes, then each parameter is made at its block's shape
        cut = self.group is not None or (self.data_group is not None and cfg.moe is not None)
        dt, dev = self.dtype, torch.device("meta") if cut else self.device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, dev)
        if cfg.modality in ("vision", "audio") and not cfg.encoder_decoder:
            # stub frontend projector (precomputed patch embeddings -> d_model)
            self.mod_proj = Dense(cfg.d_model, cfg.d_model, dt, dev)
        self.layers = nn.ModuleList(Block(cfg, spec, dt, dev, cross=cfg.encoder_decoder)
                                    for spec in self.specs)
        self.final_norm = Norm(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, self.embed.table.shape[0], dt, dev)
        if cfg.encoder_decoder:
            self.enc_layers = nn.ModuleList(Block(cfg, ("attn", False, False), dt, dev)
                                            for _ in range(cfg.num_encoder_layers))
            self.enc_norm = Norm(cfg.d_model, dt, dev)
        self.embed_scale = embed_scale(cfg.d_model) if cfg.scale_embeddings else 0.0
        self.kv_heads = cfg.num_kv_heads
        if cut:
            self._take_blocks()
        if self.device.type == "meta":
            return  # an abstract model: shapes and dtypes, nothing drawn
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, generator: torch.Generator) -> None:
        front = [self.mod_proj] if hasattr(self, "mod_proj") else []
        head = [self.lm_head] if hasattr(self, "lm_head") else []
        enc = [*self.enc_layers, self.enc_norm] if self.cfg.encoder_decoder else []
        for m in (self.embed, *front, *self.layers, self.final_norm, *head, *enc):
            m.init(generator)

    def _rank_layout(self, name: str, shape, mesh):
        """The layout of parameter ``name`` (global ``shape``) over the rank
        mesh -> (its ``PartitionSpec``, its parts along each dim): the
        logical rules, attention and mLSTM weights by whole heads, the
        sLSTM's bias by units, a fused parameter part by part (``_PARTS``)."""

        cfg = self.cfg
        leaf = name.split(".", 2)[2] if name.startswith(("layers.", "enc_layers.")) else name
        kind, _, w = leaf.partition(".")
        if kind in ("attn", "xattn"):
            if w == "wo":
                spec = logical_to_pspec((cfg.num_heads, shape[1]), ("heads", "embed"), mesh)
            else:
                n, axis = ((cfg.num_heads, "heads") if w == "wq"
                           else (cfg.num_kv_heads, "kv_heads"))
                spec = logical_to_pspec((shape[0], n), ("embed", axis), mesh)
        elif leaf in ("mlstm.wq", "mlstm.wk", "mlstm.wv", "mlstm.w_if"):
            # rows whole (xi is gathered), columns by the rank's heads
            spec = logical_to_pspec((shape[0], cfg.num_heads), (None, "heads"), mesh)
        elif leaf == "mlstm.if_bias":
            spec = logical_to_pspec((cfg.num_heads,), ("heads",), mesh)
        elif leaf == "slstm.bias":
            spec = logical_to_pspec((cfg.d_model,), ("state",), mesh)
        else:
            spec = logical_to_pspec(shape, _BLOCK_AXES.get(leaf) or _TOP_AXES[leaf], mesh)
        return spec, _PARTS.get(leaf, ())

    def _take_blocks(self) -> None:
        """Make every parameter at the shape of this rank's block (on the
        model's device, its global shape and index kept in ``tp_block``)
        and tell each module what of it the ranks share (``tp``, the
        attention's heads, the Mamba and mLSTM layers' heads and channels,
        the sLSTM layer's units)."""

        from repro_torch.launch.mesh import Mesh

        g, cfg, hd = self.group, self.cfg, self.cfg.resolved_head_dim
        dg = self.data_group
        m, nd = (g.size if g else 1), (dg.size if dg else 1)
        devs = np.empty(nd * m, dtype=object)
        devs[:] = [self.device] * devs.size
        mesh = Mesh(devs.reshape(nd, m), ("data", "model"), group=g, data_group=dg)
        for name, p in list(self.named_parameters()):
            shape = tuple(p.shape)
            spec, parts = self._rank_layout(name, shape, mesh)
            index = local_index(shape, spec, mesh, g.rank if g else 0, parts)
            local = _param(tuple(index_extent(n, ix) for n, ix in zip(shape, index)), p.dtype,
                           self.device)
            local.tp_block = (shape, index)
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner), leaf, local)
        for blk in self.layers:
            if hasattr(blk, "moe"):
                blk.moe.dp = dg
        if g is None:
            return
        if _is_cut(self.embed.table):
            self.embed.tp = g
        if hasattr(self, "lm_head") and _is_cut(self.lm_head.w):
            self.lm_head.tp = g
        m = g.size
        if cfg.num_kv_heads % m == 0:
            self.kv_heads, kv_cols = cfg.num_kv_heads // m, None
        else:  # every KV head on every rank; a rank reads its query heads' one
            j = g.rank // (m // cfg.num_kv_heads)
            self.kv_heads, kv_cols = 1, slice(j * hd, (j + 1) * hd)
        for blk in (*self.layers, *getattr(self, "enc_layers", ())):
            if hasattr(blk, "mlp") and _is_cut(blk.mlp.up.w):
                blk.mlp.tp = g
            if hasattr(blk, "moe") and blk.moe.up.shape[2] < global_shape(blk.moe.up)[2]:
                blk.moe.tp = g
            if hasattr(blk, "mamba"):
                mb = blk.mamba
                mb.d_in, mb.n_heads, mb.tp = mb.d_in // m, mb.n_heads // m, g
            elif hasattr(blk, "mlstm"):
                ml = blk.mlstm
                ml.d_in, ml.nh, ml.tp = ml.d_in // m, ml.nh // m, g
            elif hasattr(blk, "slstm"):
                blk.slstm.units, blk.slstm.tp = cfg.d_model // m, g
            for a in (getattr(blk, n) for n in ("attn", "xattn") if hasattr(blk, n)):
                a.n_heads, a.n_kv, a.kv_cols, a.tp = cfg.num_heads // m, self.kv_heads, kv_cols, g

    @property
    def graphs(self) -> bool:
        """Whether this model's calls may be captured as CUDA graphs: on a
        card, unless a group whose collectives a decode round makes stages
        them through the host (gloo), whose rounds then run eagerly: the
        model group, and the batch group of a stack whose MoE layers
        exchange rows over it or over the data group within it (experts
        spread over the data ranks, or the capacity dispatch)."""

        rows = self.batch_group is not None and self.exchanges_rows
        return (self.device.type == "cuda" and (self.group is None or self.group.graphs)
                and (not rows or self.batch_group.graphs))

    @property
    def exchanges_rows(self) -> bool:
        """Whether a round whose rows are blocked over ranks exchanges them:
        MoE layers whose experts spread over the data ranks, or the
        capacity dispatch (its table is global)."""

        return any(blk.moe.split or self.moe_impl == "capacity"
                   for blk in self.layers if hasattr(blk, "moe"))

    @property
    def vocab_padded(self) -> int:
        """The padded vocab: the width of the logits (every rank's)."""

        return global_shape(self.embed.table)[0]

    def param_logical(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """The logical axes of every parameter in the bridge's layout
        (``checkpoint.bridge.reference_tensors``: ``{reference key: names}``,
        a block tensor stacked over its unit's repeats, so its names start
        with None for the repeat axis), with the reference's names
        (``repro/models/model.py:164``)."""

        from repro_torch.checkpoint.bridge import reference_key

        out = {}
        for name, _ in self.named_parameters():
            key, idx = reference_key(name, self.period)
            if idx < 0:
                out[key] = _TOP_AXES[name]
            else:
                out[key] = (None,) + _BLOCK_AXES[name.split(".", 2)[2]]
        return out

    def abstract_params(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{reference key: (shape, dtype)}`` of every parameter in the
        bridge's layout, keyed as ``param_logical`` keys its names (a block
        tensor stacked over its unit's repeats): the reference's
        ``abstract_params`` (``repro/models/model.py:170``)."""

        from repro_torch.checkpoint.bridge import reference_key

        out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        for name, p in self.named_parameters():
            key, idx = reference_key(name, self.period)
            # the layers come in order, so a key's last write has its repeats
            shape = global_shape(p)
            out[key] = (shape if idx < 0 else (idx + 1,) + shape, p.dtype)
        return out

    def cache_logical(self, batch: int, seq: int):
        """The logical axes of the decode state, key for key: the tensors
        of ``init_cache(batch, seq)`` (``k`` / ``v`` stacked over the
        attention layers, or with ``windowed_cache`` a list of one entry a
        ring; the recurrent state under ``state_names``; not the host int
        ``len``) and what ``prefill`` adds to an enc-dec stack's cache,
        ``enc_out`` and, with ``cache_cross_kv``, ``xk`` / ``xv``.  The
        counterpart of the reference's ``cache_logical``
        (``repro/models/model.py:871``), which names its own ``{"unit":
        [...]}`` layout; the two lay out the same bytes."""

        kv = (None, "batch", "kv_seq", "kv_heads", None)
        out = {name: _STATE_AXES[name] for name in self.state_names}
        if self.n_attn:
            out["k"] = out["v"] = [kv[1:]] * self.n_attn if self.windowed_cache else kv
        if self.cfg.encoder_decoder:
            out["enc_out"] = ("batch", "act_seq", "act_embed")
            if self.cache_cross_kv:
                out["xk"] = out["xv"] = kv
        return out

    def _window_for(self, spec, seq_len: int) -> int:
        cfg = self.cfg
        if spec[2]:
            return cfg.sliding_window
        # beyond-window long-context serving of global layers
        if seq_len > cfg.long_context_window and cfg.subquadratic_decode:
            return cfg.long_context_window
        return 0

    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # per-layer blocks: the fused entry points below and the partition
    # executor (``partition/executor.py``) run the same functions
    # ------------------------------------------------------------------

    def layer_cache(self, cache, i: int):
        """Layer ``i``'s entries of a whole-model ``cache`` as a per-layer
        cache (views, so the block functions update ``cache`` in place):
        ``{"k", "v"}`` dense slabs or ``{"kp", "vp"}`` pools (an enc-dec
        decoder layer adds ``enc_out`` and, cached, its ``xk`` / ``xv``), or
        the recurrent state of a Mamba, mLSTM or sLSTM layer under its
        ``STATE_NAMES``.  The model's caches stack each kind over the layers
        of that kind (``self.slot``); the split executor keys its own
        per-layer caches by model layer; this is the one map between them."""

        j = self.slot[i]
        kind = self.specs[i][0]
        if kind != "attn":
            return {name: cache[name][j] for name in STATE_NAMES[kind]}
        if "kp" in cache:
            out = {"kp": cache["kp"][j], "vp": cache["vp"][j]}
        else:
            out = {"k": cache["k"][j], "v": cache["v"][j]}
        if self.cfg.encoder_decoder:
            out["enc_out"] = cache["enc_out"]
            if "xk" in cache:
                out["xk"], out["xv"] = cache["xk"][j], cache["xv"][j]
        return out

    @staticmethod
    def _store(cache, state) -> None:
        """Copy a block's new recurrent ``state`` into its per-layer cache."""

        for name, t in state.items():
            cache[name].copy_(t)

    def _block_mix_seq(self, i: int, x, positions, cache=None, enc_out=None):
        """Layer ``i``'s mixer half over a sequence (norm1, attention, Mamba,
        mLSTM or sLSTM, residual; an enc-dec decoder layer then its
        cross-attention over ``enc_out``), writing the prompt's K/V (and the
        cross K/V where the cache holds ``xk``) or the recurrent state into
        the per-layer ``cache`` (if given) -> x."""

        blk = self.layers[i]
        cfg = self.cfg
        kind = blk.spec[0]
        h = rms_norm(x, blk.norm1.scale, cfg.norm_eps)
        state = None
        if kind == "attn":
            s = x.shape[1]
            out, k, v = attn.attention_forward(
                h, blk.attn, cfg, positions, self._window_for(blk.spec, s)
            )
            if cache is not None:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
        elif kind == "mamba":
            out, state = ssm_lib.mamba_forward(h, blk.mamba, cfg)
        elif kind == "mlstm":
            out, st = xlstm_lib.mlstm_forward(h, blk.mlstm, cfg)
            state = dict(zip(STATE_NAMES[kind], st))
        else:
            out, st = xlstm_lib.slstm_forward(h, blk.slstm, cfg)
            state = dict(zip(STATE_NAMES[kind], st))
        if cache is not None and state is not None:
            self._store(cache, state)
        x = x + out
        if enc_out is not None and kind == "attn":
            hx = rms_norm(x, blk.xnorm.scale, cfg.norm_eps)
            out, xk, xv = attn.cross_attention_forward(hx, blk.xattn, cfg, enc_out)
            if cache is not None and "xk" in cache:
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
            x = x + out
        return x

    def _block_ffn(self, i: int, x):
        """Layer ``i``'s FFN half: norm2, MLP or MoE, residual -> x (x
        itself when ``d_ff == 0``: an xLSTM block has no FFN)."""

        return self._block_ffn_aux(i, x)[0]

    def _block_ffn_aux(self, i: int, x):
        """``_block_ffn`` -> (x, the MoE router's aux loss; None for a layer
        without experts)."""

        blk = self.layers[i]
        if self.cfg.d_ff <= 0:
            return x, None
        h = rms_norm(x, blk.norm2.scale, self.cfg.norm_eps)
        if blk.spec[1]:
            out, aux = MOE_IMPLS[self.moe_impl](h, blk.moe, self.cfg)
            return x + out, aux
        return x + mlp(h, blk.mlp, self.cfg.mlp_activation), None

    def _moe_pre_dispatch(self, i: int, x):
        """The edge half of a gather/scatter MoE split of layer ``i``: norm2
        and the router -> (h2, combine), what ships to the experts;
        ``moe_lib.moe_apply_experts(h2, combine, ...)`` finishes the mixture.
        The two halves are ``_block_ffn``'s dense MoE op for op (the
        executor splits no capacity dispatch)."""

        blk = self.layers[i]
        h2 = rms_norm(x, blk.norm2.scale, self.cfg.norm_eps)
        combine, _ = moe_lib.router_probs(h2, blk.moe.router, self.cfg.moe.num_experts_per_tok)
        return h2, combine

    def _block_seq(self, i: int, x, positions, cache=None, enc_out=None):
        return self._block_ffn(i, self._block_mix_seq(i, x, positions, cache, enc_out))

    def _block_mix_step(self, i: int, x, cache, length, paged=None):
        """Layer ``i``'s mixer half for one token, x [B,1,D], against its
        per-layer ``cache`` (updated in place) at ``length`` (an int or a
        [B] tensor).  ``paged``: the ``(page_table, cap)`` pair of a paged
        cache (``{"kp", "vp"}`` pools).  An enc-dec decoder layer then
        cross-attends: over the cache's ``xk`` / ``xv`` where it holds them,
        else over K/V projected from its ``enc_out`` -> x."""

        blk = self.layers[i]
        cfg = self.cfg
        kind = blk.spec[0]
        h = rms_norm(x, blk.norm1.scale, cfg.norm_eps)
        if kind == "mamba":
            out, state = ssm_lib.mamba_decode_step(h, blk.mamba, cfg, cache)
            self._store(cache, state)
        elif kind in ("mlstm", "slstm"):
            names = STATE_NAMES[kind]
            fwd = xlstm_lib.mlstm_forward if kind == "mlstm" else xlstm_lib.slstm_forward
            out, st = fwd(h, getattr(blk, kind), cfg, state=tuple(cache[n] for n in names),
                          step=True)
            self._store(cache, dict(zip(names, st)))
        elif paged is not None:
            pt, cap = paged
            capacity = pt.shape[1] * cache["kp"].shape[1]
            out = attn.attention_decode_step_paged(
                h, blk.attn, cfg, cache["kp"], cache["vp"], pt, length, cap,
                self._window_for(blk.spec, capacity),
            )
        else:
            ck, cv = cache["k"], cache["v"]
            out = attn.attention_decode_step(
                h, blk.attn, cfg, ck, cv, length,
                self._window_for(blk.spec, ck.shape[1]), ring=self.windowed_cache,
            )
        x = x + out
        if kind == "attn" and cfg.encoder_decoder:
            hx = rms_norm(x, blk.xnorm.scale, cfg.norm_eps)
            if "xk" in cache:
                out = attn.cross_attention_cached(hx, blk.xattn, cfg, cache["xk"], cache["xv"])
            else:
                out = attn.cross_attention_decode(hx, blk.xattn, cfg, cache["enc_out"])
            x = x + out
        return x

    def _block_step(self, i: int, x, cache, length, paged=None):
        return self._block_ffn(i, self._block_mix_step(i, x, cache, length, paged))

    def _init_state(self, kind: str, batch: int, whole: bool = False):
        """A zero recurrent state of one layer of ``kind`` (its stabilizers
        at -1e30), keyed by ``STATE_NAMES[kind]``: the rank's blocks, or
        (``whole``) the one-rank model's state on the meta device."""

        ranks, dev = (1, torch.device("meta")) if whole else (
            self.group.size if self.group else 1, self.device)
        if kind == "mamba":
            return ssm_lib.init_mamba_state(self.cfg, batch, self.dtype, dev, ranks)
        init = xlstm_lib.init_mlstm_state if kind == "mlstm" else xlstm_lib.init_slstm_state
        return dict(zip(STATE_NAMES[kind], init(self.cfg, batch, dev, ranks)))

    def _init_block_cache(self, i: int, batch: int, seq: int):
        """A zero per-layer dense cache of layer ``i``: ``{"k", "v"}``
        [B, seq, KV, Dh] (a ring of ``min(seq, window)`` slots with
        ``windowed_cache``) or the recurrent state of its kind."""

        spec = self.specs[i]
        if spec[0] != "attn":
            return self._init_state(spec[0], batch)
        n = seq
        if self.windowed_cache:
            n = min(seq, self._window_for(spec, seq) or seq)
        z = dict(dtype=self.dtype, device=self.device)
        return {"k": torch.zeros((batch, n) + self._kv_shape(), **z),
                "v": torch.zeros((batch, n) + self._kv_shape(), **z)}

    def _total_seq(self, batch) -> int:
        """The decoder's sequence length (an enc-dec stack's frames feed its
        encoder, not the decoder)."""

        s = batch["tokens"].shape[1]
        if "frontend" in batch and not self.cfg.encoder_decoder:
            s += batch["frontend"].shape[1]
        return s

    def _embed_inputs(self, batch):
        x = embed_lookup(batch["tokens"], self.embed.table, self.embed_scale,
                         self.embed.tp).to(self.dtype)
        if "frontend" in batch and not self.cfg.encoder_decoder:
            fe = dense(batch["frontend"].to(self.dtype), self.mod_proj.w)
            x = torch.cat([fe, x], dim=1)
        return x

    def _encode(self, frames):
        """The encoder (the reference's ``_encode``, model.py:517-544): frames
        [B,S_enc,D] plus sinusoidal positions, then per layer norm1,
        non-causal attention without RoPE, residual, norm2, the MLP,
        residual; ``enc_norm`` at the end -> enc_out [B,S_enc,D]."""

        cfg = self.cfg
        x = frames.to(self.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, self.dtype, x.device)[None]
        for blk in self.enc_layers:
            h = rms_norm(x, blk.norm1.scale, cfg.norm_eps)
            x = x + attn.encoder_attention(h, blk.attn, cfg)
            h = rms_norm(x, blk.norm2.scale, cfg.norm_eps)
            x = x + mlp(h, blk.mlp, cfg.mlp_activation)
        return rms_norm(x, self.enc_norm.scale, cfg.norm_eps)

    def _enc_out(self, batch):
        """The encoder's output for an enc-dec ``batch`` (None otherwise)."""

        if not self.cfg.encoder_decoder:
            return None
        if "frontend" not in batch:
            raise ValueError("an encoder-decoder stack's batch needs \"frontend\" frame "
                             "embeddings [B, S_enc, D] for its encoder")
        return self._encode(batch["frontend"])

    def _logits(self, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            return logits_from_embedding(x, self.embed.table, cfg.vocab_size,
                                         cfg.final_logit_softcap, self.embed.tp)
        # parity: the softcap, then ids >= vocab in the padded head get -1e9
        # (model.py:500-511)
        return mask_padded_vocab(all_gather_cat(dense(x, self.lm_head.w), -1, self.lm_head.tp),
                                 cfg.vocab_size, cfg.final_logit_softcap)

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch, extra: int = 0):
        """Run the prompt, fill a dense cache -> (last-token logits [B,1,V], cache).

        ``batch``: ``{"tokens": [B, S] int}`` (+ ``"frontend"`` [B, P, D]
        stub embeddings: the decoder's prefix, or an enc-dec stack's encoder
        input, whose output the cache keeps as ``enc_out``).  ``extra``
        reserves cache slots for decode.
        """

        enc_out = self._enc_out(batch)
        x = self._embed_inputs(batch)
        b, s = x.shape[:2]
        cache = self.init_cache(b, s + extra)
        if self.windowed_cache and any(s > ring.shape[1] for ring in cache.get("k", ())):
            raise ValueError(f"a {s}-token prompt is longer than a ring cache")
        if enc_out is not None:
            cache["enc_out"] = enc_out
            if self.cache_cross_kv:
                shape = (self.n_attn, b, enc_out.shape[1]) + self._kv_shape()
                cache["xk"], cache["xv"] = (torch.zeros(shape, dtype=self.dtype, device=x.device)
                                            for _ in range(2))
        positions = torch.arange(s, device=x.device)[None, :]
        for i in range(len(self.layers)):
            x = self._block_seq(i, x, positions, self.layer_cache(cache, i), enc_out)
        cache["len"] = s
        x = rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def forward(self, batch):
        """Full-sequence forward without a cache -> the final-normed hidden
        [B, S, D] (``_logits`` of it gives the logits): the parity surface of
        the split executor."""

        enc_out = self._enc_out(batch)
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for i in range(len(self.layers)):
            x = self._block_seq(i, x, positions, None, enc_out)
        return rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)

    def _ce_chunk(self, xc, yc, mc):
        """Summed masked next-token cross entropy of one chunk: xc [B,ck,D]
        hidden, yc [B,ck] labels, mc [B,ck] mask; logsumexp and the gold
        logit in float32."""

        logits = self._logits(xc).float()
        lz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        return torch.sum((lz - gold) * mc)

    def loss_fn(self, batch):
        """Next-token cross entropy over the text positions -> (loss,
        {"ce", "aux"}); the reference's ``loss_fn`` (model.py:571-611), run
        under autograd (parameters that require gradients get them from
        ``loss.backward()``).

        ``batch``: ``tokens`` [B, S_text], ``labels`` [B, S_text] (int64),
        optional ``loss_mask`` [B, S_text] (default ones) and ``frontend``
        (a VLM's patch embeddings, prefixed, or an enc-dec stack's frames).
        Parity traps kept: only the last ``labels.shape[1]`` positions are
        scored; the text is cut into ``n = max(S // CE_CHUNK, 1)`` chunks of
        ``min(CE_CHUNK, S)`` and positions past ``n`` chunks are dropped; each
        chunk's logits are recomputed in the backward
        (``torch.utils.checkpoint``, for the reference's ``jax.checkpoint``);
        MoE stacks add ``router_aux_loss * aux / num_layers``, aux summed
        over the layers; ``"ce"`` is the total loss, aux included, as the
        reference returns it."""

        cfg = self.cfg
        if self.group is not None or self.data_group is not None:
            raise NotImplementedError("training over a model or data axis of ranks: the "
                                      "backward's collectives are not written (ROADMAP queue I)")
        enc_out = self._enc_out(batch)
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(len(self.layers)):
            x, a = self._block_ffn_aux(i, self._block_mix_seq(i, x, positions, None, enc_out))
            if a is not None:
                aux = aux + a
        x = rms_norm(x, self.final_norm.scale, cfg.norm_eps)

        labels = batch["labels"]
        s = labels.shape[1]
        x = x[:, -s:]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
        n_chunks, ck = max(s // CE_CHUNK, 1), min(CE_CHUNK, s)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            sl = slice(c * ck, (c + 1) * ck)
            mc = mask[:, sl].float()
            total = total + checkpoint(self._ce_chunk, x[:, sl], labels[:, sl], mc,
                                       use_reentrant=False)
            count = count + mc.sum()
        loss = total / torch.clamp(count, min=1.0)
        if cfg.moe is not None and cfg.moe.num_experts:
            loss = loss + cfg.moe.router_aux_loss * aux / max(cfg.num_layers, 1)
        return loss, {"ce": loss, "aux": aux}

    @torch.no_grad()
    def decode_step(self, token, cache):
        """token [B,1] -> (logits [B,1,V], cache with ``len`` advanced).

        A paged cache (``"pt"`` present) reads and writes the shared page
        pool; a dense cache its per-row slabs.  Recurrent state is dense in
        both.  Caches update in place.
        """

        x = embed_lookup(token, self.embed.table, self.embed_scale, self.embed.tp).to(self.dtype)
        paged = (cache["pt"], cache["cap"]) if "pt" in cache else None
        for i in range(len(self.layers)):
            x = self._block_step(i, x, self.layer_cache(cache, i), cache["len"], paged)
        x = rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + 1
        return self._logits(x), new_cache

    @torch.no_grad()
    def decode_chunk(self, logits, cache, n_steps: int, token_floor: int = 0):
        """Greedy decode of ``n_steps`` tokens without a host sync per token.

        Each step masks ids below ``token_floor`` (the action-bin range) to
        -1e9 (parity: model.py:676-678), takes the argmax and feeds it back
        through ``decode_step``.  Returns (tokens [B, n_steps], next logits
        [B,1,V], cache).
        """

        floor = torch.arange(logits.shape[-1], device=logits.device) < token_floor
        toks = []
        for _ in range(n_steps):
            ls = logits[:, -1]
            if token_floor:
                ls = ls.masked_fill(floor, -1e9)
            tok = ls.argmax(dim=-1, keepdim=True)
            logits, cache = self.decode_step(tok, cache)
            toks.append(tok)
        return torch.cat(toks, dim=1), logits, cache

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------

    def _kv_shape(self):
        """A cache's KV heads (this rank's) and head size."""

        return (self.kv_heads, self.cfg.resolved_head_dim)

    def _recurrent_state(self, batch: int):
        """Zero recurrent state of every Mamba, mLSTM and sLSTM layer,
        stacked over the layers of each kind ({} for a stack without)."""

        out = {}
        for kind in STATE_NAMES:
            n = self.n_kind[kind]
            if n:
                for name, t in self._init_state(kind, batch).items():
                    out[name] = t.expand((n,) + t.shape).clone()
        return out

    def handoff_layout(self, batch: int, seq: int
                       ) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
        """What a prefill of ``batch`` prompts of ``seq`` tokens on the
        one-rank model hands to the decode ranks, in order: its last logits
        ``[batch, vocab_padded]`` and its dense cache (``k`` / ``v``
        ``[La, batch, seq, KV, Dh]``, the recurrent state under
        ``state_names``), each (name, shape, dtype), whatever this model's
        rank (``runtime.scheduler``'s prefill rank)."""

        kv = (self.n_attn, batch, seq, self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        out = [("logits", (batch, self.vocab_padded), self.dtype)]
        if self.n_attn:
            out += [("k", kv, self.dtype), ("v", kv, self.dtype)]
        for kind in STATE_NAMES:
            if self.n_kind[kind]:
                out += [(name, (self.n_kind[kind],) + tuple(t.shape), t.dtype)
                        for name, t in self._init_state(kind, batch, whole=True).items()]
        return out

    def rank_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of tensor ``name`` of ``handoff_layout`` (the
        one-rank model's): its KV heads of ``k`` / ``v`` and its heads,
        channels or units of the recurrent state (``_STATE_BLOCK``); the
        logits and the sLSTM's h are whole on every rank."""

        g = self.group
        if g is None or name not in ("k", "v", *_STATE_BLOCK):
            return t
        if name in ("k", "v"):
            a = next(blk.attn for blk in self.layers if hasattr(blk, "attn"))
            if a.kv_cols is not None:  # every rank one KV head
                j = a.kv_cols.start // self.cfg.resolved_head_dim
                return t[:, :, :, j:j + 1]
            return t.narrow(3, g.rank * self.kv_heads, self.kv_heads)
        axis = _STATE_BLOCK[name]
        n = t.shape[axis] // g.size
        return t.narrow(axis, g.rank * n, n)

    def init_cache(self, batch: int, seq: int):
        """Dense decode cache of ``seq`` slots per row (``windowed_cache``:
        ``min(seq, window)`` slots for each attention layer with a window,
        as model.py:844-845).  ``prefill`` adds an enc-dec stack's
        ``enc_out`` (and ``xk`` / ``xv``)."""

        cache = {"len": 0, **self._recurrent_state(batch)}
        if not self.n_attn:
            return cache
        z = dict(dtype=self.dtype, device=self.device)
        if self.windowed_cache:
            sizes = [min(seq, self._window_for(spec, seq) or seq)
                     for spec in self.specs if spec[0] == "attn"]
            k, v = ([torch.zeros((batch, n) + self._kv_shape(), **z) for n in sizes]
                    for _ in range(2))
        else:
            shape = (self.n_attn, batch, seq) + self._kv_shape()
            k, v = torch.zeros(shape, **z), torch.zeros(shape, **z)
        cache["k"], cache["v"] = k, v
        return cache

    def init_paged_cache(self, batch: int, spec: PagedSpec):
        """Page pools of ``spec.num_pages + 1`` pages per attention layer
        (the extra page absorbs writes of idle and over-capacity rows; a
        stack without attention layers has none); the page table and
        per-row capacity are shared by every layer; ``cap == 0`` rows are
        inactive.  Recurrent state is O(1) a row and stays dense."""

        i32 = dict(dtype=torch.int32, device=self.device)
        cache = {
            "len": torch.zeros((batch,), **i32),
            "pt": torch.zeros((batch, spec.max_pages_per_seq), **i32),
            "cap": torch.zeros((batch,), **i32),
            **self._recurrent_state(batch),
        }
        if self.n_attn:
            shape = (self.n_attn, spec.num_pages + 1, spec.page_size) + self._kv_shape()
            z = dict(dtype=self.dtype, device=self.device)
            cache["kp"], cache["vp"] = torch.zeros(shape, **z), torch.zeros(shape, **z)
        return cache

    @torch.no_grad()
    def cache_to_paged(self, cache, paged, page_table, caps, lens=None):
        """Scatter a dense prefilled ``cache`` into the ``paged`` pools (in
        place) and return the paged cache that drives decode.

        ``page_table`` [B, MAXP] / ``caps`` [B] come from the page
        allocator; ``lens`` defaults to the prefill length for every row.
        The recurrent state of ``cache`` and an enc-dec stack's ``enc_out``
        (and cached ``xk`` / ``xv``) carry over dense, as they are.
        """

        pt = torch.as_tensor(page_table, dtype=torch.int32, device=self.device)
        b = pt.shape[0]
        if lens is None:
            lens = torch.full((b,), int(cache["len"]), dtype=torch.int32, device=self.device)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        for i in range(self.n_attn):
            scatter_prompt_into_pool(paged["kp"][i], cache["k"][i], pt, lens)
            scatter_prompt_into_pool(paged["vp"][i], cache["v"][i], pt, lens)
        out = {
            "len": lens,
            "pt": pt,
            "cap": torch.as_tensor(caps, dtype=torch.int32, device=self.device),
        }
        if self.n_attn:
            out["kp"], out["vp"] = paged["kp"], paged["vp"]
        for name in self.state_names + ("enc_out", "xk", "xv"):
            if name in cache:
                out[name] = cache[name]
        return out

    @torch.no_grad()
    def merge_prefill_into_paged(self, cache, paged, page_table, row_idx, lens, caps):
        """Merge an admission batch's dense prefill into the live paged cache,
        in place; returns ``paged``.

        ``cache`` is a dense prefill over ``n`` new sequences; ``row_idx``
        [n] (host ints) names the batch rows they take over, ``page_table``
        [n, MAXP] their pages, ``lens`` / ``caps`` [n] their prompt lengths
        and token capacities.  Rows at or beyond the batch's row count are
        admission padding: they are dropped (the reference's
        ``mode="drop"``), and their length 0 routes their prompt K/V to the
        trash page.  The claimed rows' ``len``, ``pt`` and ``cap`` and their
        recurrent state (``state_names``) are overwritten.
        """

        i32 = dict(dtype=torch.int32, device=self.device)
        pt_new = torch.as_tensor(page_table, **i32)
        lens_t = torch.as_tensor(lens, **i32)
        for i in range(self.n_attn):
            scatter_prompt_into_pool(paged["kp"][i], cache["k"][i], pt_new, lens_t)
            scatter_prompt_into_pool(paged["vp"][i], cache["v"][i], pt_new, lens_t)
        row_idx = np.asarray(row_idx)
        keep = np.flatnonzero(row_idx < paged["len"].shape[0])
        src = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        dst = torch.as_tensor(row_idx[keep], dtype=torch.long, device=self.device)
        for name, new in (("len", lens_t), ("pt", pt_new), ("cap", torch.as_tensor(caps, **i32))):
            paged[name].index_copy_(0, dst, new.index_select(0, src))
        for name in self.state_names:  # [L, B, ...]: axis 1 is the row
            live = paged[name]
            live.index_copy_(1, dst, cache[name].index_select(1, src).to(live.dtype))
        return paged
