"""Split execution of a planned partition: edge prefix / cloud suffix (the
port's counterpart of ``repro/partition/executor.py``).

``PartitionExecutor`` runs a ``Model`` split after ``cut_layer`` layers:

  * the EDGE side owns the stem (embedding, modality projector) and the
    first ``cut_layer`` layers; its prefill emits the cut activations that
    would ship over the channel;
  * the CLOUD side owns the remaining layers, the final norm and the head;
    it finishes the prefill and drives the action-chunk decode.

Decode ping-pongs per token (the suffix owner samples, the prefix owner
embeds), the round trip the planner prices.  Both halves run the model's
own per-layer block functions (``Model._block_seq`` / ``_block_step``), the
ones its fused ``prefill`` / ``decode_step`` run, so the split numbers are
the unpartitioned model's, and every attention call reaches the hand
kernels through ``kernels.ops`` as the fused path does: prefill through
the flash kernel, the edge prefix's dense caches through the decode kernel,
the cloud suffix's shared page pools through the paged kernel.

The port's per-layer weights are separate ``Block`` modules, so a side is a
list of references into ``model.layers``: ``with_cut`` derives a sibling at
another boundary over the same storage, never a copy.  Caches here are
per-layer dicts (``{"k", "v"}`` dense slabs, ``{"kp", "vp"}`` pools, or
the recurrent state of a Mamba, mLSTM or sLSTM layer under its
``models.model.STATE_NAMES``), keyed by model layer where the reference keys its
split state, and updated in place (the reference returns new arrays).

``expert_offload`` lists edge-side MoE layers whose expert FFNs live
cloud-side: the edge runs the layer's mixer, norm2 and router
(``Model._moe_pre_dispatch``), ships the hidden states and combine weights
up, the cloud applies the experts (``moe_apply_offloaded``) and ships the
mixture down; the seam is the fused MoE block op for op, so tokens do not
change.  The port runs eagerly (or replays a CUDA graph), so the reference's
whole-edge jit and its host-composed per-layer programs (``_gs_block_calls``)
are one path here, ``_edge_blocks``; the legs are priced by
``modeled_net_ms`` / ``record_chunk_bytes``, like the cut itself.

``PartitionedPolicy`` is a drop-in ``CloudPolicy``: same observation-in /
action-chunk-out interface, its chunk a CUDA graph where the model allows
one, plus the modeled channel milliseconds of every call.

For fleet serving the executor exposes a batched cloud-suffix mode
(``edge_prefill`` / ``edge_step`` / ``suffix_prefill`` / ``suffix_step``
and the fused window ``build_fleet_decode``): per-robot edge prefixes feed
one ragged batch of cut activations into a paged suffix that shares the
continuous-batching scheduler's page pool (``runtime/scheduler.py``'s
split lanes).

**A rank's split.**  Over a tensor-parallel rank's model
(``Model(group=...)``) every rank runs both sides on its own blocks, SPMD:
the edge token embedding sums the rank's vocab block over the ranks, as the
model's own embedding does; the suffix pools hold the rank's KV heads
(``Model._kv_shape``); the lane state and the edge rows are the rank's
sizes (``Model._init_block_cache``).  A split changes where a layer runs,
not how many collectives a token makes (``launch.dist``): a ping-pong token
of ``PartitionedPolicy`` makes exactly the unsplit decode token's count
(``dist.collectives``), and a fused window over L lanes makes, a token, L
embedding all-reduces, each lane's edge layers' collectives, the shared
tail's once and one all-gather of the logits (``dist.lane_collectives``).
The cut activation is whole ``[B, d_model]`` on every rank once its layer's
all-reduce is done, so the channel's bytes and milliseconds
(``shipped_bytes``, ``record_chunk_bytes``, ``modeled_net_ms``) are the one
rank's on every rank.  Under gloo, which stages the collectives through
the host, ``PartitionedPolicy`` runs eagerly (``Model.graphs``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.launch.sharding import rows_scope
from repro_torch.models.layers import embed_lookup, rms_norm
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_apply_offloaded
from repro_torch.obs.clock import clock
from repro_torch.partition.planner import TOKEN_ID_BYTES, interior_net_ms
from repro_torch.runtime.channel import ChannelConfig, roundtrip_ms
from repro_torch.runtime.graphs import GraphedCall, owner_call
from repro_torch.runtime.kv_cache import scatter_prompt_into_pool


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))], 0)


class PartitionExecutor:
    """Run ``model`` split after ``cut_layer`` layers (0 = a stem-only edge,
    ``num_layers`` = an empty cloud suffix: the cloud holds only the final
    norm and the head)."""

    def __init__(self, model: Model, cut_layer: int, channel: Optional[ChannelConfig] = None,
                 expert_offload: Tuple[int, ...] = ()):
        cfg = model.cfg
        if cfg.encoder_decoder:
            raise NotImplementedError("split execution targets decoder-only stacks")
        if not 0 <= cut_layer <= cfg.num_layers:
            raise ValueError(f"cut_layer {cut_layer} outside [0, {cfg.num_layers}]")
        self.model = model
        self.cfg = cfg
        self.cut_layer = cut_layer
        self.channel = channel or ChannelConfig()
        self.expert_offload = tuple(sorted({int(l) for l in expert_offload}))
        self._offload_set = frozenset(self.expert_offload)
        for l in self.expert_offload:  # noqa: E741
            if not 0 <= l < cut_layer:
                raise ValueError(f"expert_offload layer {l} not edge-side of cut {cut_layer}")
            if not (model.specs[l][1] and cfg.d_ff > 0 and cfg.moe is not None):
                raise ValueError(f"expert_offload layer {l} is not an MoE layer")
        if self.expert_offload and model.moe_impl != "dense":
            raise ValueError("gather/scatter expert offload splits the dense MoE path; "
                             "capacity dispatch keeps experts fused")
        self.shipped_bytes = 0.0
        # an Observability handle (``attach_partition`` sets it): the serial
        # legs then record their host times, ``record_chunk_bytes`` its bytes
        self.obs = None
        # the sides: layer indices into the model's own blocks, never copies
        self.edge_layers = range(cut_layer)
        self.cloud_layers = range(cut_layer, cfg.num_layers)

    def with_cut(self, cut_layer: int, expert_offload: Tuple[int, ...] = ()) -> "PartitionExecutor":
        """A sibling executor at ``cut_layer`` over the same weights.
        ``expert_offload`` does not inherit: pass it to derive an
        expert-offload lane."""

        expert_offload = tuple(sorted({int(l) for l in expert_offload}))
        if cut_layer == self.cut_layer and expert_offload == self.expert_offload:
            return self
        sibling = PartitionExecutor(self.model, cut_layer, self.channel, expert_offload)
        sibling.obs = self.obs
        return sibling

    @property
    def lane_key(self):
        """The scheduler's lane key: the plain cut for a layer cut,
        ``(cut, offload)`` for an expert-offload lane."""

        if self.expert_offload:
            return (self.cut_layer, self.expert_offload)
        return self.cut_layer

    # ------------------------------------------------------------------
    # the edge prefix; the full-sequence split forward (the parity surface)
    # ------------------------------------------------------------------

    def _embed_token(self, token):
        m = self.model
        return embed_lookup(token, m.embed.table, m.embed_scale, m.embed.tp).to(m.dtype)

    def _edge_blocks(self, x, caches, positions=None, length=None, cut=None, offload=None):
        """The edge prefix over ``x`` (``positions``: a sequence; else one
        token at ``length``) with its per-layer ``caches`` (indexed by model
        layer; None: no cache) -> x.  ``cut`` / ``offload`` default to this
        executor's.  An offloaded layer runs its mixer, ships ``(h2,
        combine)`` up, applies the cloud-resident experts and ships the
        mixture down: ``_block_ffn``'s MoE op for op."""

        m = self.model
        cut = self.cut_layer if cut is None else cut
        offload = self._offload_set if offload is None else offload
        for i in range(cut):
            c = None if caches is None else caches[i]
            if positions is not None:
                x = m._block_mix_seq(i, x, positions, c)
            else:
                x = m._block_mix_step(i, x, c, length)
            if i in offload:
                h2, combine = m._moe_pre_dispatch(i, x)                 # uplink
                x = x + moe_apply_offloaded(h2, combine, m.layers[i].moe)  # downlink
            else:
                x = m._block_ffn(i, x)
        return x

    @torch.no_grad()
    def edge_forward(self, batch):
        """Stem + edge prefix -> (cut activations [B,S,D], positions)."""

        x = self.model._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return self._edge_blocks(x, None, positions=positions), positions

    @torch.no_grad()
    def cloud_forward(self, x, positions):
        """Cloud suffix + final norm -> hidden [B,S,D]."""

        for i in self.cloud_layers:
            x = self.model._block_seq(i, x, positions)
        return rms_norm(x, self.model.final_norm.scale, self.cfg.norm_eps)

    @torch.no_grad()
    def forward(self, batch):
        """The split forward; equals ``Model.forward``'s hidden."""

        x, positions = self.edge_forward(batch)
        self.shipped_bytes += float(x.numel() * x.element_size())
        return self.cloud_forward(x, positions)

    def logits(self, x):
        return self.model._logits(x)

    # ------------------------------------------------------------------
    # split serving path (prefill + ping-pong decode)
    # ------------------------------------------------------------------

    def _init_caches(self, layers, batch: int, seq: int) -> Dict[int, dict]:
        return {i: self.model._init_block_cache(i, batch, seq) for i in layers}

    @torch.no_grad()
    def split_prefill(self, batch, extra: int):
        """Both halves prefill their own caches -> (logits [B,1,V], state)."""

        m = self.model
        x = m._embed_inputs(batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :]
        caches = self._init_caches(range(self.cfg.num_layers), b, s + extra)
        x = self._edge_blocks(x, caches, positions=positions)
        for i in self.cloud_layers:
            x = m._block_seq(i, x, positions, caches[i])
        x = rms_norm(x, m.final_norm.scale, self.cfg.norm_eps)
        return m._logits(x[:, -1:]), {"caches": caches, "len": s}

    @torch.no_grad()
    def split_decode_step(self, token, state):
        """One ping-pong: the edge embeds and runs the prefix, the cloud
        finishes and returns logits [B,1,V]; ``len`` advances."""

        m = self.model
        caches, n = state["caches"], state["len"]
        x = self._edge_blocks(self._embed_token(token), caches, length=n)
        for i in self.cloud_layers:
            x = m._block_step(i, x, caches[i], n)
        x = rms_norm(x, m.final_norm.scale, self.cfg.norm_eps)
        return m._logits(x), {"caches": caches, "len": n + 1}

    @torch.no_grad()
    def split_decode_chunk(self, logits, state, n_steps: int, token_floor: int = 0):
        """Greedy split decode of ``n_steps`` tokens (``Model.decode_chunk``'s
        loop) -> (tokens [B, n_steps], next logits, state)."""

        floor = torch.arange(logits.shape[-1], device=logits.device) < token_floor
        toks = []
        for _ in range(n_steps):
            ls = logits[:, -1]
            if token_floor:
                ls = ls.masked_fill(floor, -1e9)
            tok = ls.argmax(dim=-1, keepdim=True)
            logits, state = self.split_decode_step(tok, state)
            toks.append(tok)
        return torch.cat(toks, dim=1), logits, state

    # ------------------------------------------------------------------
    # batched cloud-suffix serving (the scheduler's split lanes)
    # ------------------------------------------------------------------
    #
    # Each robot's edge prefix is its own batch-1 dense-cache stack (its
    # device), while the cloud suffix serves all of them as one ragged batch
    # over the scheduler's page pools.  ``layers`` arguments are per cloud
    # layer, in order: the shared pool ``{"kp", "vp"}`` of an attention
    # layer, the lane's per-row recurrent state of a Mamba or xLSTM layer.

    def init_layer_pool(self, spec):
        """One attention layer's suffix K/V pools (+1 trash page each), two
        distinct buffers.  The scheduler owns them, keyed by model layer:
        every lane whose cut precedes the layer shares its pool (page ids
        are global, one allocator).  A rank's pools hold its KV heads."""

        shape = (spec.num_pages + 1, spec.page_size) + self.model._kv_shape()
        z = dict(dtype=self.model.dtype, device=self.model.device)
        return {"kp": torch.zeros(shape, **z), "vp": torch.zeros(shape, **z)}

    def init_lane_state(self, spec, rows: int):
        """Per-row recurrent state of the cloud suffix's Mamba and xLSTM layers, keyed
        by model layer (per lane: each cut decodes its own rows)."""

        return {i: self.model._init_block_cache(i, rows, spec.tokens_per_seq)
                for i in self.cloud_layers if self.model.specs[i][0] != "attn"}

    def pad_lane_state(self, state, pad: int):
        return {i: {k: _pad_rows(t, pad) for k, t in st.items()} for i, st in state.items()}

    def init_edge_rows(self, rows: int, seq_len: int):
        """Row-batched dense edge-prefix caches of a pipelined lane: the
        robots' batch-1 edge caches become rows of these at admission, so a
        window of edge steps runs on the device inside the fused decode."""

        return self._init_caches(self.edge_layers, rows, seq_len)

    def pad_edge_rows(self, caches, pad: int):
        return {i: {k: _pad_rows(t, pad) for k, t in c.items()} for i, c in caches.items()}

    def merge_edge_rows(self, edge_rows, new_caches, row_idx):
        """Install batch-1 robot edge caches as rows of the lane's caches, in
        place: a full-row overwrite, so a recycled row keeps nothing of its
        previous occupant.  Rows at or beyond the lane's row count are
        dropped (the reference's ``mode="drop"``)."""

        for caches, ri in zip(new_caches, row_idx):
            for i, live in edge_rows.items():
                for k, t in live.items():
                    if ri < t.shape[0]:
                        t[ri].copy_(caches[i][k][0])
        return edge_rows

    def _stamp(self, side: str, op: str, t0: float) -> None:
        """One host leg's time into ``lane.edge_ms`` / ``lane.suffix_ms``
        (labelled by cut and op); no device sync is added."""

        self.obs.metrics.histogram(f"lane.{side}_ms", cut=self.cut_layer, op=op).observe(
            (clock() - t0) * 1e3)

    @torch.no_grad()
    def edge_prefill(self, tokens, extra: int):
        """Robot-side prompt prefill -> (cut activations [1,S,D], edge caches
        with ``extra`` decode slots).  (The reference binds ``extra`` in
        ``build_suffix_fns``, which compiles its entry points; the port
        compiles nothing.)"""

        t0 = clock() if self.obs is not None else 0.0
        m = self.model
        tokens = torch.as_tensor(tokens, device=m.device)
        x = m._embed_inputs({"tokens": tokens})
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        caches = self._init_caches(self.edge_layers, tokens.shape[0], x.shape[1] + extra)
        x = self._edge_blocks(x, caches, positions=positions)
        if self.obs is not None:
            self._stamp("edge", "prefill", t0)
        return x, caches

    @torch.no_grad()
    def edge_step(self, token: int, caches, length: int):
        """One robot-side ping-pong leg: embed the sampled token, run the
        edge prefix -> (cut activation [1,1,D], the caches, updated)."""

        t0 = clock() if self.obs is not None else 0.0
        tok = torch.tensor([[token]], dtype=torch.long, device=self.model.device)
        x = self._edge_blocks(self._embed_token(tok), caches, length=length)
        if self.obs is not None:
            self._stamp("edge", "step", t0)
        return x, caches

    @torch.no_grad()
    def suffix_prefill(self, x, layers, pt_new, row_idx, lens, caps):
        """Cloud-side prefill over a batch of shipped cut activations ``x``
        [n,S,D]: each new sequence's suffix K/V scattered into its pages
        (``pt_new`` [n, MAXP], ``lens`` [n]), its recurrent state into the rows
        ``row_idx`` (host ints; rows at or beyond the state's rows are
        padding, dropped) -> (layers, last-token logits [n, V])."""

        t0 = clock() if self.obs is not None else 0.0
        m = self.model
        n, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :]
        caches = self._init_caches(self.cloud_layers, n, s)
        x = x.to(m.dtype)
        row_idx = np.asarray(row_idx)
        for k, i in enumerate(self.cloud_layers):
            x = m._block_seq(i, x, positions, caches[i])
            live, new = layers[k], caches[i]
            if m.specs[i][0] == "attn":
                scatter_prompt_into_pool(live["kp"], new["k"], pt_new, lens)
                scatter_prompt_into_pool(live["vp"], new["v"], pt_new, lens)
            else:
                keep = np.flatnonzero(row_idx < next(iter(live.values())).shape[0])
                src = torch.as_tensor(keep, dtype=torch.long, device=m.device)
                dst = torch.as_tensor(row_idx[keep], dtype=torch.long, device=m.device)
                for name, t in live.items():
                    t.index_copy_(0, dst, new[name].index_select(0, src).to(t.dtype))
        x = rms_norm(x, m.final_norm.scale, self.cfg.norm_eps)
        logits = m._logits(x[:, -1:])[:, -1]
        if self.obs is not None:
            self._stamp("suffix", "prefill", t0)
        return layers, logits

    @torch.no_grad()
    def suffix_step(self, x, layers, page_table, lens, caps):
        """One batched cloud-suffix decode step over cut activations ``x``
        [B,1,D] (idle rows: zeros; their capacity 0 sends their writes to
        the trash page) -> (logits [B, V], layers)."""

        t0 = clock() if self.obs is not None else 0.0
        m = self.model
        x = x.to(m.dtype)
        for k, i in enumerate(self.cloud_layers):
            x = m._block_step(i, x, layers[k], lens, paged=(page_table, caps))
        x = rms_norm(x, m.final_norm.scale, self.cfg.norm_eps)
        logits = m._logits(x)[:, -1]
        if self.obs is not None:
            self._stamp("suffix", "step", t0)
        return logits, layers

    # ------------------------------------------------------------------
    # pipelined fleet decode (a window of split decode on the device)
    # ------------------------------------------------------------------

    def build_fleet_decode(self, cuts: Tuple[int, ...], n_steps: int, token_floor: int,
                           offloads: Optional[Tuple[Tuple[int, ...], ...]] = None):
        """One window of pipelined split decode over a fleet of lanes.

        ``cuts`` lists the active lanes' cut layers, ascending (a plain lane
        and an expert-offload lane may share a cut); ``offloads`` gives each
        lane's offloaded-expert layers, which run through the gather /
        scatter seam (the same ops, so tokens do not change).  The returned
        function runs ``n_steps`` iterations of (argmax -> embed -> each
        lane's edge prefix -> the shared tail -> logits) with no host sync:
        lanes join a progressively concatenated row batch at their cut, so
        each tail layer runs once over the combined rows (attention through
        the shared per-layer pools, concatenated page tables indexing one
        physical pool; recurrent layers over the joined lanes' concatenated
        state, written back to each lane).  The reference's ``lax.scan``
        with donated pools and lanes becomes a loop that updates them in
        place; the scheduler builds it for one round (``n_steps`` = its
        block), runs a window as rounds back to back, and replays each as
        one CUDA graph per ``(cuts, offloads, n_steps, rows per lane)``.

        Signature of the returned function::

            fn(pools, lanes, pts, caps) -> toks

        ``pools``: {model layer: {"kp", "vp"}} for the attention layers at
        or past the shallowest cut.  ``lanes``: per-lane dicts of float32
        ``logits`` [R_i, V] (read, then overwritten with the window's last),
        ``edge`` caches {layer: ...} [R_i, ...], ``state`` {layer: recurrent
        state} and int32 ``lens`` [R_i] (read only: the caller tracks the
        lengths); over ranks, where ``R_i`` is the rank's block of the
        lane's rows, ``rows`` (the lane's global rows, its block), which
        the lane's edge layers see as the active mesh's ``rows_layout``
        (the tail sees every joined lane's).  ``pts`` / ``caps``: per-lane
        page tables / capacities.  ``toks``: a per-lane tuple of [R_i,
        n_steps] tokens.
        """

        m, cfg = self.model, self.cfg
        specs, num_layers = m.specs, cfg.num_layers
        n_lanes = len(cuts)
        off_sets = tuple(frozenset(offloads[k]) if offloads else frozenset()
                         for k in range(n_lanes))
        first = cuts[0]

        @torch.no_grad()
        def fleet(pools, lanes, pts, caps):
            vdim = lanes[0]["logits"].shape[-1]
            floor = torch.arange(vdim, device=m.device) < token_floor
            logits = [lane["logits"] for lane in lanes]
            lens = [lane["lens"] for lane in lanes]
            toks_out = [[] for _ in range(n_lanes)]
            for _ in range(n_steps):
                xs = []
                for k, lane in enumerate(lanes):
                    ls = logits[k].masked_fill(floor, -1e9) if token_floor else logits[k]
                    tok = ls.argmax(dim=-1)
                    toks_out[k].append(tok)
                    with rows_scope((lane["rows"],) if "rows" in lane else None):
                        xs.append(self._edge_blocks(self._embed_token(tok[:, None]), lane["edge"],
                                                    length=lens[k], cut=cuts[k],
                                                    offload=off_sets[k]))
                # progressive tail: lane k joins at layer cuts[k]; offs slice
                # its rows back out
                x_cat = pt_cat = len_cat = cap_cat = None
                offs, joined = [], 0
                for layer in range(first, num_layers):
                    while joined < n_lanes and cuts[joined] == layer:
                        offs.append(0 if x_cat is None else x_cat.shape[0])
                        if x_cat is None:
                            x_cat, pt_cat = xs[joined], pts[joined]
                            len_cat, cap_cat = lens[joined], caps[joined]
                        else:
                            x_cat = torch.cat([x_cat, xs[joined]], 0)
                            pt_cat = torch.cat([pt_cat, pts[joined]], 0)
                            len_cat = torch.cat([len_cat, lens[joined]], 0)
                            cap_cat = torch.cat([cap_cat, caps[joined]], 0)
                        joined += 1
                    if specs[layer][0] == "attn":
                        x_cat = m._block_step(layer, x_cat, pools[layer], len_cat,
                                              paged=(pt_cat, cap_cat))
                    elif joined == 1:
                        x_cat = m._block_step(layer, x_cat, lanes[0]["state"][layer], len_cat)
                    else:
                        st = {name: torch.cat([lanes[k]["state"][layer][name]
                                               for k in range(joined)], 0)
                              for name in lanes[0]["state"][layer]}
                        x_cat = m._block_step(layer, x_cat, st, len_cat)
                        for k in range(joined):
                            r = lens[k].shape[0]
                            for name, t in lanes[k]["state"][layer].items():
                                t.copy_(st[name][offs[k]:offs[k] + r])
                while joined < n_lanes:
                    # an empty suffix (cut == num_layers): the edge output is
                    # the final hidden; the lane joins after the last layer
                    offs.append(0 if x_cat is None else x_cat.shape[0])
                    x_cat = xs[joined] if x_cat is None else torch.cat([x_cat, xs[joined]], 0)
                    joined += 1
                x_cat = rms_norm(x_cat, m.final_norm.scale, cfg.norm_eps)
                logits_cat = m._logits(x_cat)[:, 0].float()
                logits = [logits_cat[offs[k]:offs[k] + lens[k].shape[0]] for k in range(n_lanes)]
                lens = [n + 1 for n in lens]
            for k, lane in enumerate(lanes):
                lane["logits"].copy_(logits[k])
            return tuple(torch.stack(t, 1) for t in toks_out)

        return fleet

    # ------------------------------------------------------------------
    # channel telemetry
    # ------------------------------------------------------------------

    def modeled_net_ms(self, prompt_len: int, n_decode: int) -> Dict[str, float]:
        """Modeled channel cost of one split serving call: the prefill ship
        and the per-token ping-pong (the stem is always edge-side, so every
        call ships at least the embedded prompt); an expert-offload lane
        adds each offloaded block's gather / scatter legs (one round trip
        over the prompt, one a decode token)."""

        act_tok = self.cfg.d_model * 2.0  # bf16 activations
        out = interior_net_ms(self.channel, prompt_len * act_tok, act_tok, n_decode)
        if self.expert_offload:
            k = self.cfg.moe.num_experts_per_tok
            per_block = roundtrip_ms(
                self.channel, prompt_len * k * act_tok, prompt_len * act_tok
            ) + n_decode * roundtrip_ms(self.channel, k * act_tok, act_tok)
            out = dict(out)
            out["expert_ms"] = len(self.expert_offload) * per_block
            out["total_ms"] += out["expert_ms"]
        return out

    def record_chunk_bytes(self, prompt_len: int, n_decode: int) -> None:
        """One robot-chunk's modeled channel bytes into the per-leg
        ``channel.bytes_up`` / ``channel.bytes_down`` counters: the cut
        activation of every token up and each sampled token id down; each
        offloaded block adds an expert-gather leg (top-k hidden states up)
        and an expert-scatter leg (the mixture down).  No-op without an
        Observability handle."""

        if self.obs is None:
            return
        m = self.obs.metrics
        act_tok = self.cfg.d_model * 2.0
        tokens = prompt_len + n_decode
        m.counter("channel.bytes_up", leg="cut-activation").inc(int(tokens * act_tok))
        m.counter("channel.bytes_down", leg="cut-activation").inc(int(n_decode * TOKEN_ID_BYTES))
        if self.expert_offload:
            k = self.cfg.moe.num_experts_per_tok
            n_blocks = len(self.expert_offload)
            m.counter("channel.bytes_up", leg="expert-gather").inc(
                int(n_blocks * tokens * k * act_tok))
            m.counter("channel.bytes_down", leg="expert-scatter").inc(
                int(n_blocks * tokens * act_tok))


class PartitionedPolicy:
    """Drop-in ``CloudPolicy`` serving through a split model: the split
    prefill and the split decode chunk, replayed as one CUDA graph per
    ``(B, prompt_len)`` where the model allows graphs (``Model.graphs``:
    eagerly on a CPU model or a gloo group's, or through ``eager_chunk``).
    ``net_ms_log`` holds each call's modeled channel milliseconds (the
    planner's channel model, not a measurement)."""

    def __init__(self, executor: PartitionExecutor, tokenizer: EpisodeTokenizer,
                 chunk_len: int = 8, n_joints: int = 7):
        self.executor = executor
        self.model = executor.model
        self.tok = tokenizer
        self.chunk_len = chunk_len
        self.n_joints = n_joints
        self.n_steps = chunk_len * n_joints
        self.net_ms_log: List[float] = []
        self._graphs = {}  # (B, prompt_len) -> (static tokens, GraphedCall)

    def eager_chunk(self, tokens):
        """The chunk that ``chunk`` replays, run eagerly: the split prefill
        and decode -> (action tokens [B, n_steps], the next logits [B, 1, V])."""

        ex = self.executor
        logits, state = ex.split_prefill({"tokens": tokens}, extra=self.n_steps)
        toks, logits, _ = ex.split_decode_chunk(logits, state, self.n_steps,
                                                self.tok.action_base)
        return toks, logits

    def chunk(self, tokens):
        """tokens [B, S] on the model's device -> (action tokens, the next
        logits); where the model allows graphs a replay (its outputs hold
        until the next call)."""

        if not self.model.graphs:
            return self.eager_chunk(tokens)
        key = tuple(tokens.shape)
        entry = self._graphs.get(key)
        if entry is None:
            static = tokens.clone()
            entry = self._graphs[key] = (static,
                                         GraphedCall(owner_call(self, "eager_chunk", static)))
        static, call = entry
        static.copy_(tokens)
        return call()

    def chunk_tokens(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        obs = np.concatenate([self.tok.encode_state(qd), self.tok.encode_state(tau)], axis=1)
        toks = self.chunk(torch.as_tensor(obs, device=self.model.device))[0].cpu().numpy()
        self.net_ms_log.append(self.executor.modeled_net_ms(obs.shape[1], self.n_steps)["total_ms"])
        self.executor.record_chunk_bytes(obs.shape[1], self.n_steps)
        return toks

    def __call__(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        toks = self.chunk_tokens(qd, tau)
        return self.tok.decode_action(toks).reshape(-1, self.chunk_len, self.n_joints)
