"""The port's model (counterpart of ``repro/models/model.py``) for stacks
whose layers mix with attention or Mamba and whose FFN is an MLP (gated or
plain) or a mixture of experts: the dense attention stacks (openvla-7b,
gemma, gemma2 with local and global layers alternating, h2o-danube3,
starcoder2, phi-3-vision), the MoE stacks (qwen3-moe, phi3.5-moe; the
dispatch is ``Model(moe_impl=...)``) and the Jamba hybrid.

Where the reference stacks parameters over repeats of a repeating unit and
scans, the port keeps an ``nn.ModuleList`` of per-layer blocks and loops;
``checkpoint/bridge.py`` maps layer ``i`` to ``unit/{i % period}/...[i //
period]``, the unit being ``unit_period(layer_specs(cfg))`` layers long.
Caches hold each kind of layer state in one tensor with a leading axis over
the layers of that kind (K/V over the attention layers, ``h``/``conv`` over
the Mamba layers, which stacks without Mamba layers leave out) and are
updated in place:

  dense  {"k", "v": [La, B, S, KV, Dh], "len": int or [B] int32,
          "h": [Lm, B, H, P, N] f32, "conv": [Lm, B, K-1, d_in]}
         (``windowed_cache``: "k", "v" are lists of per-layer [B, S_l, KV,
         Dh] rings, S_l = min(S, the layer's window))
  paged  {"kp", "vp": [La, P+1, page, KV, Dh] (last page is trash),
          "len": [B] int32, "pt": [B, MAXP] int32, "cap": [B] int32,
          "h", "conv" as in the dense cache}

Entry points: ``prefill``, ``decode_step``, ``decode_chunk``, ``forward``,
``init_cache``, ``init_paged_cache``, ``cache_to_paged``,
``merge_prefill_into_paged``.  Each runs the per-layer block functions
(``_block_seq`` / ``_block_step``, each a mixer half and an FFN half, as
the reference's), over per-layer views of these caches
(``layer_cache``); the partition executor runs the same functions over its
own per-layer caches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    MLP,
    Dense,
    Embedding,
    Norm,
    dense,
    embed_lookup,
    embed_scale,
    mlp,
    rms_norm,
    softcap,
)
from repro_torch.runtime.kv_cache import PagedSpec, scatter_prompt_into_pool


# Model(moe_impl=...): the MoE layers' dispatch
MOE_IMPLS = {"dense": moe_lib.moe_forward, "capacity": moe_lib.moe_forward_capacity}


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


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: Tuple[str, bool, bool], dtype, device):
        super().__init__()
        self.spec = spec
        blk, is_moe, _ = spec
        self.norm1 = Norm(cfg.d_model, dtype, device)
        if blk == "attn":
            self.attn = attn.Attention(cfg, dtype, device)
        elif blk == "mamba":
            self.mamba = ssm_lib.Mamba(cfg, dtype, device)
        else:
            raise ValueError(f"the port has no {blk!r} block")
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
                 moe_impl: str = "dense"):
        """Build ``cfg`` on ``device`` with weights drawn from ``generator``
        (default: a generator on ``device`` seeded with 0).

        ``windowed_cache``: dense decode caches are rings sized to each
        attention layer's window (the reference's ``Model(windowed_cache=
        True)``); a ring's writes wrap and its decode masks no window.  The
        paged caches are unchanged.

        ``moe_impl``: the MoE layers' dispatch, ``"dense"`` (every expert on
        every token, ``moe_lib.moe_forward``) or ``"capacity"`` (top-k
        tokens gathered to each expert's ``cap`` slots, overflow dropped,
        ``moe_lib.moe_forward_capacity``), as the reference's switch."""

        super().__init__()
        if cfg.d_ff <= 0:
            raise ValueError("the port's Model serves stacks with an MLP or MoE FFN")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {moe_impl!r}: one of {sorted(MOE_IMPLS)}")
        self.cfg = cfg
        self.windowed_cache = windowed_cache
        self.moe_impl = moe_impl
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.specs = layer_specs(cfg)
        self.period = unit_period(self.specs)
        # layer i's index among the layers of its kind (its row in the caches)
        kinds = [spec[0] for spec in self.specs]
        self.n_attn, self.n_mamba = kinds.count("attn"), kinds.count("mamba")
        self.slot = [kinds[:i].count(kind) for i, kind in enumerate(kinds)]
        dt, dev = self.dtype, self.device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, dev)
        if cfg.modality in ("vision", "audio"):
            # stub frontend projector (precomputed patch embeddings -> d_model)
            self.mod_proj = Dense(cfg.d_model, cfg.d_model, dt, dev)
        self.layers = nn.ModuleList(Block(cfg, spec, dt, dev) for spec in self.specs)
        self.final_norm = Norm(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, self.embed.table.shape[0], dt, dev)
        self.embed_scale = embed_scale(cfg.d_model) if cfg.scale_embeddings else 0.0
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, generator: torch.Generator) -> None:
        front = [self.mod_proj] if hasattr(self, "mod_proj") else []
        head = [self.lm_head] if hasattr(self, "lm_head") else []
        for m in (self.embed, *front, *self.layers, self.final_norm, *head):
            m.init(generator)

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
        ``{"k", "v"}`` dense slabs, ``{"kp", "vp"}`` pools, or ``{"h",
        "conv"}`` Mamba state.  The model's caches stack each kind over the
        layers of that kind (``self.slot``); the split executor keys its own
        per-layer caches by model layer; this is the one map between them."""

        j = self.slot[i]
        if self.specs[i][0] == "mamba":
            return {"h": cache["h"][j], "conv": cache["conv"][j]}
        if "kp" in cache:
            return {"kp": cache["kp"][j], "vp": cache["vp"][j]}
        return {"k": cache["k"][j], "v": cache["v"][j]}

    def _block_mix_seq(self, i: int, x, positions, cache=None):
        """Layer ``i``'s mixer half over a sequence (norm1, attention or
        Mamba, residual), writing the prompt's K/V or the Mamba state into
        the per-layer ``cache`` (if given) -> x."""

        blk = self.layers[i]
        h = rms_norm(x, blk.norm1.scale, self.cfg.norm_eps)
        if blk.spec[0] == "attn":
            s = x.shape[1]
            out, k, v = attn.attention_forward(
                h, blk.attn, self.cfg, positions, self._window_for(blk.spec, s)
            )
            if cache is not None:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
        else:
            out, state = ssm_lib.mamba_forward(h, blk.mamba, self.cfg)
            if cache is not None:
                cache["h"].copy_(state["h"])
                cache["conv"].copy_(state["conv"])
        return x + out

    def _block_ffn(self, i: int, x):
        """Layer ``i``'s FFN half: norm2, MLP or MoE, residual -> x."""

        blk = self.layers[i]
        h = rms_norm(x, blk.norm2.scale, self.cfg.norm_eps)
        if blk.spec[1]:
            return x + MOE_IMPLS[self.moe_impl](h, blk.moe, self.cfg)[0]
        return x + mlp(h, blk.mlp, self.cfg.mlp_activation)

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

    def _block_seq(self, i: int, x, positions, cache=None):
        return self._block_ffn(i, self._block_mix_seq(i, x, positions, cache))

    def _block_mix_step(self, i: int, x, cache, length, paged=None):
        """Layer ``i``'s mixer half for one token, x [B,1,D], against its
        per-layer ``cache`` (updated in place) at ``length`` (an int or a
        [B] tensor).  ``paged``: the ``(page_table, cap)`` pair of a paged
        cache (``{"kp", "vp"}`` pools) -> x."""

        blk = self.layers[i]
        cfg = self.cfg
        h = rms_norm(x, blk.norm1.scale, cfg.norm_eps)
        if blk.spec[0] == "mamba":
            out, state = ssm_lib.mamba_decode_step(h, blk.mamba, cfg, cache)
            cache["h"].copy_(state["h"])
            cache["conv"].copy_(state["conv"])
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
        return x + out

    def _block_step(self, i: int, x, cache, length, paged=None):
        return self._block_ffn(i, self._block_mix_step(i, x, cache, length, paged))

    def _init_block_cache(self, i: int, batch: int, seq: int):
        """A zero per-layer dense cache of layer ``i``: ``{"k", "v"}``
        [B, seq, KV, Dh] (a ring of ``min(seq, window)`` slots with
        ``windowed_cache``) or Mamba ``{"h", "conv"}``."""

        spec = self.specs[i]
        if spec[0] == "mamba":
            return ssm_lib.init_mamba_state(self.cfg, batch, self.dtype, self.device)
        n = seq
        if self.windowed_cache:
            n = min(seq, self._window_for(spec, seq) or seq)
        z = dict(dtype=self.dtype, device=self.device)
        return {"k": torch.zeros((batch, n) + self._kv_shape(), **z),
                "v": torch.zeros((batch, n) + self._kv_shape(), **z)}

    @staticmethod
    def _total_seq(batch) -> int:
        s = batch["tokens"].shape[1]
        if "frontend" in batch:
            s += batch["frontend"].shape[1]
        return s

    def _embed_inputs(self, batch):
        x = embed_lookup(batch["tokens"], self.embed.table, self.embed_scale).to(self.dtype)
        if "frontend" in batch:
            fe = dense(batch["frontend"].to(self.dtype), self.mod_proj.w)
            x = torch.cat([fe, x], dim=1)
        return x

    def _logits(self, x):
        cfg = self.cfg
        if cfg.tie_embeddings:  # x . table^T (layers.py:139-150)
            logits = x @ self.embed.table.to(x.dtype).T
        else:
            logits = dense(x, self.lm_head.w)
        # parity: the softcap, then ids >= vocab in the padded head get -1e9
        # (model.py:500-511)
        logits = softcap(logits, cfg.final_logit_softcap)
        vpad = logits.shape[-1]
        if vpad != cfg.vocab_size:
            pad = torch.arange(vpad, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        return logits

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch, extra: int = 0):
        """Run the prompt, fill a dense cache -> (last-token logits [B,1,V], cache).

        ``batch``: ``{"tokens": [B, S] int}`` (+ ``"frontend"`` [B, P, D]
        stub embeddings).  ``extra`` reserves cache slots for decode.
        """

        x = self._embed_inputs(batch)
        b, s = x.shape[:2]
        cache = self.init_cache(b, s + extra)
        if self.windowed_cache and any(s > ring.shape[1] for ring in cache["k"]):
            raise ValueError(f"a {s}-token prompt is longer than a ring cache")
        positions = torch.arange(s, device=x.device)[None, :]
        for i in range(len(self.layers)):
            x = self._block_seq(i, x, positions, self.layer_cache(cache, i))
        cache["len"] = s
        x = rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def forward(self, batch):
        """Full-sequence forward without a cache -> the final-normed hidden
        [B, S, D] (``_logits`` of it gives the logits): the parity surface of
        the split executor."""

        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for i in range(len(self.layers)):
            x = self._block_seq(i, x, positions)
        return rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)

    @torch.no_grad()
    def decode_step(self, token, cache):
        """token [B,1] -> (logits [B,1,V], cache with ``len`` advanced).

        A paged cache (``"pt"`` present) reads and writes the shared page
        pool; a dense cache its per-row slabs.  Mamba state is dense in both.
        Caches update in place.
        """

        x = embed_lookup(token, self.embed.table, self.embed_scale).to(self.dtype)
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
        return (self.cfg.num_kv_heads, self.cfg.resolved_head_dim)

    def _mamba_state(self, batch: int):
        """Zero Mamba state of every Mamba layer ({} for stacks without)."""

        if not self.n_mamba:
            return {}
        one = ssm_lib.init_mamba_state(self.cfg, batch, self.dtype, self.device)
        return {k: v.expand((self.n_mamba,) + v.shape).clone() for k, v in one.items()}

    def init_cache(self, batch: int, seq: int):
        """Dense decode cache of ``seq`` slots per row (``windowed_cache``:
        ``min(seq, window)`` slots for each attention layer with a window,
        as model.py:844-845)."""

        z = dict(dtype=self.dtype, device=self.device)
        if self.windowed_cache:
            sizes = [min(seq, self._window_for(spec, seq) or seq)
                     for spec in self.specs if spec[0] == "attn"]
            k, v = ([torch.zeros((batch, n) + self._kv_shape(), **z) for n in sizes]
                    for _ in range(2))
        else:
            shape = (self.n_attn, batch, seq) + self._kv_shape()
            k, v = torch.zeros(shape, **z), torch.zeros(shape, **z)
        return {"k": k, "v": v, "len": 0, **self._mamba_state(batch)}

    def init_paged_cache(self, batch: int, spec: PagedSpec):
        """Page pools of ``spec.num_pages + 1`` pages per layer (the extra page
        absorbs writes of idle and over-capacity rows); the page table and
        per-row capacity are shared by every layer; ``cap == 0`` rows are
        inactive.  Mamba state is O(1) a row and stays dense."""

        shape = (self.n_attn, spec.num_pages + 1, spec.page_size) + self._kv_shape()
        z = dict(dtype=self.dtype, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        return {
            "kp": torch.zeros(shape, **z),
            "vp": torch.zeros(shape, **z),
            "len": torch.zeros((batch,), **i32),
            "pt": torch.zeros((batch, spec.max_pages_per_seq), **i32),
            "cap": torch.zeros((batch,), **i32),
            **self._mamba_state(batch),
        }

    @torch.no_grad()
    def cache_to_paged(self, cache, paged, page_table, caps, lens=None):
        """Scatter a dense prefilled ``cache`` into the ``paged`` pools (in
        place) and return the paged cache that drives decode.

        ``page_table`` [B, MAXP] / ``caps`` [B] come from the page
        allocator; ``lens`` defaults to the prefill length for every row.
        The Mamba state of ``cache`` carries over as it is.
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
            "kp": paged["kp"],
            "vp": paged["vp"],
            "len": lens,
            "pt": pt,
            "cap": torch.as_tensor(caps, dtype=torch.int32, device=self.device),
        }
        if self.n_mamba:
            out["h"], out["conv"] = cache["h"], cache["conv"]
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
        Mamba ``h`` / ``conv`` state are overwritten.
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
        if self.n_mamba:
            for name in ("h", "conv"):  # [Lm, B, ...]: axis 1 is the row
                live = paged[name]
                live.index_copy_(1, dst, cache[name].index_select(1, src).to(live.dtype))
        return paged
