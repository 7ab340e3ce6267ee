"""The port's model (counterpart of ``repro/models/model.py``) for
attention-only stacks such as openvla-7b.

Where the reference stacks parameters over repeats of a repeating unit and
scans, the port keeps an ``nn.ModuleList`` of per-layer blocks and loops.
The port's layers are all alike, so the reference's unit is one layer and
``checkpoint/bridge.py`` maps layer ``i`` to ``unit/0/...[i]``.  Caches hold every layer in one
tensor with a leading layer axis and are updated in place:

  dense  {"k", "v": [L, B, S, KV, Dh], "len": int or [B] int32}
  paged  {"kp", "vp": [L, P+1, page, KV, Dh] (last page is trash),
          "len": [B] int32, "pt": [B, MAXP] int32, "cap": [B] int32}

Entry points: ``prefill``, ``decode_step``, ``decode_chunk``,
``init_cache``, ``init_paged_cache``, ``cache_to_paged``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    MLP,
    Dense,
    Embedding,
    Norm,
    dense,
    embed_lookup,
    mlp,
    rms_norm,
)
from repro_torch.runtime.kv_cache import PagedSpec, scatter_prompt_into_pool


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.norm1, self.attn, self.norm2, self.mlp):
            m.init(generator)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """Build ``cfg`` on ``device`` with weights drawn from ``generator``
        (default: a generator on ``device`` seeded with 0)."""

        super().__init__()
        if cfg.d_ff <= 0:
            raise ValueError("the port's Model serves attention + MLP stacks")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        dt, dev = self.dtype, self.device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, dev)
        # stub frontend projector (precomputed patch embeddings -> d_model)
        self.mod_proj = Dense(cfg.d_model, cfg.d_model, dt, dev)
        self.layers = nn.ModuleList(Block(cfg, dt, dev) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, dt, dev)
        vpad = self.embed.table.shape[0]
        self.lm_head = Dense(cfg.d_model, vpad, dt, dev)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.embed, self.mod_proj, *self.layers, self.final_norm, self.lm_head):
            m.init(generator)

    # ------------------------------------------------------------------

    def _ffn(self, blk: Block, x):
        h = rms_norm(x, blk.norm2.scale, self.cfg.norm_eps)
        return x + mlp(h, blk.mlp)

    def _embed_inputs(self, batch):
        x = embed_lookup(batch["tokens"], self.embed.table).to(self.dtype)
        if "frontend" in batch:
            fe = dense(batch["frontend"].to(self.dtype), self.mod_proj.w)
            x = torch.cat([fe, x], dim=1)
        return x

    def _logits(self, x):
        cfg = self.cfg
        logits = dense(x, self.lm_head.w)
        vpad = logits.shape[-1]
        if vpad != cfg.vocab_size:
            # parity: ids >= vocab in the padded head get -1e9 (model.py:500-511)
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
        positions = torch.arange(s, device=x.device)[None, :]
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.norm1.scale, self.cfg.norm_eps)
            out, k, v = attn.attention_forward(
                h, blk.attn, self.cfg, positions, self.cfg.sliding_window
            )
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            x = self._ffn(blk, x + out)
        cache["len"] = s
        x = rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token, cache):
        """token [B,1] -> (logits [B,1,V], cache with ``len`` advanced).

        A paged cache (``"pt"`` present) reads and writes the shared page
        pool; a dense cache its per-row slabs.  Caches update in place.
        """

        cfg = self.cfg
        x = embed_lookup(token, self.embed.table).to(self.dtype)
        paged = "pt" in cache
        window = cfg.sliding_window
        for i, blk in enumerate(self.layers):
            h = rms_norm(x, blk.norm1.scale, cfg.norm_eps)
            if paged:
                out = attn.attention_decode_step_paged(
                    h, blk.attn, cfg, cache["kp"][i], cache["vp"][i],
                    cache["pt"], cache["len"], cache["cap"], window,
                )
            else:
                out = attn.attention_decode_step(
                    h, blk.attn, cfg, cache["k"][i], cache["v"][i], cache["len"], window,
                )
            x = self._ffn(blk, x + out)
        x = rms_norm(x, self.final_norm.scale, cfg.norm_eps)
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

    def init_cache(self, batch: int, seq: int):
        """Dense decode cache of ``seq`` slots per row."""

        shape = (self.cfg.num_layers, batch, seq) + self._kv_shape()
        z = dict(dtype=self.dtype, device=self.device)
        return {"k": torch.zeros(shape, **z), "v": torch.zeros(shape, **z), "len": 0}

    def init_paged_cache(self, batch: int, spec: PagedSpec):
        """Page pools of ``spec.num_pages + 1`` pages per layer (the extra page
        absorbs writes of idle and over-capacity rows); the page table and
        per-row capacity are shared by every layer; ``cap == 0`` rows are
        inactive."""

        shape = (self.cfg.num_layers, spec.num_pages + 1, spec.page_size) + self._kv_shape()
        z = dict(dtype=self.dtype, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        return {
            "kp": torch.zeros(shape, **z),
            "vp": torch.zeros(shape, **z),
            "len": torch.zeros((batch,), **i32),
            "pt": torch.zeros((batch, spec.max_pages_per_seq), **i32),
            "cap": torch.zeros((batch,), **i32),
        }

    @torch.no_grad()
    def cache_to_paged(self, cache, paged, page_table, caps, lens=None):
        """Scatter a dense prefilled ``cache`` into the ``paged`` pools (in
        place) and return the paged cache that drives decode.

        ``page_table`` [B, MAXP] / ``caps`` [B] come from the page
        allocator; ``lens`` defaults to the prefill length for every row.
        """

        pt = torch.as_tensor(page_table, dtype=torch.int32, device=self.device)
        b = pt.shape[0]
        if lens is None:
            lens = torch.full((b,), int(cache["len"]), dtype=torch.int32, device=self.device)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        for i in range(self.cfg.num_layers):
            scatter_prompt_into_pool(paged["kp"][i], cache["k"][i], pt, lens)
            scatter_prompt_into_pool(paged["vp"][i], cache["v"][i], pt, lens)
        return {
            "kp": paged["kp"],
            "vp": paged["vp"],
            "len": lens,
            "pt": pt,
            "cap": torch.as_tensor(caps, dtype=torch.int32, device=self.device),
        }
