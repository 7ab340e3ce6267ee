"""One rank of the port's tensor-parallel runs, for
``tests/test_torch_model_axis.py``.  Imports torch and the port only.

    GLOO_SOCKET_IFNAME=lo PYTHONPATH=src \\
        python tests/torch_model_axis_rank.py RANK WORLD STORE PARAMS.npz OUT_DIR [PART]

Joins a gloo group of ``WORLD`` CPU ranks over the file store ``STORE``,
runs the cases of its world and writes ``OUT_DIR/rank<RANK>.npz``.  PART
``dense`` (the default; ``tests/test_torch_model_axis.py``):

* world 2: (a) the layers of a f32 openvla-smoke rank model built by
  ``Model.init`` (its parameter blocks, the MLP, prefill attention, a
  paged decode step, ``embed_lookup`` and the logits on ``layer_inputs``),
  then of a f32 jamba-smoke rank model built so (its blocks, the MoE layer
  under both dispatches, a Mamba prefill and a Mamba step from a given
  state on ``hybrid_inputs``), and the parameter blocks of qwen3-moe-smoke
  and phi3.5-moe-smoke built so; the engine's ``tp42``, ``gm42``,
  ``jb42`` and ``pc42`` scenarios and the rapid fleet (``TP_FLEET``) over
  a rank mesh, on the weights in ``PARAMS.npz`` (the reference's layout,
  ``params/<arch>/<key>``, which ``tests/torch_sharded_ref.py
  --model-axis --params`` runs on too); on ``jb42``'s model the
  collectives of its engine run, and the first prompt's logits with and
  without the Mamba ``out_proj`` and the MoE all-reduces (``controls``);
* world 4: the ``sc24`` and ``qm24`` scenarios.

PART ``xlstm_encdec`` (``tests/test_torch_model_axis_xlstm_encdec.py``):

* world 2: (a) the parameter blocks of a f32 xlstm-smoke and a
  seamless-smoke rank model built by ``Model.init``, and their layers on
  ``xlstm_inputs`` / ``encdec_inputs``: an mLSTM block chunked and
  stepped, an sLSTM block over a prompt and stepped, each from the rank's
  block of a given state, the encoder's attention, the cross-attention
  over a prompt (its K/V), cached and uncached, each case's collectives;
  the engine's ``xl42`` scenario (``XLSTM_SCENARIOS``) with its
  collectives, and the first prompt's logits with and without the sLSTM's
  h all-gather; seamless-smoke's ``prefill`` + ``decode_chunk`` in the
  four ``ENCDEC_MODES`` (``ed42``: logits, tokens, collectives), and the
  prefill's logits without the cross-attention's ``wo`` all-reduce;
* world 4: the blocks of xlstm-wide and seamless-smoke, the ``xw24``
  scenario and ``ed24``'s four modes.

PART ``split`` (``tests/test_torch_model_axis_split.py``):

* both worlds: the ``SPLIT_SCENARIOS`` of their model axis (the engine with
  split lanes over a rank mesh: results, tokens, every reservation, cloud
  and lane, the first lane prefill's logits, the lanes' buffers after the
  drain), the executor cases (``EXEC_CASES``: ``split_prefill`` and
  ``split_decode_step``, and the suffix path over the rank's pools and lane
  state, with their shapes), one ``PartitionedPolicy`` chunk
  (``POLICY_CASE``), the collectives of a ping-pong token and of a fused
  window token over 1 and 2 lanes, and the channel's figures of a rank's
  executor;
* world 2 also: the rapid fleet with split robots (``SPLIT_FLEET``), the
  split decode step's logits with the edge embedding's all-reduce skipped
  (the control), and ``dist.BYTES`` after a prefill and a decode token of
  openvla-, jamba-, xlstm- and seamless-smoke.
"""

import json

import sys

import numpy as np
import torch

from repro_torch.checkpoint.bridge import load_reference_params
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.serve import serve_fleet
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import embed_lookup, mlp
from repro_torch.models import layers as layers_lib
from repro_torch.models.model import Model
from repro_torch.obs import Observability
from repro_torch.partition import PartitionExecutor, PartitionedPolicy
from repro_torch.partition import executor as executor_lib
from repro_torch.runtime import scheduler as sched_lib
from repro_torch.runtime.kv_cache import PagedSpec, scatter_prompt_into_pool
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler
from torch_model_axis_cases import (AXIS_STACKS, ENCDEC_MESHES, ENCDEC_MODES, ENCDEC_PLAN,
                                    ENGINE_KW, EXEC_CASES, EXEC_PLAN, POLICY_CASE, SMOKE_LAYERS,
                                    SPLIT_FLEET, SPLIT_SCENARIOS, TP_FLEET, TP_SCENARIOS,
                                    XLSTM_SCENARIOS, encdec_batch, encdec_mode, encdec_pages,
                                    exec_inputs, fleet_record, lane_cut, obs_pair, split_key)

F32 = dict(dtype="float32")
# the paged step's plan: rows, page size, pages a row; its row lengths
PAGED = dict(b=3, page=8, maxp=4)
PAGED_LENS = (0, 5, 17)
# the stacks whose rank models (a) builds by ``Model.init``: the first
# runs the attention, MLP and vocab cases, the second the MoE and Mamba
# ones; the MoE stacks only give their parameter blocks
INIT_ARCHS = ("openvla-7b", "jamba-1.5-large-398b", "qwen3-moe-235b-a22b",
              "phi3.5-moe-42b-a6.6b")
# a record's axis of the rank's block (Mamba heads of ``h``, channels of
# ``conv``; KV heads of the attention's K/V and pool; mLSTM heads of its
# state; sLSTM units of c, n and m, whose h is whole; the cross K/V's heads)
BLOCK_AXIS = {"a/prefill_k": 2, "a/prefill_v": 2, "a/paged_kp": 2,
              "a/mamba_prefill_h": 1, "a/mamba_prefill_conv": 2,
              "a/mamba_step_h": 1, "a/mamba_step_conv": 2,
              **{f"a/{case}_{n}": 1 for case in ("mlstm_chunk", "mlstm_step")
                 for n in ("C", "n", "m")},
              **{f"a/{case}_{n}": 1 for case in ("slstm_prefill", "slstm_step")
                 for n in ("c", "n", "m")},
              "a/cross_k": 2, "a/cross_v": 2}
# the xLSTM and enc-dec stacks whose rank models (a) builds by
# ``Model.init``, by world
XE_INIT = {2: ("xlstm-125m", "seamless-m4t-medium"), 4: ("xlstm-wide", "seamless-m4t-medium")}
# the sLSTM prompt's length (one all-gather a token)
SLSTM_PROMPT = 9


def layer_inputs(cfg):
    """Case (a)'s numpy inputs (seeded): the MLP's and prefill's x, the
    paged step's x, dense K/V, page table and lengths, the embedding's
    token ids (every vocab block) and the logits' x."""

    rng = np.random.default_rng(11)
    b, page, maxp = PAGED["b"], PAGED["page"], PAGED["maxp"]
    hd, kv, d = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.d_model
    return {
        "mlp_x": rng.normal(0, 1, (2, 5, d)).astype(np.float32),
        "attn_x": rng.normal(0, 1, (2, 14, d)).astype(np.float32),
        "step_x": rng.normal(0, 1, (b, 1, d)).astype(np.float32),
        "ck": rng.normal(0, 1, (b, maxp * page, kv, hd)).astype(np.float32),
        "cv": rng.normal(0, 1, (b, maxp * page, kv, hd)).astype(np.float32),
        "table": rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32),
        "lens": np.asarray(PAGED_LENS, np.int32),
        "tokens": rng.integers(0, cfg.vocab_size, (2, 9)),
        "logits_x": rng.normal(0, 1, (2, 1, d)).astype(np.float32),
    }


def smoke(arch):
    return get_smoke_config(arch).replace(num_layers=SMOKE_LAYERS, **F32)


def hybrid_inputs(cfg):
    """Case (a)'s numpy inputs for jamba-smoke (seeded): the MoE layer's x,
    the Mamba prefill's x, the Mamba step's x and the state it starts
    from (``h`` [B, H, P, N], ``conv`` [B, K-1, d_in])."""

    rng = np.random.default_rng(12)
    d, s = cfg.d_model, cfg.ssm
    d_in, nh, n = s.expand * d, s.expand * d // 64, s.state_dim
    return {
        "moe_x": rng.normal(0, 1, (2, 5, d)).astype(np.float32),
        "mamba_x": rng.normal(0, 1, (2, 14, d)).astype(np.float32),
        "step_x": rng.normal(0, 1, (3, 1, d)).astype(np.float32),
        "h": rng.normal(0, 1, (3, nh, 64, n)).astype(np.float32),
        "conv": rng.normal(0, 1, (3, s.conv_width - 1, d_in)).astype(np.float32),
    }


def axis_smoke(key):
    """The f32 smoke config of ``AXIS_STACKS[key]`` at ``SMOKE_LAYERS``."""

    arch, kw = AXIS_STACKS[key]
    return get_smoke_config(arch).replace(num_layers=SMOKE_LAYERS, **F32, **kw)


def xlstm_inputs(cfg):
    """Case (a)'s numpy inputs for xlstm-smoke (seeded): the mLSTM block's
    prompt and step x and the state both start from (C [B, H, Dh, Dh], n
    [B, H, Dh], m [B, H]); the sLSTM block's prompt and step x and its
    state (c, n, h, m [B, D])."""

    rng = np.random.default_rng(14)
    d = cfg.d_model
    d_in, nh, dh = xlstm_lib.mlstm_dims(cfg)
    b = 2
    return {
        "mlstm_x": rng.normal(0, 1, (b, 16, d)).astype(np.float32),
        "mlstm_step_x": rng.normal(0, 1, (b, 1, d)).astype(np.float32),
        "mC": rng.normal(0, 0.5, (b, nh, dh, dh)).astype(np.float32),
        "mn": rng.normal(0, 0.5, (b, nh, dh)).astype(np.float32),
        "mm": rng.normal(0, 1, (b, nh)).astype(np.float32),
        "slstm_x": rng.normal(0, 1, (b, SLSTM_PROMPT, d)).astype(np.float32),
        "slstm_step_x": rng.normal(0, 1, (b, 1, d)).astype(np.float32),
        "sc": rng.normal(0, 0.5, (b, d)).astype(np.float32),
        "sn": np.abs(rng.normal(1, 0.5, (b, d))).astype(np.float32),
        "sh": rng.normal(0, 0.5, (b, d)).astype(np.float32),
        "sm": rng.normal(0, 1, (b, d)).astype(np.float32),
    }


def encdec_inputs(cfg):
    """Case (a)'s numpy inputs for seamless-smoke (seeded): the encoder
    attention's x, the cross-attention's prompt x, a token's x, the
    encoder's output and a layer's cached K/V [B, S_enc, KV, Dh]."""

    rng = np.random.default_rng(15)
    d, hd, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads
    frames = ENCDEC_PLAN["frames"]
    return {
        "enc_x": rng.normal(0, 1, (2, frames, d)).astype(np.float32),
        "cross_x": rng.normal(0, 1, (2, 14, d)).astype(np.float32),
        "token_x": rng.normal(0, 1, (2, 1, d)).astype(np.float32),
        "enc_out": rng.normal(0, 1, (2, frames, d)).astype(np.float32),
        "xk": rng.normal(0, 1, (2, frames, kv, hd)).astype(np.float32),
        "xv": rng.normal(0, 1, (2, frames, kv, hd)).astype(np.float32),
    }


def block(a, axis, rank, world):
    """Rank ``rank``'s block of ``a`` along ``axis``, of ``world``."""

    n = a.shape[axis] // world
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


def calls():
    return np.asarray([dist.CALLS["all_reduce"], dist.CALLS["all_gather"]])


def rank_kv(model, a):
    """The KV heads of a dense [B, S, KV, Dh] array that this rank's pool
    holds (``Model.kv_heads`` of them)."""

    blk = model.layers[0].attn
    if blk.kv_cols is not None:
        j = blk.kv_cols.start // model.cfg.resolved_head_dim
        return a[:, :, j:j + 1]
    n = model.kv_heads
    r = model.group.rank
    return a[:, :, r * n:(r + 1) * n]


@torch.no_grad()
def layers_case(group, out):
    """(a) on a rank of openvla-smoke built by ``Model.init``."""

    for arch in INIT_ARCHS:
        for name, p in Model(smoke(arch), device="cpu", group=group).named_parameters():
            out[f"a/param/{arch}/{name}"] = p.numpy()
    cfg = smoke("openvla-7b")
    model = Model(cfg, device="cpu", group=group)
    inp = layer_inputs(cfg)
    blk = model.layers[0]
    out["a/mlp"] = mlp(torch.as_tensor(inp["mlp_x"]), blk.mlp, cfg.mlp_activation).numpy()
    s = inp["attn_x"].shape[1]
    o, k, v = attn.attention_forward(torch.as_tensor(inp["attn_x"]), blk.attn, cfg,
                                     torch.arange(s)[None], 0)
    out["a/prefill"], out["a/prefill_k"], out["a/prefill_v"] = o.numpy(), k.numpy(), v.numpy()

    b, page, maxp = PAGED["b"], PAGED["page"], PAGED["maxp"]
    hd = cfg.resolved_head_dim
    kp = torch.zeros((b * maxp + 1, page, model.kv_heads, hd))
    vp = torch.zeros_like(kp)
    table = torch.as_tensor(inp["table"])
    full = torch.full((b,), maxp * page, dtype=torch.int32)
    scatter_prompt_into_pool(kp, torch.as_tensor(rank_kv(model, inp["ck"])), table, full)
    scatter_prompt_into_pool(vp, torch.as_tensor(rank_kv(model, inp["cv"])), table, full)
    out["a/paged"] = attn.attention_decode_step_paged(
        torch.as_tensor(inp["step_x"]), blk.attn, cfg, kp, vp, table,
        torch.as_tensor(inp["lens"]), full, 0).numpy()
    out["a/paged_kp"] = kp.numpy()

    toks = torch.as_tensor(inp["tokens"])
    for scale in (0.0, 16.0):
        x = embed_lookup(toks, model.embed.table, scale, model.embed.tp)
        out[f"a/embed_{int(scale)}"] = x.float().numpy()
    out["a/logits"] = model._logits(torch.as_tensor(inp["logits_x"])).numpy()
    out["a/collectives"] = calls()


@torch.no_grad()
def hybrid_layers_case(group, out):
    """(a) on a rank of jamba-smoke built by ``Model.init``: layer 1's MoE
    under both dispatches, layer 0's Mamba prefill and a step from the
    rank's block of a given state; each case's collectives."""

    cfg = smoke("jamba-1.5-large-398b")
    model = Model(cfg, device="cpu", group=group)
    inp = hybrid_inputs(cfg)
    moe, mamba = model.layers[1].moe, model.layers[0].mamba
    x = torch.as_tensor(inp["moe_x"])
    for case, fn in (("moe", moe_lib.moe_forward), ("moe_capacity", moe_lib.moe_forward_capacity)):
        c0 = calls()
        o, aux = fn(x, moe, cfg)
        out[f"a/{case}"], out[f"a/{case}_aux"] = o.numpy(), aux.numpy()
        out[f"a/calls/{case}"] = calls() - c0
    c0 = calls()
    o, st = ssm_lib.mamba_forward(torch.as_tensor(inp["mamba_x"]), mamba, cfg)
    out["a/mamba_prefill"] = o.numpy()
    out["a/mamba_prefill_h"], out["a/mamba_prefill_conv"] = st["h"].numpy(), st["conv"].numpy()
    out["a/calls/mamba_prefill"] = calls() - c0
    r, m = group.rank, group.size
    state = {"h": torch.as_tensor(block(inp["h"], 1, r, m)),
             "conv": torch.as_tensor(block(inp["conv"], 2, r, m))}
    c0 = calls()
    o, st = ssm_lib.mamba_decode_step(torch.as_tensor(inp["step_x"]), mamba, cfg, state)
    out["a/mamba_step"] = o.numpy()
    out["a/mamba_step_h"], out["a/mamba_step_conv"] = st["h"].numpy(), st["conv"].numpy()
    out["a/calls/mamba_step"] = calls() - c0


def first_logits(model, tok, rng):
    """The last position's logits of the first robot's prompt of a
    scenario drawn from ``rng``."""

    prompt = np.concatenate([tok.encode_state(q) for q in obs_pair(rng)], axis=1)
    return model.prefill({"tokens": torch.as_tensor(prompt)})[0][0, -1].numpy()


def skip_out_proj(model, tok, rng):
    """``first_logits`` of a rank that skips the Mamba ``out_proj``
    all-reduce in every Mamba layer (every rank alike, so the other
    collectives still pair; its ``dt`` / B / C all-reduce stays)."""

    d = model.cfg.d_model
    real = ssm_lib.all_reduce_sum
    ssm_lib.all_reduce_sum = lambda x, g: x if x.shape[-1] == d else real(x, g)
    try:
        return first_logits(model, tok, rng)
    finally:
        ssm_lib.all_reduce_sum = real


def skip_moe(model, tok, rng):
    """``first_logits`` of a rank that skips the MoE all-reduce in every
    MoE layer."""

    moes = [blk.moe for blk in model.layers if hasattr(blk, "moe")]
    for p in moes:
        p.tp = None
    try:
        return first_logits(model, tok, rng)
    finally:
        for p in moes:
            p.tp = model.group


def rank_model(group, ref, arch, moe_impl="dense"):
    """The f32 smoke stack ``arch`` as this rank, on the reference's
    weights."""

    model = Model(smoke(arch), device="cpu", group=group, moe_impl=moe_impl)
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return model, EpisodeTokenizer(model.cfg.vocab_size)


class Recording(ContinuousBatchingScheduler):
    """Logs every reservation (robot, row, pages)."""

    def __init__(self, *a, **kw):
        self.reserved = []
        super().__init__(*a, **kw)

    def _reserve(self, req):
        seq = super()._reserve(req)
        self.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq


def engine_case(group, ref, out, name, arch, data, n, seed, impl):
    """One of ``TP_SCENARIOS`` over a rank mesh of ``data`` shards; on a
    stack with Mamba layers also ``controls``."""

    model, tok = rank_model(group, ref, arch, impl)
    sched = Recording(model, tok, mesh=make_rank_mesh(data, group), **ENGINE_KW)
    rng = np.random.default_rng(seed)
    for r in range(n):
        sched.submit(r, *obs_pair(rng))
    c0 = calls()
    results = sched.drain()
    out[f"{name}/collectives"] = np.asarray([*(calls() - c0), len(sched.admit_ms),
                                             sched.decode_rounds * sched.decode_block])
    if model.n_mamba:
        controls(model, tok, out, name, seed)
    record_engine(out, name, sched, results)
    out[f"{name}/pool_shape"] = np.asarray(sched._pcache["kp"].shape)


def record_engine(out, name, sched, results):
    """The engine run's results, tokens, reservations, final pool,
    counters and round mode."""

    st = sched.pool_stats()
    out[f"{name}/results"] = np.asarray([(r.robot_id, r.submitted_round, r.admitted_round,
                                          r.completed_round, int(r.kind == "split"))
                                         for r in results])
    out[f"{name}/tokens"] = np.stack([np.asarray(r.tokens, np.int64) for r in results])
    out[f"{name}/reserved"] = np.asarray(sched.reserved)
    out[f"{name}/pool"] = np.asarray([st.pages_in_use, st.high_water, *(st.shard_in_use or ()),
                                      *(st.shard_high_water or ())])
    out[f"{name}/counters"] = np.asarray([sched.round, sched.windows, sched.window_closes,
                                          sched.mixed_rounds, sched.peak_active, sched.rows,
                                          sched.allocator.num_pages])
    out[f"{name}/round_mode"] = np.frombuffer(sched.round_mode.encode(), np.uint8)


def controls(model, tok, out, name, seed):
    """The first robot's prompt's logits, then with the Mamba ``out_proj``
    and with the MoE all-reduces skipped."""

    for key, fn in (("logits", first_logits), ("skip_out_proj", skip_out_proj),
                    ("skip_moe", skip_moe)):
        out[f"{name}/{key}"] = fn(model, tok, np.random.default_rng(seed))


def fleet_case(group, ref, out):
    model, tok = rank_model(group, ref, "openvla-7b")
    mesh = make_rank_mesh(TP_FLEET["data"], group)
    fleet_record(out, "fleet42", serve_fleet(model, tok, mesh=mesh, **TP_FLEET["kw"]))


@torch.no_grad()
def xlstm_layers_case(group, out):
    """(a) on a rank of xlstm-smoke built by ``Model.init``: layer 0's
    mLSTM chunked and stepped, layer 1's sLSTM over a prompt and stepped,
    each from the rank's block of a given state; each case's collectives."""

    cfg = axis_smoke("xlstm-125m")
    model = Model(cfg, device="cpu", group=group)
    inp = xlstm_inputs(cfg)
    r, m = group.rank, group.size
    ml, sl = model.layers[0].mlstm, model.layers[1].slstm
    mstate = tuple(torch.as_tensor(block(inp[n], 1, r, m)) for n in ("mC", "mn", "mm"))
    sstate = (*(torch.as_tensor(block(inp[n], 1, r, m)) for n in ("sc", "sn")),
              torch.as_tensor(inp["sh"]), torch.as_tensor(block(inp["sm"], 1, r, m)))
    for case, fn, p, x, state, names in (
            ("mlstm_chunk", xlstm_lib.mlstm_forward, ml, "mlstm_x", mstate, "Cnm"),
            ("mlstm_step", xlstm_lib.mlstm_forward, ml, "mlstm_step_x", mstate, "Cnm"),
            ("slstm_prefill", xlstm_lib.slstm_forward, sl, "slstm_x", sstate, "cnhm"),
            ("slstm_step", xlstm_lib.slstm_forward, sl, "slstm_step_x", sstate, "cnhm")):
        c0 = calls()
        o, st = fn(torch.as_tensor(inp[x]), p, cfg, state=state, step=case.endswith("step"))
        out[f"a/calls/{case}"] = calls() - c0
        out[f"a/{case}"] = o.numpy()
        for n, t in zip(names, st):
            out[f"a/{case}_{n}"] = t.numpy()


@torch.no_grad()
def encdec_layers_case(group, out):
    """(a) on a rank of seamless-smoke built by ``Model.init``: encoder
    layer 0's attention, decoder layer 0's cross-attention over a prompt
    (and its K/V), decoder layer 1's cross-attention of a token over the
    rank's KV heads of given K/V and projected from the encoder's output;
    each case's collectives."""

    cfg = axis_smoke("seamless-m4t-medium")
    model = Model(cfg, device="cpu", group=group)
    inp = {k: torch.as_tensor(v) for k, v in encdec_inputs(cfg).items()}
    n = model.kv_heads
    xk, xv = (inp[k][:, :, group.rank * n:(group.rank + 1) * n] for k in ("xk", "xv"))
    xa0, xa1 = model.layers[0].xattn, model.layers[1].xattn
    cases = (
        ("encoder", lambda: attn.encoder_attention(inp["enc_x"], model.enc_layers[0].attn, cfg)),
        ("cross", lambda: attn.cross_attention_forward(inp["cross_x"], xa0, cfg, inp["enc_out"])),
        ("cross_cached", lambda: attn.cross_attention_cached(inp["token_x"], xa1, cfg, xk, xv)),
        ("cross_uncached", lambda: attn.cross_attention_decode(inp["token_x"], xa1, cfg,
                                                               inp["enc_out"])))
    for case, fn in cases:
        c0 = calls()
        o = fn()
        out[f"a/calls/{case}"] = calls() - c0
        if case == "cross":
            o, out["a/cross_k"], out["a/cross_v"] = o[0], o[1].numpy(), o[2].numpy()
        out[f"a/{case}"] = o.numpy()


def skip_h_gather(model, tok, rng):
    """``first_logits`` of a rank whose sLSTM layers skip the h all-gather:
    the rank's units stand in for every rank's (every rank alike, so the
    other collectives still pair)."""

    real = xlstm_lib._slstm_cell

    def cell(w_rec, bias, units, carry, x_in, tp=None):
        c, n, h, m = real(w_rec, bias, units, carry, x_in, None)
        return c, n, h.repeat(1, tp.size) if tp is not None else h, m

    xlstm_lib._slstm_cell = cell
    try:
        return first_logits(model, tok, rng)
    finally:
        xlstm_lib._slstm_cell = real


def xlstm_engine_case(group, ref, out, name, key, data, n, seed):
    """One of ``XLSTM_SCENARIOS`` over a rank mesh of ``data`` shards, its
    collectives (prefill and decode apart) and the rank's state shapes;
    on world 2 also the first prompt's logits with and without the h
    all-gather."""

    model = Model(axis_smoke(key), device="cpu", group=group)
    pre = f"params/{key}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    tok = EpisodeTokenizer(model.cfg.vocab_size)
    sched = Recording(model, tok, mesh=make_rank_mesh(data, group), **ENGINE_KW)
    rng = np.random.default_rng(seed)
    for r in range(n):
        sched.submit(r, *obs_pair(rng))
    c0 = calls()
    results = sched.drain()
    out[f"{name}/collectives"] = np.asarray([*(calls() - c0), len(sched.admit_ms),
                                             sched.decode_rounds * sched.decode_block])
    record_engine(out, name, sched, results)
    for st in ("mC", "sc", "sh"):
        out[f"{name}/shape_{st}"] = np.asarray(sched._pcache[st].shape)
    if group.size == 2:
        for key, fn in (("logits", first_logits), ("skip_h_gather", skip_h_gather)):
            out[f"{name}/{key}"] = fn(model, tok, np.random.default_rng(seed))


@torch.no_grad()
def encdec_case(group, ref, out, name):
    """seamless-smoke on the reference's weights through ``prefill`` (+
    ``cache_to_paged``) and ``decode_chunk`` in each of ``ENCDEC_MODES``:
    the prefill's and the chunk's last logits, its tokens, the collectives
    of the prefill and of the chunk; on world 2 the prefill's logits with
    every cross-attention's ``wo`` all-reduce skipped."""

    key = "seamless-m4t-medium"
    cfg, p = axis_smoke(key), ENCDEC_PLAN
    batch = {k: torch.as_tensor(v) for k, v in encdec_batch(cfg.vocab_size, cfg.d_model).items()}
    maxp, pt, caps = encdec_pages()
    spec = PagedSpec(num_pages=p["b"] * maxp, page_size=p["page"], max_pages_per_seq=maxp)
    pre = f"params/{key}/"
    model = load_reference_params(Model(cfg, device="cpu", group=group),
                                  {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    for cached, paged in ENCDEC_MODES:
        model.cache_cross_kv = cached
        mode = f"{name}/{encdec_mode(cached, paged)}"
        c0 = calls()
        logits, cache = model.prefill(batch, extra=0 if paged else p["steps"])
        c1 = calls()
        if paged:
            cache = model.cache_to_paged(cache, model.init_paged_cache(p["b"], spec), pt, caps)
        toks, last, cache = model.decode_chunk(logits, cache, p["steps"], 0)
        out[f"{mode}/calls"] = np.asarray([*(c1 - c0), *(calls() - c1)])
        out[f"{mode}/prefill"], out[f"{mode}/tokens"] = logits.numpy(), toks.numpy()
        out[f"{mode}/last"] = last.numpy()
        out[f"{mode}/xk_shape"] = np.asarray(cache["xk"].shape if cached else ())
        out[f"{mode}/enc_out_shape"] = np.asarray(cache["enc_out"].shape)
    if group.size == 2:
        model.cache_cross_kv = False
        xattn = [blk.xattn for blk in model.layers]
        for a in xattn:
            a.tp = None
        try:
            out[f"{name}/skip_xattn_wo"] = model.prefill(batch)[0].numpy()
        finally:
            for a in xattn:
                a.tp = group


def xlstm_encdec_main(group, ref, out):
    """PART ``xlstm_encdec``: the cases of this world."""

    world = group.size
    for key in XE_INIT[world]:
        for name, p in Model(axis_smoke(key), device="cpu", group=group).named_parameters():
            out[f"a/param/{key}/{name}"] = p.numpy()
    if world == 2:
        xlstm_layers_case(group, out)
        encdec_layers_case(group, out)
    for name, key, data, model_axis, n, seed in XLSTM_SCENARIOS:
        if model_axis == world:
            xlstm_engine_case(group, ref, out, name, key, data, n, seed)
    for name, data, model_axis in ENCDEC_MESHES:
        if model_axis == world:
            encdec_case(group, ref, out, name)


# ---------------------------------------------------------------------------
# PART split: the split lanes on a rank's model
# ---------------------------------------------------------------------------

# the stacks whose prefill and decode token ``bytes_case`` counts
BYTES_ARCHS = ("openvla-7b", "jamba-1.5-large-398b", "xlstm-125m", "seamless-m4t-medium")


def record_lanes():
    """Every lane reservation into its scheduler's ``reserved`` (where it
    keeps one), after the cloud ones as they come; a scheduler's first
    lane flush's logits of its new rows into its ``first_lane``."""

    reserve, flush = sched_lib._SplitLane.reserve, sched_lib._SplitLane.flush

    def recording_reserve(self, req):
        seq = reserve(self, req)
        if hasattr(self.sched, "reserved"):
            self.sched.reserved.append([req.robot_id, seq.row, *seq.pages])
        return seq

    def recording_flush(self, new):
        if getattr(self.sched, "first_lane", ()) is not None:
            return flush(self, new)
        # the suffix prefill's logits of the new rows (whole on every rank,
        # each of which keeps its own rows; none on a prefill rank)
        prefill, got = self.ex.suffix_prefill, []

        def kept(*args):
            out = prefill(*args)
            got.append(out[1][:len(new)].float().numpy())
            return out

        self.ex.suffix_prefill = kept
        try:
            flush(self, new)
        finally:
            del self.ex.suffix_prefill
        if got:
            self.sched.first_lane = got[0]

    sched_lib._SplitLane.reserve = recording_reserve
    sched_lib._SplitLane.flush = recording_flush


def split_engine_case(group, ref, out, name, arch, data, keys, pipelined, n, seed):
    """One of ``SPLIT_SCENARIOS`` over a rank mesh of ``data`` shards: the
    engine's records, the first lane prefill's logits, each lane's
    [drops, buffers held, peak bytes] and the scheduler's pools and fused
    graphs left after the drain, a suffix pool's shape."""

    model, tok = rank_model(group, ref, arch)
    sched = Recording(model, tok, mesh=make_rank_mesh(data, group), **ENGINE_KW)
    sched.first_lane = None
    exs = []
    for key in keys:
        cut, off = lane_cut(key)
        exs.append(PartitionExecutor(model, cut, expert_offload=off))
        sched.attach_partition(exs[-1], pipelined=pipelined)
    rng = np.random.default_rng(seed)
    for r in range(n):
        key = split_key(r, keys)
        sched.submit(r, *obs_pair(rng), partitioned=key is not None, cut=key)
    results = sched.drain()
    record_engine(out, name, sched, results)
    out[f"{name}/first_lane"] = sched.first_lane
    out[f"{name}/lanes"] = np.asarray([[lane.drops, int(lane.has_buffers), lane.peak_bytes]
                                       for lane in (sched._lanes[k] for k in keys)])
    out[f"{name}/left"] = np.asarray([len(sched._suffix_pools), len(sched._fleet_graphs)])
    out[f"{name}/pool_shape"] = np.asarray(exs[0].init_layer_pool(sched.paged_spec)["kp"].shape)


def state_shapes(states):
    """{layer/name: shape} of per-layer caches."""

    return {f"{i}/{k}": tuple(t.shape) for i, c in states.items() for k, t in c.items()}


@torch.no_grad()
def exec_case(group, ref, out, arch, cut):
    """``EXEC_CASES``' (arch, cut) on this rank: ``split_prefill`` and the
    ``split_decode_step`` tokens (the first one's collectives), then the
    same robots through the suffix path over the rank's pools
    (``init_layer_pool``) and lane state (``init_lane_state``); the pool's,
    the lane state's and the full edge's (``init_edge_rows``) shapes."""

    model, _ = rank_model(group, ref, arch)
    ex = PartitionExecutor(model, cut)
    prompts, steps = exec_inputs(model.cfg.vocab_size)
    p, key = EXEC_PLAN, f"exec/{arch}/{cut}"
    logits, state = ex.split_prefill({"tokens": torch.as_tensor(prompts)}, extra=len(steps))
    got = [logits[:, -1]]
    for i, token in enumerate(steps):
        c0 = calls()
        logits, state = ex.split_decode_step(torch.as_tensor(token), state)
        if i == 0:
            out[f"{key}/pingpong_calls"] = calls() - c0
        got.append(logits[:, -1])
    out[f"{key}/split"] = torch.stack(got).numpy()

    b, s = prompts.shape
    spec = PagedSpec(num_pages=b * p["maxp"], page_size=p["page"], max_pages_per_seq=p["maxp"])
    pools = {i: ex.init_layer_pool(spec) for i in ex.cloud_layers if model.specs[i][0] == "attn"}
    lane = ex.init_lane_state(spec, b)
    layers = [pools[i] if i in pools else lane[i] for i in ex.cloud_layers]
    xs, edges = zip(*(ex.edge_prefill(prompts[r:r + 1], len(steps)) for r in range(b)))
    i32 = dict(dtype=torch.int32)
    pt = torch.arange(b * p["maxp"], **i32).reshape(b, p["maxp"])
    lens = torch.full((b,), s, **i32)
    caps = torch.full((b,), p["maxp"] * p["page"], **i32)
    _, lg = ex.suffix_prefill(torch.cat(xs), layers, pt, np.arange(b), lens, caps)
    got = [lg]
    for token in steps:
        x = torch.cat([ex.edge_step(int(token[r, 0]), edges[r], s + len(got) - 1)[0]
                       for r in range(b)])
        lg, _ = ex.suffix_step(x, layers, pt, lens, caps)
        got.append(lg)
        lens = lens + 1
    out[f"{key}/suffix"] = torch.stack(got).numpy()
    shapes = {f"pool/{i}/kp": tuple(c["kp"].shape) for i, c in pools.items()}
    shapes.update({f"lane/{k}": v for k, v in state_shapes(lane).items()})
    edge = ex.with_cut(model.cfg.num_layers).init_edge_rows(b, s)
    shapes.update({f"edge/{k}": v for k, v in state_shapes(edge).items()})
    out[f"{key}/shapes"] = np.frombuffer(json.dumps(shapes).encode(), np.uint8)


def fused_calls(model, cuts, rows=2):
    """The collectives of one token of a fused split round over lanes at
    ``cuts`` (``build_fleet_decode``), on zero buffers (capacity 0: every
    write to the trash page)."""

    base = PartitionExecutor(model, cuts[0])
    spec = PagedSpec(num_pages=4, page_size=8, max_pages_per_seq=2)
    fn = base.build_fleet_decode(tuple(cuts), 1, 0)
    pools = {i: base.init_layer_pool(spec) for i in range(cuts[0], model.cfg.num_layers)
             if model.specs[i][0] == "attn"}
    i32 = dict(dtype=torch.int32, device=model.device)
    lanes = [{"logits": torch.zeros((rows, model.vocab_padded), device=model.device),
              "edge": base.with_cut(c).init_edge_rows(rows, 16),
              "state": base.with_cut(c).init_lane_state(spec, rows),
              "lens": torch.ones((rows,), **i32)} for c in cuts]
    pts = [torch.zeros((rows, 2), **i32) for _ in cuts]
    caps = [torch.zeros((rows,), **i32) for _ in cuts]
    c0 = calls()
    fn(pools, lanes, pts, caps)
    return calls() - c0


def policy_case(group, ref, out):
    """``POLICY_CASE``'s chunk through ``PartitionedPolicy`` on this rank
    (eager under gloo): its prefill's logits, tokens and collectives, then
    its actions and modeled channel ms."""

    arch, cut, seed = POLICY_CASE
    model, tok = rank_model(group, ref, arch)
    policy = PartitionedPolicy(PartitionExecutor(model, cut), tok)
    qd, tau = obs_pair(np.random.default_rng(seed))
    obs = torch.as_tensor(np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1))
    out["policy/prefill"] = policy.executor.split_prefill({"tokens": obs}, 0)[0][:, -1].numpy()
    c0 = calls()
    toks, _ = policy.chunk(obs)
    out["policy/calls"] = calls() - c0
    out["policy/tokens"] = toks.numpy()
    out["policy/actions"] = policy(qd, tau)
    out["policy/net_ms"] = np.asarray(policy.net_ms_log)
    out["policy/graphs"] = np.asarray(len(policy._graphs))


def channel_case(group, ref, out):
    """The channel's figures of a rank's executor: ``shipped_bytes`` of the
    split forward, ``modeled_net_ms`` and ``record_chunk_bytes``' counters,
    at openvla-smoke's cut 1 and qwen3-moe-smoke's expert-offload lane."""

    for arch, cut, off in (("openvla-7b", 1, ()), ("qwen3-moe-235b-a22b", 1, (0,))):
        model, _ = rank_model(group, ref, arch)
        ex = PartitionExecutor(model, cut, expert_offload=off)
        ex.forward({"tokens": torch.as_tensor(exec_inputs(model.cfg.vocab_size)[0])})
        ex.obs = Observability()
        ex.record_chunk_bytes(14, 56)
        fig = {"shipped": ex.shipped_bytes, "net": ex.modeled_net_ms(14, 56),
               "bytes": {k: v for k, v in ex.obs.metrics.to_json().items()
                         if k.startswith("channel.")}}
        out[f"channel/{arch}"] = np.frombuffer(json.dumps(fig).encode(), np.uint8)


@torch.no_grad()
def control_case(group, ref, out):
    """Openvla-smoke's executor case with the edge token embedding's
    all-reduce skipped on every rank: the rank's vocab block looked up and
    not summed, as ``_embed_token`` did before it passed the tp."""

    def unsummed(tokens, table, scale, tp):
        real = layers_lib.all_reduce_sum
        layers_lib.all_reduce_sum = lambda x, g: x
        try:
            return layers_lib.embed_lookup(tokens, table, scale, tp)
        finally:
            layers_lib.all_reduce_sum = real

    arch, cut, _ = EXEC_CASES[0]
    real = executor_lib.embed_lookup
    executor_lib.embed_lookup = unsummed
    try:
        sub = {}
        exec_case(group, ref, sub, arch, cut)
    finally:
        executor_lib.embed_lookup = real
    out["control/no_embed_sum"] = sub[f"exec/{arch}/{cut}/split"]


@torch.no_grad()
def bytes_case(group, out):
    """``dist.CALLS`` and ``dist.BYTES`` after a prefill and after one decode
    token of ``BYTES_ARCHS``' f32 smoke rank models (``Model.init``; 2 rows
    of 14 tokens, seamless's batch of ``encdec_batch``)."""

    for arch in BYTES_ARCHS:
        cfg = axis_smoke(arch) if arch in AXIS_STACKS else smoke(arch)
        model = Model(cfg, device="cpu", group=group)
        if cfg.encoder_decoder:
            batch = {k: torch.as_tensor(v)
                     for k, v in encdec_batch(cfg.vocab_size, cfg.d_model).items()}
        else:
            batch = {"tokens": torch.as_tensor(exec_inputs(cfg.vocab_size)[0])}
        rec = []
        for step in range(2):
            c0, b0 = calls(), np.asarray(list(dist.BYTES.values()))
            if step == 0:
                logits, cache = model.prefill(batch, extra=1)
            else:
                model.decode_step(logits[:, -1].argmax(-1, keepdim=True), cache)
            rec.append([*(calls() - c0), *(np.asarray(list(dist.BYTES.values())) - b0)])
        out[f"bytes/{arch}"] = np.asarray(rec)


def split_main(group, ref, out):
    """PART ``split``: the cases of this world."""

    record_lanes()
    world = group.size
    for name, arch, data, model_axis, keys, pipelined, n, seed in SPLIT_SCENARIOS:
        if model_axis == world:
            split_engine_case(group, ref, out, name, arch, data, keys, pipelined, n, seed)
    for arch, cut, worlds in EXEC_CASES:
        if world in worlds:
            exec_case(group, ref, out, arch, cut)
    policy_case(group, ref, out)
    channel_case(group, ref, out)
    model, _ = rank_model(group, ref, "openvla-7b")
    for cuts in ((1,), (0, 1)):
        out[f"fused_calls/{'_'.join(map(str, cuts))}"] = fused_calls(model, cuts)
    if world == 2:
        control_case(group, ref, out)
        bytes_case(group, out)
        model, tok = rank_model(group, ref, "openvla-7b")
        fleet_record(out, "spfleet", serve_fleet(
            model, tok, mesh=make_rank_mesh(TP_FLEET["data"], group),
            partition_executor=PartitionExecutor(model, SPLIT_FLEET["cut"]),
            split_robots=SPLIT_FLEET["split_robots"], **TP_FLEET["kw"]))


def main(rank, world, store, params_path, out_dir, part="dense"):
    torch.set_num_threads(1)
    group = dist.init_model_group(rank, world, backend="gloo", init_method=f"file://{store}",
                                  device="cpu")
    with np.load(params_path) as z:
        ref = {k: z[k] for k in z.files if k.startswith("params/")}
    out = {}
    if part == "xlstm_encdec":
        xlstm_encdec_main(group, ref, out)
    elif part == "split":
        split_main(group, ref, out)
    else:
        if world == 2:
            layers_case(group, out)
            hybrid_layers_case(group, out)
        for name, arch, data, model_axis, n, seed, impl in TP_SCENARIOS:
            if model_axis == world:
                engine_case(group, ref, out, name, arch, data, n, seed, impl)
        if TP_FLEET["model"] == world:
            fleet_case(group, ref, out)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_model_group(group)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
