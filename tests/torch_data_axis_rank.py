"""One rank of the port's data and prefill ranks, for
``tests/test_torch_data_axis.py``.  Imports torch and the port only.

    GLOO_SOCKET_IFNAME=lo PYTHONPATH=src:tests \\
        python tests/torch_data_axis_rank.py RANK WORLD STORE PARAMS.npz OUT_DIR

Joins a gloo world of ``WORLD`` (8) CPU ranks over the file store
``STORE``, then lays the grids of ``GRIDS`` over it one after another
(``launch.dist.rank_grid``: a grid's data ranks, model ranks and prefill
rank; a process outside a grid waits for the next) and writes
``OUT_DIR/rank<RANK>.npz``.  On each grid, on the weights in
``PARAMS.npz`` (``params/<arch>/<key>``, the reference's layout, which
``tests/torch_sharded_ref.py --params`` runs on too):

* ``d8`` (8 data ranks): ``cloud8`` and ``mixed8`` of ``SCENARIOS``; the
  capacity MoE layer of phi3.5-moe-smoke over rows sharded over the 8 data
  ranks (E = 4 does not divide over them, so every rank holds every
  expert), and the same with the table built from the rank's own rows (a
  control); qwen3-moe-smoke's dense MoE layer so (its rows stay the
  rank's: no collective);
* ``d1p1`` (1 decode rank, 1 prefill rank): ``disagg``, and the same with
  a prefill rank that hands off zeros (a control); ``cancel_pending``
  (robot 1 cancelled while its prefill is pending);
* ``d7p1`` (7 data ranks, 1 prefill rank): ``combo7``; ``mixed7p`` (a
  split lane at cut 1 beside the prefill rank), and the same with a
  prefill rank that takes no lane tokens (a control);
* ``d4m2`` (data 4 x model 2): ``tp42``, ``jb42`` and ``pc42`` of
  ``TP_SCENARIOS``, the rapid fleet (``TP_FLEET``), ``sp42``, ``ss42``
  and ``sj42`` of ``SPLIT_SCENARIOS``; pc42's MoE layer over sharded rows,
  and its first prompt's logits with and without the MoE's data-axis
  reduction; phi3.5-moe-smoke's capacity layer over 6 rows in blocks of 2
  (2 pad rows), and the same with the pad rows in the table (a control);
* ``d2m4`` (data 2 x model 4): ``qm24``, ``sx24`` and ``sh24``,
  qwen3-moe-smoke's MoE layer over sharded rows;
* ``d2m2p1`` (data 2 x model 2 and a prefill rank): ``PREFILL_RUNS``, the
  prefill rank handing its whole model's K/V (and Jamba's Mamba state) to
  decode ranks that each take their KV heads and state blocks; the rapid
  fleet with ``SPLIT_FLEET``'s robots split (``split_fleet_p``);
* ``p2d2m2`` (pod 2 x data 2 x model 2): ``POD_SCENARIOS``, the rows
  blocked over the four (pod, data) ranks of a model column.

Each engine run records what the reference's does (results, tokens,
reservations, pool, counters), the round mode, the rank's row and pool
shapes, each lane's rows, block and buffer bytes, and the data axis's and
batch group's collectives (``dist.DATA_CALLS`` / ``DATA_BYTES``) of every
admission prefill, decode round, window harvest, handoff and row growth,
and of every lane's edge prefill, flush, fused round, serial token and
row growth (``events``); each MoE stack its expert bytes.
"""

import sys

import numpy as np
import torch

from repro_torch.checkpoint.bridge import load_reference_params
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.serve import serve_fleet
from repro_torch.launch.sharding import sharding_rules
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import Model
from repro_torch.partition import PartitionExecutor
from repro_torch.runtime import scheduler as sched_lib
from torch_model_axis_cases import (ENGINE_KW, POD_SCENARIOS, SCENARIOS, SMOKE_LAYERS,
                                    SPLIT_FLEET, SPLIT_FLEET_P, SPLIT_SCENARIOS, TP_FLEET,
                                    TP_SCENARIOS, fleet_record, lane_cut, obs_pair, split_key)
from torch_model_axis_rank import Recording, first_logits, record_engine, record_lanes

# (name, data, model, prefill, pod): the grids, in order, over one world of 8
GRIDS = (("d8", 8, 1, 0, 1), ("d1p1", 1, 1, 1, 1), ("d7p1", 7, 1, 1, 1), ("d4m2", 4, 2, 0, 1),
         ("d2m4", 2, 4, 0, 1), ("d2m2p1", 2, 2, 1, 1), ("p2d2m2", 2, 2, 0, 2))
# the runs with a prefill rank beside a model axis: (name, arch, robots,
# seed), each held to one process with ``prefill_group=[cpu]``
PREFILL_RUNS = (("tpp", "openvla-7b", 6, 0), ("jbp", "jamba-1.5-large-398b", 6, 4))
# the data-shard scenarios by grid, and the model-axis ones by (data, model)
GRID_OF = {"cloud8": "d8", "mixed8": "d8", "disagg": "d1p1", "combo7": "d7p1",
           "mixed7p": "d7p1"}
TP_RUN = ("tp42", "jb42", "pc42", "qm24")
SPLIT_RUN = ("sp42", "sx24", "ss42", "sh24", "sj42")
# the MoE layer cases: (grid, arch, dispatch); the rows of their input
LAYER_CASES = (("d8", "phi3.5-moe-42b-a6.6b", "capacity"), ("d8", "qwen3-moe-235b-a22b", "dense"),
               ("d4m2", "phi3.5-moe-42b-a6.6b", "capacity"),
               ("d2m4", "qwen3-moe-235b-a22b", "dense"))
LAYER_ROWS = 8
# the capacity layer over padded blocks: (grid, arch, real rows R, rows a
# block B); its rows are the first R of ``layer_inputs``
PAD_CASE = ("d4m2", "phi3.5-moe-42b-a6.6b", 6, 2)
# the seed of ``cancel_pending``'s observations
CANCEL_SEED = 1
# the data axis's counters, in order; each event's figures (``Counted``)
DATA_KEYS = ("all_reduce", "all_gather", "broadcast")
FIGURES = {"prefill": 2, "round": 2, "harvest": 2, "handoff": 1, "grow": 3,
           "edge": 1, "flush": 2, "fused": 5, "serial": 4, "lane_grow": 3}
# the rows that double while their sequences decode, so that rows change
# rank with their pages: on ``GROW_GRID``, openvla-smoke, a lane at cut 1 of
# 2 rows (pipelined, and serial: its robots' edge caches move too) and 2
# cloud rows; robots submitted before the steps of these rounds (the odd
# ones split), with the moves and without (a control each)
GROW_GRID = "d2m4"
GROW_KW = dict(max_slots=2, num_pages=63, scan_rounds=2)
GROW_PLAN = {0: (0, 1, 2), 2: (3, 4), 4: (5, 6)}
GROW_SEED = 50
# lanes whose MoE layers exchange over the data ranks, held to one
# process's port run: (name, arch, grid, lane key, pipelined, moe_impl,
# robots, seed); a serial lane whose edge layer's experts spread over the
# data ranks (each token's tokens gathered, every robot's edge stepped on
# every rank), a pipelined lane under the capacity dispatch (the tables
# over each lane's real rows)
LANE_RUNS = (("sxs", "qwen3-moe-235b-a22b", "d2m4", 1, False, "dense", 6, 60),
             ("spc", "phi3.5-moe-42b-a6.6b", "d4m2", 1, True, "capacity", 6, 61))
# the counts of the events around the one being counted (an event inside
# another is counted once, in its own row)
_OPEN = []


def smoke(arch):
    return get_smoke_config(arch).replace(num_layers=SMOKE_LAYERS, dtype="float32")


def grid_model(grid, ref, arch, moe_impl="dense"):
    """The f32 smoke stack ``arch`` as this rank of ``grid`` (a prefill
    rank: the whole model), on the reference's weights."""

    groups = ({} if grid.is_prefill else
              dict(group=grid.model_group, data_group=grid.data_group,
                   batch_group=grid.batch_group))
    model = Model(smoke(arch), device="cpu", moe_impl=moe_impl, **groups)
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return model, EpisodeTokenizer(model.cfg.vocab_size)


def data_counts():
    return np.asarray([*(dist.DATA_CALLS[k] for k in DATA_KEYS),
                       *(dist.DATA_BYTES[k] for k in DATA_KEYS)])


def counted(events, kind, figures, fn, *args):
    """``fn(*args)``, its data-axis collectives (less those of the events
    inside it) logged as a row of ``events[kind]`` after ``figures``."""

    c0 = data_counts()
    _OPEN.append(np.zeros(2 * len(DATA_KEYS), np.int64))
    try:
        out = fn(*args)
    finally:
        inner = _OPEN.pop()
    seen = data_counts() - c0
    if _OPEN:
        _OPEN[-1] += seen
    events[kind].append([*figures, *(seen - inner)])
    return out


class Counted(Recording):
    """``Recording`` that also logs the data axis's collectives of each
    admission prefill [rows, prompt], decode round [rows, block], window
    harvest [gathered rows, steps], handoff [prompts], row growth [rows
    after, whether rows moved with their pages, the gathers it counts
    (``grow_gathers``)] and fused split round [block, then (cut, rows a
    block) of up to two lanes, -1 where none] (``events``: kind -> rows of
    its figures then the six counters); ``count_lanes`` adds the lanes'
    own."""

    def __init__(self, *a, **kw):
        self.events = {k: [] for k in FIGURES}
        super().__init__(*a, **kw)
        prefill = self.model.prefill

        def counted_prefill(batch, extra=0):
            tokens = batch["tokens"]
            return self._counted("prefill", [*tokens.shape], prefill, batch, extra)

        self.model.prefill = counted_prefill

    def _counted(self, kind, figures, fn, *args):
        return counted(self.events, kind, figures, fn, *args)

    def _decode_round(self, block):
        return self._counted("round", [self._local_rows, block], super()._decode_round, block)

    def _fused_window(self, keys, block):
        lanes = [self._lanes[k] for k in keys]
        figures = [block, *(v for l in lanes for v in (l.cut, l.block)),
                   *([-1, -1] * (2 - len(lanes)))]
        return self._counted("fused", figures, super()._fused_window, keys, block)

    def _window_tokens(self, parts, n_steps):
        rows = self._nranks * sum(b for b, _, _ in parts)
        return self._counted("harvest", [rows, n_steps], super()._window_tokens, parts, n_steps)

    def _handoff_payload(self, n_new, payload):
        return self._counted("handoff", [n_new], super()._handoff_payload, n_new, payload)

    def _grow_rows(self):
        moves = self.page_moves
        out = self._counted("grow", [2 * self.rows, -1, -1], super()._grow_rows)
        moved = self.page_moves - moves
        self.events["grow"][-1][1:3] = [moved, self.grow_gathers(moved)]
        return out


def count_lanes():
    """Each lane's edge prefill (its reservation) [cut], flush [cut, new
    rows], serial token [cut, rows a block, active robots, whether its edge
    layers exchange over the data ranks] and row growth [cut, whether rows
    moved with their pages, the gathers it counts (``grow_gathers``)] into
    its scheduler's ``events``, where it keeps them."""

    lane_cls = sched_lib._SplitLane

    def wrap(name, kind, figures):
        real = getattr(lane_cls, name)

        def fn(self, *args):
            events = getattr(self.sched, "events", None)
            if events is None:
                return real(self, *args)
            return counted(events, kind, figures(self, *args), real, self, *args)

        setattr(lane_cls, name, fn)

    wrap("reserve", "edge", lambda lane, req: [lane.cut])
    wrap("flush", "flush", lambda lane, new: [lane.cut, len(new)])
    wrap("_serial_token", "serial", lambda lane, active, *a: [
        lane.cut, lane.block, len(active), int(lane._edge_exchanges)])
    real_grow = lane_cls._grow_rows

    def grow(self):
        events = getattr(self.sched, "events", None)
        if events is None:
            return real_grow(self)
        moves = self.page_moves
        out = counted(events, "lane_grow", [self.cut, -1, -1], real_grow, self)
        moved = self.page_moves - moves
        events["lane_grow"][-1][1:3] = [moved, self.grow_gathers(moved)]
        return out

    lane_cls._grow_rows = grow


def record_grid_engine(out, name, sched, results):
    """``record_engine``, plus the rank's shapes, its lanes' [cut, rows,
    rows a block, peak buffer bytes] and the logged counts."""

    record_engine(out, name, sched, results)
    out[f"{name}/lanes"] = np.asarray([[l.cut, l.rows, l.block, l.peak_bytes]
                                       for l in sched._lanes.values()], np.int64).reshape(-1, 4)
    pc = sched._pcache
    out[f"{name}/shapes"] = np.asarray(
        [sched.rows, *(pc["len"].shape if pc is not None else (0,)),
         *(pc["kp"].shape if pc is not None else (0,) * 5)])
    out[f"{name}/state_rows"] = np.asarray(
        [pc[k].shape[1] for k in sched.model.state_names] if pc is not None else [], np.int64)
    for kind, rows in sched.events.items():
        out[f"{name}/events/{kind}"] = np.asarray(rows, np.int64).reshape(
            len(rows), FIGURES[kind] + 2 * len(DATA_KEYS))


class NoLaneTokens(Counted):
    """A control: the prefill rank's windows take the cloud rows' tokens
    and none of the lanes' (zeros; the collectives run as they do)."""

    _cloud = False

    def _close_window(self):
        self._cloud = self._window.cloud
        try:
            return super()._close_window()
        finally:
            self._cloud = False

    def _window_tokens(self, parts, n_steps):
        out = super()._window_tokens(parts, n_steps)
        if self.is_prefill_rank:
            keep = int(self._cloud)
            out = out[:keep] + [np.zeros_like(t) for t in out[keep:]]
        return out


def scenario_case(grid, ref, out, name, n, seed, disagg, cut, zeros=False, lane_control=False):
    """One of ``SCENARIOS`` on ``grid`` (``zeros``: a control, the prefill
    rank hands off zeros; ``lane_control``: a prefill rank that takes no
    lane tokens)."""

    model, tok = grid_model(grid, ref, "openvla-7b")
    cls = NoLaneTokens if lane_control else Counted
    sched = cls(model, tok, mesh=make_rank_mesh(grid.data, grid),
                prefill_group=grid.handoff if disagg else None, **ENGINE_KW)
    if zeros:
        real = sched._pack
        sched._pack = lambda last, dcache: torch.zeros_like(real(last, dcache))
    if cut is not None:
        sched.attach_partition(PartitionExecutor(model, cut))
    rng = np.random.default_rng(seed)
    for r in range(n):
        sched.submit(r, *obs_pair(rng), partitioned=cut is not None and r % 2 == 1)
    record_grid_engine(out, name, sched, sched.drain())


def tp_case(grid, ref, out, name, arch, n, seed, impl):
    """One of ``TP_SCENARIOS`` on ``grid``; the rank's expert bytes."""

    model, tok = grid_model(grid, ref, arch, impl)
    sched = Counted(model, tok, mesh=make_rank_mesh(grid.data, grid), **ENGINE_KW)
    rng = np.random.default_rng(seed)
    for r in range(n):
        sched.submit(r, *obs_pair(rng))
    record_grid_engine(out, name, sched, sched.drain())
    out[f"{name}/expert_bytes"] = np.asarray(expert_bytes(model))


def expert_bytes(model):
    return sum(t.numel() * t.element_size() for blk in model.layers if hasattr(blk, "moe")
               for t in (blk.moe.up, blk.moe.gate, blk.moe.down))


def split_case(grid, ref, out, name, arch, keys, pipelined, n, seed, impl="dense"):
    """One of ``SPLIT_SCENARIOS`` (or ``LANE_RUNS``) on ``grid``: each data
    rank holding its block of every lane's rows."""

    model, tok = grid_model(grid, ref, arch, impl)
    sched = Counted(model, tok, mesh=make_rank_mesh(grid.data, grid), **ENGINE_KW)
    sched.first_lane = None
    for key in keys:
        cut, off = lane_cut(key)
        sched.attach_partition(PartitionExecutor(model, cut, expert_offload=off),
                               pipelined=pipelined)
    rng = np.random.default_rng(seed)
    for r in range(n):
        key = split_key(r, keys)
        sched.submit(r, *obs_pair(rng), partitioned=key is not None, cut=key)
    record_grid_engine(out, name, sched, sched.drain())
    out[f"{name}/first_lane"] = sched.first_lane


def layer_inputs(d_model):
    """The MoE layer cases' rows [LAYER_ROWS, 1, D] (seeded): one row and
    small offsets of it, so that every row takes the same experts and the
    capacity dispatch drops the last rows' picks (over every row: cap 5 of
    8 picks an expert; over one row alone: none dropped)."""

    rng = np.random.default_rng(16)
    base = rng.normal(0, 1, (1, 1, d_model))
    return (base + 1e-3 * rng.normal(0, 1, (LAYER_ROWS, 1, d_model))).astype(np.float32)


def own_table(x, p, capacity):
    """A control: ``moe_lib._gathered`` that never gathers, so a capacity
    table is built from the rank's own rows."""

    return x, None


@torch.no_grad()
def layer_case(grid, ref, out, gname, arch, impl):
    """The MoE layer of layer 1 of ``arch`` over this rank's block of
    ``layer_inputs``' rows, sharded over the grid's data ranks (a decode
    round's case); on a grid where the experts stay whole, also with the
    table built from the rank's own rows."""

    model, _ = grid_model(grid, ref, arch, impl)
    moe = model.layers[1].moe
    x = torch.as_tensor(layer_inputs(model.cfg.d_model))
    n = LAYER_ROWS // grid.data
    mine = x[grid.d * n:(grid.d + 1) * n]
    fn = moe_lib.moe_forward_capacity if impl == "capacity" else moe_lib.moe_forward
    mesh = make_rank_mesh(grid.data, grid)
    key = f"layer/{gname}/{arch}"
    with sharding_rules(mesh):
        c0 = data_counts()
        out[key] = fn(mine, moe, model.cfg)[0].numpy()
        out[f"{key}/counts"] = data_counts() - c0
        if not moe.split:
            real = moe_lib._gathered
            moe_lib._gathered = own_table
            try:
                out[f"{key}/own_table"] = fn(mine, moe, model.cfg)[0].numpy()
            finally:
                moe_lib._gathered = real
    out[f"{key}/expert_bytes"] = np.asarray(expert_bytes(model))


def skip_data_reduction(out, p, rows, dtype):
    """A control: ``moe_lib._finish`` without the data axis's sum (every
    rank alike, so the model axis's collectives still pair)."""

    if rows is not None:
        out = out.narrow(0, rows.group.rank * rows.local, rows.local)
    return moe_lib.all_reduce_sum(out.to(dtype), p.tp)


def reduction_control(grid, ref, out):
    """pc42's first prompt's logits on this rank, then with the MoE's
    data-axis reduction skipped."""

    name, arch, _, _, _, seed, impl = next(s for s in TP_SCENARIOS if s[0] == "pc42")
    model, tok = grid_model(grid, ref, arch, impl)
    with torch.no_grad():
        out[f"{name}/logits"] = first_logits(model, tok, np.random.default_rng(seed))
        real = moe_lib._finish
        moe_lib._finish = skip_data_reduction
        try:
            out[f"{name}/skip_data"] = first_logits(model, tok, np.random.default_rng(seed))
        finally:
            moe_lib._finish = real


def grid_cases(gname, grid, ref, out):
    at = (grid.data, grid.model) if grid.pod == 1 else None
    for name, n, seed, _, disagg, cut in SCENARIOS:
        if GRID_OF[name] == gname:
            scenario_case(grid, ref, out, name, n, seed, disagg, cut)
    if gname == "d1p1":
        name, n, seed, _, _, _ = next(s for s in SCENARIOS if s[0] == "disagg")
        scenario_case(grid, ref, out, f"{name}_zeros", n, seed, True, None, zeros=True)
        cancel_pending_case(grid, ref, out)
    if gname == "d7p1":
        name, n, seed, _, _, cut = next(s for s in SCENARIOS if s[0] == "mixed7p")
        scenario_case(grid, ref, out, f"{name}_nolane", n, seed, True, cut, lane_control=True)
    for name, arch, data, model_axis, n, seed, impl in TP_SCENARIOS:
        if name in TP_RUN and (data, model_axis) == at:
            tp_case(grid, ref, out, name, arch, n, seed, impl)
    for name, arch, pod, data, model_axis, n, seed, impl in POD_SCENARIOS:
        if (pod, data, model_axis) == (grid.pod, grid.data, grid.model):
            tp_case(grid, ref, out, name, arch, n, seed, impl)
    if (TP_FLEET["data"], TP_FLEET["model"]) == at:
        model, tok = grid_model(grid, ref, "openvla-7b")
        fleet_record(out, "fleet42", serve_fleet(model, tok, mesh=make_rank_mesh(grid.data, grid),
                                                 **TP_FLEET["kw"]))
        reduction_control(grid, ref, out)
    for name, arch, data, model_axis, keys, pipelined, n, seed in SPLIT_SCENARIOS:
        if name in SPLIT_RUN and (data, model_axis) == at:
            split_case(grid, ref, out, name, arch, keys, pipelined, n, seed)
    for lg, arch, impl in LAYER_CASES:
        if lg == gname:
            layer_case(grid, ref, out, gname, arch, impl)
    if gname == PAD_CASE[0]:
        pad_case(grid, ref, out)
    for name, arch, lg, key, pipelined, impl, n, seed in LANE_RUNS:
        if lg == gname:
            split_case(grid, ref, out, name, arch, (key,), pipelined, n, seed, impl)
    if gname == GROW_GRID:
        for pipelined in (True, False):
            grow_case(grid, ref, out, pipelined=pipelined)
            grow_case(grid, ref, out, moves=False, pipelined=pipelined)
    if gname == "d2m2p1":
        for name, arch, n, seed in PREFILL_RUNS:
            prefill_case(grid, ref, out, name, arch, n, seed)
        split_fleet_case(grid, ref, out)


def grow_run(sched, rng):
    """``GROW_PLAN``'s robots through ``submit`` and ``step`` -> the
    results in harvest order."""

    n = max(max(r) for r in GROW_PLAN.values()) + 1
    obs = [obs_pair(rng) for _ in range(n)]
    results = []
    while len(results) < n:
        for r in GROW_PLAN.get(sched.round, ()):
            sched.submit(r, *obs[r], partitioned=r % 2 == 1)
        results += sched.step()
    return results


def grow_case(grid, ref, out, moves=True, pipelined=True):
    """``grow_run`` on ``grid`` with a pipelined lane (``grow``) or a
    serial one (``grow_serial``); ``moves=False``: a control whose rows
    change rank without their pages (``grow_nomove``) or, serial, without
    their robots' edge caches (``grow_serial_stale``)."""

    model, tok = grid_model(grid, ref, "openvla-7b")
    sched = Counted(model, tok, mesh=make_rank_mesh(grid.data, grid), **GROW_KW)
    sched.attach_partition(PartitionExecutor(model, 1), pipelined=pipelined)
    if not moves and pipelined:
        sched._move_pages = lambda *a: False
    elif not moves:
        sched._lanes[1]._move_edge_caches = lambda *a: None
    name = ("grow" if pipelined else "grow_serial") + (
        "" if moves else "_nomove" if pipelined else "_stale")
    record_grid_engine(out, name, sched, grow_run(sched, np.random.default_rng(GROW_SEED)))
    out[f"{name}/page_moves"] = np.asarray([sched.page_moves, sched._lanes[1].page_moves])


def split_fleet_case(grid, ref, out):
    """The rapid fleet with ``SPLIT_FLEET``'s robots split at its cut,
    pipelined, beside the grid's prefill rank (``split_fleet_p``)."""

    assert (grid.data, grid.model) == (SPLIT_FLEET_P["data"], SPLIT_FLEET_P["model"])
    model, tok = grid_model(grid, ref, "openvla-7b")
    fleet_record(out, "split_fleet_p", serve_fleet(
        model, tok, mesh=make_rank_mesh(grid.data, grid), prefill_group=grid.handoff,
        partition_executor=PartitionExecutor(model, SPLIT_FLEET["cut"]),
        split_robots=SPLIT_FLEET["split_robots"], **TP_FLEET["kw"]))


def pad_rows(x, rows, block, ranks):
    """``x``'s first ``rows`` rows as ``ranks`` padded blocks of ``block``
    [ranks * block, ...] (zero pad rows)."""

    out = np.zeros((ranks * block,) + x.shape[1:], x.dtype)
    out[:rows] = x[:rows]
    return out


@torch.no_grad()
def pad_case(grid, ref, out):
    """``PAD_CASE``: the capacity layer over the rank's padded block of R
    rows, sharded over the data ranks, the table from the real rows; then
    with every block's pad rows in the table (a control)."""

    gname, arch, rows, block = PAD_CASE
    model, _ = grid_model(grid, ref, arch, "capacity")
    moe = model.layers[1].moe
    x = pad_rows(layer_inputs(model.cfg.d_model), rows, block, grid.blocks)
    mine = torch.as_tensor(x[grid.d * block:(grid.d + 1) * block])
    key = f"pad/{gname}/{arch}"
    with sharding_rules(make_rank_mesh(grid.data, grid), rows=((rows, block),)):
        c0 = data_counts()
        out[key] = moe_lib.moe_forward_capacity(mine, moe, model.cfg)[0].numpy()
        out[f"{key}/counts"] = data_counts() - c0
        real = moe_lib.real_rows
        moe_lib.real_rows = lambda local, ranks: None
        try:
            out[f"{key}/with_pad"] = moe_lib.moe_forward_capacity(mine, moe, model.cfg)[0].numpy()
        finally:
            moe_lib.real_rows = real


def cancel_pending(sched, rng):
    """Four robots admitted at once; robot 1 cancelled while its prefill
    is pending; robot 4 arrives and takes its row and pages at the next
    boundary -> the results."""

    for r in range(4):
        sched.submit(r, *obs_pair(rng))
    results = sched.step()
    assert sched.cancel(1)
    sched.submit(4, *obs_pair(rng))
    while sched.n_pending or sched.n_active:
        results += sched.step()
    return results


def cancel_pending_case(grid, ref, out):
    """``cancel_pending`` with the prefill on the grid's prefill rank."""

    model, tok = grid_model(grid, ref, "openvla-7b")
    sched = Counted(model, tok, mesh=make_rank_mesh(grid.data, grid),
                    prefill_group=grid.handoff, max_slots=4, scan_rounds=2)
    record_grid_engine(out, "cancel_pending", sched,
                       cancel_pending(sched, np.random.default_rng(CANCEL_SEED)))


def prefill_case(grid, ref, out, name, arch, n, seed):
    """One of ``PREFILL_RUNS`` on ``grid``: the prefill rank's whole model
    hands off to decode ranks over a model axis."""

    model, tok = grid_model(grid, ref, arch)
    sched = Counted(model, tok, mesh=make_rank_mesh(grid.data, grid),
                    prefill_group=grid.handoff, **ENGINE_KW)
    rng = np.random.default_rng(seed)
    for r in range(n):
        sched.submit(r, *obs_pair(rng))
    record_grid_engine(out, name, sched, sched.drain())


def main(rank, world, store, params_path, out_dir):
    torch.set_num_threads(1)
    record_lanes()
    count_lanes()
    with np.load(params_path) as z:
        ref = {k: z[k] for k in z.files if k.startswith("params/")}
    assert GRIDS[0][1:] == (world, 1, 0, 1)
    first = dist.init_rank_grid(rank, data=world, backend="gloo", init_method=f"file://{store}",
                                device="cpu")
    out = {}
    for gname, data, model, prefill, pod in GRIDS:
        grid = first if gname == GRIDS[0][0] else dist.rank_grid(data, model, prefill, pod)
        if grid is not None:
            out[f"grid/{gname}"] = np.asarray([grid.d, grid.m, int(grid.is_prefill), grid.p])
            grid_cases(gname, grid, ref, out)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_rank_grid(first)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
