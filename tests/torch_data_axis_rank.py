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
* ``d7p1`` (7 data ranks, 1 prefill rank): ``combo7``;
* ``d4m2`` (data 4 x model 2): ``tp42``, ``jb42`` and ``pc42`` of
  ``TP_SCENARIOS``, the rapid fleet (``TP_FLEET``), ``sp42`` of
  ``SPLIT_SCENARIOS``; pc42's MoE layer over sharded rows, and its first
  prompt's logits with and without the MoE's data-axis reduction;
* ``d2m4`` (data 2 x model 4): ``qm24`` and ``sx24``, qwen3-moe-smoke's
  MoE layer over sharded rows;
* ``d2m2p1`` (data 2 x model 2 and a prefill rank): ``PREFILL_RUNS``, the
  prefill rank handing its whole model's K/V (and Jamba's Mamba state) to
  decode ranks that each take their KV heads and state blocks.

Each engine run records what the reference's does (results, tokens,
reservations, pool, counters), the round mode, the rank's row and pool
shapes, and the data axis's collectives (``dist.DATA_CALLS`` /
``DATA_BYTES``) of every admission prefill, decode round, window harvest,
handoff and row growth (``events``); each MoE stack its expert bytes.
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
from torch_model_axis_cases import (ENGINE_KW, SCENARIOS, SMOKE_LAYERS, SPLIT_SCENARIOS,
                                    TP_FLEET, TP_SCENARIOS, fleet_record, lane_cut, obs_pair,
                                    split_key)
from torch_model_axis_rank import Recording, first_logits, record_engine, record_lanes

# (name, data, model, prefill): the grids, in order, over one world of 8
GRIDS = (("d8", 8, 1, 0), ("d1p1", 1, 1, 1), ("d7p1", 7, 1, 1), ("d4m2", 4, 2, 0),
         ("d2m4", 2, 4, 0), ("d2m2p1", 2, 2, 1))
# the runs with a prefill rank beside a model axis: (name, arch, robots,
# seed), each held to one process with ``prefill_group=[cpu]``
PREFILL_RUNS = (("tpp", "openvla-7b", 6, 0), ("jbp", "jamba-1.5-large-398b", 6, 4))
# the data-shard scenarios by grid, and the model-axis ones by (data, model)
GRID_OF = {"cloud8": "d8", "mixed8": "d8", "disagg": "d1p1", "combo7": "d7p1"}
TP_RUN = ("tp42", "jb42", "pc42", "qm24")
SPLIT_RUN = ("sp42", "sx24")
# the MoE layer cases: (grid, arch, dispatch); the rows of their input
LAYER_CASES = (("d8", "phi3.5-moe-42b-a6.6b", "capacity"), ("d8", "qwen3-moe-235b-a22b", "dense"),
               ("d4m2", "phi3.5-moe-42b-a6.6b", "capacity"),
               ("d2m4", "qwen3-moe-235b-a22b", "dense"))
LAYER_ROWS = 8
# the seed of ``cancel_pending``'s observations
CANCEL_SEED = 1
# the data axis's counters, in order; each event's figures (``Counted``)
DATA_KEYS = ("all_reduce", "all_gather", "broadcast")
FIGURES = {"prefill": 2, "round": 2, "harvest": 2, "handoff": 1, "grow": 1}


def smoke(arch):
    return get_smoke_config(arch).replace(num_layers=SMOKE_LAYERS, dtype="float32")


def grid_model(grid, ref, arch, moe_impl="dense"):
    """The f32 smoke stack ``arch`` as this rank of ``grid`` (a prefill
    rank: the whole model), on the reference's weights."""

    groups = ({} if grid.is_prefill else
              dict(group=grid.model_group, data_group=grid.data_group))
    model = Model(smoke(arch), device="cpu", moe_impl=moe_impl, **groups)
    pre = f"params/{arch}/"
    load_reference_params(model, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return model, EpisodeTokenizer(model.cfg.vocab_size)


def data_counts():
    return np.asarray([*(dist.DATA_CALLS[k] for k in DATA_KEYS),
                       *(dist.DATA_BYTES[k] for k in DATA_KEYS)])


class Counted(Recording):
    """``Recording`` that also logs the data axis's collectives of each
    admission prefill [rows, prompt], decode round [rows, block], window
    harvest [rows, steps], handoff [prompts] and row growth [rows after]
    (``events``: kind -> rows of its figures then the six counters)."""

    def __init__(self, *a, **kw):
        self.events = {k: [] for k in FIGURES}
        super().__init__(*a, **kw)
        prefill = self.model.prefill

        def counted_prefill(batch, extra=0):
            tokens = batch["tokens"]
            return self._counted("prefill", [*tokens.shape], prefill, batch, extra)

        self.model.prefill = counted_prefill

    def _counted(self, kind, figures, fn, *args):
        c0 = data_counts()
        out = fn(*args)
        self.events[kind].append([*figures, *(data_counts() - c0)])
        return out

    def _decode_round(self, block):
        return self._counted("round", [self._local_rows, block], super()._decode_round, block)

    def _window_tokens(self, w):
        return self._counted("harvest", [self.rows, w.n_steps], super()._window_tokens, w)

    def _handoff_payload(self, n_new, payload):
        return self._counted("handoff", [n_new], super()._handoff_payload, n_new, payload)

    def _grow_rows(self):
        return self._counted("grow", [2 * self.rows], super()._grow_rows)


def record_grid_engine(out, name, sched, results):
    """``record_engine``, plus the rank's shapes and the logged counts."""

    record_engine(out, name, sched, results)
    pc = sched._pcache
    out[f"{name}/shapes"] = np.asarray(
        [sched.rows, *(pc["len"].shape if pc is not None else (0,)),
         *(pc["kp"].shape if pc is not None else (0,) * 5)])
    out[f"{name}/state_rows"] = np.asarray(
        [pc[k].shape[1] for k in sched.model.state_names] if pc is not None else [], np.int64)
    for kind, rows in sched.events.items():
        out[f"{name}/events/{kind}"] = np.asarray(rows, np.int64).reshape(
            len(rows), FIGURES[kind] + 2 * len(DATA_KEYS))


def scenario_case(grid, ref, out, name, n, seed, disagg, cut, zeros=False):
    """One of ``SCENARIOS`` on ``grid`` (``zeros``: a control, the prefill
    rank hands off zeros)."""

    model, tok = grid_model(grid, ref, "openvla-7b")
    sched = Counted(model, tok, mesh=make_rank_mesh(grid.data, grid),
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


def split_case(grid, ref, out, name, arch, keys, pipelined, n, seed):
    """One of ``SPLIT_SCENARIOS`` on ``grid``: the lanes whole on every
    data rank."""

    model, tok = grid_model(grid, ref, arch)
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

    return x, False


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


def skip_data_reduction(out, p, gathered, dtype):
    """A control: ``moe_lib._finish`` without the data axis's sum (every
    rank alike, so the model axis's collectives still pair)."""

    if gathered:
        n = out.shape[0] // p.dp.size
        out = out.narrow(0, p.dp.rank * n, n)
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
    for name, n, seed, _, disagg, cut in SCENARIOS:
        if GRID_OF[name] == gname:
            scenario_case(grid, ref, out, name, n, seed, disagg, cut)
    if gname == "d1p1":
        name, n, seed, _, _, _ = next(s for s in SCENARIOS if s[0] == "disagg")
        scenario_case(grid, ref, out, f"{name}_zeros", n, seed, True, None, zeros=True)
        cancel_pending_case(grid, ref, out)
    for name, arch, data, model_axis, n, seed, impl in TP_SCENARIOS:
        if name in TP_RUN and (data, model_axis) == (grid.data, grid.model):
            tp_case(grid, ref, out, name, arch, n, seed, impl)
    if (grid.data, grid.model) == (TP_FLEET["data"], TP_FLEET["model"]):
        model, tok = grid_model(grid, ref, "openvla-7b")
        fleet_record(out, "fleet42", serve_fleet(model, tok, mesh=make_rank_mesh(grid.data, grid),
                                                 **TP_FLEET["kw"]))
        reduction_control(grid, ref, out)
    for name, arch, data, model_axis, keys, pipelined, n, seed in SPLIT_SCENARIOS:
        if name in SPLIT_RUN and (data, model_axis) == (grid.data, grid.model):
            split_case(grid, ref, out, name, arch, keys, pipelined, n, seed)
    for lg, arch, impl in LAYER_CASES:
        if lg == gname:
            layer_case(grid, ref, out, gname, arch, impl)
    if gname == "d2m2p1":
        for name, arch, n, seed in PREFILL_RUNS:
            prefill_case(grid, ref, out, name, arch, n, seed)


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
    with np.load(params_path) as z:
        ref = {k: z[k] for k in z.files if k.startswith("params/")}
    assert GRIDS[0][1:] == (world, 1, 0)
    first = dist.init_rank_grid(rank, data=world, backend="gloo", init_method=f"file://{store}",
                                device="cpu")
    out = {}
    for gname, data, model, prefill in GRIDS:
        grid = first if gname == GRIDS[0][0] else dist.rank_grid(data, model, prefill)
        if grid is not None:
            out[f"grid/{gname}"] = np.asarray([grid.d, grid.m, int(grid.is_prefill)])
            grid_cases(gname, grid, ref, out)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_rank_grid(first)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
