"""Dry run of the port: every (arch x input shape x production mesh) laid
out on the meta device, with each device's memory and the three roofline
terms on an H100 (counterpart of ``repro/launch/dryrun.py``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both [--variant optimized] [--out build/dryrun_torch.json]

For each combination the model is built on the meta device (``Model(cfg,
device="meta")``: shapes and dtypes, nothing drawn or allocated; the
optimized variant with ``moe_impl="capacity"``, ``windowed_cache`` and
``cache_cross_kv``), and the step's state is laid out over
``make_production_mesh`` with the kind's rules (``RULE_OVERRIDES``,
``pspec_tree``, ``shard_shape``): the parameters (``param_logical``), the
inputs, AdamW's two bf16 moments for ``train`` and the decode cache for
``decode`` (``cache_logical``).  FLOPs and HBM bytes come from the cost
model (``roofline.costmodel.estimate``), the terms from
``roofline_from_compiled`` on ``HW_H100``.  Records are keyed as the
reference keys them (``arch|shape|pod16x16``, ``...|skip``,
``...|optimized``); ``ok`` records already in ``--out`` are kept unless
``--force``.  Nothing here touches a card.

Where the reference's record differs, and why:
  * the reference compiles each step under GSPMD and reads XLA's
    ``memory_analysis()`` (arguments, outputs and temporaries, less what is
    aliased).  The port compiles nothing: ``mem_per_device_gb`` is the
    largest device's share of the step's arguments plus its outputs less
    what is donated (train: parameters, both moments and the batch;
    prefill: parameters, the batch and the logits; decode: parameters,
    the cache, the tokens and the logits), without temporaries, as
    ``mem_counts`` says, so it is not the reference's quantity;
  * ``xla_cost_flops`` / ``xla_cost_bytes`` (XLA's cost analysis) have no
    counterpart and are left out;
  * the collective term counts what the port's ranks issue, where the
    reference parses GSPMD's HLO: on the mesh's ``model`` axis of M ranks
    each rank is a ``Model(group=...)`` whose collectives are explicit, so
    ``collective_bytes`` is the result bytes of the collectives one rank
    issues in the step (``launch.dist.collective_bytes``: one decode token,
    or a prefill of ``seq_len`` tokens and an enc-dec stack's encoder,
    over the device's data shard of ``global_batch``), and
    ``collective_breakdown`` gives them by op in GB.  Under its ``act_seq``
    / ``kv_seq`` rules (``RULE_OVERRIDES``) GSPMD may place collectives the
    port does not run (its ranks hold whole sequences), so the two terms
    are not the same quantity.  An MoE stack's term adds its experts'
    exchanges over the ``data`` axis of D ranks (``data_all_gather`` /
    ``data_all_reduce``, ``launch.dist.data_collective_bytes``: where the
    batch shards over data, each MoE layer gathers its rows and
    reduce-scatters its float32 mixture over the D ranks; where it does not,
    it all-reduces the mixture; each where the experts spread over data or
    the capacity dispatch needs every row; on the pod mesh the rows shard
    over the 32 (pod, data) ranks, the dense dispatch gathers the rows of
    the pod's 16 data ranks and the capacity dispatch those of all 32, its
    batch group).  The term is modeled from the
    counts, not measured.  It is None, with the reason in ``collective_note``, for a
    stack whose widths do not divide over the model axis
    (``check_model_axis``: starcoder2-3b's 24 heads and xlstm-125m's 4 over
    16 ranks) and for ``train``, since the port runs no training over a
    model axis (``Model.loss_fn`` refuses a rank);
  * ``layout_s``, the seconds the layout took, stands where ``compile_s``
    stood; the port's ``Model`` has no ``causal_skip``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Dict, Tuple

import torch

from repro_torch.configs import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    supports_shape,
)
from repro_torch.launch.dist import (collective_bytes, collectives, data_collective_bytes,
                                     data_collectives)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import make_rules, pspec_tree, shard_shape
from repro_torch.models.model import Model, check_model_axis
from repro_torch.obs.clock import clock
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline import HW_H100, roofline_from_compiled
from repro_torch.roofline.costmodel import VOCAB_PAD, estimate

DRYRUN_ARCHS = tuple(a for a in ARCH_IDS if a != "openvla-7b")

# per-kind logical -> mesh overrides (the reference's)
RULE_OVERRIDES = {
    "train": {"embed": ("data",), "act_seq": ("model",), "kv_seq": ()},
    "prefill": {"embed": (), "act_seq": ("model",), "kv_seq": ()},
    "decode": {"embed": (), "act_seq": (), "kv_seq": ("model",)},
}

MEM_COUNTS = "arguments+outputs-donated; no temporaries"
TRAIN_NO_AXIS = ("train: the port runs no training over a model axis (Model.loss_fn refuses "
                 "a rank), so its ranks issue no collective to count")
META = torch.device("meta")


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return type(tree)(_shapes(v) for v in tree)


def _shard_bytes(tree, specs, mesh) -> int:
    if isinstance(tree, torch.Tensor):
        return math.prod(shard_shape(mesh, tree.shape, specs)) * tree.element_size()
    if isinstance(tree, dict):
        return sum(_shard_bytes(tree[k], specs[k], mesh) for k in tree)
    return sum(_shard_bytes(t, s, mesh) for t, s in zip(tree, specs))


def lay_out(tree, logical, mesh, rules) -> Tuple[object, int]:
    """A tree (dicts, lists) of meta tensors laid out by its logical axes ->
    (its ``PartitionSpec`` tree, one device's bytes).  The divisibility
    guard of ``logical_to_pspec`` shards a dim only evenly, so every device
    holds the same bytes: one shard is the largest."""

    specs = pspec_tree(_shapes(tree), logical, mesh, rules)
    return specs, _shard_bytes(tree, specs, mesh)


def abstract_params(model: Model) -> Dict[str, torch.Tensor]:
    """The model's parameters as meta tensors in the bridge's layout."""

    return {k: torch.empty(shape, dtype=dt, device=META)
            for k, (shape, dt) in model.abstract_params().items()}


def decode_cache(model: Model, batch: int, seq: int) -> Dict[str, object]:
    """The decode state of ``seq`` tokens as meta tensors, keyed as
    ``model.cache_logical``: ``init_cache`` and, on an enc-dec stack, what
    prefill adds over ``seq`` frames (``enc_out``; ``xk`` / ``xv`` with
    ``cache_cross_kv``)."""

    cache = {k: v for k, v in model.init_cache(batch, seq).items() if k != "len"}
    if model.cfg.encoder_decoder:
        z = dict(dtype=model.dtype, device=META)
        cache["enc_out"] = torch.empty((batch, seq, model.cfg.d_model), **z)
        if model.cache_cross_kv:
            cache["xk"], cache["xv"] = (torch.empty((model.n_attn, batch, seq) + model._kv_shape(),
                                                    **z) for _ in range(2))
    return cache


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Meta stand-ins for every model input of ``shape`` -> (tensors,
    their logical axes): the text tokens (a VLM's patch embeddings take
    ``num_modality_tokens`` of the sequence), the frontend embeddings, the
    labels to train; one new token a sequence to decode."""

    b, s = shape.global_batch, shape.seq_len
    is_mm = cfg.modality in ("vision", "audio") and not cfg.encoder_decoder
    s_text = s - (cfg.num_modality_tokens if is_mm else 0)
    out: Dict[str, torch.Tensor] = {}
    logical: Dict[str, Tuple] = {}

    def add(name, shp, names, dtype=torch.long):
        out[name] = torch.empty(shp, dtype=dtype, device=META)
        logical[name] = names

    if shape.kind in ("train", "prefill"):
        add("tokens", (b, s_text), ("batch", None))
        if is_mm:
            add("frontend", (b, cfg.num_modality_tokens, cfg.d_model), ("batch", None, None),
                torch.bfloat16)
        if cfg.encoder_decoder:
            add("frontend", (b, s, cfg.d_model), ("batch", "act_seq", None), torch.bfloat16)
        if shape.kind == "train":
            add("labels", (b, s_text), ("batch", None))
    else:
        add("tokens", (b, 1), ("batch", None))
    return out, logical


def collective_term(cfg: ModelConfig, shape: InputShape, mesh, rules, moe_impl: str = "dense"):
    """The result bytes of the collectives one rank of the mesh issues in
    the step, by op: the ``model`` axis's (``launch.dist.collective_bytes``)
    and an MoE stack's experts' over the ``data`` axis
    (``data_collective_bytes``, as ``data_all_gather`` / ``data_all_reduce``)
    -> (bytes by op, or None; what was counted, or why nothing was)."""

    ranks = int(mesh.shape.get("model", 1))
    if shape.kind == "train":
        return None, TRAIN_NO_AXIS
    try:
        check_model_axis(cfg, ranks)
    except NotImplementedError as e:
        return None, str(e)
    inputs, logical = input_specs(cfg, shape)
    specs = lay_out(inputs, logical, mesh, rules)[0]
    rows = shard_shape(mesh, inputs["tokens"].shape, specs["tokens"])[0]
    prompt = 1 if shape.kind == "decode" else shape.seq_len
    frontend = (cfg.num_modality_tokens if prompt > 1 and "frontend" in inputs
                and not cfg.encoder_decoder else 0)
    by_op = collective_bytes(cfg, rows, prompt, ranks, frontend=frontend)
    n = collectives(cfg, prompt)
    step = "one decode token" if prompt == 1 else f"a prefill of {prompt} tokens"
    note = (f"counted: {n['all_reduce']} all-reduces and {n['all_gather']} all-gathers "
            f"a rank issues for {step} of {rows} rows over {ranks} ranks")
    data = int(mesh.shape.get("data", 1))
    batch = int(mesh.shape.get("pod", 1)) * data
    sharded = rows < shape.global_batch
    nd = data_collectives(cfg, data, sharded=sharded, moe_impl=moe_impl)
    if nd["all_reduce"] or nd["all_gather"]:
        db = data_collective_bytes(cfg, rows, prompt, data, sharded=sharded, moe_impl=moe_impl,
                                   batch=batch)
        by_op.update({f"data_{k}": v for k, v in db.items() if k != "broadcast"})
        note += (f"; its experts over {data} data ranks, the rows "
                 f"{'sharded' if sharded else 'replicated'}: {nd['all_gather']} all-gathers "
                 f"and {nd['all_reduce']} all-reduces")
        if batch > data and sharded and moe_impl == "capacity":
            note += f" (the capacity table's rows gathered over the {batch} (pod, data) ranks)"
    return by_op, note


def model_flops_for(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def run_combo(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
              variant: str = "baseline") -> Dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.devices.size
    opt = variant == "optimized"
    t0 = clock()
    model = Model(cfg, device=META, moe_impl="capacity" if opt else "dense",
                  windowed_cache=opt, cache_cross_kv=opt)
    rules = make_rules(mesh, RULE_OVERRIDES[shape.kind])
    params, plogical = abstract_params(model), model.param_logical()
    b, s = shape.global_batch, shape.seq_len
    parts = {"params": lay_out(params, plogical, mesh, rules)[1],
             "inputs": lay_out(*input_specs(cfg, shape), mesh, rules)[1]}
    if shape.kind == "train":
        state = adamw_init(params, AdamWConfig(moment_dtype="bfloat16"))
        parts["moments"] = sum(lay_out(m, plogical, mesh, rules)[1] for m in (state.m, state.v))
    else:
        vpad = -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD
        logits = torch.empty((b, 1, vpad), dtype=model.dtype, device=META)
        parts["logits"] = lay_out(logits, ("batch", None, "vocab"), mesh, rules)[1]
    if shape.kind == "decode":
        parts["cache"] = lay_out(decode_cache(model, b, s), model.cache_logical(b, s), mesh,
                                 rules)[1]
    mem_bytes = sum(parts.values())
    est = estimate(cfg, shape, optimized=opt)
    coll, note = collective_term(cfg, shape, mesh, rules, model.moe_impl)
    terms = roofline_from_compiled(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips, flops=est.flops,
        bytes_accessed=est.hbm_bytes,
        collective_bytes=None if coll is None else float(sum(coll.values())),
        model_flops=est.flops_model, mem_per_device_bytes=mem_bytes, hw=HW_H100,
    )
    rec = terms.as_dict()
    rec.update(
        collective_breakdown=None if coll is None else {
            **{k: v / 1e9 for k, v in coll.items()}, "total": sum(coll.values()) / 1e9},
        collective_note=note,
        layout_s=round(clock() - t0, 3),
        mem_counts=MEM_COUNTS,
        mem_parts_gb={k: v / 1e9 for k, v in parts.items()},
        hw=HW_H100.name,
        variant=variant,
        status="ok",
    )
    if verbose:
        print(f"--- {arch} x {shape_name} x {mesh_name} ---")
        print("per device: " + " ".join(f"{k}={v / 1e9:.3f}GB" for k, v in parts.items())
              + f" ({MEM_COUNTS})")
        coll_s = "None" if terms.collective_s is None else f"{terms.collective_s:.4f}s"
        print(f"roofline [{HW_H100.name}]: compute={terms.compute_s:.4f}s "
              f"memory={terms.memory_s:.4f}s collective={coll_s} (modeled from the ranks' "
              f"counts, not measured) bottleneck={terms.bottleneck} "
              f"useful={terms.useful_ratio:.3f} mem/dev={terms.mem_per_device_gb:.2f}GB")
        print(f"collectives: {note}")
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    p.add_argument("--out", default="build/dryrun_torch.json")
    p.add_argument("--variant", choices=["baseline", "optimized"], default="baseline")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    archs = DRYRUN_ARCHS if args.arch == "all" else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.shape == "all" else (args.shape,)
    pods = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]

    # earlier records are always loaded; --force only bypasses the cache
    results: Dict[str, Dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not supports_shape(cfg, INPUT_SHAPES[shape_name]):
                results[f"{arch}|{shape_name}|skip"] = {
                    "status": "skip",
                    "reason": "full-attention arch: long_500k needs sub-quadratic decode"}
                continue
            for multi_pod in pods:
                key = f"{arch}|{shape_name}|{'pod2x16x16' if multi_pod else 'pod16x16'}"
                if args.variant != "baseline":
                    key += f"|{args.variant}"
                if key in results and results[key].get("status") == "ok" and not args.force:
                    print(f"cached: {key}")
                    continue
                try:
                    results[key] = run_combo(arch, shape_name, multi_pod, variant=args.variant)
                except Exception as e:  # noqa: BLE001 - record the failure and go on
                    traceback.print_exc()
                    results[key] = {"status": "fail", "error": str(e)[:2000]}
                    failures.append(key)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    print(f"\n{n_ok} ok / {len(results)} recorded; failures: {failures}")
    return results


if __name__ == "__main__":
    main()
