"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: ``python3 chip_smoke.py``.

Phases, in order; any failure exits nonzero and prints no result line:

1. environment: the card's name and power limit, the PyTorch and CUDA
   versions; TF32 is switched off for float32 matmuls and convolutions;
2. build: the seven kernel sources in ``src/repro_torch/csrc/`` (three
   attention kernels, the Mamba scan, the monitor statistics, and the two
   training backwards, flash attention's and the Mamba scan's), one nvcc
   each, in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   inputs (numpy, seeded, or a fleet's episodes), at the main paths' shapes
   and at harder ones, with times: the kernel, the plain version, one
   PyTorch library call of the same function where one exists (a yardstick
   the port never calls) and the least time the card could take (the
   bound); the three attention kernels also at each stack of ``NEW_ARCHS``'
   and ``MOE_ARCHS``' shapes (its heads, KV heads, head dim, window and
   softcap; qwen3-moe's G = 16, phi3.5-moe's G = 4): prompt 14,
   decode length 70, the scheduler's 32 ragged rows, phi-3-vision's 590
   and gemma2-9b's 4608-token prompt and 4664-token decode; and at
   seamless-m4t-medium's (H = KV = 16, D = 64): its decoder's prompt, its
   encoder over 300 frames (non-causal), decode at length 70 (dense and
   paged) and its cross-attention decode over the 300 frames, the same
   at phase 7e's rank (H = KV = 8; the round's 32 rows); the paged
   and flash kernels also at a model-axis rank's shape (phase 7c: H = KV =
   16, the round's 32 rows and the prompt's S = 14, and the decode kernel
   at length 70 for its split runs; phase 7d's Jamba: H = 32, KV = 4),
   the Mamba scan at phase 7d's rank's 128 heads (S = 14) and
   at Jamba's training shape with the chunk states (the forward of the
   training pair);
4. model: for each served stack, its smoke size in float32 on the card
   against the same weights on the CPU (plain versions; ``CloudPolicy``
   chunks and a scheduler run whose decode rounds are CUDA graphs), then
   the stack at full width in bf16 serving one robot's closed loop with
   ``serve_episode`` twice, dense and paged (``CloudPolicy`` replaying its
   CUDA graphs), with the kernels' launch counts read around each run and
   the two runs' chunks held to the greedy-margin rule; ``CloudPolicy``'s
   graphs against the same chunks run eagerly (tokens equal, cloud_ms of
   both); one profiled graph chunk a mode: openvla-7b cut to its first
   ``OPENVLA_LAYERS`` = 8 layers, then
   jamba-1.5-large-398b cut to its first 4 layers (mamba+MLP, mamba+MoE,
   mamba+MLP, attn+MoE; ~46 GB); then the five dense attention stacks of
   ``NEW_ARCHS`` at full width, depth cut to ``NEW_ARCH_LAYERS`` (gemma-7b,
   gemma2-9b, h2o-danube-3-4b, starcoder2-3b, phi-3-vision-4.2b), each with its
   figures (cloud_ms graph and eager, busy share, launches a chunk) beside
   its weight-read floor, its scheduler run (a) at R = 4, and, for
   gemma2-9b, a 4608-token prompt decoded dense and paged (greedy-margin
   rule; the kernels held to their plain versions on the arguments of one
   local and one global layer), for phi-3-vision a prefill with 576 stub
   patch embeddings (its flash call at S = 590 held the same way); then
   the monitor path:
   ``ops.rolling_stats`` over a fleet's bank of 1024 episode streams, held
   against the port's ``run_trigger`` scores; then the dispatcher:
   ``run_episode`` (Algorithm 1) over the same bank with each robot's
   cloud and edge-policy chunks, in cloud and edge modes, its decisions
   equal to the decision core's ``rollout``, every field bitwise equal to
   a tick loop of ``dispatcher_step``, the first 8 robots held to a CPU
   run (equal up to a decision within 1e-5 of its threshold), no hand
   kernel launched, with its ms a tick; then the MoE stacks of
   ``MOE_ARCHS`` at published widths, depth cut to fit the card
   (qwen3-moe-235b-a22b 2 layers, phi3.5-moe-42b-a6.6b 4): the f32 smoke
   twins card vs CPU under ``Model(moe_impl=...)`` "dense" and "capacity",
   then one set of bf16 weights served under both dispatches (``moe_twin``),
   dense and paged, graph and eager, each held as the dense stacks are, one
   profiled graph chunk each; the capacity dispatch uncapped (``cf = E /
   k``) against the dense one by the greedy-margin rule, the default
   factor's prefill drops counted; cloud_ms beside two weight-read floors
   (every expert read, the active experts only); then xlstm-125m at full
   depth (12 mLSTM / sLSTM blocks, no attention layer, so no hand-kernel
   launch: its f32 smoke twin card vs CPU, the closed loop dense and paged
   with equal chunks, graph vs eager, one profile, scheduler (a) at R = 4,
   ``PartitionedPolicy`` at cut 6), and seamless-m4t-medium at full depth
   (12 encoder + 12 decoder layers): its f32 smoke twin card vs CPU, then
   a prompt of 14 tokens and 300 stub frames through ``Model.prefill`` and
   ``decode_chunk`` in four modes (dense or paged cache x cross K/V
   projected each token or cached at prefill), exact launches, the four
   held to one another by the greedy-margin rule, each chunk as a CUDA
   graph against eager beside its weight-read floor;
5. scheduler, on the same full-width model before it is freed: the
   continuous-batching scheduler through ``submit`` / ``submit_batch``,
   ``step``, ``cancel_batch`` and ``drain``, its decode rounds replayed as
   CUDA graphs.  openvla-7b: (a) parity, 8 robots staggered at
   ``scan_rounds`` 1 and 4, each chunk held to ``CloudPolicy(paged=True)``
   by the greedy-margin rule; (b) load, 64 robots arriving 4 a round,
   admission bounded by pages at 32 resident sequences, 6 cancels (3
   queued, 3 mid-window), run cold and warm, with tokens/s, latency and
   queue-wait percentiles, pool, window, graph and admission numbers, then
   all 64 at once (admission bounded by pages at 32 resident), and one
   profiled window.  Jamba: (a) at ``scan_rounds=4``.  Every run's
   launch counts are checked exactly, graph replays included.  The MoE
   stacks: (a) on the capacity dispatch at R = 4, 8 robots, cold and warm,
   tokens/s and chunk latency percentiles (their tokens are held card
   against CPU by the f32 smoke twin of phase 4);
6. fleet, on openvla-7b at full width, depth cut to its first
   ``FLEET_LAYERS`` = 4 layers (run between its phase 5 and Jamba's phase
   4): (a) f32 openvla-smoke, the same weights on the
   card and on the CPU, ``serve_fleet(trigger="rapid")`` with 8 robots, R =
   4, both ticks: decision streams, telemetry, rounds, cancels and latency
   draws equal, chunks equal or inside the f32 greedy margin, a differing
   decision only within 1e-5 (relative) of its threshold; (b) full width,
   16 robots, R = 4, ``max_slots=8``, with ``Observability``: rapid cold (a
   new scheduler, its round graph captured on the way), rapid warm (the
   same scheduler, reset), the legacy tick and the decision core on the
   model's stream (a contrast; both equal to the warm run) and ``always``,
   each with offloads, cancels, tokens/s, latency and
   queue-wait percentiles, the wall split per tick (decision core, engine
   at a window close and inside a window, host) and exact launch counts;
   (c) ``serve_trace``, 64 robots x 240 ticks, ``max_slots=16``, Poisson
   arrivals with churn and bursty arrivals, its SLO report, pages all back
   after a drain; (d) the offline engine's six strategies, the decision
   core on the card against the CPU.  Fleet runs last 300 ticks: the
   episodes' first contact phases start at tick 220-260;
7. partition, the edge-cloud split (``repro_torch.partition``), run after
   openvla-7b's phase 6 on the same 4-layer model and after Jamba's phase 5: (a)
   f32 smoke twins, card vs CPU on the same weights: ``PartitionedPolicy``
   at every cut of openvla-smoke and jamba-smoke's cut 2 with the experts
   of layer 1 cloud-side against its plain cut-2 lane (chunks equal to
   ``CloudPolicy``'s or inside the f32 margin), and ``serve_fleet(trigger=
   "rapid")`` with 8 robots at cuts {0, 1, 2}, R = 4 (decisions, counters,
   rounds, ``mixed_rounds``, ``hetero_rounds`` equal); (b) openvla-7b at
   full width (4 layers): ``PartitionedPolicy`` at cuts 0, 2 and 4 (graph
   equal to eager, greedy-margin rule against ``CloudPolicy``, cloud_ms beside
   ``CloudPolicy``'s and the modeled channel ms), a heterogeneous fleet of
   16 robots x 300 ticks (4 cloud-only, 4 each at cuts 0, 1, 2), R = 4,
   ``max_slots=8``, pipelined, cold and warm, with ``Observability``
   (tokens/s, latency, fused windows, per-leg channel bytes, graph
   captures, pages back after a drain; each lane's buffers freed each time
   it empties, the most it held, no buffer or pool left after a drain),
   and 4 robots through serial and
   pipelined lanes (tokens equal or inside the margin); (c) Jamba: an
   expert-offload lane and a plain cut-2 lane with cloud-only robots in
   one scheduler, chunks held to ``CloudPolicy(paged=True)``; (xLSTM)
   ``PartitionedPolicy`` on xlstm-125m at cut 6 of 12.  Every run's
   launch counts are derived from what it dispatched (``SplitLedger``) and
   checked exactly;
7b. data shards and disaggregated prefill (``launch/mesh.py``, the
   scheduler's ``mesh`` and ``prefill_group``), on the same 4-layer model
   after phase 7, every shard on the card: (a) f32 openvla-smoke card vs
   CPU, a mesh of ``SHARDS`` = 2 data shards with disaggregated prefill, 8
   robots staggered, R = 4 (admitted and completed rounds equal, chunks
   equal or inside the f32 margin, every shard drained); (b) full width,
   16 robots, 2 new at each boundary, R = 4, ``max_slots=8``, in four
   modes (base, data=2, disaggregated, both), cold and warm: tokens/s,
   chunk latency, per-shard high water, exact launches (a sharded round
   launches the paged kernel twice a layer a token), each mode's chunks
   held to base's by the greedy-margin rule; (c) two new robots at every
   boundary for 12 windows without and with disaggregation, the mean host
   ms a window, then one profiled window: the prefill's flash kernels on
   another stream than the round graph's paged kernels, and how long the
   two streams overlapped; (d) ``python -m repro_torch.launch.serve
   --fleet 4 --sharded --disaggregate-prefill`` exits 0;
7c. the mesh's model axis (``launch/dist.py``, ``make_rank_mesh``,
   ``Model(group=...)``), on the same 4-layer model after phase 7b:
   ``MODEL_AXIS`` = 2 tensor-parallel ranks, each a process of its own
   (gloo with both on card 0 where there is one card, since NCCL takes no
   two ranks on one card; NCCL one rank a card where there are two), the
   backend printed; each rank builds openvla-7b at full width on 4 layers
   from the phase-6 model's seed and checks every parameter block against
   the parent's tensor (shared from the parent's card), then serves
   ``serve_fleet(trigger="rapid")`` on 8 robots x ``AXIS_TICKS`` = 221
   over a rank mesh (the bootstrap fetches, the first trigger fires and
   the first cancels); the ranks equal to each other, their chunks held to
   the one-rank model's same run by the greedy-margin rule, rounds,
   offloads, cancels and the rest of the actions equal, the first
   prefill's logits within ``TP_LOGIT_TOL`` and a rank that skips the
   attention output's all-reduce in every layer outside it; launches exact
   (one paged launch a layer a decode step at 16 heads and 16 KV heads),
   the collectives a decode token exact (2 all-reduces a layer, one for
   the embedding, one all-gather of the logits); each rank's weight and
   pool bytes and engine ms a round beside the one rank's, timed warm
   after the ranks' join; then RAPID's split on the ranks: a staggered
   scheduler run of 4 robots at R = 4, robots 1 and 3 on a pipelined lane
   at ``AXIS_SPLIT_CUT`` = 2, and one ``PartitionedPolicy`` chunk at cut 2
   (56 ping-pong tokens, eager under gloo), held to the one rank's same
   runs: chunks by the greedy-margin rule, the lane's first prefill logits
   and the first ping-pong token's within ``TP_LOGIT_TOL``, a rank whose
   edge token embedding skips its all-reduce outside it, launches exact at
   the rank's heads (flash, decode and paged at 16 heads and 16 KV heads),
   the collectives exactly ``launch.dist``'s counts, the lane's buffers
   freed; ms a mixed round and a ping-pong token and the suffix pools'
   bytes beside the one rank's (warm, after the join); the ranks joined
   within ``RANKS_TIMEOUT_S``;
7d. MoE and Mamba layers on the model axis, after Jamba's phases 5 and 7:
   the one-rank Jamba (4 layers at full width) records the first prompt's
   logits and routes, a staggered scheduler run of ``JAMBA_AXIS_ROBOTS`` =
   8 robots at R = 4 (its dense dispatch), itself teacher-forced along
   those chunks (top-two gaps and routes) and an exact digest of every
   rank's block of every parameter, and is freed (it and two ranks do not
   fit on one card); then ``MODEL_AXIS`` = 2 ranks (as in 7c) each build
   Jamba from the same seed, hold every block's digest to the parent's (a
   block with one element changed must fail it), run the same prefill,
   the two controls (a rank that skips the Mamba ``out_proj`` all-reduce,
   one that skips the MoE all-reduce) and the same scheduler run over a
   rank mesh: the ranks equal to each other (routes of every MoE call of
   the prefill included), their chunks held to the one rank's by the
   greedy-margin rule with routing near-ties (the one rank's top-two gap
   at the first differing step, or its router gap where the two paths'
   routes first part), the first prefill's tokens routed as the one
   rank's or otherwise only at a router gap within ``MARGIN_TOL``, its
   logits with the one rank's routes (``ForcedRoutes``) within
   ``TP_LOGIT_TOL`` and both controls (with those routes) outside it,
   launches exact (one paged launch an attention layer a decode step at
   32 heads and 4 KV heads, one Mamba scan a Mamba layer a prefill at 128
   heads), the collectives exact (12 all-reduces and 1 all-gather a
   decode token or a prefill); each rank's weight, Mamba-state and pool
   bytes and ms a round beside the one rank's; the ranks joined within
   ``JAMBA_RANKS_TIMEOUT_S``;
7e. xLSTM and the encoder-decoder stack on the model axis, after
   seamless-m4t-medium's phase 4: the one-rank xlstm-125m and
   seamless-m4t-medium (full width and depth, phase 4's seed) record the
   xLSTM's first prompt, a staggered scheduler run of ``XE_ROBOTS`` = 4
   robots at R = 4 and seamless's prompt of 14 tokens and 300 stub frames
   through ``prefill`` and an ``XE_STEPS`` = 16-token ``decode_chunk`` in
   two modes (paged with the cross K/V cached, dense projecting them each
   token), and the digest of every rank's block of every parameter; then
   ``MODEL_AXIS`` = 2 ranks (as in 7c) build both stacks from the same
   seed, their blocks' digests equal to the parent's, and run the same
   and two controls (a rank that skips the sLSTM's h all-gather, one that
   skips the cross-attention's ``wo`` all-reduce): the ranks equal to each
   other, the xLSTM's chunks and seamless's tokens held to the one rank's
   by the greedy-margin rule, the logits (over the real vocab; the padded
   ids masked) within ``TP_LOGIT_TOL`` and both controls outside it,
   launches exact (none for the xLSTM; flash, decode and paged at H = KV =
   8), the collectives exact (26 and 38 a decode token); each rank's
   weight, mLSTM and sLSTM state and cross-K/V bytes and ms a round or a
   token beside the one rank's; the ranks joined within
   ``XE_RANKS_TIMEOUT_S``;
7f. data shards and the prefill as ranks of their own (``launch.dist``
   ``init_rank_grid``, ``make_rank_mesh`` over a ``RankGrid``), after 7c
   on the same 4-layer model: ``DATA_RANKS`` = 2 data ranks and a prefill
   rank, each a process of its own, gloo on card 0; every rank builds
   openvla-7b from the phase-6 seed (every parameter equal to the
   parent's); (a) the rapid fleet of 7c (8 robots x ``AXIS_TICKS``) on the
   two data ranks, each decoding its block of the rows (its paged launches
   over 4 rows, the rounds CUDA graphs: no data-axis collective inside
   them), (b) the same with the prefill rank, which prefills each
   boundary's admissions and hands their K/V and logits to the decode
   ranks at the next; each held to one process's same run over a
   one-device ``(data 2)`` mesh (without and with ``prefill_group``):
   chunks, order, actions, offloads, cancels, reservations and
   ``PoolStats`` equal, launches exact, the data axis's collectives
   exactly ``launch.dist``'s counts, each handoff's bytes the reckoning's
   (n x 917,504 B of K/V plus n x 2 x ``vocab_padded`` B of logits at the
   bucket n); ms a round beside one process's; (c) phi3.5-moe at
   ``PHI35_DATA_LAYERS`` = 2 layers with its 16 experts spread over the two
   data ranks (8 a rank: 1,258,291,200 B a layer against 2,516,582,400 for
   one process, every block the parent's slice), 4 robots staggered at R
   = 4, held to one process with every expert as 7d holds Jamba (chunks by
   the greedy-margin rule and routing near-ties, the first prompt's logits
   with the one process's routes within ``TP_LOGIT_TOL``), a rank that
   skips the MoE's data-axis sum caught, the collectives exact;
8. train (``repro_torch.launch.train``): (a) the flash backward kernel
   (``csrc/flash_attention_bwd.cu``) and the forward's log-sum-exp against
   their plain versions at the training shapes (openvla-7b's B = 4, S =
   256 in bf16 and float32, qwen3-moe's G = 16, gemma2-9b's heads with
   softcap 50 and window 256 at S = 1024, a ragged S = 300, seamless's
   non-causal heads), timed as phase 3 times a kernel, beside the backward
   of ``F.scaled_dot_product_attention`` through autograd (the yardstick),
   held to the plain version under ``BWD_TOL`` (bf16: the bound of the
   kernel's rounding of P and dS) and to the float64 truth beside the plain
   version's and SDPA's distances, each case's plan (splits, grids) logged;
   then the Mamba scan backward kernel (``csrc/mamba_scan_bwd.cu``) against
   its plain version in float64, every gradient under ``MAMBA_BWD_TOL`` (a
   share of each element's sum of absolute terms), a rerun bitwise equal,
   at Jamba's training shape (B = 2, S = 1024, H = 256, 4 chunks), one
   chunk, with h0 and dh_t, jamba-smoke's H = 8, a large dt and a ragged
   small shape, timed as phase 3 times a kernel, beside its float32 and its
   tensor-core (3xTF32) bounds, and its main case's device time split by
   launch (state, chunk, reduce) under torch.profiler, in a process of its
   own;
   (b) f32 smoke twins, card against CPU on the same weights: the loss and
   every gradient of openvla-smoke, xlstm-smoke and jamba-smoke (S = 512,
   two chunks; its experts in layers 1 and 3), then one AdamW update on the
   same (the card's) gradients;
   (c) openvla-7b at full width and depth (32 layers, bf16, AdamW with bf16
   moments), ``TRAIN_STEPS`` steps of ``make_train_step`` on episode
   batches of B = 4, S = 256, then Jamba at full width, its first
   ``JAMBA_TRAIN_LAYERS`` = 4 layers (mamba, mamba, mamba, attn) with dense
   MLPs, ``JAMBA_TRAIN_STEPS`` steps of B = 2, S = 1024: finite, falling
   losses, step ms, tokens/s, peak memory, the share of the bf16 peak,
   exact launches (Jamba: 3 Mamba scans forward and backward and one flash
   forward and backward a step), the forward / backward / AdamW split; (d)
   xlstm-125m through ``launch.train.main`` on the card, its loss falling,
   and its npz checkpoint round-tripped;
8b. dry run, roofline and examples: (a) ``python -m
   repro_torch.launch.dryrun --arch all --shape all --mesh both`` for both
   variants (every arch but openvla-7b, shape and production mesh laid out
   on the meta device; 136 ok, 6 skip, 0 fail records), the same in this
   process, where the card's allocated bytes and peak must not move; each
   record's compute and memory seconds on ``HW_H100`` and GB a device;
   (b) ``estimate``'s memory term of openvla-7b decode at kv length 70
   over 56 tokens beside ``weight_floor_ms``, the gap held to the untied
   embedding table; (c) ``examples/quickstart_torch.py`` and
   ``examples/ecc_serving_torch.py`` (``--fleet 4 --trigger rapid
   --scan-rounds 4``, ``--fleet 8 --arrivals poisson``, ``--fleet 4
   --partition auto --network lan`` and one robot) on the card, side by
   side, each exiting 0, the fleets having launched the flash and paged
   kernels and the one robot the flash and dense decode kernels;
9. the result: a ``{"kernels": [...]}`` line and, last, the device line.

Phase 3 times each kernel three ways: ``ms`` (CUDA events around calls
issued back to back, so at least the host's cost of a call), ``device_ms``
(the calls captured in a CUDA graph and replayed: the device's own time)
and ``host_us`` (the host clock around calls with no synchronise: the
launcher's cost), and the library yardstick the same ways.

Each phase prints the seconds it took.  Needs one CUDA card; takes no
arguments.  ``--kernels-only`` stops after
phase 3 and prints no result line (a short call for kernel work);
``--train-only`` runs phases 1, 2 and 8 and prints no result line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import latest_checkpoint, restore  # noqa: E402
from repro_torch.checkpoint.bridge import reference_tensors  # noqa: E402
from repro_torch.configs import InputShape, get_config, get_smoke_config  # noqa: E402
from repro_torch.core import dispatcher_init, dispatcher_step, run_episode  # noqa: E402
from repro_torch.core import kinematics as kin  # noqa: E402
from repro_torch.core.dispatcher import DispatcherConfig, _leaves  # noqa: E402
from repro_torch.core.trigger import TriggerConfig, run_trigger  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    EpisodeTokenizer,
    TokenBatchIterator,
    episode_dataset,
)
from repro_torch.kernels import _lib, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kfab  # noqa: E402
from repro_torch.kernels import mamba_scan as kms  # noqa: E402
from repro_torch.kernels import mamba_scan_bwd as kmsb  # noqa: E402
from repro_torch.kernels import paged_attention as kpa  # noqa: E402
from repro_torch.kernels import rolling_stats as krs  # noqa: E402
from repro_torch.launch import dist, dryrun  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_rank_mesh, make_test_mesh  # noqa: E402
from repro_torch.launch.serve import CloudPolicy, serve_episode, serve_fleet  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import make_train_step, trainable_params  # noqa: E402
from repro_torch.models import layers as layers_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models import xlstm as xlstm_lib  # noqa: E402
from repro_torch.models.layers import block_of, global_shape  # noqa: E402
from repro_torch.models.model import MOE_IMPLS, STATE_NAMES, Model  # noqa: E402
from repro_torch.obs import Observability, build_slo_report  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.partition import PartitionedPolicy, PartitionExecutor  # noqa: E402
from repro_torch.partition import executor as executor_lib  # noqa: E402
from repro_torch.robotics.episodes import (  # noqa: E402
    edge_policy_chunks,
    generate_episode,
    reference_chunks,
)
from repro_torch.roofline import HW_H100  # noqa: E402
from repro_torch.roofline.costmodel import _decode_cache_bytes, estimate  # noqa: E402
from repro_torch.runtime.engine import (  # noqa: E402
    STRATEGIES,
    EngineConfig,
    episode_suite,
    evaluate_strategy,
    rapid_trigger_stream,
)
from repro_torch.runtime.fleet import make_trace, serve_trace  # noqa: E402
from repro_torch.runtime.policy import (  # noqa: E402
    DecisionCore,
    PolicyConfig,
    fleet_policy_config,
    rollout,
)
from repro_torch.runtime.graphs import GraphedCall  # noqa: E402
from repro_torch.runtime.kv_cache import PagedSpec  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and flop/s by input type
# (bf16 on the tensor cores, ``roofline.HW_H100``; float32 outside them)
HBM_BPS = HW_H100.hbm_bw
PEAK_FLOPS = {torch.bfloat16: HW_H100.peak_flops, torch.float32: 67e12}
# the tensor cores' dense TF32 rate; a 3xTF32 product takes three of its
# multiplies a float32 one (the scan backward's second bound)
TF32_FLOPS = 495e12
# float32: the same math summed in another order.  bf16: each output is a
# weighted mean of standard-normal v rows, so |out| reaches ~3 where a row
# sees few keys (the first rows of a prefill) and ~0.2 over 70+ keys.  The
# plain versions keep the probabilities in float32 (ref.py); the bf16
# kernels differ: the flash kernel rounds its unnormalised probabilities to
# bf16 before P.V on the tensor cores, as the model's attention rounds its
# probabilities to the value dtype (repro/models/attention.py:110), and the
# decode kernels keep them in float32.  Both sides round the output to bf16
# once.  So the two may differ by a bf16 step at |out| (2^-8 at 0.5-1, the
# 0.0039 that flash S=300 showed) plus the probability rounding, at most
# 2^-9 * max|v| ~ 0.009 and far less where signs cancel.  2e-2 holds a step
# plus that worst case up to |out| 2, and a step alone up to |out| 4; a
# limit of 1e-3 would fail the one-step difference seen at S=300.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 0.0)}
# mamba_scan is held against its plain version evaluated in float64 (the
# kernel keeps its prefix sums in float64; a float32 plain version carries
# ~1e-4 relative error on the decay factors of fast heads, where the prefix
# sums reach ~-10^3): atol 5e-4, rtol 5e-3, the JAX package's tolerance for
# its own kernel (tests/test_kernels.py:147-148).
MAMBA_TOL = (5e-4, 5e-3)
# mamba_scan_bwd is held against its plain version evaluated in float64 on
# the same inputs (h_in from the forward kernel): each output element within
# 1e-30 (values past float32's range, which the kernel flushes to 0: a
# chunk's decay at a large dt) plus 2^-14 of its sum of absolute terms
# (``mamba_bwd_abs_terms``: the plain arithmetic on |values|, dcum's
# differences taken as sums).  The kernel sums in float32 over up to 256
# steps a chunk and over the heads (dB, dC); the emulation of its algorithm
# (tests/test_torch_mamba_bwd_tiles.py) came within 2e-6 of the terms on the
# CPU, and the float32 plain version within 2.6e-4 (its float32 prefix sums;
# the kernel's are float64, as the forward's).
MAMBA_BWD_TOL = (1e-30, 2.0**-14)
# rolling_stats: the JAX package's tolerances (tests/test_kernels.py:88-90):
# scores 5e-4, the moving average 5e-5 — the kernel's incremental window
# sums drift from the plain version's recomputed ones.  On episode streams
# the torque power spikes to ~1e6 at contacts, and a running window sum
# keeps rounding errors of the largest value it held (~ulp(1e6) = 0.06)
# after the spike leaves the window: there the moving average's error is
# held to 5e-5 of its stream's peak instead of its current value.
STATS_TOL = (5e-4, 5e-4, 5e-5)
# greedy-margin rule for the bf16 runs: two paths' tokens may differ only
# where the reference path's top-two logit gap is at most this (logits are
# O(1); 0.1 is ~13 bf16 steps there)
MARGIN_TOL = 0.1
# The new stacks' capped cases draw q at this scale: scores (q.k / sqrt(D),
# k ~ N(0, 1)) then spread with a deviation of 30, and the cap of 50 moves
# the large ones (60 becomes 41.7, 100 becomes 48.2), so the softmax leans
# on a few keys, |out| is O(1), and a kernel that dropped the cap (or, past
# the window, the window) misses by far more than the limits below: each
# such case also holds the kernel against the plain version run without
# it, which must disagree.
CAP_Q_SCALE = 30.0
# The new stacks' cases, and the arguments captured from the long and the
# frontend prompt, are held besides TOL to a limit on each output row's
# scale: 1e-4 + 2^-6 * max|row|, four bf16 steps at the row's largest
# value (one step from the final rounding of either side, plus the flash
# kernel's bf16 probabilities, at most 2^-9 of the weighted |v|).
ROW_TOL = (1e-4, 0.0, 2.0**-6)
# control ticks per served episode: the 64-tick trigger warm-up and 56 more
STEPS = 120
# the stacks of NEW_ARCHS: 70 ticks (the warm-up and 6 more, 9 chunks)
NEW_STEPS = 70
# control ticks of a fleet run: the episodes' first contact phases start at
# tick 220-260, so 120 ticks would see only the 16 bootstrap fetches and no
# trigger fire or cancel
FLEET_TICKS = 300
# a decision (float32 kinematic z-scores) may differ between the card and the
# CPU only at a tick whose trigger term lies within this (relative) of its
# threshold; the f32 greedy margin of the port's scheduler tests
DECISION_RTOL = 1e-5
F32_MARGIN = 1e-4
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
    "decode_attention": "src/repro/kernels/decode_attention.py:87",
    "paged_attention": "src/repro/kernels/paged_attention.py:100",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:85",
    "rolling_stats": "src/repro/kernels/rolling_stats.py:104",
    # port-only kernels: the reference's training backward is the jnp
    # custom VJP strip_bwd, which has no Pallas kernel, and XLA's autodiff
    # of ssd_chunked
    "flash_attention_bwd": "src/repro/models/attention.py:261",
    "mamba_scan_bwd": "src/repro/models/ssm.py:94",
}
JAMBA = "jamba-1.5-large-398b"
# the dense attention stacks served at full width after openvla-7b
NEW_ARCHS = ("gemma-7b", "gemma2-9b", "h2o-danube-3-4b", "starcoder2-3b", "phi-3-vision-4.2b")
# their depth (the time limit): the first 2 layers at published widths
# (gemma2-9b: 1 local, 1 global); their figures at 4 layers and at full
# depth are in PERF.md, section 5
NEW_ARCH_LAYERS = 2
JAMBA_LAYERS = 4  # the first 4 layers of the real pattern: ~46 GB of bf16 weights
# the MoE stacks at published widths, depth cut: PR 20 ran 14 and 28
# layers (67.2 and 68.3 GiB, the most one 80 GB card held beside the
# caches and graph pools; their figures are in PERF.md, sections 5-6);
# then 7 and 14 (the xLSTM and enc-dec stacks), 4 and 7 (the train
# phase), now 2 and 4 (phase 7d, within the time limit)
QWEN3_LAYERS = 2   # (437.9 GiB of bf16 weights at the published 94 layers)
PHI35_LAYERS = 4   # (78.0 GiB at the published 32)
MOE_ARCHS = {"qwen3-moe-235b-a22b": QWEN3_LAYERS, "phi3.5-moe-42b-a6.6b": PHI35_LAYERS}
MIN_FREE_GIB = 6.0  # free device memory a MoE stack must leave after loading
# the MoE stacks' brief mode (the time limit): the paged runs take the
# first 2 chunks' ticks (held to the dense runs' first 2), and one
# observation goes through graph and eager chunks a mode and through the
# uncapped capacity twin
MOE_PAGED_STEPS = 16
MOE_EAGER_OBS = 1
# the last two archs (PR 21), after the MoE stacks: xlstm-125m at full
# depth (12 blocks, mLSTM and sLSTM; no attention layer) and
# seamless-m4t-medium at full depth (12 encoder + 12 decoder layers)
XLSTM = "xlstm-125m"
XLSTM_CUTS = (6,)  # its PartitionedPolicy cut: 6 of 12 blocks on the edge
ENCDEC = "seamless-m4t-medium"
ENC_FRAMES = 300   # stub frame embeddings of a seamless prompt (a few seconds of speech)
# phases 6-7c (fleet, partition, shards, model axis) run on openvla-7b at
# full width cut to its first FLEET_LAYERS layers (the time limit): at all
# 32 phases 6-7, mostly host-bound, took 466 s of a 1043 s run on an H100
# 80GB HBM3 (700 W), and a run on another such card passed the 1200 s
# limit; at 8 layers, with phase 7d, a run took 1120.4 s of phases on a
# slower machine
FLEET_LAYERS = 4
# openvla-7b's phases 4-5 (served, the scheduler) on its first 8 of 32
# layers, for the same run (the figures at 16 and 32 are in PERF.md,
# section 5; at 16, with phase 7e's 51.7 s, a run took 1002.9 s of phases
# on a slow H100 80GB HBM3 at 700 W); phase 8 trains all 32
OPENVLA_LAYERS = 8
FLEET = 1024      # robots in the monitor's episode bank
DISPATCH_CPU_ROBOTS = 8  # the dispatcher phase's robots run again on the CPU
DISPATCH_WARMUP = 8      # its untimed ticks before the timed run of each mode
TASKS = ("pick_place", "drawer_open", "peg_insertion")


def log(*a):
    print(*a, flush=True)


_PHASE = {"title": "", "t0": 0.0}


def phase(title: str = "") -> None:
    """Log the seconds the current phase took, then open ``title`` (if any)."""

    now = time.perf_counter()
    if _PHASE["title"]:
        log(f"  [{_PHASE['title']}: {now - _PHASE['t0']:.1f} s]")
    _PHASE.update(title=title, t0=now)
    if title:
        log(f"== {title}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # slow plain versions (the monitor's, ~0.4-1.6 s a call): about half a
    # second of warm-up and of timed calls, at least 3 timed
    calls = int(0.5 / max(time.perf_counter() - t0, 1e-6))
    for _ in range(min(warmup, calls)):
        fn()
    iters = max(3, min(iters, calls))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=20, seconds=0.1) -> float:
    """The device's time for one call, without the host's: ``calls`` calls
    captured in one CUDA graph, the graph replayed back to back between two
    CUDA events.  Launchers count their launches at capture only."""

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    reps = max(3, min(500, int(seconds / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def host_us(fn, calls=200, rounds=5) -> float:
    """The host's time to issue one call: the host clock around ``calls``
    calls with no synchronise inside (few enough that the launch queue
    never fills), the least of ``rounds`` rounds (the host's cores are
    shared, so single rounds spread)."""

    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


def bound_ms(nbytes: float, flops: float, dtype):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _t(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def sdpa(q, k, v, **kw):
    """One SDPA call on [B, H, S, D] (the yardstick); GQA through
    ``enable_gqa`` where the heads differ."""

    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def checked_case(case, plain, kw, controls):
    """``case`` held to ROW_TOL as well, and against the plain version
    without each of ``controls`` ("cap", "window"): what a kernel that
    ignored it would match, and must not."""

    key = {"cap": "logit_cap", "window": "window"}
    case["row_tol"] = ROW_TOL
    case["controls"] = [(f"{c} 0", lambda c=c: plain(**dict(kw, **{key[c]: 0}))) for c in controls]
    return case


def flash_case(rng, dtype, s, h, kv, window=0, cap=0.0, d=128, b=1, causal=True,
               q_scale=1.0, checked=False, controls=()):
    """``q_scale`` scales q; ``checked``: see ``checked_case``."""

    q, k, v = _t(rng, (b, s, h, d), dtype), _t(rng, (b, s, kv, d), dtype), _t(rng, (b, s, kv, d), dtype)
    q.mul_(q_scale)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    lim = (lambda i: i + 1) if causal else (lambda i: s)
    pairs = sum(min(lim(i), window) if window else lim(i) for i in range(s))
    lib = None
    if not window and not cap:
        lib = sdpa(*(x.transpose(1, 2) for x in (q, k, v)), is_causal=causal)
    plain = lambda **a: ref.flash_attention_ref(q, k, v, **a)  # noqa: E731
    case = dict(
        kernel=lambda: kfa.flash_attention(q, k, v, **kw),
        plain=lambda: plain(**kw),
        library=lib,
        bytes=2 * nbytes(q) + 2 * nbytes(k),
        flops=4.0 * b * h * d * pairs,
    )
    return checked_case(case, plain, kw, controls) if checked else case


def decode_case(rng, dtype, s, h, kv, cache_len, window=0, cap=0.0, b=1, d=128,
                q_scale=1.0, checked=False, controls=()):
    q = _t(rng, (b, h, d), dtype).mul_(q_scale)
    ck, cv = _t(rng, (b, s, kv, d), dtype), _t(rng, (b, s, kv, d), dtype)
    kw = dict(cache_len=cache_len, window=window, logit_cap=cap)
    lens = (cache_len.tolist() if isinstance(cache_len, torch.Tensor) else [cache_len] * b)
    live = sum(min(n, window) if window else n for n in lens)
    lib = None
    if not window and not cap and not isinstance(cache_len, torch.Tensor):
        lib = sdpa(q[:, :, None, :], ck[:, :cache_len].transpose(1, 2),
                   cv[:, :cache_len].transpose(1, 2))
    plain = lambda **a: ref.decode_attention_ref(q, ck, cv, cache_len=cache_len, **a)  # noqa: E731
    case = dict(
        kernel=lambda: kdec.decode_attention(q, ck, cv, **kw),
        plain=lambda: ref.decode_attention_ref(q, ck, cv, **kw),
        library=lib,
        bytes=2 * nbytes(q) + 2 * live * kv * d * ck.element_size(),
        flops=4.0 * live * h * d,
    )
    return (checked_case(case, plain, dict(window=window, logit_cap=cap), controls)
            if checked else case)


def paged_case(rng, dtype, lens, page, h, kv, window=0, cap=0.0, identity=False, d=128,
               masked_library=False, q_scale=1.0, checked=False, controls=()):
    """``masked_library``: the yardstick is SDPA over each row's pages
    gathered into a dense [B, KV, MAXP * page, D] cache (outside the timed
    call) with a mask of the row's length (rows of length 0 give NaN there
    and 0 in the kernel; the yardstick is only timed)."""

    b = len(lens)
    maxp = max(1, -(-max(lens) // page))
    pool = b * maxp + 3
    kp, vp = _t(rng, (pool, page, kv, d), dtype), _t(rng, (pool, page, kv, d), dtype)
    q = _t(rng, (b, h, d), dtype).mul_(q_scale)
    perm = np.arange(pool) if identity else rng.permutation(pool)
    table = torch.as_tensor(perm[: b * maxp].reshape(b, maxp).astype(np.int32), device="cuda")
    cl = torch.as_tensor(np.asarray(lens, np.int32), device="cuda")
    kw = dict(window=window, logit_cap=cap)
    live = sum(min(n, window) if window else n for n in lens)
    lib = None
    if identity and b == 1 and not window and not cap:
        # identity page table: the pool is the row's dense cache
        lib = sdpa(q[:, :, None, :], kp.view(1, -1, kv, d)[:, : lens[0]].transpose(1, 2),
                   vp.view(1, -1, kv, d)[:, : lens[0]].transpose(1, 2))
    elif masked_library:
        gather = lambda pages: pages[table.long()].reshape(b, maxp * page, kv, d).transpose(1, 2)  # noqa: E731
        mask = (torch.arange(maxp * page, device="cuda")[None, :] < cl[:, None].long())
        lib = sdpa(q[:, :, None, :], gather(kp).contiguous(), gather(vp).contiguous(),
                   attn_mask=mask[:, None, None, :])
    plain = lambda **a: ref.paged_decode_attention_ref(q, kp, vp, table, cl, **a)  # noqa: E731
    case = dict(
        kernel=lambda: kpa.paged_decode_attention(q, kp, vp, table, cl, **kw),
        plain=lambda: plain(**kw),
        library=lib,
        bytes=2 * nbytes(q) + 2 * live * kv * d * kp.element_size() + nbytes(table, cl),
        flops=4.0 * live * h * d,
    )
    return checked_case(case, plain, kw, controls) if checked else case


def mamba_case(rng, b, s, h, p, n, chunk, with_h0=False, with_states=False):
    """x, dt = softplus(normal), a = -exp(normal), B, C, and h0 as the JAX
    package's kernel tests draw them; compared in float64.  ``with_states``:
    the training forward's call, which also returns the state entering each
    chunk (written: B x chunks x H x P x N floats more)."""

    f32 = torch.float32
    x, bm, c = _t(rng, (b, s, h, p), f32), _t(rng, (b, s, n), f32), _t(rng, (b, s, n), f32)
    dt = F.softplus(_t(rng, (b, s, h), f32))
    a = -torch.exp(_t(rng, (h,), f32))
    h0 = _t(rng, (b, h, p, n), f32) if with_h0 else None
    args = (x, dt, a, bm, c)
    wide = [t.double() for t in args]
    h0_wide = None if h0 is None else h0.double()
    nc, L = s // min(chunk, s), min(chunk, s)
    pairs = L * (L + 1) // 2
    # per head and chunk: the weights and y over the causal pairs, the
    # carried state's term, sc and the state update, the prefix sums; G =
    # C B^T once per (batch row, chunk), for all heads (its B and C have no
    # head axis).  The earlier count took G once per head (flops_old).
    per_head = pairs * (4 + 2 * p) + L * p * (2 * n + 2) + p * n * (3 * L + 2) + 5 * L
    flops = b * nc * pairs * 2 * n + b * h * nc * per_head
    flops_old = b * h * nc * (pairs * 2 * n + per_head)
    kw = dict(h0=h0, chunk=chunk, with_states=with_states)
    return dict(
        kernel=lambda: kms.mamba_scan(*args, **kw),
        plain=lambda: ref.mamba_scan_ref(*args, **kw),
        oracle=lambda: ref.mamba_scan_ref(*wide, h0=h0_wide, chunk=chunk,
                                          with_states=with_states),
        tols=[MAMBA_TOL + (0.0,)] * (3 if with_states else 2),
        library=None,
        bytes=2 * nbytes(x) + nbytes(dt, a, bm, c) + (2 if with_h0 else 1) * b * h * p * n * 4
        + (b * nc * h * p * n * 4 if with_states else 0),
        flops=float(flops),
        flops_old=float(flops_old),
    )


def stats_case(m_acc, tau_pow, peak_relative=False, **kw):
    """The monitor kernel over [N, T] streams; ~44 float32 operations a
    tick a stream (csrc/rolling_stats.cu)."""

    n, t = m_acc.shape
    tols = [STATS_TOL[:2] + (0.0,), STATS_TOL[:2] + (0.0,),
            (STATS_TOL[2], STATS_TOL[2], STATS_TOL[2] if peak_relative else 0.0)]
    return dict(
        kernel=lambda: krs.rolling_stats(m_acc, tau_pow, **kw),
        plain=lambda: ref.rolling_stats_ref(m_acc, tau_pow, **kw),
        tols=tols,
        library=None,
        bytes=5 * n * t * 4,
        flops=44.0 * n * t,
    )


def random_streams(rng, n, t):
    """|normal| * 2 and |normal| streams, as the JAX package's kernel tests."""

    return (torch.as_tensor(np.abs(rng.standard_normal((n, t))) * 2, dtype=torch.float32,
                            device="cuda"),
            torch.as_tensor(np.abs(rng.standard_normal((n, t))), dtype=torch.float32,
                            device="cuda"))


def fleet_episodes(n_robots=FLEET):
    """One fleet's episodes: tasks in turn, seeds 0..n-1."""

    return [generate_episode(TASKS[r % 3], seed=r) for r in range(n_robots)]


def fleet_streams(eps, t_len=600):
    """The fleet's episodes cut to the shortest task's 600 ticks -> (q, qd,
    tau [T, R, 7] on the card)."""

    return tuple(
        torch.as_tensor(np.stack([getattr(e, k)[:t_len] for e in eps], axis=1), device="cuda")
        for k in ("q", "qd", "tau")
    )


def fleet_chunks(eps, t_len, device):
    """Each robot's cloud (reference) and edge-policy chunks at the default
    k -> (cloud, edge [T, R, k, A] on ``device``)."""

    k = DispatcherConfig().chunk_len
    return tuple(
        torch.as_tensor(np.stack([fn(e, k)[:t_len] for e in eps], axis=1), device=device)
        for fn in (reference_chunks, edge_policy_chunks)
    )


def monitor_features(qd, tau, cfg: TriggerConfig):
    """m_acc, tau_pow [R, T] from [T, R, 7] streams, as the trigger forms
    them tick by tick (core.kinematics; the previous frame is 0 at t = 0)."""

    w = kin.end_joint_weights(qd.shape[-1], cfg.end_joint_emphasis, qd.device)
    prev = lambda v: torch.cat([torch.zeros_like(v[:1]), v[:-1]])  # noqa: E731
    m_acc = kin.accel_magnitude(kin.finite_diff_accel(qd, prev(qd), cfg.dt), w)
    tau_pow = kin.torque_power(kin.torque_variation(tau, prev(tau)), w)
    return m_acc.T.contiguous(), tau_pow.T.contiguous()


def scheduler_lens(rng, rows=32, idle=8, longest=70):
    """A scheduler round's ragged lengths: ``idle`` rows at length 0 (cap
    0), the rest between 1 and ``longest`` (one of them ``longest``)."""

    lens = [0] * idle + [longest] + rng.integers(1, longest + 1, rows - idle - 1).tolist()
    return [int(x) for x in rng.permutation(lens)]


def arch_shape(arch: str):
    """(label prefix, heads, KV heads, head dim, window, softcap) of an
    arch's attention layers at published widths (gemma2's local layers:
    its global ones differ only in window 0)."""

    cfg = get_config(arch)
    return (f"{arch} H={cfg.num_heads} KV={cfg.num_kv_heads} D={cfg.resolved_head_dim}"
            + (f" win {cfg.sliding_window}" if cfg.sliding_window else "")
            + (f" cap {cfg.attn_logit_softcap:g}" if cfg.attn_logit_softcap else ""),
            cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.sliding_window,
            cfg.attn_logit_softcap)


def arch_kernel_cases(rng):
    """The three attention kernels at the shapes of the new stacks and the
    MoE stacks (bf16, the served dtype; qwen3-moe's G = 16 fills the decode
    kernels' largest template): the closed loop's prompt (flash S = 14) and
    decode length 70 (dense and paged), the scheduler round's 32 ragged rows, phi-3-vision's
    prompt with its 576 patch tokens (S = 590), and gemma2-9b's long prompt
    (S = 4608) and its decode at length 4664 (window 4096, softcap 50).
    Each is held to ROW_TOL as well; capped ones draw q at CAP_Q_SCALE and
    must disagree with the plain version run without the cap (and, at
    gemma2's long lengths, without the window)."""

    bf = torch.bfloat16
    cases = []
    for arch in NEW_ARCHS + tuple(MOE_ARCHS):
        label, h, kv, d, win, cap = arch_shape(arch)
        wc = dict(window=win, cap=cap, q_scale=CAP_Q_SCALE if cap else 1.0, checked=True,
                  controls=("cap",) if cap else ())
        if cap:
            label += f" q x{CAP_Q_SCALE:g}"
        cases += [
            ("flash_attention", f"{label} S=14", bf, flash_case(rng, bf, 14, h, kv, d=d, **wc)),
            ("decode_attention", f"{label} S=70 len=70", bf,
             decode_case(rng, bf, 70, h, kv, 70, d=d, **wc)),
            ("paged_attention", f"{label} B=1 len=70 page 16 identity", bf,
             paged_case(rng, bf, [70], 16, h, kv, identity=True, d=d, **wc)),
            ("paged_attention", f"{label} scheduler rows=32 lens 0..70 (8 idle)", bf,
             paged_case(rng, bf, scheduler_lens(rng), 16, h, kv, d=d,
                        masked_library=not (win or cap), **wc)),
        ]
        if arch == "phi-3-vision-4.2b":
            cases.append(("flash_attention", f"{label} S=590 (576 patches + 14)", bf,
                          flash_case(rng, bf, 590, h, kv, d=d, **wc)))
        if arch == "gemma2-9b":  # past the window: the window is live too
            wc["controls"] = ("cap", "window")
            cases += [
                ("flash_attention", f"{label} S=4608", bf,
                 flash_case(rng, bf, 4608, h, kv, d=d, **wc)),
                ("decode_attention", f"{label} S=4664 len=4664", bf,
                 decode_case(rng, bf, 4664, h, kv, 4664, d=d, **wc)),
                ("paged_attention", f"{label} B=1 len=4664 page 16 shuffled", bf,
                 paged_case(rng, bf, [4664], 16, h, kv, d=d, **wc)),
            ]
    return [(name, label, dtype, case, False) for name, label, dtype, case in cases]


def encdec_kernel_cases(rng, ranks: int = 1):
    """The three attention kernels at seamless-m4t-medium's shapes (bf16,
    H = KV = 16, D = 64; a model-axis rank's H = KV = 16 / ``ranks``),
    each also held to ROW_TOL: the decoder's prompt (flash S = 14, causal),
    the encoder over ``ENC_FRAMES`` frames (flash, non-causal), the
    decoder's self-attention decode at length 70 (dense; paged at B = 1
    and at the scheduler's 32 ragged rows) and a token's cross-attention
    over the frames (decode, ``cache_len`` = S_enc, every key valid)."""

    bf = torch.bfloat16
    label, h, kv, d, _, _ = arch_shape(ENCDEC)
    if ranks > 1:
        h, kv = h // ranks, kv // ranks
        label = f"{ENCDEC} model-axis rank M={ranks} H=KV={h} D={d}"
    c = dict(d=d, checked=True)
    cases = [
        ("flash_attention", f"{label} S=14 decoder prompt", flash_case(rng, bf, 14, h, kv, **c)),
        ("flash_attention", f"{label} S={ENC_FRAMES} encoder, non-causal",
         flash_case(rng, bf, ENC_FRAMES, h, kv, causal=False, **c)),
        ("decode_attention", f"{label} S=70 len=70", decode_case(rng, bf, 70, h, kv, 70, **c)),
        ("decode_attention", f"{label} cross S_enc={ENC_FRAMES} len={ENC_FRAMES}",
         decode_case(rng, bf, ENC_FRAMES, h, kv, ENC_FRAMES, **c)),
        ("paged_attention", f"{label} B=1 len=70 page 16 identity",
         paged_case(rng, bf, [70], 16, h, kv, identity=True, **c)),
        ("paged_attention", f"{label} scheduler rows=32 lens 0..70 (8 idle)",
         paged_case(rng, bf, scheduler_lens(rng), 16, h, kv, masked_library=True, **c)),
    ]
    if ranks > 1:  # phase 7e's: the prompt, the encoder, decode, cross decode, the round
        cases = [c for c in cases if "B=1" not in c[1]]
    return [(name, label, bf, case, False) for name, label, case in cases]


def kernel_cases(rng, fleet):
    bf, f32 = torch.bfloat16, torch.float32
    ragged = [1, 1000, 0, 17, 250, 16, 999, 64]
    tcfg = TriggerConfig()
    fleet_acc, fleet_tau = monitor_features(*fleet[1:], tcfg)
    wins = dict(window_acc=tcfg.window_acc, window_tau=tcfg.window_tau,
                sigma_floor_acc=tcfg.sigma_floor_acc, sigma_floor_tau=tcfg.sigma_floor_tau)
    rank_rng, jamba_rng = np.random.default_rng(29), np.random.default_rng(30)
    data_rng = np.random.default_rng(31)
    return [
        # (kernel, label, dtype, case, main-path shape?)
        ("flash_attention", "S=14 H=KV=32 D=128", bf, flash_case(rng, bf, 14, 32, 32), True),
        ("flash_attention", "S=14 H=KV=32 D=128", f32, flash_case(rng, f32, 14, 32, 32), False),
        ("flash_attention", "S=300 H=KV=32", bf, flash_case(rng, bf, 300, 32, 32), False),
        ("flash_attention", "S=300 H=KV=32", f32, flash_case(rng, f32, 300, 32, 32), False),
        ("flash_attention", "S=300 H=32 KV=8 win 64 cap 50", f32,
         flash_case(rng, f32, 300, 32, 8, window=64, cap=50.0), False),
        ("decode_attention", "S=70 len=70 H=KV=32", bf, decode_case(rng, bf, 70, 32, 32, 70), True),
        ("decode_attention", "S=70 len=70 H=KV=32", f32, decode_case(rng, f32, 70, 32, 32, 70), False),
        ("decode_attention", "S=4096 len=4096", bf, decode_case(rng, bf, 4096, 32, 32, 4096), False),
        ("decode_attention", "S=4096 len=4096", f32, decode_case(rng, f32, 4096, 32, 32, 4096), False),
        ("decode_attention", "S=4096 len=3000 H=32 KV=8 win 64 cap 50", f32,
         decode_case(rng, f32, 4096, 32, 8, 3000, window=64, cap=50.0), False),
        ("decode_attention", "B=4 S=70 per-row lens", f32,
         decode_case(rng, f32, 70, 32, 32, torch.tensor([70, 1, 33, 0], dtype=torch.int32,
                                                          device="cuda"), b=4), False),
        # the scheduler's decode round: 32 rows, ragged lengths, idle rows at 0
        ("paged_attention", "scheduler rows=32 lens 0..70 (8 idle) page 16 shuffled", bf,
         paged_case(rng, bf, scheduler_lens(rng), 16, 32, 32, masked_library=True), True),
        # the same round and the prompt's prefill on a rank of phase 7c's
        # model axis (M = 2: 16 heads, 16 KV heads); drawn from a generator
        # of their own, so the cases after them keep theirs
        ("paged_attention", "model-axis rank M=2 rows=32 lens 0..70 (8 idle) H=KV=16", bf,
         paged_case(rank_rng, bf, scheduler_lens(rank_rng), 16, 16, 16, masked_library=True),
         False),
        ("flash_attention", "model-axis rank M=2 S=14 H=KV=16 D=128", bf,
         flash_case(rank_rng, bf, 14, 16, 16), False),
        # a rank's split: the edge prefix's dense caches and the ping-pong
        # tokens of ``PartitionedPolicy`` (phase 7c's split runs)
        ("decode_attention", "model-axis rank M=2 S=70 len=70 H=KV=16 D=128", bf,
         decode_case(rank_rng, bf, 70, 16, 16, 70), False),
        # a rank of phase 7d's Jamba (M = 2): its attention layer's 32 heads
        # and 4 KV heads over the round's rows and the prompt, its Mamba
        # layers' 128 heads over the prompt; a generator of their own
        ("paged_attention", "Jamba model-axis rank M=2 rows=32 lens 0..70 (8 idle) H=32 KV=4",
         bf, paged_case(jamba_rng, bf, scheduler_lens(jamba_rng), 16, 32, 4,
                        masked_library=True), False),
        ("flash_attention", "Jamba model-axis rank M=2 S=14 H=32 KV=4", bf,
         flash_case(jamba_rng, bf, 14, 32, 4), False),
        ("mamba_scan", "Jamba model-axis rank M=2 B=1 S=14 H=128 P=64 N=16", f32,
         mamba_case(jamba_rng, 1, 14, 128, 64, 16, 256), False),
        # phase 7f's ranks: a data rank's block of the fleet's 8 rows (4, one
        # idle) and of phi3.5-moe's 4 (2; H = 32, KV = 8), the prefill
        # rank's batch of 8 prompts; a generator of their own
        ("paged_attention", "data rank D=2 rows=4 lens 0..70 (1 idle) H=KV=32", bf,
         paged_case(data_rng, bf, scheduler_lens(data_rng, rows=4, idle=1), 16, 32, 32,
                    masked_library=True), False),
        ("paged_attention", "phi3.5-moe data rank D=2 rows=2 lens 1..70 H=32 KV=8", bf,
         paged_case(data_rng, bf, scheduler_lens(data_rng, rows=2, idle=0), 16, 32, 8,
                    masked_library=True), False),
        ("flash_attention", "prefill rank B=8 S=14 H=KV=32 D=128", bf,
         flash_case(data_rng, bf, 14, 32, 32, b=8), False),
        ("paged_attention", "B=1 len=70 page 16 identity", bf,
         paged_case(rng, bf, [70], 16, 32, 32, identity=True), False),
        ("paged_attention", "B=1 len=70 page 16 identity", f32,
         paged_case(rng, f32, [70], 16, 32, 32, identity=True), False),
        ("paged_attention", "B=8 ragged 0..1000 page 16 shuffled", bf,
         paged_case(rng, bf, ragged, 16, 32, 32), False),
        ("paged_attention", "B=8 ragged 0..1000 page 16 shuffled", f32,
         paged_case(rng, f32, ragged, 16, 32, 32), False),
        ("paged_attention", "B=8 ragged page 128 H=32 KV=8 win 64 cap 50", f32,
         paged_case(rng, f32, ragged, 128, 32, 8, window=64, cap=50.0), False),
        # Jamba's attention layer: H=64, KV=8
        ("flash_attention", "Jamba S=14 H=64 KV=8", bf, flash_case(rng, bf, 14, 64, 8), False),
        # the prefill kernel's tensor-core body: a long prompt (operations-bound),
        # a batched prefill, window + softcap with GQA, and the shapes its
        # templates take (D 64/256, D 40 padded to 48, MQA, non-causal)
        ("flash_attention", "S=4096 H=KV=32", bf, flash_case(rng, bf, 4096, 32, 32), False),
        ("flash_attention", "B=8 S=14 H=KV=32", bf, flash_case(rng, bf, 14, 32, 32, b=8), False),
        # the scheduler's batched admission prefill (16 prompts)
        ("flash_attention", "admission B=16 S=14 H=KV=32", bf,
         flash_case(rng, bf, 14, 32, 32, b=16), False),
        ("flash_attention", "S=300 H=32 KV=8 win 64 cap 50", bf,
         flash_case(rng, bf, 300, 32, 8, window=64, cap=50.0), False),
        ("flash_attention", "B=2 S=33 H=8 KV=2 D=64", bf,
         flash_case(rng, bf, 33, 8, 2, d=64, b=2), False),
        ("flash_attention", "S=70 H=KV=4 D=256", bf, flash_case(rng, bf, 70, 4, 4, d=256), False),
        ("flash_attention", "S=17 H=4 KV=1 D=40 win 5 cap 20", bf,
         flash_case(rng, bf, 17, 4, 1, window=5, cap=20.0, d=40), False),
        ("flash_attention", "S=100 H=KV=4 D=64 non-causal", bf,
         flash_case(rng, bf, 100, 4, 4, d=64, causal=False), False),
        # two m-tiles a warp (long prompts): ragged S, and GQA with window + cap
        ("flash_attention", "B=2 S=1031 H=KV=8", bf, flash_case(rng, bf, 1031, 8, 8, b=2), False),
        ("flash_attention", "B=4 S=1000 H=16 KV=4 D=64 win 300 cap 30", bf,
         flash_case(rng, bf, 1000, 16, 4, window=300, cap=30.0, d=64, b=4), False),
        ("decode_attention", "Jamba S=70 len=70 H=64 KV=8", bf,
         decode_case(rng, bf, 70, 64, 8, 70), False),
        ("paged_attention", "Jamba B=1 len=70 page 16 identity H=64 KV=8", bf,
         paged_case(rng, bf, [70], 16, 64, 8, identity=True), False),
        # long and ragged contexts: many KV splits, splits cut by a window,
        # splits left empty by a short row
        ("decode_attention", "Jamba S=4096 len=4096 H=64 KV=8", bf,
         decode_case(rng, bf, 4096, 64, 8, 4096), False),
        ("decode_attention", "S=4096 len=3000 H=KV=32 win 700", bf,
         decode_case(rng, bf, 4096, 32, 32, 3000, window=700), False),
        ("decode_attention", "B=3 S=4096 per-row lens 1/4096/0", bf,
         decode_case(rng, bf, 4096, 32, 32, torch.tensor([1, 4096, 0], dtype=torch.int32,
                                                           device="cuda"), b=3), False),
        ("paged_attention", "Jamba B=8 ragged 0..1000 page 16 shuffled H=64 KV=8", bf,
         paged_case(rng, bf, ragged, 16, 64, 8), False),
        ("paged_attention", "B=2 lens 1/4096 page 16 shuffled", bf,
         paged_case(rng, bf, [1, 4096], 16, 32, 32), False),
        # the Mamba scan: Jamba's prefill shape, long sequences, a carried state
        ("mamba_scan", "Jamba B=1 S=14 H=256 P=64 N=16", f32,
         mamba_case(rng, 1, 14, 256, 64, 16, 256), True),
        ("mamba_scan", "B=2 S=512 H=256 P=64 N=16 chunk 256", f32,
         mamba_case(rng, 2, 512, 256, 64, 16, 256), False),
        ("mamba_scan", "B=2 S=512 H=256 chunk 256 with h0", f32,
         mamba_case(rng, 2, 512, 256, 64, 16, 256, with_h0=True), False),
        ("mamba_scan", "B=1 S=14 H=256 with h0", f32,
         mamba_case(rng, 1, 14, 256, 64, 16, 256, with_h0=True), False),
        ("mamba_scan", "B=1 S=128 H=2 P=16 N=4 chunk 64", f32,
         mamba_case(rng, 1, 128, 2, 16, 4, 64), False),
        ("mamba_scan", "B=2 S=64 H=3 P=8 N=32 chunk 16 with h0", f32,
         mamba_case(rng, 2, 64, 3, 8, 32, 16, with_h0=True), False),
        # a long Jamba prompt: 16 chunks of 256 (operations-bound)
        ("mamba_scan", "B=1 S=4096 H=256 P=64 N=16 chunk 256", f32,
         mamba_case(rng, 1, 4096, 256, 64, 16, 256), False),
        # Jamba's training forward (phase 8(c)), the scan backward's pair;
        # drawn from a generator of its own, so the cases after it keep theirs
        ("mamba_scan", "Jamba train B=2 S=1024 H=256 P=64 N=16 chunk 256 with states", f32,
         mamba_case(np.random.default_rng(27), 2, 1024, 256, 64, 16, 256, with_states=True),
         False),
        # the monitor: a fleet's 1024 episodes, a 16x replay bank, a ragged tile
        ("rolling_stats", f"fleet N={fleet_acc.shape[0]} T=600 episodes", f32,
         stats_case(fleet_acc, fleet_tau, peak_relative=True, **wins), True),
        ("rolling_stats", f"replay bank N={16 * fleet_acc.shape[0]} T=600 (fleet x16)", f32,
         stats_case(fleet_acc.repeat(16, 1), fleet_tau.repeat(16, 1), peak_relative=True,
                    **wins), False),
        ("rolling_stats", "N=130 T=96 windows 32/8 random", f32,
         stats_case(*random_streams(rng, 130, 96), window_acc=32, window_tau=8), False),
        ("rolling_stats", "N=4 T=200 random", f32,
         stats_case(*random_streams(rng, 4, 200)), False),
        # 5 s streams at 500 Hz: longer than one super-tile of 32 x 32 ticks
        ("rolling_stats", "N=256 T=2500 random", f32,
         stats_case(*random_streams(rng, 256, 2500)), False),
    ] + arch_kernel_cases(rng) + encdec_kernel_cases(rng) + encdec_kernel_cases(
        np.random.default_rng(31), ranks=MODEL_AXIS)  # phase 7e's rank, a generator of its own


def compare(outs, wants, tols):
    """Max abs error over the outputs, and whether every element of each
    output is finite and within atol + rtol * |want| + peak * max|want row|."""

    worst, ok = 0.0, True
    for out, want, (atol, rtol, peak) in zip(outs, wants, tols):
        want = want.to(torch.float64)
        err = (out.to(torch.float64) - want).abs()
        lim = atol + rtol * want.abs()
        if peak:
            lim = lim + peak * want.abs().amax(dim=-1, keepdim=True)
        worst = max(worst, float(err.max()))
        ok = ok and bool((err <= lim).all()) and bool(torch.isfinite(out).all())
    return worst, ok


def check_kernels(cases):
    main = {}
    for name, label, dtype, case, is_main in cases:
        out = case["kernel"]()
        want = case.get("oracle", case["plain"])()
        torch.cuda.synchronize()
        outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
        tols = case.get("tols", [TOL[dtype] + (0.0,)] * len(outs))
        err, ok = compare(outs, wants, tols)
        atol, rtol, _ = tols[0]
        checks, blind = "", []
        if "row_tol" in case:
            row_ok = compare(outs, wants, [case["row_tol"]])[1]
            ok = ok and row_ok
            checks = (f" row limit {'met' if row_ok else 'MISSED'} (|want| max "
                      f"{max(float(w.abs().max()) for w in wants):.3g})")
            for what, control in case["controls"]:
                c = (control(),)
                c_err, c_ok = compare(outs, c, tols)
                c_ok = c_ok and compare(outs, c, [case["row_tol"]])[1]
                checks += (f"; vs plain with {what}: err {c_err:.3g} "
                           f"({'AGREES' if c_ok else 'disagrees'})")
                if c_ok:
                    blind.append(what)
        lib = case["library"]
        row = dict(
            max_abs_err=err,
            ms=time_ms(case["kernel"]),
            plain_ms=time_ms(case["plain"]),
            library_ms=time_ms(lib) if lib else None,
            device_ms=device_ms(case["kernel"]),
            host_us=host_us(case["kernel"]),
            library_device_ms=device_ms(lib) if lib else None,
            library_host_us=host_us(lib) if lib else None,
        )
        row["bound_ms"], row["bound_by"] = bound_ms(case["bytes"], case["flops"], dtype)
        fmt = lambda x, n=4: "-" if x is None else f"{x:.{n}f}"  # noqa: E731
        old = ""
        if "flops_old" in case:  # the bound by the count of earlier runs, for comparison
            old_ms, old_by = bound_ms(case["bytes"], case["flops_old"], dtype)
            old = f" bound_old_ms={old_ms:.5f} ({old_by})"
        log(f"  {name:17s} {label:52s} {str(dtype)[6:]:8s} err={row['max_abs_err']:.3g} "
            f"(atol {atol:g} rtol {rtol:g}) ms={row['ms']:.4f} device_ms={row['device_ms']:.5f} "
            f"host_us={row['host_us']:.1f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={fmt(row['library_ms'])} library_device_ms={fmt(row['library_device_ms'], 5)} "
            f"library_host_us={fmt(row['library_host_us'], 1)} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}){old}{checks}")
        if blind:
            raise AssertionError(f"{name} [{label}]: the plain version with {', '.join(blind)} "
                                 "agrees with the kernel too: the case cannot tell them apart")
        if not ok:
            raise AssertionError(f"{name} [{label}, {dtype}] disagrees with its plain version: "
                                 f"max abs err {row['max_abs_err']:.3g}")
        if is_main:
            main[name] = row
    return main


# ---------------------------------------------------------------------------
# phase 4: the model
# ---------------------------------------------------------------------------


class RecordingPolicy(CloudPolicy):
    """A CloudPolicy that keeps each chunk's prompt and tokens."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.record = []

    def chunk_tokens(self, qd, tau):
        toks = super().chunk_tokens(qd, tau)
        self.record.append((np.array(qd), np.array(tau), toks))
        return toks


def check_small_model_against_cpu(arch: str, moe_impl: str = "dense"):
    """Smoke-size f32 stack (its MoE layers dispatching with ``moe_impl``):
    kernels on the card vs plain versions on the CPU, same weights; chunk
    tokens equal, prefill logits within 1e-4."""

    cfg = get_smoke_config(arch).replace(dtype="float32")
    cpu = Model(cfg, device="cpu", moe_impl=moe_impl)
    gpu = Model(cfg, device="cuda", moe_impl=moe_impl)
    gpu.load_state_dict(cpu.state_dict())
    tok = EpisodeTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(1)
    qd, tau = rng.normal(0, 0.5, (2, 7)), rng.normal(0, 0.5, (2, 7))
    obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    lg, _ = gpu.prefill({"tokens": torch.as_tensor(obs, device="cuda")})
    lc, _ = cpu.prefill({"tokens": torch.as_tensor(obs)})
    err = float((lg.cpu() - lc).abs().max())
    for paged in (False, True):
        tg = CloudPolicy(gpu, tok, paged=paged).chunk_tokens(qd, tau)
        tc = CloudPolicy(cpu, tok, paged=paged).chunk_tokens(qd, tau)
        if not np.array_equal(tg, tc):
            raise AssertionError(f"smoke f32 chunk tokens differ card vs CPU (paged={paged})")
    if err > 1e-4:
        raise AssertionError(f"{cfg.name} f32 prefill logits differ card vs CPU by {err:.3g}")
    # the scheduler: decode rounds as CUDA graphs (rows doubling 2 -> 4)
    # against the same requests served eagerly on the CPU
    out = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        sched = ContinuousBatchingScheduler(model, tok, max_slots=2, scan_rounds=4,
                                            num_pages=4 * -(-(14 + 56) // 16))
        res = staggered(sched, requests(np.random.default_rng(2), 6))
        out[name] = [(r.robot_id, r.admitted_round, r.completed_round, r.tokens.tolist())
                     for r in res]
    if out["card"] != out["cpu"]:
        raise AssertionError(f"{cfg.name} f32 scheduler results differ card (graphs) vs CPU")
    impl = f" (moe_impl {moe_impl})" if cfg.moe is not None else ""
    log(f"  {cfg.name}{impl} f32 stack, card kernels vs CPU plain: logits max err {err:.3g}, "
        "dense and paged chunk tokens equal (CloudPolicy graphs on the card); scheduler "
        f"(R = 4, rows 2 -> 4, decode rounds as graphs): {len(res)} chunks and rounds equal")
    if cfg.sliding_window:
        ring_on_card(gpu, cpu)


RING_STEPS = 80  # past the smoke stacks' window of 64


def ring_on_card(gpu, cpu):
    """``Model(windowed_cache=True)`` on the card: ``RING_STEPS`` tokens
    stepped from an empty cache through the decode kernel over rings of the
    window's size, one row (host-int lengths) and two rows at different
    depths (a [B] length tensor, one row 20 tokens behind), each step's
    logits against the full cache on the card and the ring on the CPU
    (f32, 1e-4); exact decode launches."""

    cfg = gpu.cfg
    rings = {}
    for name, full in (("card", gpu), ("cpu", cpu)):
        rings[name] = Model(cfg, device=full.device, windowed_cache=True)
        rings[name].load_state_dict(full.state_dict())
    sizes = [c.shape[1] for c in rings["card"].init_cache(1, RING_STEPS)["k"]]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, RING_STEPS))
    worst = {"full cache": 0.0, "CPU ring": 0.0}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b in (1, 2):
        caches = {"ring": rings["card"].init_cache(b, RING_STEPS),
                  "full": gpu.init_cache(b, RING_STEPS),
                  "cpu": rings["cpu"].init_cache(b, RING_STEPS)}
        for t in range(RING_STEPS):
            lens = t if b == 1 else torch.tensor([t, max(t - 20, 0)], dtype=torch.int32)
            x = toks[:b, t:t + 1]
            out = {}
            for key, model in (("ring", rings["card"]), ("full", gpu), ("cpu", rings["cpu"])):
                dev = model.device
                c = dict(caches[key], len=lens.to(dev) if b == 2 else lens)
                out[key], c = model.decode_step(torch.as_tensor(x, device=dev), c)
                caches[key] = c
            got = out["ring"].float().cpu()
            for key, other in (("full cache", out["full"].float().cpu()), ("CPU ring", out["cpu"])):
                worst[key] = max(worst[key], float((got - other).abs().max()))
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = 2 * 2 * RING_STEPS * gpu.n_attn  # B = 1 and 2; ring and full cache on the card
    log(f"  {cfg.name} f32 ring cache on the card: rings of {sizes} slots, {RING_STEPS} tokens "
        f"stepped at B = 1 and 2 (ragged); logits max err vs the full cache on the card "
        f"{worst['full cache']:.3g}, vs the ring on the CPU {worst['CPU ring']:.3g} (limit 1e-4); "
        f"decode launches {counts['decode_attention']} (expected {want})")
    if counts["decode_attention"] != want:
        raise AssertionError(f"ring decode launches {counts['decode_attention']}, expected {want}")
    if max(worst.values()) > 1e-4:
        raise AssertionError(f"{cfg.name} ring cache differs on the card: {worst}")


def top2_gap_at(model, tok, qd, tau, toks, step, obs=None):
    """Dense path, teacher-forced with ``toks``: the top-two logit gap over
    the action bins at decode step ``step`` (``obs``: the prompt's tokens
    [1, 14] in place of ``qd`` / ``tau``)."""

    if obs is None:
        obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    logits, cache = model.prefill({"tokens": torch.as_tensor(obs, device="cuda")}, extra=step + 1)
    for j in range(step):
        nxt = torch.as_tensor(toks[:, j : j + 1], device="cuda")
        logits, cache = model.decode_step(nxt, cache)
    top = logits[0, -1, tok.action_base :].float().topk(2).values
    return float(top[0] - top[1])


def serve_main_path(model, tok, paged: bool, steps: int = STEPS):
    policy = RecordingPolicy(model, tok, paged=paged)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_episode(policy, task="pick_place", max_steps=steps, verbose=False, device="cuda")
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    n_off, ms = out["offloads"], np.asarray(out["cloud_ms"])
    acts = out["actions"]
    if not (n_off > 0 and acts.shape == (steps, 7) and np.isfinite(acts).all()):
        raise AssertionError(f"bad serve output: offloads={n_off} actions {acts.shape}")
    chunk = policy.n_steps
    log(f"  {'paged' if paged else 'dense'}: offloads={n_off} cloud_ms mean={ms.mean():.2f} "
        f"median={np.median(ms):.2f} first={ms[0]:.2f} "
        f"chunk tokens/s={chunk * n_off / (ms.sum() / 1e3):.1f} "
        f"(steady, excluding the first chunk: {chunk * (n_off - 1) / (ms[1:].sum() / 1e3):.1f}) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"launches={counts}")
    attn_layers, mamba_layers = model.n_attn, model.n_mamba
    want = {
        "flash_attention": attn_layers * n_off,
        "decode_attention": 0 if paged else attn_layers * chunk * n_off,
        "paged_attention": attn_layers * chunk * n_off if paged else 0,
        "mamba_scan": mamba_layers * n_off,
        "rolling_stats": 0,
        "flash_attention_bwd": 0,
        "mamba_scan_bwd": 0,
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return policy, counts


def device_events(prof):
    """(name, ms) of each device activity (kernels, copies) ``prof``
    recorded, read from the profiler's raw kineto events: building its
    Python event list (``prof.events()``) takes ~15 s for a graph chunk's
    100k-210k kernels."""

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def profile_chunk(policy):
    """One chunk of ``policy`` (dense or paged; a replay of its CUDA graph,
    captured before) under torch.profiler (``profile_fn``)."""

    rng = np.random.default_rng(2)
    qd, tau = rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7))
    mode = "paged" if policy.paged else "dense"
    return profile_fn(f"{mode} graph chunk ({policy.model.cfg.name})",
                      lambda: policy.chunk_tokens(qd, tau))


def profile_fn(what, fn):
    """``fn`` once, then once more under torch.profiler: wall ms, the
    device's busy share (returned; None where the profiler saw no kernel),
    the decode attention kernels' device time and the kernels that take
    the device's time (the ten largest)."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    if not kernels:
        log(f"  profiled {what}: wall {wall_ms:.1f} ms; device time not measured (the "
            "profiler recorded no CUDA kernels)")
        return None
    busy_ms = sum(t for _, t in kernels)
    by_name = {}
    for name, ms in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + ms)
    log(f"  profiled {what}: wall {wall_ms:.1f} ms (profiler on), device "
        f"kernels {busy_ms:.1f} ms in {len(kernels)} launches, busy share {busy_ms / wall_ms:.3f}")
    dec = [(n, t) for name, (n, t) in by_name.items() if "decode" in name]
    log(f"    decode attention kernels: {sum(t for _, t in dec):.3f} ms in "
        f"{sum(n for n, _ in dec)} launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"    {t:9.2f} ms {n:6d}x  {name[:110]}")
    return busy_ms / wall_ms


class RouteLog:
    """While entered, records each MoE router call (``moe_lib.router_probs``
    wrapped): the routed sets [T, E] and each token's top-k boundary gap of
    the router logits (its k-th largest minus its (k+1)-th)."""

    def __enter__(self):
        self.fn, self.calls = moe_lib.router_probs, []

        def record(x, router_w, k):
            out = self.fn(x, router_w, k)
            top = (x.float() @ router_w.float()).topk(k + 1, dim=-1).values
            self.calls.append(((out[0] > 0).reshape(-1, router_w.shape[-1]),
                               (top[..., k - 1] - top[..., k]).reshape(-1)))
            return out

        moe_lib.router_probs = record
        return self

    def __exit__(self, *exc):
        moe_lib.router_probs = self.fn


def routes_along(model, tok, qd, tau, toks, step, paged):
    """``model``'s router calls, teacher-forced along the prompt and
    ``toks[:, :step]``, through a dense cache or a paged one (laid out as
    ``CloudPolicy(paged=True)`` lays it out)."""

    obs = obs_prompt(tok, qd, tau)
    with RouteLog() as routes:
        if paged:
            spec, pt, caps = CloudPolicy(model, tok, paged=True)._page_plan(1, obs.shape[1])
            _, dcache = model.prefill({"tokens": obs})
            cache = model.cache_to_paged(dcache, model.init_paged_cache(1, spec), pt, caps)
        else:
            _, cache = model.prefill({"tokens": obs}, extra=step + 1)
        for j in range(step):
            _, cache = model.decode_step(torch.as_tensor(toks[:, j:j + 1], device="cuda"), cache)
    return routes.calls


def route_flip_gap(tok, qd, tau, toks, step, a, b):
    """Two paths ``a``, ``b`` (each ``(model, paged)``) teacher-forced along
    the same tokens up to decode step ``step``: at the first router call
    whose routed sets differ between them, the largest of path ``a``'s
    router boundary gaps over the tokens that differ; None where every
    call routes alike.  Top-k routing is discontinuous: a flip at a
    near-tie moves a token's output by a whole expert, which the
    greedy-margin rule on the output logits alone cannot allow for."""

    for (sa, ga), (sb, _) in zip(routes_along(a[0], tok, qd, tau, toks, step, a[1]),
                                 routes_along(b[0], tok, qd, tau, toks, step, b[1])):
        rows = (sa != sb).any(-1)
        if rows.any():
            return float(ga[rows].max())
    return None


def explain_divergence(what, model, tok, qd, tau, toks, step, other=None):
    """A token of two paths differs at decode step ``step`` (``toks``: the
    first path's chunk, dense cache on ``model``): allowed where that path's
    top-two logit gap is within MARGIN_TOL, or, given ``other`` (the second
    path, ``(model, paged)``), where the two first part at a routing
    decision whose boundary gap is within MARGIN_TOL -> the router gap
    where that explained it, else None."""

    gap = top2_gap_at(model, tok, qd, tau, toks, step)
    if gap <= MARGIN_TOL:
        return None
    flip = None if other is None else route_flip_gap(tok, qd, tau, toks, step, (model, False),
                                                     other)
    if flip is None or flip > MARGIN_TOL:
        routes = ("" if other is None else " and the routes agree" if flip is None
                  else f" and the routes first part at a router gap of {flip:.3g}")
        raise AssertionError(f"{what} token differs at step {step} where the top-two gap is "
                             f"{gap:.3g} > {MARGIN_TOL}{routes}")
    return flip


def check_greedy_margin(model, tok, dense_rec, paged_rec, routes=False):
    """The dense and the paged run's chunks, observation by observation:
    a token may differ only within the greedy margin; with ``routes`` (the
    MoE stacks) also past a routing near-tie (``explain_divergence``)."""

    if len(dense_rec) != len(paged_rec):
        raise AssertionError("dense and paged runs offloaded a different number of times")
    diverged, flips = 0, []
    for (qd, tau, td), (qd2, tau2, tp) in zip(dense_rec, paged_rec):
        if not (np.array_equal(qd, qd2) and np.array_equal(tau, tau2)):
            raise AssertionError("dense and paged runs saw different observations")
        diff = np.flatnonzero(td[0] != tp[0])
        if diff.size:
            diverged += 1
            flip = explain_divergence("paged", model, tok, qd, tau, td, int(diff[0]),
                                      (model, True) if routes else None)
            if flip is not None:
                flips.append(round(flip, 4))
    log(f"  greedy-margin rule: {len(dense_rec)} chunks, {diverged} diverged within the margin"
        + (f" ({len(flips)} past a routing near-tie, router gaps {flips})" if routes else ""))


def graph_vs_eager(model, tok, policies, n_obs=3, n_timed=3):
    """``CloudPolicy``'s CUDA graph (``policies``: the dense and the paged
    policy of the served runs, their graphs captured) against the same
    chunk run eagerly (``Model.prefill`` + ``Model.decode_chunk``) on
    ``n_obs`` observations: tokens equal, token for token; the largest
    difference of the chunk's final logits; cloud_ms of each on the first
    ``n_timed``, in turns (eager, graph, graph, eager), or with
    ``n_timed=0`` on the checked chunks themselves (each observation eager,
    then graph) -> {mode: (graph mean ms, eager mean ms, hand-kernel
    launches a replay)}."""

    rng = np.random.default_rng(3)
    obs = [(rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7))) for _ in range(n_obs)]
    figures = {}
    for policy in policies:
        mode = "paged" if policy.paged else "dense"
        tokens = [torch.as_tensor(np.concatenate([tok.encode_state(qd), tok.encode_state(tau)],
                                                 axis=1), device="cuda") for qd, tau in obs]
        worst = 0.0
        # cloud_ms as CloudPolicy.chunk_tokens takes it: tokens on the host
        ms = {"eager": [], "graph": []}

        def timed(which, t):
            t0 = time.perf_counter()
            out = (policy.eager_chunk if which == "eager" else policy.chunk)(t)
            out[0].cpu()
            ms[which].append((time.perf_counter() - t0) * 1e3)
            return out

        for t in tokens:
            te, le = timed("eager", t)
            tg, lg = timed("graph", t)
            if not torch.equal(te, tg):
                raise AssertionError(f"{mode} CloudPolicy graph tokens differ from eager")
            worst = max(worst, float((le.float() - lg.float()).abs().max()))
        if n_timed:
            ms = {"eager": [], "graph": []}
            for which in ("eager", "graph", "graph", "eager"):
                for t in tokens[:n_timed]:
                    timed(which, t)
        call = policy._graphs[(1, 14)][1]
        log(f"  {mode} CloudPolicy graph vs eager ({model.cfg.name}): {n_obs} chunks' tokens "
            f"equal, final logits max abs diff {worst:.3g}; cloud_ms eager mean "
            f"{np.mean(ms['eager']):.2f} (min {min(ms['eager']):.2f}) graph mean "
            f"{np.mean(ms['graph']):.2f} (min {min(ms['graph']):.2f}) over {len(ms['graph'])} "
            f"chunks each ({'in turns' if n_timed else 'the checked ones'}); "
            f"capture {call.capture_s:.2f} s, {sum(call.launches.values())} "
            f"hand-kernel launches a replay {call.launches}")
        figures[mode] = (np.mean(ms["graph"]), np.mean(ms["eager"]), dict(call.launches))
    return figures


def weight_floor_ms(cfg, tokens: int = 56) -> float:
    """The least time ``tokens`` decode steps take on the card: each reads
    every bf16 weight once (the head, tied or not; of an untied embedding
    table only a row) at the card's memory rate."""

    vpad = -(-cfg.vocab_size // 256) * 256
    params = cfg.param_count() - (0 if cfg.tie_embeddings else vpad * cfg.d_model)
    return tokens * 2 * params / HBM_BPS * 1e3


def serve_stack(cfg, launches, scheduler_phase, brief: bool = False):
    """Build ``cfg`` at full width on the card (weights from a seeded card
    generator), serve it dense and paged, hold the two to the
    greedy-margin rule, hold ``CloudPolicy``'s graphs against eager chunks
    (cloud_ms of both in turns), profile a graph chunk of each mode, print
    the stack's figures beside its weight-read floor, then run
    ``scheduler_phase(model, tok, launches, paged policy)``; adds the
    runs' launch counts to ``launches``.  ``brief`` (the stacks of
    ``NEW_ARCHS``, within the time limit): ``NEW_STEPS`` ticks, cloud_ms
    timed on the checked chunks (``graph_vs_eager(n_timed=0)``)."""

    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  {cfg.name} ({cfg.num_layers} layers {list(cfg.blocks)}): "
        f"{cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}, built in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = EpisodeTokenizer(cfg.vocab_size)
    steps = NEW_STEPS if brief else STEPS
    dense, c_dense = serve_main_path(model, tok, paged=False, steps=steps)
    paged, c_paged = serve_main_path(model, tok, paged=True, steps=steps)
    if model.n_attn:
        check_greedy_margin(model, tok, dense.record, paged.record)
    else:
        # no attention layer: both caches hold the same recurrent state
        if [r[2].tolist() for r in dense.record] != [r[2].tolist() for r in paged.record]:
            raise AssertionError(f"{cfg.name}: dense and paged chunks differ with no attention "
                                 "layer")
        log(f"  dense and paged runs: {len(dense.record)} chunks equal token for token (no "
            "attention layer)")
    for n in launches:
        launches[n] += c_dense[n] + c_paged[n]
    t1 = time.perf_counter()
    # in turns on one observation since PR 21 (three before): the time limit
    figures = graph_vs_eager(model, tok, (dense, paged), n_timed=0 if brief else 1)
    t2 = time.perf_counter()
    # a stack without attention runs the same kernels in both modes: one profile
    busy = {"dense": profile_chunk(dense)}
    busy["paged"] = profile_chunk(paged) if model.n_attn else busy["dense"]
    log(f"  [{cfg.name}: built and served in {t1 - t0:.1f} s, graph vs eager {t2 - t1:.1f} s, "
        f"profiles {time.perf_counter() - t2:.1f} s]")
    floor = weight_floor_ms(cfg)
    fmt = lambda x: "not measured" if x is None else f"{x:.3f}"  # noqa: E731
    for mode, (graph_ms, eager_ms, per_replay) in figures.items():
        log(f"  figures {cfg.name} {mode}: cloud_ms graph {graph_ms:.2f} eager {eager_ms:.2f} "
            f"against a weight-read floor of {floor:.1f} ms (graph {graph_ms / floor:.2f}x); "
            f"busy share {fmt(busy[mode])}; hand-kernel launches a chunk {per_replay}")
    phase(f"5. scheduler ({cfg.name})")
    after = scheduler_phase(model, tok, launches, paged)
    del model, dense, paged
    gc.collect()
    torch.cuda.empty_cache()
    if after is not None:
        after()  # a phase that needs this model's memory back (7d)


# ---------------------------------------------------------------------------
# phase 5: the continuous-batching scheduler
# ---------------------------------------------------------------------------


def requests(rng, n):
    return [(r, rng.normal(0, 0.5, (1, 7)).astype(np.float32),
             rng.normal(0, 0.5, (1, 7)).astype(np.float32)) for r in range(n)]


def staggered(sched, reqs, split=()):
    """Three requests at once, then one every 2 rounds (joining mid-decode),
    through ``submit`` and ``step``, the robots in ``split`` to the split
    lane -> the results in harvest order."""

    for req in reqs[:3]:
        sched.submit(*req, partitioned=req[0] in split)
    results, nxt = [], 3
    while len(results) < len(reqs):
        results += sched.step()
        if nxt < len(reqs) and sched.round % 2 == 0:
            sched.submit(*reqs[nxt], partitioned=reqs[nxt][0] in split)
            nxt += 1
    return results


def sched_launches(model, sched, admits: int, rounds: int):
    """The launches a scheduler run must count: one flash (per attention
    layer) and one Mamba scan (per Mamba layer) per admission prefill, one
    paged decode per attention layer per decoded token of every round, per
    data shard of its mesh that this process holds (one on a data rank, none
    on a prefill rank)."""

    return {
        "flash_attention": model.n_attn * admits,
        "decode_attention": 0,
        "paged_attention": model.n_attn * rounds * sched.decode_block * sched.local_shards,
        "mamba_scan": model.n_mamba * admits,
        "rolling_stats": 0,
        "flash_attention_bwd": 0,
        "mamba_scan_bwd": 0,
    }


def check_sched_counts(model, sched, admits0, rounds0, launches):
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = sched_launches(model, sched, len(sched.admit_ms) - admits0,
                          sched.decode_rounds - rounds0)
    if counts != want:
        raise AssertionError(f"scheduler launch counts {counts}, expected {want}")
    for n in launches:
        launches[n] += counts[n]
    return counts


def check_chunks(model, tok, results, reference, obs_of):
    """Each result's tokens: 56 action tokens, and equal to ``reference``
    (CloudPolicy(paged=True) on the same observation) under the
    greedy-margin rule -> the number of chunks that diverged."""

    diverged = 0
    for r in results:
        toks = np.asarray(r.tokens)
        if toks.shape != (56,) or (toks < tok.action_base).any() or (toks >= tok.vocab_size).any():
            raise AssertionError(f"robot {r.robot_id}: bad chunk {toks}")
        want = reference[r.robot_id]
        diff = np.flatnonzero(want != toks)
        if diff.size:
            diverged += 1
            qd, tau = obs_of[r.robot_id]
            gap = top2_gap_at(model, tok, qd, tau, want[None], int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"robot {r.robot_id}: scheduler token differs at step "
                                     f"{diff[0]} where the top-two gap is {gap:.3g}")
    return diverged


def sched_parity(model, tok, launches, policy, rounds_list=(1, 4), n=8):
    """8 robots, ``max_slots=4`` with room for 8 (rows double to 8), 3
    submitted at once then one every 2 rounds; each chunk against
    ``policy`` (a ``CloudPolicy(paged=True)``) by the greedy-margin rule;
    exact counts."""

    reqs = requests(np.random.default_rng(7), n)
    obs_of = {r: (qd, tau) for r, qd, tau in reqs}
    reference = {r: policy.chunk_tokens(qd, tau)[0] for r, qd, tau in reqs}
    for rounds in rounds_list:
        sched = ContinuousBatchingScheduler(model, tok, max_slots=4, scan_rounds=rounds,
                                            num_pages=n * -(-(14 + 56) // 16))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = staggered(sched, reqs)
        counts = check_sched_counts(model, sched, 0, 0, launches)
        wall = time.perf_counter() - t0
        if sorted(r.robot_id for r in results) != list(range(n)):
            raise AssertionError(f"scheduler served {[r.robot_id for r in results]}")
        diverged = check_chunks(model, tok, results, reference, obs_of)
        log(f"  parity R={rounds}: {n} robots, rows {sched.rows}, peak_active "
            f"{sched.peak_active}, {sched.decode_rounds} rounds in {sched.windows} windows, "
            f"wall {wall:.2f} s; vs CloudPolicy(paged=True): {diverged} of {n} chunks diverged "
            f"within the margin; graphs {sched.graph_captures} captured in "
            f"{sched.capture_s:.2f} s; launches {counts} (exact)")


def sched_load_run(model, tok, sched, reqs, per_round, launches):
    """One load run: ``per_round`` arrivals a round through ``submit_batch``,
    3 queued and 3 mid-window requests cancelled through ``cancel_batch``;
    exact launch counts -> (results, wall s, cancelled robots)."""

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    admits0, rounds0 = len(sched.admit_ms), sched.decode_rounds
    t0 = time.perf_counter()
    results, cancelled, nxt = [], {"queued": [], "window": []}, 0
    while nxt < len(reqs) or sched.n_pending or sched.n_active:
        if nxt < len(reqs):
            batch = reqs[nxt:nxt + per_round]
            sched.submit_batch([r for r, _, _ in batch], np.concatenate([b[1] for b in batch]),
                               np.concatenate([b[2] for b in batch]))
            nxt += len(batch)
        results += sched.step()
        if not cancelled["queued"] and sched.round >= 6 and sched.n_pending >= 3:
            ids = [q.robot_id for q in sched._queue][-3:]
            if not sched.cancel_batch(ids).all():
                raise AssertionError("queued cancels missed")
            cancelled["queued"] = ids
        if not cancelled["window"] and sched.round >= 10 and sched._window is not None:
            live = [q.robot_id for q in sched._window.seqs if not q.dead]
            if len(live) >= 3:
                ids = sorted(live)[-3:]
                if not sched.cancel_batch(ids).all():
                    raise AssertionError("mid-window cancels missed")
                cancelled["window"] = ids
    counts = check_sched_counts(model, sched, admits0, rounds0, launches)
    return results, time.perf_counter() - t0, cancelled, counts, sched.admit_ms[admits0:]


def sched_load(model, tok, launches, policy, n=64, per_round=4):
    """64 robots, one chunk each, 4 arrivals a round; ``max_slots=8`` (rows
    double on demand), a pool of 32 requests' pages, ``scan_rounds=4``,
    ``decode_block=7``; 6 cancels.  Run cold (the graphs are captured on
    the way) and warm (after ``reset``, the graphs replayed); at 4 arrivals
    a round at most 29 sequences are resident, so a third run submits all
    64 at once, where the pages bound admission at 32 resident; then one
    profiled window."""

    ppr = -(-(14 + 56) // 16)
    reqs = requests(np.random.default_rng(11), n)
    sched = ContinuousBatchingScheduler(model, tok, max_slots=8, num_pages=32 * ppr,
                                        scan_rounds=4, decode_block=7)
    kv_gib = 2 * model.n_attn * (32 * ppr + 1) * 16 * model.cfg.num_kv_heads * \
        model.cfg.resolved_head_dim * 2 / 2**30
    for run, arrivals in (("cold", per_round), ("warm", per_round), ("burst", n)):
        if run != "cold":
            sched.reset()
        sched.obs = Observability(trace=False)
        captures0, capture_s0 = sched.graph_captures, sched.capture_s
        results, wall, cancelled, counts, admit_ms = sched_load_run(
            model, tok, sched, reqs, arrivals, launches)
        done = sorted(r.robot_id for r in results)
        gone = set(cancelled["queued"] + cancelled["window"])
        if len(gone) != 6 or done != sorted(set(range(n)) - gone) or sched.cancelled != 6:
            raise AssertionError(f"load run served {len(done)} robots, cancelled {cancelled}")
        m = sched.obs.metrics
        lat, qw = m.get("serve.chunk_latency_ms"), m.get("serve.queue_wait_ms")
        a = sched.allocator
        log(f"  load {run}: {n} robots, {arrivals} arrivals a round, cancelled queued "
            f"{cancelled['queued']} and mid-window {cancelled['window']}; {len(results)} chunks "
            f"in {wall:.3f} s: action tokens/s {len(results) * 56 / wall:.1f}; chunk latency "
            f"p50 {lat.quantile(0.5):.2f} p99 {lat.quantile(0.99):.2f} ms; queue wait p50 "
            f"{qw.quantile(0.5):.2f} p99 {qw.quantile(0.99):.2f} ms; peak_active "
            f"{sched.peak_active}, rows {sched.rows}, pool high_water {a.high_water} of "
            f"{a.num_pages} pages ({kv_gib:.2f} GiB of KV); {sched.decode_rounds} rounds, "
            f"windows {sched.windows}, window closes {sched.window_closes}; graphs captured "
            f"{sched.graph_captures - captures0} in {sched.capture_s - capture_s0:.2f} s; "
            f"admissions {len(admit_ms)}, host ms a boundary mean {np.mean(admit_ms):.2f} max "
            f"{max(admit_ms):.2f}; launches {counts} (exact)")
    # spot check: four robots' chunks against CloudPolicy(paged=True)
    pick = results[:: max(1, len(results) // 4)][:4]
    obs_of = {r: (qd, tau) for r, qd, tau in reqs}
    reference = {r.robot_id: policy.chunk_tokens(*obs_of[r.robot_id])[0] for r in pick}
    diverged = check_chunks(model, tok, pick, reference, obs_of)
    log(f"  load spot check vs CloudPolicy(paged=True): {len(pick)} chunks, {diverged} diverged "
        "within the margin")
    profile_window(model, tok, sched, reqs[:32])


def profile_window(model, tok, sched, reqs, route=None, skip_first=False):
    """One scan window under torch.profiler: the requests admitted at once
    (the eager admission prefill; ``route``: {robot: lane key} of the split
    ones), then the window's graph replays and its harvest: wall ms, device
    busy share, time by kernel.  ``skip_first``: the first window (the
    admission, and the captures of split lanes' graphs) runs before the
    profiler, which sees the second (replays and harvest only)."""

    from torch.profiler import ProfilerActivity, profile

    route = route or {}
    sched.reset()
    for r, qd, tau in reqs:
        sched.submit(r, qd, tau, partitioned=r in route, cut=route.get(r))
    if skip_first:
        sched.step()
        while sched._window is not None:
            sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        while sched._window is not None:
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sched.drain()
    kernels = device_events(prof)
    if not kernels:
        log(f"  profiled window: wall {wall_ms:.1f} ms; device time not measured (the profiler "
            "recorded no CUDA kernels)")
        return
    busy_ms = sum(t for _, t in kernels)
    by_name = {}
    for name, ms in kernels:
        k, t = by_name.get(name, (0, 0.0))
        by_name[name] = (k + 1, t + ms)
    what = ("its second window, no admission" if skip_first
            else f"admission {sched.admit_ms[-1]:.1f} ms of host")
    log(f"  profiled window ({len(reqs)} admitted, R = {sched.scan_rounds}, rows {sched.rows}): "
        f"wall {wall_ms:.1f} ms (profiler on; {what}), "
        f"device kernels {busy_ms:.1f} ms in {len(kernels)} launches, busy share "
        f"{busy_ms / wall_ms:.3f}")
    for name, (k, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"    {t:9.2f} ms {k:6d}x  {name[:110]}")


def openvla_scheduler(model, tok, launches, policy):
    sched_parity(model, tok, launches, policy)
    sched_load(model, tok, launches, policy)
    cfg = model.cfg.replace(num_layers=FLEET_LAYERS)
    t0 = time.perf_counter()
    cut = Model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    phase(f"6. fleet ({cfg.name}, {FLEET_LAYERS} layers)")
    log(f"  {cfg.name} at full width, depth cut to {FLEET_LAYERS} of {model.cfg.num_layers} "
        f"layers for phases 6-7: {cfg.param_count() / 1e9:.3f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    fleet_phase(cut, tok, launches)
    phase(f"7. partition ({cfg.name}, {FLEET_LAYERS} layers)")
    partition_phase(cut, tok, launches)
    phase(f"7b. data shards and disaggregated prefill ({cfg.name}, {FLEET_LAYERS} layers)")
    sharded_phase(cut, tok, launches)
    phase(f"7c. model axis ({cfg.name}, {FLEET_LAYERS} layers, {MODEL_AXIS} ranks)")
    model_axis_phase(cut, tok, launches)
    phase(f"7f. data and prefill ranks ({cfg.name}, {FLEET_LAYERS} layers; {PHI35}, "
          f"{PHI35_DATA_LAYERS} layers; {DATA_RANKS} data ranks + a prefill rank)")
    data_axis_phase(cut, tok, launches)
    del cut
    gc.collect()
    torch.cuda.empty_cache()


def jamba_scheduler(model, tok, launches, policy):
    """Jamba's phases 5 and 7, then 7d's one-rank runs -> phase 7d, which
    ``serve_stack`` runs once this model is freed."""

    sched_parity(model, tok, launches, policy, rounds_list=(4,))
    phase(f"7. partition ({model.cfg.name})")
    split_jamba(model, tok, launches, policy)
    phase(f"7d. MoE and Mamba on the model axis ({model.cfg.name}, {model.cfg.num_layers} "
          f"layers, {MODEL_AXIS} ranks)")
    one = jamba_axis_prepare(model, tok, launches)
    return lambda: jamba_axis_phase(one, tok, launches)


def dense_arch_scheduler(model, tok, launches, policy):
    """The new dense stacks: scheduler (a) at R = 4, then the long prompt of
    the stack whose local and global layers alternate (gemma2-9b) and the
    frontend prompt of the stack with modality tokens (phi-3-vision)."""

    sched_parity(model, tok, launches, policy, rounds_list=(4,))
    if model.cfg.local_global_alternating:
        long_prompt(model, tok, launches)
    if model.cfg.num_modality_tokens:
        frontend_prompt(model, tok, launches)


class Capture:
    """Records the arguments of ``ops.<name>`` calls while it is entered:
    the latest call of each layer in ``layers`` (layer = call index modulo
    the stack's attention layers), the tensors as they were passed (the
    caches are not written again after a chunk's last step)."""

    def __init__(self, name, n_layers, layers=(0, 1)):
        self.name, self.n_layers, self.layers = name, n_layers, layers
        self.calls, self.seen = {}, 0

    def __enter__(self):
        self.fn = getattr(ops, self.name)

        def record(*a, **kw):
            layer = self.seen % self.n_layers
            self.seen += 1
            if layer in self.layers:
                self.calls[layer] = (a, kw)
            return self.fn(*a, **kw)

        setattr(ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.fn)


KERNEL_FNS = {"flash_attention": (kfa.flash_attention, ref.flash_attention_ref),
              "decode_attention": (kdec.decode_attention, ref.decode_attention_ref),
              "paged_attention": (kpa.paged_decode_attention, ref.paged_decode_attention_ref)}


def hold_captured(what, name, call):
    """The kernel against its plain version on captured arguments, to TOL
    and ROW_TOL.  Prints how far the plain version moves without the cap
    and without the window: at random weights the model's scores are small
    and these may move nothing (phase 3's capped cases show each live)."""

    a, kw = call
    kernel, plain = KERNEL_FNS[name]
    out, want = kernel(*a, **kw), plain(*a, **kw)
    torch.cuda.synchronize()
    err, ok = compare((out,), (want,), [TOL[out.dtype] + (0.0,)])
    ok = ok and compare((out,), (want,), [ROW_TOL])[1]
    moved = "".join(
        f"; the plain version without the {key.replace('logit_', '')} moves "
        f"{float((plain(*a, **dict(kw, **{key: 0})).float() - want.float()).abs().max()):.3g}"
        for key in ("logit_cap", "window") if kw.get(key))
    shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
    log(f"    {what}: {name} {shapes} window {kw.get('window')} cap {kw.get('logit_cap')} "
        f"vs plain max abs err {err:.3g} (atol {TOL[out.dtype][0]:g}, and the row limit; "
        f"|want| max {float(want.abs().max()):.3g}){moved}")
    if not ok:
        raise AssertionError(f"{what}: {name} disagrees with its plain version by {err:.3g}")


LONG_PROMPT = 4608  # past gemma2-9b's 4096-token window


def long_prompt(model, tok, launches):
    """gemma2-9b: a 4608-token prompt prefilled, then 56 decode tokens,
    dense and paged (eager chunks); the two held to each other by the
    greedy-margin rule; exact launch counts; then each attention kernel
    against its plain version on the arguments captured from one local
    (window 4096) and one global layer of that run."""

    rng = np.random.default_rng(13)
    prompt = torch.as_tensor(rng.integers(tok.state_base, tok.action_base, (1, LONG_PROMPT)),
                             device="cuda")
    n = model.n_attn
    toks, caps = {}, {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for paged in (False, True):
        policy = CloudPolicy(model, tok, paged=paged)
        with Capture("flash_attention", n) as fa, \
                Capture("paged_decode_attention" if paged else "decode_attention", n) as dec:
            toks[paged] = policy.eager_chunk(prompt)[0].cpu().numpy()[0]
        caps[paged] = (fa, dec)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    want = {"flash_attention": 2 * n, "decode_attention": 56 * n, "paged_attention": 56 * n,
            "mamba_scan": 0, "rolling_stats": 0, "flash_attention_bwd": 0,
            "mamba_scan_bwd": 0}
    if counts != want:
        raise AssertionError(f"long prompt launch counts {counts}, expected {want}")
    for k in launches:
        launches[k] += counts[k]
    if (toks[False] < tok.action_base).any() or toks[False].shape != (56,):
        raise AssertionError(f"long prompt: bad chunk {toks[False]}")
    diff = np.flatnonzero(toks[False] != toks[True])
    if diff.size:
        gap = top2_gap_tokens(model, tok, prompt[0].cpu().numpy(), toks[False], int(diff[0]))
        if gap > MARGIN_TOL:
            raise AssertionError(f"long prompt: paged token differs at step {diff[0]} where "
                                 f"the dense top-two gap is {gap:.3g} > {MARGIN_TOL}")
    log(f"  {model.cfg.name} long prompt: {LONG_PROMPT} tokens + 56 decoded, dense and paged (eager) "
        f"in {wall:.2f} s; tokens {'equal' if not diff.size else f'differ from step {diff[0]}, within the margin'}; "
        f"launches {counts} (exact); captured, layer 0 local (window {model.cfg.sliding_window}) "
        "and layer 1 global:")
    for paged in (False, True):
        fa, dec = caps[paged]
        for layer in (0, 1):
            kind = "local" if layer == 0 else "global"
            if not paged:
                hold_captured(f"prefill layer {layer} ({kind})", "flash_attention", fa.calls[layer])
            hold_captured(f"last decode step, layer {layer} ({kind})",
                          "paged_attention" if paged else "decode_attention", dec.calls[layer])


def frontend_prompt(model, tok, launches):
    """phi-3-vision: ``Model.prefill`` of ``num_modality_tokens`` stub patch
    embeddings and a 14-token prompt; finite logits, exact launch counts,
    and its first layer's flash call at S = 590 against the plain version
    on the captured arguments."""

    cfg = model.cfg
    rng = np.random.default_rng(17)
    fe = torch.as_tensor(rng.normal(0, 0.02, (1, cfg.num_modality_tokens, cfg.d_model)),
                         dtype=model.dtype, device="cuda")
    prompt = torch.as_tensor(rng.integers(tok.state_base, tok.action_base, (1, 14)), device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with Capture("flash_attention", model.n_attn, layers=(0,)) as fa:
        logits, cache = model.prefill({"tokens": prompt, "frontend": fe})
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = {"flash_attention": model.n_attn, "decode_attention": 0, "paged_attention": 0,
            "mamba_scan": 0, "rolling_stats": 0, "flash_attention_bwd": 0,
            "mamba_scan_bwd": 0}
    if counts != want:
        raise AssertionError(f"frontend prefill launch counts {counts}, expected {want}")
    for k in launches:
        launches[k] += counts[k]
    s = cfg.num_modality_tokens + 14
    if cache["len"] != s or logits.shape != (1, 1, model.embed.table.shape[0]) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"frontend prefill: len {cache['len']}, logits {tuple(logits.shape)}")
    log(f"  {cfg.name} frontend prompt: {cfg.num_modality_tokens} patches + 14 tokens, S = {s}, "
        f"logits finite; launches {counts} (exact)")
    hold_captured(f"prefill layer 0 (S = {s})", "flash_attention", fa.calls[0])


# ---------------------------------------------------------------------------
# phases 4-5: the MoE stacks
# ---------------------------------------------------------------------------


def moe_twin(model, moe_impl: str, capacity_factor=None):
    """A sibling of ``model`` over the same weights (nothing copied: a
    shallow copy shares the modules) whose MoE layers dispatch with
    ``moe_impl``, at ``capacity_factor`` if given.  A stack at the card's
    size cannot be built twice."""

    twin = copy.copy(model)
    twin.moe_impl = moe_impl
    if capacity_factor is not None:
        twin.cfg = model.cfg.replace(
            moe=dataclasses.replace(model.cfg.moe, capacity_factor=capacity_factor))
    return twin


class CountDrops:
    """While entered, sums the token slots the capacity dispatch routes and
    keeps (``moe_lib.capacity_slots`` wrapped; eager calls only)."""

    def __enter__(self):
        self.fn, self.routed, self.kept = moe_lib.capacity_slots, [], []

        def count(selected, cap):
            keep, slot = self.fn(selected, cap)
            self.routed.append(selected.sum())
            self.kept.append(keep.sum())
            return keep, slot

        moe_lib.capacity_slots = count
        return self

    def __exit__(self, *exc):
        moe_lib.capacity_slots = self.fn

    def totals(self):
        return int(sum(self.routed)), int(sum(self.kept))


def moe_floors_ms(cfg, tokens: int = 56):
    """(every expert, active experts only): ``weight_floor_ms`` with all of
    each MoE layer's experts read, and with only its top-k read."""

    per_expert = 3 * cfg.d_model * cfg.d_ff
    idle = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers)) * \
        (cfg.moe.num_experts - cfg.moe.num_experts_per_tok) * per_expert
    every = weight_floor_ms(cfg, tokens)
    return every, every - tokens * 2 * idle / HBM_BPS * 1e3


def obs_prompt(tok, qd, tau):
    return torch.as_tensor(np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1),
                           device="cuda")


def uncapped_vs_dense(model, tok, record):
    """The capacity dispatch with ``capacity_factor = E / k`` (``cap`` >= the
    tokens: nothing drops) on the dense dispatch's recorded observations:
    its ``CloudPolicy`` graph chunks against the dense chunks by the
    greedy-margin rule; then the default factor's prefill on the same
    prompts, eager, counting the token slots it drops."""

    m = model.cfg.moe
    twin = moe_twin(model, "capacity", capacity_factor=m.num_experts / m.num_experts_per_tok)
    policy = CloudPolicy(twin, tok)
    diverged, flips = 0, []
    for qd, tau, want in record:
        got = policy.chunk_tokens(qd, tau)
        diff = np.flatnonzero(got[0] != want[0])
        if diff.size:
            diverged += 1
            flip = explain_divergence("uncapped capacity", model, tok, qd, tau, want,
                                      int(diff[0]), (twin, False))
            if flip is not None:
                flips.append(round(flip, 4))
    del policy
    capped = moe_twin(model, "capacity")
    with CountDrops() as drops:
        for qd, tau, _ in record:
            capped.prefill({"tokens": obs_prompt(tok, qd, tau)})
    routed, kept = drops.totals()
    cap = max(int(14 * m.num_experts_per_tok * m.capacity_factor / m.num_experts), 1)
    log(f"  uncapped capacity (cf {m.num_experts / m.num_experts_per_tok:g}) vs dense dispatch: "
        f"{len(record)} chunks, {diverged} diverged within the margin ({len(flips)} past a "
        f"routing near-tie, router gaps {flips}); default cf "
        f"{m.capacity_factor:g} (cap {cap} at a 14-token prefill): {routed - kept} of {routed} "
        f"prefill token slots dropped over {len(record)} prompts x {model.cfg.num_layers} layers")


def serve_moe_stack(cfg, launches):
    """A MoE stack at published widths (``cfg`` at its cut depth): built on
    the card, then under ``moe_impl`` "dense" and "capacity" (one set of
    weights; ``moe_twin``) served dense for ``NEW_STEPS`` ticks and paged
    for ``MOE_PAGED_STEPS``, the two held to the greedy-margin rule (and
    its routing near-ties), ``CloudPolicy``'s graphs against eager chunks
    on ``MOE_EAGER_OBS`` observations (cloud_ms of both), one
    profiled graph chunk (dense cache), and its exact hand-kernel launches
    a replay; the uncapped capacity twin against the dense dispatch; the
    figures beside both weight-read floors; then the capacity scheduler."""

    gc.collect()  # the blocks the earlier stacks' policies cached go back to the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    free = torch.cuda.mem_get_info()[0] / 2**30
    log(f"  {cfg.name} ({cfg.num_layers} layers, every one MoE, {cfg.moe.num_experts} experts "
        f"top-{cfg.moe.num_experts_per_tok}): {cfg.param_count() / 1e9:.3f} B params, "
        f"{cfg.dtype}, built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, {free:.2f} GiB free")
    if free < MIN_FREE_GIB:
        raise AssertionError(f"{cfg.name}: {free:.2f} GiB free after loading, under "
                             f"{MIN_FREE_GIB} GiB: cut the depth")
    tok = EpisodeTokenizer(cfg.vocab_size)
    n = model.n_attn
    figures, busy = {}, {}
    for impl in MOE_IMPLS:
        served = model if impl == "dense" else moe_twin(model, impl)
        t1 = time.perf_counter()
        dense, c_dense = serve_main_path(served, tok, paged=False, steps=NEW_STEPS)
        paged, c_paged = serve_main_path(served, tok, paged=True, steps=MOE_PAGED_STEPS)
        check_greedy_margin(served, tok, dense.record[:len(paged.record)], paged.record,
                            routes=True)
        for k in launches:
            launches[k] += c_dense[k] + c_paged[k]
        figures[impl] = graph_vs_eager(served, tok, (dense, paged), n_obs=MOE_EAGER_OBS,
                                       n_timed=0)
        for mode, name in (("dense", "decode_attention"), ("paged", "paged_attention")):
            per_replay = figures[impl][mode][2]
            if per_replay != {"flash_attention": n, name: dense.n_steps * n}:
                raise AssertionError(f"{impl} {mode} hand-kernel launches a replay {per_replay}")
        busy[impl] = profile_chunk(dense)
        log(f"  [{cfg.name} moe_impl {impl}: {time.perf_counter() - t1:.1f} s]")
        if impl == "dense":
            record = dense.record[:MOE_EAGER_OBS]
        del dense, paged
    uncapped_vs_dense(model, tok, record)
    every, active = moe_floors_ms(cfg)
    fmt = lambda x: "not measured" if x is None else f"{x:.3f}"  # noqa: E731
    for impl in MOE_IMPLS:
        for mode, (graph_ms, eager_ms, per_replay) in figures[impl].items():
            log(f"  figures {cfg.name} moe_impl {impl} {mode}: cloud_ms graph {graph_ms:.2f} "
                f"eager {eager_ms:.2f}; busy share (dense cache) {fmt(busy[impl])}; "
                f"hand-kernel launches a chunk {per_replay}")
    log(f"  floors {cfg.name}: every expert read {every:.1f} ms (graph dense dispatch "
        f"{figures['dense']['dense'][0] / every:.2f}x, capacity "
        f"{figures['capacity']['dense'][0] / every:.2f}x); active experts only {active:.1f} ms "
        f"(dense dispatch {figures['dense']['dense'][0] / active:.2f}x)")
    phase(f"5. scheduler ({cfg.name})")
    moe_scheduler(moe_twin(model, "capacity"), tok, launches)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_scheduler(model, tok, launches, n=8):
    """(a) on the capacity dispatch at R = 4: 8 robots, three at once then
    one every 2 rounds, ``max_slots=4`` (rows double to 8), cold (graphs
    captured on the way) and warm (after ``reset``), with
    ``Observability``: action tokens/s, chunk latency p50 / p99, exact
    launch counts, pages back.  Each chunk is 56 action tokens; the rows
    (idle ones too) share each expert's capacity, so no single-robot path
    reproduces them: the f32 smoke twin (phase 4) holds the scheduler's
    tokens card against CPU."""

    reqs = requests(np.random.default_rng(7), n)
    sched = ContinuousBatchingScheduler(model, tok, max_slots=4, scan_rounds=4,
                                        num_pages=n * -(-(14 + 56) // 16))
    for run in ("cold", "warm"):
        if run == "warm":
            sched.reset()
        sched.obs = Observability(trace=False)
        admits0, rounds0 = len(sched.admit_ms), sched.decode_rounds
        captures0, capture_s0 = sched.graph_captures, sched.capture_s
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = staggered(sched, reqs)
        wall = time.perf_counter() - t0
        counts = check_sched_counts(model, sched, admits0, rounds0, launches)
        if sorted(r.robot_id for r in results) != list(range(n)) or \
                sched.pool_stats().pages_in_use != 0:
            raise AssertionError(f"capacity scheduler served {[r.robot_id for r in results]}")
        for r in results:
            toks = np.asarray(r.tokens)
            if toks.shape != (56,) or (toks < tok.action_base).any() or \
                    (toks >= tok.vocab_size).any():
                raise AssertionError(f"robot {r.robot_id}: bad chunk {toks}")
        lat = sched.obs.metrics.get("serve.chunk_latency_ms")
        log(f"  capacity scheduler {run} (R = 4): {n} robots, rows {sched.rows}, peak_active "
            f"{sched.peak_active}, {sched.decode_rounds - rounds0} rounds in {wall:.3f} s: action "
            f"tokens/s {n * 56 / wall:.1f}; chunk latency p50 {lat.quantile(0.5):.2f} p99 "
            f"{lat.quantile(0.99):.2f} ms; graphs {sched.graph_captures - captures0} captured in "
            f"{sched.capture_s - capture_s0:.2f} s; launches {counts} (exact)")


# ---------------------------------------------------------------------------
# phases 4-7: the xLSTM stack and the encoder-decoder stack
# ---------------------------------------------------------------------------


def xlstm_scheduler(model, tok, launches, policy):
    """xlstm-125m: scheduler (a) at R = 4 (its rows hold only the mLSTM and
    sLSTM state; its rounds launch no hand kernel), then
    ``PartitionedPolicy`` at ``XLSTM_CUTS`` against ``CloudPolicy``."""

    sched_parity(model, tok, launches, policy, rounds_list=(4,))
    phase(f"7. partition ({model.cfg.name})")
    split_policy_full_width(model, tok, launches, cuts=XLSTM_CUTS)


def enc_twin(model, cache_cross_kv: bool):
    """A sibling of ``model`` over the same weights (a shallow copy shares
    the modules) with ``cache_cross_kv`` set."""

    twin = copy.copy(model)
    twin.cache_cross_kv = cache_cross_kv
    return twin


def encdec_batch(cfg, tok, rng, b, frames, device):
    """``b`` prompts of 14 state tokens and ``frames`` stub frame embeddings
    (standard normal) for the encoder."""

    return {"tokens": torch.as_tensor(rng.integers(tok.state_base, tok.action_base, (b, 14)),
                                      device=device),
            "frontend": torch.as_tensor(rng.standard_normal((b, frames, cfg.d_model)),
                                        dtype=torch.float32, device=device)}


def encdec_chunk(model, batch, paged, floor, n_steps=56, into=None):
    """``Model.prefill(extra=n_steps)`` (paged: ``extra=0``, then the dense
    cache scattered into pages as ``CloudPolicy(paged=True)`` lays them
    out) and ``decode_chunk(n_steps, token_floor=floor)`` -> (tokens
    [B, n_steps], the next logits).  ``into`` (a dict, eager runs only):
    gets the prefill's last logits, its collectives, the cross-K/V bytes
    and the host clock when the decode starts."""

    b = batch["tokens"].shape[0]
    logits, cache = model.prefill(batch, extra=0 if paged else n_steps)
    if into is not None:
        into.update(prefill=logits[0, -1].float().cpu().numpy(),
                    prefill_calls=dict(dist.CALLS), t_decode=time.perf_counter(),
                    xkv_bytes=sum(cache[k].nbytes for k in ("xk", "xv") if k in cache))
    if paged:
        page = 16
        maxp = -(-(14 + n_steps) // page)
        spec = PagedSpec(num_pages=b * maxp, page_size=page, max_pages_per_seq=maxp)
        i32 = dict(dtype=torch.int32, device=model.device)
        pt = torch.arange(b * maxp, **i32).reshape(b, maxp)
        cache = model.cache_to_paged(cache, model.init_paged_cache(b, spec), pt,
                                     torch.full((b,), maxp * page, **i32))
    toks, logits, _ = model.decode_chunk(logits, cache, n_steps, floor)
    return toks, logits


ENC_MODES = [(cached, paged) for cached in (False, True) for paged in (False, True)]


def enc_mode(cached, paged):
    return f"{'paged' if paged else 'dense'}, {'cached' if cached else 'uncached'} cross K/V"


def encdec_card_vs_cpu():
    """f32 seamless-smoke, the same weights on the card (kernels) and on the
    CPU (plain versions): 2 prompts of 14 tokens and 24 frames, prefill
    logits within 1e-4, the 56-token chunk's tokens equal and its final
    logits within 1e-4, dense and paged, cross K/V cached and not."""

    cfg = get_smoke_config(ENCDEC).replace(dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tok = EpisodeTokenizer(cfg.vocab_size)
    batch = encdec_batch(cfg, tok, np.random.default_rng(41), 2, 24, "cpu")
    worst = 0.0
    for cached, paged in ENC_MODES:
        out = {}
        for name, model in (("card", gpu), ("cpu", cpu)):
            m = enc_twin(model, cached)
            b = {k: v.to(model.device) for k, v in batch.items()}
            lg, _ = m.prefill(b)
            toks, last = encdec_chunk(m, b, paged, tok.action_base)
            out[name] = (lg.float().cpu(), toks.cpu(), last.float().cpu())
        if not torch.equal(out["card"][1], out["cpu"][1]):
            raise AssertionError(f"{cfg.name} f32 ({enc_mode(cached, paged)}): chunk tokens "
                                 "differ card vs CPU")
        err = max(float((out["card"][i] - out["cpu"][i]).abs().max()) for i in (0, 2))
        if err > 1e-4:
            raise AssertionError(f"{cfg.name} f32 ({enc_mode(cached, paged)}): logits differ "
                                 f"card vs CPU by {err:.3g}")
        worst = max(worst, err)
    log(f"  {cfg.name} f32 stack, card kernels vs CPU plain: 2 prompts of 14 tokens + 24 frames, "
        f"prefill and final logits max err {worst:.3g} (limit 1e-4), 56-token chunk tokens equal "
        "in all four modes (dense / paged x cross K/V uncached / cached)")


def encdec_top2_gap(model, batch, floor, toks, step):
    """Dense cache, uncached cross K/V, teacher-forced with ``toks``: the
    top-two logit gap over the action bins at decode step ``step``."""

    logits, cache = model.prefill(batch, extra=step + 1)
    for j in range(step):
        logits, cache = model.decode_step(toks[:, j:j + 1], cache)
    top = logits[0, -1, floor:].float().topk(2).values
    return float(top[0] - top[1])


def encdec_launches(model, paged, n_steps=56):
    """One chunk's hand-kernel launches: a flash prefill per encoder layer
    (non-causal) and per decoder layer (causal); per token and decoder
    layer one self-attention decode (dense or paged) and one cross-attention
    decode over the frames."""

    n_dec, n_enc = model.n_attn, model.cfg.num_encoder_layers
    want = {k: 0 for k in _lib.KERNELS}
    want["flash_attention"] = n_enc + n_dec
    want["decode_attention"] = n_dec * n_steps * (1 if paged else 2)
    want["paged_attention"] = n_dec * n_steps if paged else 0
    return want


def encdec_floor_ms(cfg, cached, tokens=56, frames=ENC_FRAMES):
    """The decode's weight-read floor: each token reads the decoder (the
    cross-attention's K/V projections only when they are not cached) and
    the head at the card's memory rate; uncached, the K/V projections over
    ``frames`` add their operations (bf16 peak) each token."""

    d, hd = cfg.d_model, cfg.resolved_head_dim
    vpad = -(-cfg.vocab_size // 256) * 256
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    kv = 2 * d * hd * cfg.num_kv_heads
    per_layer = 2 * attn + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff - (kv if cached else 0)
    params = cfg.num_layers * per_layer + vpad * d
    ms = tokens * 2 * params / HBM_BPS * 1e3
    if not cached:
        ms += tokens * cfg.num_layers * 2.0 * frames * kv / PEAK_FLOPS[torch.bfloat16] * 1e3
    return ms


def serve_encdec(cfg, launches):
    """seamless-m4t-medium at full width and depth (bf16, random weights):
    one prompt of 14 state tokens and ``ENC_FRAMES`` stub frames through
    ``Model.prefill(extra=56)`` and ``decode_chunk(56)`` in the four modes
    (dense / paged cache x cross K/V projected each token / cached at
    prefill; one set of weights, ``enc_twin``), exact launch counts, the
    four held to one another by the greedy-margin rule; then each mode's
    chunk replayed as a ``GraphedCall`` graph against eager (tokens equal),
    cloud_ms of both beside the mode's weight-read floor, and the hand
    kernels' launches a replay."""

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  {cfg.name} ({cfg.num_encoder_layers} encoder + {cfg.num_layers} decoder layers): "
        f"{cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}, built in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = EpisodeTokenizer(cfg.vocab_size)
    floor = tok.action_base
    batch = encdec_batch(cfg, tok, np.random.default_rng(43), 1, ENC_FRAMES, "cuda")
    toks, eager_ms = {}, {}
    for cached, paged in ENC_MODES:
        m = enc_twin(model, cached)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out, last = encdec_chunk(m, batch, paged, floor)
        out = out.cpu()
        ms = eager_ms[(cached, paged)] = (time.perf_counter() - t1) * 1e3
        counts = dict(ops.LAUNCHES)
        want = encdec_launches(model, paged)
        if counts != want:
            raise AssertionError(f"{cfg.name} ({enc_mode(cached, paged)}): launches {counts}, "
                                 f"expected {want}")
        for k in launches:
            launches[k] += counts[k]
        t = out.numpy()
        if t.shape != (1, 56) or (t < floor).any() or (t >= cfg.vocab_size).any() or \
                not torch.isfinite(last).all():
            raise AssertionError(f"{cfg.name} ({enc_mode(cached, paged)}): bad chunk {t}")
        toks[(cached, paged)] = out
        log(f"  {enc_mode(cached, paged)}: prefill of 14 tokens + {ENC_FRAMES} frames and a "
            f"56-token chunk, eager {ms:.1f} ms (first of its mode); launches {counts} (exact)")
    ref_toks = toks[(False, False)]
    diverged = 0
    for mode, t in toks.items():
        diff = np.flatnonzero(t[0].numpy() != ref_toks[0].numpy())
        if diff.size:
            diverged += 1
            gap = encdec_top2_gap(model, batch, floor, ref_toks.to("cuda"), int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"{cfg.name} {enc_mode(*mode)}: token {diff[0]} differs from "
                                     f"the dense uncached chunk where the top-two gap is {gap:.3g}")
    log(f"  greedy-margin rule: the four modes' chunks against dense uncached, {diverged} of 3 "
        "diverged within the margin")
    for cached, paged in ENC_MODES:
        m = enc_twin(model, cached)
        static = {k: v.clone() for k, v in batch.items()}
        call = GraphedCall(lambda m=m, static=static, paged=paged:
                           encdec_chunk(m, static, paged, floor))
        ms = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        runs = 3  # the first runs eagerly, then captures
        for _ in range(runs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = call()[0].cpu()
            ms.append((time.perf_counter() - t1) * 1e3)
            if not torch.equal(got, toks[(cached, paged)]):
                raise AssertionError(f"{cfg.name} {enc_mode(cached, paged)}: graph tokens "
                                     "differ from the eager chunk")
        graph_ms = ms[1:]
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        want = encdec_launches(model, paged)
        if call.launches != {k: n for k, n in want.items() if n} or \
                counts != {k: n * runs for k, n in want.items()}:
            raise AssertionError(f"{cfg.name} {enc_mode(cached, paged)}: launches a replay "
                                 f"{call.launches}, in all {counts}; expected {want} a chunk")
        for k in launches:
            launches[k] += counts[k]
        busy = None
        if cached and not paged:  # one profiled graph chunk (its launches go uncounted)
            busy = profile_fn(f"{enc_mode(cached, paged)} graph chunk ({cfg.name})",
                              lambda: call()[0].cpu())
        fl = encdec_floor_ms(cfg, cached)
        log(f"  figures {cfg.name} {enc_mode(cached, paged)}: graph == eager tokens; cloud_ms "
            f"graph {np.mean(graph_ms):.2f} (min {min(graph_ms):.2f}; first, eager + capture, "
            f"{ms[0]:.1f}) eager {eager_ms[(cached, paged)]:.2f} against a weight-read floor "
            f"of {fl:.2f} ms (graph {np.mean(graph_ms) / fl:.2f}x); capture {call.capture_s:.2f} s;"
            f"{'' if busy is None else f' busy share {busy:.3f};'} hand-kernel launches a replay "
            f"{call.launches}")
        del call
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the fleet
# ---------------------------------------------------------------------------


class RecordingScheduler(ContinuousBatchingScheduler):
    """A scheduler that keeps each harvested chunk's robot, prompt tokens and
    action tokens, in harvest order (split lanes' chunks included)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.record = []

    def _close_window(self):
        w = self._window
        prompt = {q.robot_id: q.request.obs
                  for q in w.seqs + [q for seqs in w.lane_seqs.values() for q in seqs]
                  if not q.dead}
        done = super()._close_window()
        self.record += [(r.robot_id, prompt[r.robot_id], r.tokens) for r in done]
        return done


def fleet_frames(n_robots, seed, t_len):
    tasks = list(TASKS)
    eps = [generate_episode(tasks[i % 3], seed=seed + i) for i in range(n_robots)]
    return kin.KinematicFrame(*(torch.as_tensor(np.stack([getattr(e, n)[:t_len] for e in eps], 1))
                                for n in ("q", "qd", "tau")))


def threshold_distance(pcfg, frames, t, r):
    """Relative distance of tick ``t``, robot ``r``'s trigger terms from
    their thresholds, from the CPU decision core over ``frames``."""

    _, dec = rollout(pcfg, kin.KinematicFrame(*(f[: t + 1] for f in frames)))
    o = dec.trig
    tc, tr = pcfg.trigger.theta_comp, pcfg.trigger.theta_red
    acc = float(o.w_acc[t, r] * o.score_acc[t, r])
    tau = float((1.0 - o.w_acc[t, r]) * o.score_tau[t, r])
    return min(abs(acc - tc) / tc, abs(tau - tr) / tr)


def first_decision_flip(sc, sp, pcfg, frames):
    """None when two runs' decision streams (dicts of [T, R] arrays) are
    equal; else (t, r, distance) of the first tick whose decision differs,
    which must lie within ``DECISION_RTOL`` of a threshold (the runs part
    ways from there)."""

    diff = np.zeros_like(sc["offload"])
    for k in sc:
        diff |= sc[k] != sp[k]
    if not diff.any():
        return None
    t, r = (int(x) for x in np.argwhere(diff)[0])
    dist = threshold_distance(pcfg, frames, t, r)
    if dist > DECISION_RTOL:
        raise AssertionError(f"card and CPU decisions differ at tick {t} robot {r}, "
                             f"{dist:.3g} (relative) from its threshold")
    return t, r, dist


def top2_gap_tokens(model, tok, obs_tokens, toks, step):
    """``model``'s top-two logit gap over the action bins at decode step
    ``step`` of the prompt ``obs_tokens``, teacher-forced with ``toks``."""

    dev = model.device
    logits, cache = model.prefill({"tokens": torch.as_tensor(obs_tokens[None], device=dev)},
                                  extra=step + 1)
    for j in range(step):
        logits, cache = model.decode_step(torch.as_tensor(toks[None, j:j + 1], device=dev), cache)
    top = logits[0, -1, tok.action_base:].float().topk(2).values
    return float(top[0] - top[1])


def fleet_card_vs_cpu():
    """(a) f32 openvla-smoke, the same weights on the card (kernels, graphs,
    the decision core on its stream) and on the CPU (plain versions):
    ``serve_fleet(trigger="rapid")``, 8 robots, R = 4, both ticks; the
    decision streams, counters, rounds, cancels and latency draws equal,
    chunk tokens equal or inside the f32 greedy margin."""

    cfg = get_smoke_config("openvla-7b").replace(dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tok = EpisodeTokenizer(cfg.vocab_size)
    kw = dict(n_robots=8, max_steps=FLEET_TICKS, scan_rounds=4, trigger="rapid",
              record_streams=True, verbose=False)
    pcfg = fleet_policy_config("rapid", 8, 7)
    frames = fleet_frames(8, 0, FLEET_TICKS)
    serve_mod.ContinuousBatchingScheduler = RecordingScheduler
    try:
        for tick in ("vectorized", "legacy"):
            out = {name: serve_fleet(m, tok, tick=tick, **kw) for name, m in
                   (("card", gpu), ("cpu", cpu))}
            card, ref_ = out["card"], out["cpu"]
            flip = first_decision_flip(card["telemetry"].streams(),
                                       ref_["telemetry"].streams(), pcfg, frames)
            if flip is not None:
                log(f"  (a) {tick}: decisions part ways at tick {flip[0]} robot {flip[1]}, "
                    f"{flip[2]:.3g} from its threshold (within {DECISION_RTOL:g}); "
                    "the rest of the run is not compared")
                continue
            for k in ("service_rounds", "decode_rounds", "scan_windows", "cancelled",
                      "offload_ms", "offload_ms_by_robot", "deferred"):
                if card[k] != ref_[k]:
                    raise AssertionError(f"(a) {tick}: {k} differs card vs CPU")
            tc, tp = card["telemetry"].summary(), ref_["telemetry"].summary()
            if {**tc, "host_gap_ms": 0} != {**tp, "host_gap_ms": 0}:
                raise AssertionError(f"(a) {tick}: telemetry differs card vs CPU")
            rc, rp = card["sched"].record, ref_["sched"].record
            if [(r, o.tolist()) for r, o, _ in rc] != [(r, o.tolist()) for r, o, _ in rp]:
                raise AssertionError(f"(a) {tick}: chunks harvested in another order")
            near = set()
            for (r, obs_t, tg), (_, _, tp_) in zip(rc, rp):
                diff = np.flatnonzero(tg != tp_)
                if diff.size:
                    gap = top2_gap_tokens(cpu, tok, obs_t, tp_, int(diff[0]))
                    if gap > F32_MARGIN:
                        raise AssertionError(f"(a) {tick}: robot {r}'s chunk differs at step "
                                             f"{diff[0]} where the top-two gap is {gap:.3g}")
                    near.add(r)
            same = [r for r in range(8) if r not in near]
            if not np.array_equal(card["actions"][:, same], ref_["actions"][:, same]):
                raise AssertionError(f"(a) {tick}: actions differ card vs CPU")
            log(f"  (a) f32 smoke {tick}: card vs CPU over {FLEET_TICKS} ticks: decision streams, "
                f"telemetry, {len(rc)} chunks ({len(near)} robots' chunks inside the "
                f"{F32_MARGIN:g} margin), {card['decode_rounds']} rounds in "
                f"{card['scan_windows']} windows, {card['cancelled']} cancels, offload_ms and "
                f"actions equal; offloads {int(card['offloads'].sum())}")
    finally:
        serve_mod.ContinuousBatchingScheduler = ContinuousBatchingScheduler


def fleet_run_line(name, out, counts, captures):
    t, chunks = out["steps"], int(out["telemetry"].completions.sum())
    tel, pool, sched = out["telemetry"], out["pool"], out["sched"]
    m = out["obs"].metrics
    lat, qw = m.get("serve.chunk_latency_ms"), m.get("serve.queue_wait_ms")
    core, eng, close = out["core_tick_ms"], out["engine_tick_ms"], out["close_ticks"]
    inside = eng[~close]
    log(f"  (b) {name}: offloads {int(out['offloads'].sum())} replays {int(tel.replays.sum())} "
        f"cancels {int(tel.cancels.sum())} f_off {out['offload_fraction']:.4f}; "
        f"{chunks} chunks in {out['wall_s']:.3f} s: decode action tokens/s "
        f"{56 * chunks / out['wall_s']:.1f}; chunk latency p50 {lat.quantile(0.5):.2f} p99 "
        f"{lat.quantile(0.99):.2f} ms; queue wait p50 {qw.quantile(0.5):.2f} p99 "
        f"{qw.quantile(0.99):.2f} ms; the decision core a tick mean "
        f"{core.mean():.3f} p99 {np.percentile(core, 99):.3f} max {core.max():.3f} ms; per tick "
        f"core {out['core_s'] / t * 1e3:.3f} engine {out['engine_s'] / t * 1e3:.3f} host "
        f"{out['host_s'] / t * 1e3:.3f} ms; engine ms a tick at a window close mean "
        f"{eng[close].mean() if close.any() else 0:.2f}, inside a window mean "
        f"{inside.mean():.3f} max {inside.max():.2f}; host_gap_ms {out['host_gap_ms']:.2f}; "
        f"peak_batch {out['peak_batch']} rows {sched.rows}; pool high_water {pool.high_water} of "
        f"{sched.allocator.num_pages}; {out['decode_rounds']} rounds in {out['scan_windows']} "
        f"windows; graphs captured {captures}; launches {counts} (exact)")


class SharedStreamCore(DecisionCore):
    """The decision core on the model's stream (no stream of its own): each
    tick's host read then waits for the decode rounds queued before it.  A
    contrast for phase 6(b), not a path of the port."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.stream = None


def same_fleet_run(a, b):
    sa, sb = a["telemetry"].streams(), b["telemetry"].streams()
    ta, tb = (o["telemetry"].summary() | {"host_gap_ms": 0} for o in (a, b))
    return (np.array_equal(a["actions"], b["actions"]) and ta == tb
            and all(np.array_equal(sa[k], sb[k]) for k in sa)
            and all(a[k] == b[k] for k in ("service_rounds", "decode_rounds", "scan_windows",
                                           "cancelled", "offload_ms")))


def fleet_full_width(model, tok, launches):
    """(b) the main path at full width: ``serve_fleet`` on 16 robots, R = 4,
    ``max_slots=8``, with ``Observability``: rapid cold (a new scheduler,
    its graph captured on the way), rapid warm (the same scheduler, reset),
    the legacy tick and the decision core on the model's stream (both equal
    to the warm run), and ``always`` once."""

    kw = dict(n_robots=16, max_steps=FLEET_TICKS, max_slots=8, scan_rounds=4,
              record_streams=True, verbose=False)
    sched, outs = None, {}
    for name, extra in (("rapid cold", {}), ("rapid warm", {}),
                        ("rapid legacy", {"tick": "legacy"}), ("rapid, core on the model's stream",
                                                               {}),
                        ("always", {"trigger": "always"})):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        admits0 = len(sched.admit_ms) if sched is not None else 0
        captures0 = sched.graph_captures if sched is not None else 0
        args = {"trigger": "rapid", **kw, **extra}
        if "model's stream" in name:
            serve_mod.DecisionCore = SharedStreamCore
        try:
            out = serve_fleet(model, tok, obs=Observability(trace=False), sched=sched, **args)
        finally:
            serve_mod.DecisionCore = DecisionCore
        sched = out["sched"]
        counts = check_sched_counts(model, sched, admits0, 0, launches)
        acts = out["actions"]
        if not (acts.shape == (FLEET_TICKS, 16, 7) and np.isfinite(acts).all()
                and out["offloads"].sum() > 0 and out["telemetry"].completions.sum() > 0):
            raise AssertionError(f"(b) {name}: bad fleet output")
        if args["trigger"] == "rapid" and out["cancelled"] == 0:
            raise AssertionError(f"(b) {name}: no cancels")
        fleet_run_line(name, out, counts, sched.graph_captures - captures0)
        outs[name] = out
    for other in ("rapid legacy", "rapid, core on the model's stream"):
        if not same_fleet_run(outs["rapid warm"], outs[other]):
            raise AssertionError(f"(b) {other} differs from the warm vectorized run")
    sched.drain()
    if sched.pool_stats().pages_in_use != 0:
        raise AssertionError("(b) pages left after drain")
    log("  (b) the legacy tick and the core on the model's stream against the warm run (same "
        "scheduler): actions, decision streams, counters, rounds and offload_ms equal")


def fleet_trace_runs(model, tok, launches):
    """(c) ``serve_trace`` at full width: 64 robots, horizon 240, R = 4,
    ``max_slots=16``; Poisson arrivals with churn (mean dwell 96 ticks) and
    bursty arrivals (a burst every 32 ticks); its SLO report; churn returns
    pages without a reset, and a drain returns them all."""

    for name, trace in (("poisson churn", make_trace(64, 240, arrivals="poisson", mean_dwell=96,
                                                     seed=0)),
                        ("bursty", make_trace(64, 240, arrivals="bursty", burst_every=32,
                                              seed=0))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        obs = Observability(trace=False)
        out = serve_trace(model, tok, trace, horizon=240, max_slots=16, scan_rounds=4, obs=obs,
                          verbose=False)
        sched = out["sched"]
        left_pages = sched.pool_stats().pages_in_use
        if left_pages != sched.n_active * sched.pages_per_req:
            raise AssertionError(f"(c) {name}: {left_pages} pages held by "
                                 f"{sched.n_active} live sequences")
        rounds = sched.decode_rounds
        sched.drain()
        counts = check_sched_counts(model, sched, 0, 0, launches)
        if sched.pool_stats().pages_in_use != 0 or out["completions"] == 0:
            raise AssertionError(f"(c) {name}: pages left after drain or no completions")
        log(f"  (c) serve_trace {name}: joined {out['joined']} left {out['left']} churn cancels "
            f"{out['churn_cancels']} peak_active_robots {out['peak_active_robots']}; completions "
            f"{out['completions']} fires {out['fires']} cancels {out['cancels']}; ticks_per_s "
            f"{out['ticks_per_s']:.2f} (wall {out['wall_s']:.3f} s); peak_batch "
            f"{out['peak_batch']}, {rounds} rounds in {out['scan_windows']} windows; pages at the "
            f"horizon {left_pages} (live sequences' only), after drain 0 of "
            f"{sched.allocator.num_pages}; graphs captured {sched.graph_captures}; launches "
            f"{counts} (exact, drain included)")
        for line in build_slo_report(obs.metrics).lines():
            log(f"      {line}")


def engine_card_vs_cpu():
    """(d) the offline engine: ``evaluate_strategy`` over ``episode_suite()``
    for the six strategies, the decision core on the card against the CPU;
    a differing report must come from a tick within ``DECISION_RTOL`` of a
    threshold."""

    rows = []
    for strategy in STRATEGIES:
        t0 = time.perf_counter()
        card = evaluate_strategy(strategy, device="cuda")
        t1 = time.perf_counter()
        cpu = evaluate_strategy(strategy, device="cpu")
        t2 = time.perf_counter()
        if vars(card["report"]) != vars(cpu["report"]) or card["accuracy"] != cpu["accuracy"] \
                or card["mean_error"] != cpu["mean_error"]:
            tcfg = EngineConfig().trigger
            if strategy == "rapid_no_comp":
                tcfg = type(tcfg)(**{**tcfg.__dict__, "theta_comp": 1e9})
            if strategy == "rapid_no_red":
                tcfg = type(tcfg)(**{**tcfg.__dict__, "theta_red": 1e9})
            pcfg = PolicyConfig(trigger=tcfg, chunk_len=8, on_empty="edge")
            for ep in episode_suite():
                a = rapid_trigger_stream(ep, tcfg, device="cuda")
                b = rapid_trigger_stream(ep, tcfg, device="cpu")
                if not np.array_equal(a, b):
                    t = int(np.flatnonzero(a != b)[0])
                    frames = kin.KinematicFrame(*(torch.as_tensor(x[:, None])
                                                  for x in (ep.q, ep.qd, ep.tau)))
                    dist = threshold_distance(pcfg, frames, t, 0)
                    if dist > DECISION_RTOL:
                        raise AssertionError(f"(d) {strategy}: card and CPU dispatch differ "
                                             f"at tick {t} of {ep.task}, {dist:.3g} from its "
                                             "threshold")
                    log(f"  (d) {strategy}: {ep.task} parts ways at tick {t}, {dist:.3g} from "
                        "its threshold")
        rows.append(f"{strategy} {card['total_ms']:.2f} ms acc {card['accuracy']:.4f} "
                    f"(card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s)")
    log(f"  (d) evaluate_strategy, card vs CPU: reports equal for all six: {'; '.join(rows)}")


def fleet_phase(model, tok, launches):
    fleet_card_vs_cpu()
    fleet_full_width(model, tok, launches)
    fleet_trace_runs(model, tok, launches)
    engine_card_vs_cpu()


# ---------------------------------------------------------------------------
# phase 7: partitioned lanes (the edge-cloud split)
# ---------------------------------------------------------------------------

# PartitionedPolicy cuts of the FLEET_LAYERS-deep openvla-7b (the last: empty suffix)
SPLIT_CUTS = (0, FLEET_LAYERS // 2, FLEET_LAYERS)
# lane cut -> its first robot (4 each; 0-3 cloud-only)
HETERO = {0: 4, FLEET_LAYERS // 4: 8, FLEET_LAYERS // 2: 12}
SERIAL_ROBOTS = 4


def n_kind(model, layers, kind="attn"):
    return sum(model.specs[i][0] == kind for i in layers)


class SplitLedger:
    """The hand-kernel launches a split serving run must make, counted
    from what the scheduler and its lanes' executors dispatch (their
    methods wrapped; a weak reference back, so no cycle keeps the
    scheduler's graphs alive):

      * a robot's edge prefill: one flash (Mamba scan) per edge attention
        (Mamba) layer; a lane's suffix prefill: the same over its suffix;
      * a serial token: one dense decode per edge attention layer per
        robot, one paged decode per suffix attention layer for the lane;
      * a fused window of ``n`` tokens over lanes with cuts ``c_i``: ``n``
        dense decodes per edge attention layer of each lane, ``n`` paged
        decodes per attention layer from ``min(c_i)`` on (the tail runs
        once over the joined rows);
      * a cloud window and a cloud admission (in ``_try_admit``, or a
        disaggregated one's in ``_dispatch_prefill``): as
        ``sched_launches``.

    On a rank's model it also counts the collectives those calls must make
    (``calls``, from ``dist``'s counts: a cloud token's or an admission's,
    a robot's edge prefill or token, a lane's suffix prefill or token, a
    fused window token's ``lane_collectives``)."""

    def __init__(self, sched):
        self.want = {n: 0 for n in _lib.KERNELS}
        self.calls = {"all_reduce": 0, "all_gather": 0}
        self.sched_ref = weakref.ref(sched)
        self.wrapped = {}  # id -> weak reference of each executor wrapped
        model, cls = sched.model, type(sched)
        ledger = weakref.ref(self)

        def counted_window(block, rounds):
            s = ledger().sched_ref()
            ledger().add("paged_attention", model.n_attn * block * rounds * s.local_shards)
            ledger().add_calls(dist.collectives(model.cfg), block * rounds)
            return cls._decode_window(ledger().sched_ref(), block, rounds)

        def counted_fused(lanes, block, rounds):
            n_steps = block * rounds
            first = min(l.cut for l in lanes)
            ledger().add("decode_attention",
                         n_steps * sum(n_kind(model, range(l.cut)) for l in lanes))
            ledger().add("paged_attention",
                         n_steps * n_kind(model, range(first, model.cfg.num_layers)))
            ledger().add_calls(dist.lane_collectives(model.cfg, tuple(l.cut for l in lanes)),
                               n_steps)
            return cls._split_fused_step(ledger().sched_ref(), lanes, block, rounds)

        def counted(fn):
            def admit(*a):
                s = ledger().sched_ref()
                n0 = len(s.admit_ms)
                out = fn(s, *a)
                ledger().add("flash_attention", model.n_attn * (len(s.admit_ms) - n0))
                ledger().add("mamba_scan", model.n_mamba * (len(s.admit_ms) - n0))
                ledger().add_calls(dist.collectives(model.cfg, s.prompt_len),
                                   len(s.admit_ms) - n0)
                return out

            return admit

        sched._decode_window, sched._split_fused_step = counted_window, counted_fused
        # an admission prefills in ``_try_admit``, or, disaggregated, in
        # ``_dispatch_prefill`` (on the prefill rank over ranks)
        sched._try_admit = counted(cls._try_admit)
        sched._dispatch_prefill = counted(cls._dispatch_prefill)
        self.wrap_lanes()

    def add(self, name, n):
        self.want[name] += n

    def add_calls(self, counts, times=1):
        if self.sched_ref().model.group is not None:  # one rank makes none
            for k, n in counts.items():
                self.calls[k] += n * times

    def side_calls(self, model, layers, prompt, embed):
        """One edge (``embed``: its embedding's all-reduce) or suffix (the
        logits' all-gather) pass over ``layers``."""

        out = dist.layer_collectives(model.cfg, layers, prompt)
        out["all_reduce" if embed else "all_gather"] += 1
        self.add_calls(out)

    def wrap_lanes(self):
        """Count the lanes' executor calls (attach every lane first)."""

        ledger = weakref.ref(self)
        for lane in self.sched_ref()._lanes.values():
            ex = lane.ex
            if id(ex) in self.wrapped:
                continue
            self.wrapped[id(ex)] = weakref.ref(ex)
            exr, cls = weakref.ref(ex), type(ex)  # bound per lane by the defaults
            edge = n_kind(ex.model, ex.edge_layers), n_kind(ex.model, ex.edge_layers, "mamba")
            cloud = n_kind(ex.model, ex.cloud_layers), n_kind(ex.model, ex.cloud_layers, "mamba")

            def prefill(*a, _n=edge, _x=exr):
                ledger().add("flash_attention", _n[0])
                ledger().add("mamba_scan", _n[1])
                ledger().side_calls(_x().model, _x().edge_layers, np.shape(a[0])[1], True)
                return cls.edge_prefill(_x(), *a)

            def suffix_prefill(*a, _n=cloud, _x=exr):
                ledger().add("flash_attention", _n[0])
                ledger().add("mamba_scan", _n[1])
                ledger().side_calls(_x().model, _x().cloud_layers, a[0].shape[1], False)
                return cls.suffix_prefill(_x(), *a)

            def edge_step(*a, _n=edge, _x=exr):
                ledger().add("decode_attention", _n[0])
                ledger().side_calls(_x().model, _x().edge_layers, 1, True)
                return cls.edge_step(_x(), *a)

            def suffix_step(*a, _n=cloud, _x=exr):
                ledger().add("paged_attention", _n[0])
                ledger().side_calls(_x().model, _x().cloud_layers, 1, False)
                return cls.suffix_step(_x(), *a)

            ex.edge_prefill, ex.suffix_prefill = prefill, suffix_prefill
            ex.edge_step, ex.suffix_step = edge_step, suffix_step

    def release(self):
        """Take the counting wrappers off the scheduler and its executors."""

        for obj in [self.sched_ref()] + [r() for r in self.wrapped.values()]:
            if obj is not None:
                for name in ("_decode_window", "_split_fused_step", "_try_admit",
                             "_dispatch_prefill", "edge_prefill", "suffix_prefill", "edge_step",
                             "suffix_step"):
                    obj.__dict__.pop(name, None)

    def check(self, what, launches):
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        if counts != self.want:
            raise AssertionError(f"{what}: launch counts {counts}, expected {self.want}")
        for n in launches:
            launches[n] += counts[n]
        return counts


def split_policy_card_vs_cpu():
    """(a) f32 smoke twins, the same weights on the card (kernels, the
    policy's CUDA graph) and on the CPU: ``PartitionedPolicy`` at every cut
    of openvla-smoke, and jamba-smoke's cut 2 with the experts of layer 1
    cloud-side against its plain cut-2 lane; each chunk equal to the CPU's
    and to ``CloudPolicy``'s, or different only inside the f32 margin."""

    rng = np.random.default_rng(21)
    obs = [(rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7))) for _ in range(3)]
    for arch, lanes in (("openvla-7b", None), (JAMBA, [(2, ()), (2, (1,))])):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        cpu = Model(cfg, device="cpu")
        gpu = Model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        tok = EpisodeTokenizer(cfg.vocab_size)
        lanes = lanes or [(c, ()) for c in range(cfg.num_layers + 1)]
        near = 0
        for qd, tau in obs:
            obs_t = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)[0]
            want = CloudPolicy(cpu, tok).chunk_tokens(qd, tau)[0]
            for cut, off in lanes:
                for name, m in (("card", gpu), ("cpu", cpu)):
                    got = PartitionedPolicy(PartitionExecutor(m, cut, expert_offload=off),
                                            tok).chunk_tokens(qd, tau)[0]
                    diff = np.flatnonzero(got != want)
                    if diff.size:
                        gap = top2_gap_tokens(cpu, tok, obs_t, want, int(diff[0]))
                        if gap > F32_MARGIN:
                            raise AssertionError(f"(a) {arch} cut {cut} {off} {name}: chunk "
                                                 f"differs at step {diff[0]}, gap {gap:.3g}")
                        near += 1
        log(f"  (a) {cfg.name} f32: PartitionedPolicy at {lanes} on the card (graphs) and the "
            f"CPU, {len(obs)} observations: chunks equal to CloudPolicy's "
            f"({near} inside the {F32_MARGIN:g} margin)")


def split_fleet_card_vs_cpu():
    """(a) f32 openvla-smoke ``serve_fleet(trigger="rapid")``, 8 robots at
    ``robot_cuts`` {0, 1, 2} (two cloud-only), pipelined, R = 4, card vs
    CPU: decision streams, counters, rounds, ``mixed_rounds``,
    ``hetero_rounds`` equal, chunks equal or inside the f32 margin."""

    cfg = get_smoke_config("openvla-7b").replace(dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tok = EpisodeTokenizer(cfg.vocab_size)
    cuts = {1: 0, 2: 1, 3: 2, 5: 0, 6: 1, 7: 2}
    serve_mod.ContinuousBatchingScheduler = RecordingScheduler
    try:
        out = {name: serve_fleet(m, tok, n_robots=8, max_steps=FLEET_TICKS, scan_rounds=4,
                                 trigger="rapid", record_streams=True, verbose=False,
                                 partition_executor=PartitionExecutor(m, 0), robot_cuts=cuts)
               for name, m in (("card", gpu), ("cpu", cpu))}
    finally:
        serve_mod.ContinuousBatchingScheduler = ContinuousBatchingScheduler
    card, ref_ = out["card"], out["cpu"]
    flip = first_decision_flip(card["telemetry"].streams(), ref_["telemetry"].streams(),
                               fleet_policy_config("rapid", 8, 7), fleet_frames(8, 0, FLEET_TICKS))
    if flip is not None:
        log(f"  (a) split fleet: decisions part ways at tick {flip[0]} robot {flip[1]}, "
            f"{flip[2]:.3g} from its threshold; the rest is not compared")
        return
    for k in ("service_rounds", "decode_rounds", "scan_windows", "cancelled", "mixed_rounds",
              "hetero_rounds", "offload_ms"):
        if card[k] != ref_[k]:
            raise AssertionError(f"(a) split fleet: {k} differs card vs CPU")
    if card["hetero_rounds"] == 0 or card["mixed_rounds"] == 0:
        raise AssertionError("(a) split fleet: no mixed or heterogeneous rounds")
    tc, tp = card["telemetry"].summary(), ref_["telemetry"].summary()
    if {**tc, "host_gap_ms": 0} != {**tp, "host_gap_ms": 0}:
        raise AssertionError("(a) split fleet: telemetry differs card vs CPU")
    rc, rp = card["sched"].record, ref_["sched"].record
    if [(r, o.tolist()) for r, o, _ in rc] != [(r, o.tolist()) for r, o, _ in rp]:
        raise AssertionError("(a) split fleet: chunks harvested in another order")
    near = set()
    for (r, obs_t, tg), (_, _, tp_) in zip(rc, rp):
        diff = np.flatnonzero(tg != tp_)
        if diff.size:
            gap = top2_gap_tokens(cpu, tok, obs_t, tp_, int(diff[0]))
            if gap > F32_MARGIN:
                raise AssertionError(f"(a) split fleet: robot {r}'s chunk differs at step "
                                     f"{diff[0]} where the top-two gap is {gap:.3g}")
            near.add(r)
    same = [r for r in range(8) if r not in near]
    if not np.array_equal(card["actions"][:, same], ref_["actions"][:, same]):
        raise AssertionError("(a) split fleet: actions differ card vs CPU")
    log(f"  (a) f32 smoke split fleet, card vs CPU over {FLEET_TICKS} ticks, cuts {cuts}: "
        f"decision streams, telemetry, {len(rc)} chunks ({len(near)} robots' chunks inside "
        f"the {F32_MARGIN:g} margin), {card['decode_rounds']} rounds in "
        f"{card['scan_windows']} windows, mixed_rounds {card['mixed_rounds']}, hetero_rounds "
        f"{card['hetero_rounds']}, {card['cancelled']} cancels and actions equal")


def split_policy_full_width(model, tok, launches, cuts=SPLIT_CUTS):
    """(b) ``PartitionedPolicy`` on openvla-7b (``FLEET_LAYERS`` deep) at ``cuts``: graph
    chunks against eager (tokens equal) and against ``CloudPolicy`` by the
    greedy-margin rule; cloud_ms of the split graph beside CloudPolicy's
    graph and the modeled channel ms."""

    rng = np.random.default_rng(23)
    obs = [(rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7))) for _ in range(2)]
    cloud = CloudPolicy(model, tok)
    want = [cloud.chunk_tokens(qd, tau) for qd, tau in obs]
    cloud_ms = []
    for qd, tau in obs:
        t0 = time.perf_counter()
        cloud.chunk_tokens(qd, tau)
        cloud_ms.append((time.perf_counter() - t0) * 1e3)
    n = model.n_attn
    for cut in cuts:
        policy = PartitionedPolicy(PartitionExecutor(model, cut), tok)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms, eager_ms, diverged = [], [], 0
        for (qd, tau), w in zip(obs, want):
            tokens = torch.as_tensor(np.concatenate([tok.encode_state(qd), tok.encode_state(tau)],
                                                    axis=1), device="cuda")
            t0 = time.perf_counter()
            te = policy.eager_chunk(tokens)[0].cpu().numpy()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            tg = policy.chunk_tokens(qd, tau)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(te, tg):
                raise AssertionError(f"(b) PartitionedPolicy cut {cut}: graph tokens differ "
                                     "from eager")
            diff = np.flatnonzero(tg[0] != w[0])
            if diff.size:
                diverged += 1
                gap = top2_gap_at(model, tok, qd, tau, w, int(diff[0]))
                if gap > MARGIN_TOL:
                    raise AssertionError(f"(b) cut {cut}: split token differs at step "
                                         f"{diff[0]} where the top-two gap is {gap:.3g}")
        # each chunk twice (eager, graph; the first graph call runs eagerly
        # and captures): a prefill flash and 56 dense decodes per layer
        want_counts = {k: 0 for k in _lib.KERNELS}
        want_counts["flash_attention"] = 2 * len(obs) * n
        want_counts["decode_attention"] = 2 * len(obs) * n * policy.n_steps
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        if counts != want_counts:
            raise AssertionError(f"(b) cut {cut}: launches {counts}, expected {want_counts}")
        for k in launches:
            launches[k] += counts[k]
        log(f"  (b) PartitionedPolicy cut {cut}/{model.cfg.num_layers}: graph == eager tokens; "
            f"vs CloudPolicy {diverged} of {len(obs)} chunks diverged within the margin; "
            f"cloud_ms graph {ms[1:]} (first, with capture, {ms[0]:.1f}) eager "
            f"{np.mean(eager_ms):.1f} vs CloudPolicy graph {np.mean(cloud_ms):.2f}; modeled "
            f"net_ms {policy.net_ms_log[-1]:.2f} (the channel model, wan); launches {counts}")


class SplitRecorder(ContinuousBatchingScheduler):
    """A scheduler that counts its harvested chunks by lane (cloud or cut)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.by_lane = {}

    def _close_window(self):
        done = super()._close_window()
        for r in done:
            key = "cloud" if r.cut is None else r.cut
            self.by_lane[key] = self.by_lane.get(key, 0) + 1
        return done


def suffix_pool_bytes(sched, first_cut):
    """Bytes of the scheduler's shared suffix K/V pools for lanes whose
    shallowest cut is ``first_cut``: two pools per attention layer past it."""

    spec, model = sched.paged_spec, sched.model
    per_layer = (2 * (spec.num_pages + 1) * spec.page_size * model.cfg.num_kv_heads
                 * model.cfg.resolved_head_dim * model.embed.table.element_size())
    return per_layer * n_kind(model, range(first_cut, model.cfg.num_layers))


def hetero_robot_cuts():
    return {r: cut for cut, start in HETERO.items() for r in range(start, start + 4)}


def split_fleet_full_width(model, tok, launches):
    """(b) a heterogeneous fleet at full width: 16 robots x ``FLEET_TICKS``,
    R = 4, ``max_slots=8``, robots 0-3 cloud-only and four each at the cuts
    of ``HETERO``, pipelined, with ``Observability``, cold then warm; pages all
    back after a drain; exact launch counts.  Then a short serial run (the
    host ping-pong) of ``SERIAL_ROBOTS`` robots against the pipelined lanes
    on the same observations."""

    cuts = hetero_robot_cuts()
    sched = SplitRecorder(model, tok, max_slots=8, scan_rounds=4)
    base = PartitionExecutor(model, 0)
    for cut in sorted(HETERO):
        sched.attach_partition(base.with_cut(cut))
    ledger = SplitLedger(sched)
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ledger.want = {n: 0 for n in _lib.KERNELS}
        captures0, capture_s0 = sched.graph_captures, sched.capture_s
        drops0 = {c: lane.drops for c, lane in sched._lanes.items()}
        sched.by_lane = {}
        obs = Observability(trace=False)
        out = serve_fleet(model, tok, n_robots=16, max_steps=FLEET_TICKS, scan_rounds=4,
                          trigger="rapid", record_streams=True, verbose=False, obs=obs,
                          partition_executor=base, robot_cuts=cuts, sched=sched)
        sched.drain()
        if sched.pool_stats().pages_in_use != 0:
            raise AssertionError(f"(b) split fleet {run}: pages left after drain")
        counts = ledger.check(f"(b) split fleet {run}", launches)
        m = obs.metrics
        chunks = int(out["telemetry"].completions.sum())
        lat = m.get("serve.chunk_latency_ms")
        fused = {k: v for k, v in m.to_json().items() if k.startswith("sched.fused_dispatch_ms")}
        bytes_ = {k: v for k, v in m.to_json().items() if k.startswith("channel.bytes")}
        if out["hetero_rounds"] == 0 or out["mixed_rounds"] == 0:
            raise AssertionError(f"(b) split fleet {run}: no heterogeneous or mixed rounds")
        if any(lane.has_buffers for lane in sched._lanes.values()) or sched._suffix_pools:
            raise AssertionError(f"(b) split fleet {run}: lane buffers or pools kept after drain")
        log(f"  (b) split fleet {run}, lane buffers: freed {{cut: times}} "
            f"{ {c: lane.drops - drops0[c] for c, lane in sched._lanes.items()} }; the most a "
            f"lane held (bytes) { {c: lane.peak_bytes for c, lane in sched._lanes.items()} }; "
            f"shared suffix pools while a lane lives "
            f"{suffix_pool_bytes(sched, min(HETERO)) / 2**20:.1f} MiB; fused graphs captured "
            f"{sched.graph_captures - captures0} in {sched.capture_s - capture_s0:.2f} s")
        log(f"  (b) split fleet {run}: offloads {int(out['offloads'].sum())} cancels "
            f"{out['cancelled']}; {chunks} chunks in {out['wall_s']:.3f} s: decode action "
            f"tokens/s {56 * chunks / out['wall_s']:.1f}; chunk latency p50 "
            f"{lat.quantile(0.5):.2f} p99 {lat.quantile(0.99):.2f} ms; mixed_rounds "
            f"{out['mixed_rounds']} hetero_rounds {out['hetero_rounds']} of "
            f"{out['decode_rounds']} rounds; fused graphs captured "
            f"{sched.graph_captures - captures0} (all graphs {len(sched._fleet_graphs)} fused, "
            f"{len(sched._graphs)} cloud); fused_dispatch_ms {fused}; channel bytes {bytes_}; "
            f"chunks by lane {sched.by_lane} (drain included); pages back after drain; "
            f"launches {counts} (exact, drain included)")
    ledger.release()
    # all 16 at once, the second window under the profiler: an emptied
    # lane's graphs go with its buffers, so the first window after an
    # admission captures them, and the second replays them
    reqs = requests(np.random.default_rng(37), 16)
    profile_window(model, tok, sched, reqs, route=cuts, skip_first=True)
    # the serial lanes (per-token host ping-pong) on the first robots'
    # observations, against the same robots through the pipelined lanes
    rng = np.random.default_rng(29)
    reqs = [(r, rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7)))
            for r in range(SERIAL_ROBOTS)]
    lane_cuts = sorted(HETERO)
    lane_of = {r: lane_cuts[min(r, len(lane_cuts) - 1)] for r in range(SERIAL_ROBOTS)}
    toks = {}
    for pipelined in (True, False):
        s = ContinuousBatchingScheduler(model, tok, max_slots=4, scan_rounds=4)
        for cut in sorted(set(lane_of.values())):
            s.attach_partition(base.with_cut(cut), pipelined=pipelined)
        ledger = SplitLedger(s)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for r, qd, tau in reqs:
            s.submit(r, qd, tau, partitioned=True, cut=lane_of[r])
        res = s.drain()
        wall = time.perf_counter() - t0
        counts = ledger.check(f"(b) {'pipelined' if pipelined else 'serial'} lanes", launches)
        toks[pipelined] = {x.robot_id: x.tokens for x in res}
        log(f"  (b) {'pipelined' if pipelined else 'serial'} lanes, {SERIAL_ROBOTS} robots at "
            f"cuts {lane_of}: {len(res)} chunks in {wall:.2f} s; launches {counts} (exact)")
        ledger.release()
    equal = 0
    for r, qd, tau in reqs:
        a, b = toks[True][r], toks[False][r]
        if np.array_equal(a, b):
            equal += 1
            continue
        diff = int(np.flatnonzero(a != b)[0])
        gap = top2_gap_at(model, tok, qd, tau, b[None], diff)
        if gap > MARGIN_TOL:
            raise AssertionError(f"(b) serial vs pipelined robot {r}: token {diff} differs, "
                                 f"gap {gap:.3g}")
    log(f"  (b) serial vs pipelined: {equal} of {SERIAL_ROBOTS} chunks equal, the rest within "
        "the greedy margin")


def split_jamba(model, tok, launches, policy):
    """(c) Jamba (4 layers, bf16): an expert-offload lane (cut 2, the
    experts of layer 1 cloud-side) and a plain cut-2 lane served together
    with cloud-only robots by the scheduler (R = 4); each chunk held to
    ``policy`` (``CloudPolicy(paged=True)``) by the greedy-margin rule;
    exact launch counts; pages back."""

    reqs = requests(np.random.default_rng(31), 6)
    obs_of = {r: (qd, tau) for r, qd, tau in reqs}
    reference = {r: policy.chunk_tokens(qd, tau)[0] for r, qd, tau in reqs}
    route = {0: (2, (1,)), 1: 2, 3: (2, (1,)), 4: 2}
    sched = ContinuousBatchingScheduler(model, tok, max_slots=4, scan_rounds=4,
                                        num_pages=6 * -(-(14 + 56) // 16))
    base = PartitionExecutor(model, 2)
    sched.attach_partition(base)
    sched.attach_partition(base.with_cut(2, expert_offload=(1,)))
    ledger = SplitLedger(sched)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r, qd, tau in reqs:
        sched.submit(r, qd, tau, partitioned=r in route, cut=route.get(r))
    results = sched.drain()
    wall = time.perf_counter() - t0
    counts = ledger.check("(c) jamba split lanes", launches)
    if sorted(r.robot_id for r in results) != list(range(6)) or \
            sched.pool_stats().pages_in_use != 0:
        raise AssertionError("(c) jamba split lanes: wrong results or pages left")
    if sched.mixed_rounds == 0:
        raise AssertionError("(c) jamba split lanes: no mixed rounds")
    diverged = check_chunks(model, tok, results, reference, obs_of)
    log(f"  (c) {model.cfg.name}: lanes {sched.active_lanes or [2, (2, (1,))]} and cloud-only, "
        f"{len(results)} chunks in {wall:.2f} s ({sched.decode_rounds} rounds, mixed "
        f"{sched.mixed_rounds}); vs CloudPolicy(paged=True) {diverged} of 6 diverged within the "
        f"margin; fused graphs {len(sched._fleet_graphs)}; launches {counts} (exact)")


def partition_phase(model, tok, launches):
    split_policy_card_vs_cpu()
    split_fleet_card_vs_cpu()
    split_policy_full_width(model, tok, launches)
    split_fleet_full_width(model, tok, launches)


# ---------------------------------------------------------------------------
# phase 7b: data shards and disaggregated prefill on one card
# ---------------------------------------------------------------------------

SHARDS = 2  # data shards of the phase's meshes, all on the model's card
# (name, data shards (0: no mesh), disaggregated prefill)
SHARD_MODES = (("base", 0, False), (f"data={SHARDS}", SHARDS, False),
               ("disaggregated", 0, True), (f"data={SHARDS} + disaggregated", SHARDS, True))
GAP_WINDOWS = 12  # windows of (c)'s staggered load, two new robots at each boundary


def shard_kw(model, data: int, disagg: bool):
    """The scheduler's ``mesh`` (``data`` shards, every one on the model's
    device) and ``prefill_group`` (the model's device)."""

    dev = model.device
    return dict(mesh=make_test_mesh(data=data, devices=[dev] * data) if data else None,
                prefill_group=[dev] if disagg else None)


def boundary_arrivals(sched, reqs, per, gaps=None):
    """``per`` new robots (``submit_batch``) at every window boundary until
    all of ``reqs`` are in, then to the drain -> results; ``gaps`` gets each
    window's host ms (the sum of its ``step`` calls)."""

    results, nxt, cur = [], 0, 0.0
    while nxt < len(reqs) or sched.n_pending or sched.n_active:
        if sched._window is None and nxt < len(reqs):
            batch = reqs[nxt:nxt + per]
            sched.submit_batch([r for r, _, _ in batch], np.concatenate([b[1] for b in batch]),
                               np.concatenate([b[2] for b in batch]))
            nxt += len(batch)
        closes = sched.window_closes
        t0 = time.perf_counter()
        results += sched.step()
        cur += (time.perf_counter() - t0) * 1e3
        if sched.window_closes > closes:
            if gaps is not None:
                gaps.append(cur)
            cur = 0.0
    return results


def sharded_card_vs_cpu(launches):
    """(a) f32 openvla-smoke, the same weights on the card (kernels, graphs,
    the prefill stream) and on the CPU (plain versions, both phases of the
    disaggregated admission in order): a scheduler over ``SHARDS`` data
    shards with disaggregated prefill, 8 robots staggered, R = 4; admitted
    and completed rounds equal, chunks equal or inside the f32 margin, every
    shard back to 0; the card's launches exact."""

    cfg = get_smoke_config("openvla-7b").replace(dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tok = EpisodeTokenizer(cfg.vocab_size)
    reqs = requests(np.random.default_rng(5), 8)
    out = {}
    for name, m in (("card", gpu), ("cpu", cpu)):
        sched = ContinuousBatchingScheduler(m, tok, max_slots=4, scan_rounds=4,
                                            num_pages=8 * -(-(14 + 56) // 16),
                                            **shard_kw(m, SHARDS, True))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        results = staggered(sched, reqs)
        if name == "card":
            counts = check_sched_counts(m, sched, 0, 0, launches)
        out[name] = (sched, {r.robot_id: r for r in results})
    (sc, card), (sp, cpu_res) = out["card"], out["cpu"]
    if card.keys() != cpu_res.keys() or len(card) != 8:
        raise AssertionError(f"(a) served {sorted(card)} on the card, {sorted(cpu_res)} on the CPU")
    near = 0
    obs_of = {r: (qd, tau) for r, qd, tau in reqs}
    for r, got in card.items():
        want = cpu_res[r]
        if (got.admitted_round, got.completed_round) != (want.admitted_round,
                                                          want.completed_round):
            raise AssertionError(f"(a) robot {r}: rounds {got.admitted_round}-"
                                 f"{got.completed_round} on the card, {want.admitted_round}-"
                                 f"{want.completed_round} on the CPU")
        diff = np.flatnonzero(np.asarray(got.tokens) != np.asarray(want.tokens))
        if diff.size:
            qd, tau = obs_of[r]
            prompt = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)[0]
            gap = top2_gap_tokens(cpu, tok, prompt, np.asarray(want.tokens), int(diff[0]))
            if gap > F32_MARGIN:
                raise AssertionError(f"(a) robot {r}: chunk differs at step {diff[0]} where the "
                                     f"top-two gap is {gap:.3g}")
            near += 1
    for s in (sc, sp):
        if s.pool_stats().shard_in_use != (0,) * SHARDS or s._pending_admit:
            raise AssertionError(f"(a) pages or prefills left: {s.pool_stats()}")
    log(f"  (a) f32 smoke, data={SHARDS} + disaggregated prefill, card vs CPU: 8 robots "
        f"staggered, R = 4, rows {sc.rows}; admitted and completed rounds equal, {near} of 8 "
        f"chunks inside the {F32_MARGIN:g} margin, the rest equal; shard high water card "
        f"{sc.pool_stats().shard_high_water} CPU {sp.pool_stats().shard_high_water}, in use "
        f"(0, 0); {len(sc.admit_ms)} prefills on the side stream, merges host ms mean "
        f"{np.mean(sc.merge_ms):.2f}; launches {counts} (exact)")


def sharded_full_width(model, tok, launches):
    """(b) full width: 16 robots, 2 new at each boundary, R = 4,
    ``max_slots=8``, in the four ``SHARD_MODES``, each cold (a new
    scheduler, its graphs captured on the way) and warm (reset): tokens/s,
    chunk latency, per-shard high water, exact launches (a sharded round
    launches the paged kernel ``SHARDS`` times a layer a token); each mode's
    chunks held to base's by the greedy-margin rule (a mode's split plan
    follows the rows a launch holds, so modes need not agree bit for bit)."""

    ppr = -(-(14 + 56) // 16)
    reqs = requests(np.random.default_rng(13), 16)
    obs_of = {r: (qd, tau) for r, qd, tau in reqs}
    base = None
    for name, data, disagg in SHARD_MODES:
        sched = ContinuousBatchingScheduler(model, tok, max_slots=8, scan_rounds=4,
                                            num_pages=16 * ppr, decode_block=7,
                                            **shard_kw(model, data, disagg))
        for run in ("cold", "warm"):
            if run == "warm":
                sched.reset()
            sched.obs = Observability(trace=False)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            admits0, rounds0, captures0 = len(sched.admit_ms), sched.decode_rounds, \
                sched.graph_captures
            t0 = time.perf_counter()
            results = boundary_arrivals(sched, reqs, 2)
            counts = check_sched_counts(model, sched, admits0, rounds0, launches)
            wall = time.perf_counter() - t0
            if sorted(r.robot_id for r in results) != list(range(16)):
                raise AssertionError(f"(b) {name} {run}: served {[r.robot_id for r in results]}")
            per_layer = counts["paged_attention"] / (model.n_attn * 7 *
                                                     (sched.decode_rounds - rounds0))
            m = sched.obs.metrics
            lat = m.get("serve.chunk_latency_ms")
            st = sched.pool_stats()
            merges = (f", merges host ms mean {np.mean(sched.merge_ms):.2f}"
                      if sched.merge_ms else "")
            log(f"  (b) {name} {run}: 16 chunks in {wall:.3f} s: action tokens/s "
                f"{16 * 56 / wall:.1f}; chunk latency p50 {lat.quantile(0.5):.2f} p99 "
                f"{lat.quantile(0.99):.2f} ms; rows {sched.rows}, pool high water "
                f"{st.high_water} of {sched.allocator.num_pages}, per shard "
                f"{st.shard_high_water}; {sched.decode_rounds - rounds0} rounds in "
                f"{sched.windows} windows; admission host ms mean "
                f"{np.mean(sched.admit_ms[admits0:]):.2f}{merges}; graphs captured "
                f"{sched.graph_captures - captures0}; paged launches a layer a token "
                f"{per_layer:g}; launches {counts} (exact)")
            if per_layer != max(data, 1) or st.pages_in_use or (
                    data and st.shard_in_use != (0,) * data):
                raise AssertionError(f"(b) {name}: {per_layer} paged launches a layer a token, "
                                     f"pool {st}")
        chunks = {r.robot_id: np.asarray(r.tokens) for r in results}
        if base is None:
            base = chunks
            continue
        diverged = check_chunks(model, tok, results, base, obs_of)
        log(f"  (b) {name} vs base: {diverged} of 16 chunks diverged within the margin")


def stream_overlap(prof):
    """The prefill's and the round graph's device activity in a profile:
    their streams (the flash kernel's and the paged kernel's), each
    stream's busy ms and the ms both were busy at once (None: the profiler
    saw none of them)."""

    cuda = torch.autograd.DeviceType.CUDA
    evs = [(e.name(), e.device_resource_id(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    fl = {s for n, s, _, _ in evs if "flash" in n}
    pg = {s for n, s, _, _ in evs if "paged" in n}
    if not fl or not pg:
        return None

    def union(stream):
        spans = sorted((a, b) for _, s, a, b in evs if s == stream)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy(spans):
        return sum(b - a for a, b in spans) / 1e6

    ps, ds = union(min(fl)), union(min(pg))
    both, i, j = 0, 0, 0
    while i < len(ps) and j < len(ds):
        both += max(0, min(ps[i][1], ds[j][1]) - max(ps[i][0], ds[j][0]))
        if ps[i][1] < ds[j][1]:
            i += 1
        else:
            j += 1
    return sorted(fl), sorted(pg), busy(ps), busy(ds), both / 1e6


def disaggregation_gaps(model, tok, launches):
    """(c) the staggered load of the reference's disaggregation test: two new
    robots at every boundary for ``GAP_WINDOWS`` windows, R = 4, without and
    with disaggregated prefill: the mean host ms of a window after the
    third (printed, not held to anything); then one profiled window of the
    disaggregated scheduler, two prompts prefilled while two robots decode:
    the flash kernels must run on another stream than the round graph's
    paged kernels, and the two streams' overlap is printed."""

    from torch.profiler import ProfilerActivity, profile

    reqs = requests(np.random.default_rng(17), 2 * GAP_WINDOWS)
    scheds = {}
    for name, disagg in (("base", False), ("disaggregated", True)):
        sched = ContinuousBatchingScheduler(model, tok, max_slots=8, scan_rounds=4,
                                            num_pages=63, **shard_kw(model, 0, disagg))
        for run in ("cold", "warm"):
            if run == "warm":
                sched.reset()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            admits0, rounds0 = len(sched.admit_ms), sched.decode_rounds
            gaps = []
            boundary_arrivals(sched, reqs, 2, gaps)
            counts = check_sched_counts(model, sched, admits0, rounds0, launches)
            log(f"  (c) {name} {run}: {len(gaps)} windows, host ms a window after the third "
                f"mean {np.mean(gaps[3:GAP_WINDOWS]):.2f} (all: mean {np.mean(gaps):.2f}, max "
                f"{max(gaps):.2f}); launches {counts} (exact)")
        scheds[name] = sched
    sched = scheds["disaggregated"]
    sched.reset()
    sched.submit_batch([0, 1], np.concatenate([reqs[0][1], reqs[1][1]]),
                       np.concatenate([reqs[0][2], reqs[1][2]]))
    sched.step()
    while sched._window is not None:
        sched.step()
    sched.submit_batch([2, 3], np.concatenate([reqs[2][1], reqs[3][1]]),
                       np.concatenate([reqs[2][2], reqs[3][2]]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        while sched._window is not None:
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sched.drain()
    seen = stream_overlap(prof)
    if seen is None:
        log(f"  (c) profiled window: wall {wall_ms:.1f} ms; streams not measured (the profiler "
            "recorded no flash or paged kernel)")
        return
    fl, pg, pre_ms, dec_ms, both_ms = seen
    if set(fl) & set(pg):
        raise AssertionError(f"(c) the prefill's flash kernels ran on the round graph's stream "
                             f"{fl} / {pg}")
    log(f"  (c) profiled window (2 prompts prefilled while 2 robots decode, R = 4): wall "
        f"{wall_ms:.1f} ms (profiler on); prefill stream {fl} busy {pre_ms:.3f} ms, round "
        f"stream {pg} busy {dec_ms:.3f} ms, both busy at once {both_ms:.3f} ms")


def serve_cli_sharded():
    """(d) ``python -m repro_torch.launch.serve --fleet 4 --sharded
    --disaggregate-prefill`` on the card: exit 0."""

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--fleet", "4",
                           "--sharded", "--disaggregate-prefill"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"(d) serve CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    log(f"  (d) serve --fleet 4 --sharded --disaggregate-prefill: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines[:2] + lines[-1:]))


def sharded_phase(model, tok, launches):
    sharded_card_vs_cpu(launches)
    sharded_full_width(model, tok, launches)
    disaggregation_gaps(model, tok, launches)
    serve_cli_sharded()


# ---------------------------------------------------------------------------
# phase 7c: the mesh's model axis, tensor-parallel ranks
# ---------------------------------------------------------------------------

MODEL_AXIS = 2      # ranks of phase 7c's model axis
RANKS_TIMEOUT_S = 190  # the ranks' own limit: started, served and joined within it
# the rapid fleet's ticks in phase 7c: the 8 bootstrap fetches, the first
# trigger fires (ticks 190-200), the first cancels (ticks 214-216) and the
# window after them: 24 offloads, 2 cancels, 40 decode rounds (a gloo round
# of 7 tokens, 126 collectives each a pinned-host round trip, took 531-666
# ms on one H100 80GB HBM3 at 700 W, so the episodes' later contact phases,
# 80 rounds more to tick 300, stay with phase 6)
AXIS_TICKS = 221
# the first prefill's logits, rank vs one rank: every element within 2^-5
# of the row's largest |logit|, twice the error measured on the card
# (0.06445 at a largest |logit| of 4.344: 2^-6.1 of it); a rank that skips
# the attention output's all-reduce must fail it (``control_logits``)
TP_LOGIT_TOL = (0.0, 0.0, 2.0**-5)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def axis_plan():
    """(backend, each rank's device): NCCL one rank a card where there are
    ``MODEL_AXIS`` cards, else gloo with every rank on card 0 (NCCL takes
    no two ranks on one card)."""

    if torch.cuda.device_count() >= MODEL_AXIS:
        return "nccl", [f"cuda:{m}" for m in range(MODEL_AXIS)]
    return "gloo", ["cuda:0"] * MODEL_AXIS


def first_logits(model, tok, reqs):
    """The last position's logits of the first request's prompt, on the host."""

    qd, tau = reqs[0][1:]
    prompt = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    logits = model.prefill({"tokens": torch.as_tensor(prompt, device=model.device)})[0]
    return logits[0, -1].float().cpu().numpy()


def control_logits(model, tok, reqs, layers):
    """``first_logits`` of a rank that skips the attention output's
    all-reduce in ``layers`` (every rank skips it alike, so the other
    collectives still pair): the fault ``TP_LOGIT_TOL`` must catch."""

    attn = [model.layers[i].attn for i in layers]
    for a in attn:
        a.tp = None
    try:
        return first_logits(model, tok, reqs)
    finally:
        for a in attn:
            a.tp = model.group


# phase 7c's split runs after its fleet: a staggered scheduler run of 4
# robots at R = 4, robots 1 and 3 on a pipelined lane at this cut of the 4
# layers, and one ``PartitionedPolicy`` chunk at it (56 ping-pong tokens)
AXIS_SPLIT_CUT = 2
AXIS_SPLIT_ROBOTS = (1, 3)


def axis_split_run(model, tok, reqs, launches, mesh=None, sched=None):
    """(7c) ``staggered`` over ``reqs`` (``max_slots=4``, R = 4) with the
    robots of ``AXIS_SPLIT_ROBOTS`` on a pipelined lane at
    ``AXIS_SPLIT_CUT`` (through ``sched`` when given: a warm run): chunks,
    the lane's first prefill logits, launches exact (``SplitLedger``) and
    the collectives with the ones they must be -> (a picklable record, the
    scheduler)."""

    if sched is None:
        sched = ContinuousBatchingScheduler(model, tok, max_slots=4, scan_rounds=4, mesh=mesh,
                                            num_pages=len(reqs) * -(-(14 + 56) // 16))
        sched.attach_partition(PartitionExecutor(model, AXIS_SPLIT_CUT))
    else:
        sched.reset()
    lane = sched._lanes[AXIS_SPLIT_CUT]
    first = []

    def flush(new):  # the lane's first prefill: its new rows' logits
        type(lane).flush(lane, new)
        if not first:
            rows = torch.as_tensor([q.row for q in new], device=lane._logits.device)
            first.append(lane._logits.index_select(0, rows).cpu().numpy())

    lane.flush = flush
    ledger = SplitLedger(sched)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dist.reset_calls()
        t0 = time.perf_counter()
        results = staggered(sched, reqs, split=AXIS_SPLIT_ROBOTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ledger.check("(7c) split run", launches)
    finally:
        ledger.release()
        lane.__dict__.pop("flush", None)
    spec, n_tail = sched.paged_spec, n_kind(model, range(AXIS_SPLIT_CUT, model.cfg.num_layers))
    pool = (spec.num_pages + 1) * spec.page_size * int(np.prod(model._kv_shape()))
    return dict(chunks={r.robot_id: np.asarray(r.tokens) for r in results},
                order=[(r.robot_id, r.kind) for r in results], first_lane=first[0],
                launches=counts, collectives=dict(dist.CALLS), want_calls=dict(ledger.calls),
                rounds=sched.decode_rounds, mixed=sched.mixed_rounds, wall_s=wall,
                ms_round=wall * 1e3 / sched.decode_rounds, mode=sched.round_mode,
                suffix_pool_bytes=2 * n_tail * pool * model.dtype.itemsize,
                lane_peak=lane.peak_bytes, lane_drops=lane.drops,
                left=len(sched._suffix_pools) + int(lane.has_buffers)), sched


def axis_policy_chunk(model, tok, reqs, launches, policy=None):
    """(7c) one ``PartitionedPolicy`` chunk at ``AXIS_SPLIT_CUT`` on the
    first request (``policy`` when given: a graph replay where the model
    allows graphs, else eager): its tokens and ms, launches exact (a flash
    launch a layer for the split prefill, a dense decode launch a layer a
    ping-pong token) and the collectives -> (a picklable record, the
    policy)."""

    policy = policy or PartitionedPolicy(PartitionExecutor(model, AXIS_SPLIT_CUT), tok)
    qd, tau = reqs[0][1:]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dist.reset_calls()
    t0 = time.perf_counter()
    toks = policy.chunk_tokens(qd, tau)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(ops.LAUNCHES)
    want = {n: 0 for n in _lib.KERNELS}
    want.update(flash_attention=model.n_attn, decode_attention=policy.n_steps * model.n_attn)
    if counts != want:
        raise AssertionError(f"(7c) policy chunk: launch counts {counts}, expected {want}")
    for n in launches:
        launches[n] += counts[n]
    return dict(tokens=toks, ms=ms, graphs=len(policy._graphs), launches=counts,
                collectives=dict(dist.CALLS)), policy


def edge_embed_control(model, tok, reqs):
    """The first request's first ping-pong token's logits through
    ``PartitionExecutor`` at ``AXIS_SPLIT_CUT``, as served and (on a rank)
    with the edge token embedding's all-reduce skipped on every rank: the
    rank's vocab block looked up and not summed, the fault
    ``TP_LOGIT_TOL`` must catch -> (logits, control logits or None)."""

    ex = PartitionExecutor(model, AXIS_SPLIT_CUT)
    qd, tau = reqs[0][1:]
    prompt = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    logits, state = ex.split_prefill({"tokens": torch.as_tensor(prompt, device=model.device)}, 1)
    token = logits[:, -1].argmax(-1, keepdim=True)
    out = [ex.split_decode_step(token, state)[0][0, -1].float().cpu().numpy()]
    if model.group is None:
        return out[0], None

    def unsummed(tokens, table, scale, tp):
        real = layers_lib.all_reduce_sum
        layers_lib.all_reduce_sum = lambda x, g: x
        try:
            return layers_lib.embed_lookup(tokens, table, scale, tp)
        finally:
            layers_lib.all_reduce_sum = real

    real = executor_lib.embed_lookup
    executor_lib.embed_lookup = unsummed
    try:
        out.append(ex.split_decode_step(token, state)[0][0, -1].float().cpu().numpy())
    finally:
        executor_lib.embed_lookup = real
    return out[0], out[1]


def axis_runs(model, tok, mesh, reqs, launches, sched=None):
    """The runs phase 7c holds a rank to: the first request's prefill
    logits, then ``serve_fleet(trigger="rapid")`` on 8 robots x
    ``AXIS_TICKS`` (through ``sched`` when given: a warm run); exact
    launches -> (a picklable record, the fleet's scheduler)."""

    out = {"logits": first_logits(model, tok, reqs)}
    admits0, rec0 = (len(sched.admit_ms), len(sched.record)) if sched is not None else (0, 0)
    serve_mod.ContinuousBatchingScheduler = RecordingScheduler
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dist.reset_calls()
        t0 = time.perf_counter()
        fl = serve_fleet(model, tok, mesh=mesh, n_robots=8, max_steps=AXIS_TICKS,
                         max_slots=8, scan_rounds=4, trigger="rapid", verbose=False, sched=sched)
        wall = time.perf_counter() - t0
    finally:
        serve_mod.ContinuousBatchingScheduler = ContinuousBatchingScheduler
    fs = fl["sched"]
    counts = check_sched_counts(model, fs, admits0, 0, launches)
    out["fleet"] = dict(actions=fl["actions"], offloads=fl["offloads"],
                        service_rounds=fl["service_rounds"], cancelled=fl["cancelled"],
                        decode_rounds=fl["decode_rounds"], record=fs.record[rec0:],
                        launches=counts, admits=len(fs.admit_ms) - admits0,
                        steps=fs.decode_rounds * fs.decode_block, collectives=dict(dist.CALLS),
                        mode=fs.round_mode, wall_s=wall,
                        ms_round=fl["engine_s"] * 1e3 / fs.decode_rounds,
                        pool_bytes=sum(fs._pcache[k].nbytes for k in ("kp", "vp")))
    out["weight_bytes"] = sum(p.nbytes for p in model.parameters())
    return out, fs


def model_axis_rank(rank, backend, init, device, parent, reqs, queue):
    """One rank of phase 7c, in a process of its own: joins the model axis,
    builds openvla-7b at full width on ``FLEET_LAYERS`` layers from the
    phase-6 model's seed, checks each parameter block against the parent's
    tensor (``parent``, shared from the parent's card), runs ``axis_runs``
    over a rank mesh and puts (rank, record or error) on ``queue``."""

    try:
        if backend == "gloo":
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        else:
            os.environ["NCCL_SOCKET_IFNAME"] = "lo"
        torch.backends.cuda.matmul.allow_tf32 = False
        group = dist.init_model_group(rank, MODEL_AXIS, backend=backend, init_method=init,
                                      device=device)
        dev = group.device
        cfg = get_config("openvla-7b").replace(num_layers=FLEET_LAYERS)
        t0 = time.perf_counter()
        model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0), group=group)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        cut = 0
        for name, p in model.named_parameters():
            _, index = block_of(p)
            if not torch.equal(p, parent[name][index].to(dev)):
                raise AssertionError(f"rank {rank}: {name} is not its block of the parent's")
            cut += tuple(p.shape) != tuple(parent[name].shape)
        parent.clear()  # the parent's tensors, released as soon as checked
        heads = {"flash": set(), "decode": set(), "paged": set()}

        def recorder(fn, name):
            def call(q, k, *a, **kw):  # q [.., H, D], k [.., .., KV, D]
                heads[name].add((q.shape[-2], k.shape[2]))
                return fn(q, k, *a, **kw)
            return call

        for mod, attr, name in ((kfa, "flash_attention", "flash"),
                                (kdec, "decode_attention", "decode"),
                                (kpa, "paged_decode_attention", "paged")):
            setattr(mod, attr, recorder(getattr(mod, attr), name))
        tok = EpisodeTokenizer(cfg.vocab_size)
        counts = {n: 0 for n in _lib.KERNELS}
        mesh = make_rank_mesh(1, group)
        rec = axis_runs(model, tok, mesh, reqs, counts)[0]
        rec.update(rank=rank, device=str(dev), cut=cut, build_s=build_s, launches=counts,
                   paged_heads=sorted(heads["paged"]),
                   controls={n: control_logits(model, tok, reqs, layers) for n, layers in
                             (("every layer", range(model.n_attn)),
                              ("the last layer", [model.n_attn - 1]))})
        for h in heads.values():
            h.clear()
        split = {n: 0 for n in _lib.KERNELS}
        rec["split"] = axis_split_run(model, tok, reqs[:4], split, mesh)[0]
        rec["policy"] = axis_policy_chunk(model, tok, reqs, split)[0]
        rec["embed"], rec["embed_control"] = edge_embed_control(model, tok, reqs)
        rec["split_heads"] = {k: sorted(v) for k, v in heads.items()}
        queue.put((rank, rec))
        dist.destroy_model_group(group)
    except Exception:  # the rank's failure goes to the parent, which fails the phase
        import traceback

        queue.put((rank, traceback.format_exc()))


def start_model_axis(backend, devices, *args, target=model_axis_rank,
                     timeout_s=RANKS_TIMEOUT_S, what="7c"):
    """Start a rank of ``target(rank, backend, init, device, *args,
    queue)`` on each of ``devices`` (``torch.multiprocessing``, spawned)
    -> what ``join_model_axis`` waits on, ``timeout_s`` from now."""

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(m, backend, init, devices[m], *args, q),
                         daemon=True)
             for m in range(len(devices))]
    for p in procs:
        p.start()
    return procs, q, (time.perf_counter() + timeout_s, timeout_s, what)


def join_model_axis(procs, q, limit):
    """The ranks' records by rank, within their limit (``start_model_axis``)
    of their start; ranks past it are killed, and any rank's failure fails
    the phase."""

    import queue as queue_mod

    deadline, timeout_s, what = limit
    n = len(procs)
    recs, errors, heard = {}, [], set()
    try:
        while len(heard) < n:
            try:
                rank, rec = q.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that exited has put its record before it did
                gone = [m for m in range(n) if m not in heard and procs[m].exitcode is not None]
                if gone and q.empty():
                    raise AssertionError(f"({what}) ranks {gone} exited "
                                         f"({[procs[m].exitcode for m in gone]}) with no record")
                if time.perf_counter() > deadline:
                    raise AssertionError(f"({what}) ranks {sorted(set(range(n)) - heard)} not "
                                         f"done in {timeout_s} s") from None
                continue
            heard.add(rank)
            if isinstance(rec, str):
                errors.append(f"rank {rank}:\n{rec}")
            else:
                recs[rank] = rec
        if errors:
            raise AssertionError(f"({what}) " + "\n".join(errors)[-6000:])
        for p in procs:
            p.join(timeout=max(deadline - time.perf_counter(), 1.0))
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"({what}) rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        torch.cuda.ipc_collect()
    return [recs[m] for m in range(n)]


def same_axis_runs(a, b):
    """Two ranks' records: the same logits, actions, chunks and counts."""

    fa, fb = a["fleet"], b["fleet"]
    return (np.array_equal(a["logits"], b["logits"])
            and all(np.array_equal(a["controls"][n], b["controls"][n]) for n in a["controls"])
            and np.array_equal(fa["actions"], fb["actions"])
            and np.array_equal(fa["offloads"], fb["offloads"])
            and len(fa["record"]) == len(fb["record"])
            and all(x[0] == y[0] and np.array_equal(x[2], y[2])
                    for x, y in zip(fa["record"], fb["record"]))
            and all(fa[k] == fb[k] for k in ("service_rounds", "cancelled", "decode_rounds")))


def hold_axis_to_one_rank(model, tok, rank, one):
    """A rank's record against the parent's one-rank run: the fleet's
    rounds, offloads, cancels and chunk order equal; every chunk equal or
    differing only where the one-rank top-two gap is within ``MARGIN_TOL``;
    actions equal for robots whose chunks are all equal; the first
    prefill's logits within ``TP_LOGIT_TOL``, and the every-layer control
    past it -> (robots with a chunk inside the margin, the logits' max abs
    error, {control: (max abs error, caught)})."""

    f, f1 = rank["fleet"], one["fleet"]
    for k in ("service_rounds", "cancelled", "decode_rounds"):
        if f[k] != f1[k]:
            raise AssertionError(f"(7c) fleet {k}: {f[k]} vs one rank {f1[k]}")
    if not np.array_equal(f["offloads"], f1["offloads"]) or \
            [(r, o.tolist()) for r, o, _ in f["record"]] != \
            [(r, o.tolist()) for r, o, _ in f1["record"]]:
        raise AssertionError("(7c) fleet offloads or chunk order differ from one rank")
    fleet_near = set()
    for (r, obs_t, tg), (_, _, t1) in zip(f["record"], f1["record"]):
        diff = np.flatnonzero(np.asarray(tg) != np.asarray(t1))
        if diff.size:
            gap = top2_gap_tokens(model, tok, obs_t, np.asarray(t1), int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"(7c) fleet robot {r}: chunk differs at step {diff[0]} "
                                     f"where the top-two gap is {gap:.3g}")
            fleet_near.add(r)
    same = [r for r in range(8) if r not in fleet_near]
    if not np.array_equal(f["actions"][:, same], f1["actions"][:, same]):
        raise AssertionError("(7c) fleet actions differ from one rank's")
    want = [torch.as_tensor(one["logits"])[None]]
    err, ok = compare([torch.as_tensor(rank["logits"])[None]], want, [TP_LOGIT_TOL])
    if not ok:
        raise AssertionError(f"(7c) first prefill's logits: max abs error {err:.4g} past "
                             f"2^-5 of max |logit| {np.abs(one['logits']).max():.4g}")
    controls = {}
    for name, logits in rank["controls"].items():
        c_err, c_ok = compare([torch.as_tensor(logits)[None]], want, [TP_LOGIT_TOL])
        controls[name] = (c_err, not c_ok)
    if not controls["every layer"][1]:
        raise AssertionError("(7c) a rank that skips the attention output's all-reduce in every "
                             f"layer passes TP_LOGIT_TOL (max abs error "
                             f"{controls['every layer'][0]:.4g})")
    return len(fleet_near), err, controls


def same_split_runs(a, b):
    """Two ranks' split records: the same chunks, order, logits and counts."""

    sa, sb = a["split"], b["split"]
    return (sa["order"] == sb["order"] and sa["collectives"] == sb["collectives"]
            and all(np.array_equal(sa["chunks"][r], sb["chunks"][r]) for r in sa["chunks"])
            and np.array_equal(sa["first_lane"], sb["first_lane"])
            and np.array_equal(a["policy"]["tokens"], b["policy"]["tokens"])
            and np.array_equal(a["embed"], b["embed"])
            and np.array_equal(a["embed_control"], b["embed_control"]))


def hold_split_to_one_rank(model, tok, reqs, rank, one):
    """(7c) A rank's split runs against the one rank's: harvest order and
    kinds equal, every chunk equal or differing only where the one-rank
    top-two gap is within ``MARGIN_TOL`` (the policy's chunk too), the
    lane's first prefill logits and the first ping-pong token's within
    ``TP_LOGIT_TOL`` and the edge embedding control outside it; launches
    at the rank's heads; collectives exactly ``dist``'s counts -> (chunks
    inside the margin, the lane logits' and the ping-pong logits' max abs
    errors, the control's)."""

    s, s1 = rank["split"], one["split"]
    if s["order"] != s1["order"] or s["rounds"] != s1["rounds"]:
        raise AssertionError(f"(7c) split run order {s['order']} / {s['rounds']} rounds vs one "
                             f"rank {s1['order']} / {s1['rounds']}")
    obs_of = {r: np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)[0]
              for r, qd, tau in reqs}
    near = 0
    pairs = [(r, s["chunks"][r], s1["chunks"][r]) for r in s1["chunks"]]
    pairs.append((reqs[0][0], rank["policy"]["tokens"], one["policy"]["tokens"]))
    for r, got, want in pairs:
        diff = np.flatnonzero(np.asarray(got) != np.asarray(want))
        if diff.size:
            gap = top2_gap_tokens(model, tok, obs_of[r], np.asarray(want), int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"(7c) split robot {r}: chunk differs at step {diff[0]} "
                                     f"where the top-two gap is {gap:.3g}")
            near += 1
    errs = []
    for got, want, what in ((s["first_lane"], s1["first_lane"], "the lane's first prefill"),
                            (rank["embed"][None], one["embed"][None], "the first ping-pong")):
        err, ok = compare([torch.as_tensor(got)], [torch.as_tensor(want)], [TP_LOGIT_TOL])
        if not ok:
            raise AssertionError(f"(7c) {what} logits: max abs error {err:.4g} past 2^-5 of "
                                 f"max |logit| {np.abs(want).max():.4g}")
        errs.append(err)
    c_err, c_ok = compare([torch.as_tensor(rank["embed_control"])[None]],
                          [torch.as_tensor(one["embed"])[None]], [TP_LOGIT_TOL])
    if c_ok:
        raise AssertionError("(7c) an edge embedding without its all-reduce passes "
                             f"TP_LOGIT_TOL (max abs error {c_err:.4g})")
    kv = (model.cfg.num_heads // MODEL_AXIS, model.cfg.num_kv_heads // MODEL_AXIS)
    if rank["split_heads"] != {"flash": [kv], "decode": [kv], "paged": [kv]}:
        raise AssertionError(f"(7c) split launches at (H, KV) {rank['split_heads']}")
    if s["collectives"] != s["want_calls"]:
        raise AssertionError(f"(7c) split run collectives {s['collectives']}, expected "
                             f"{s['want_calls']}")
    pre, tok1 = dist.collectives(model.cfg, obs_of[0].shape[0]), dist.collectives(model.cfg)
    want = {k: pre[k] + 56 * tok1[k] for k in pre}
    if rank["policy"]["collectives"] != want:
        raise AssertionError(f"(7c) policy chunk collectives {rank['policy']['collectives']}, "
                             f"expected {want}")
    if s["left"] or s["lane_drops"] < 1:
        raise AssertionError(f"(7c) split lane: {s['left']} buffers left, {s['lane_drops']} drops")
    return near, errs, c_err


def model_axis_phase(model, tok, launches):
    """(7c) the mesh's model axis: ``MODEL_AXIS`` tensor-parallel ranks of
    ``model`` (each its own process, gloo on one card or NCCL one a card)
    serve the rapid fleet on a rank mesh, then a staggered scheduler run
    with a split lane and a ``PartitionedPolicy`` chunk, each held to the
    same run of the one-rank ``model``."""

    backend, devices = axis_plan()
    log(f"  backend {backend}: {MODEL_AXIS} ranks on {devices} "
        + ("(one card: NCCL takes no two ranks on one card; collectives staged through pinned "
           "host memory, rounds eager)" if backend == "gloo" else "(one rank a card)"))
    reqs = requests(np.random.default_rng(5), 8)
    parent = {n: p.detach() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    # the one-rank reference run while the ranks start (python, CUDA, the
    # group); it is timed again, warm, once they are done
    started = start_model_axis(backend, devices, parent, reqs)
    one, one_sched = axis_runs(model, tok, None, reqs, launches)
    one["split"], split_sched = axis_split_run(model, tok, reqs[:4], launches)
    one["policy"], policy = axis_policy_chunk(model, tok, reqs, launches)
    one["embed"] = edge_embed_control(model, tok, reqs)[0]
    ranks = join_model_axis(*started)
    spawn_s = time.perf_counter() - t0
    idle = {n: 0 for n in launches}
    warm = axis_runs(model, tok, None, reqs, idle, sched=one_sched)[0]
    warm_split = axis_split_run(model, tok, reqs[:4], idle, sched=split_sched)[0]
    warm_policy = axis_policy_chunk(model, tok, reqs, idle, policy=policy)[0]
    del split_sched, policy
    for r in ranks[1:]:
        if not same_axis_runs(ranks[0], r) or not same_split_runs(ranks[0], r):
            raise AssertionError(f"(7c) rank {r['rank']}'s runs differ from rank 0's")
    per_token = dist.collectives(model.cfg)
    for r in ranks:
        f = r["fleet"]
        calls = f["admits"] + f["steps"]
        want = {k: n * calls for k, n in per_token.items()}
        if f["collectives"] != want:
            raise AssertionError(f"(7c) rank {r['rank']}: collectives {f['collectives']}, "
                                 f"expected {want}")
        if r["paged_heads"] != [(model.cfg.num_heads // MODEL_AXIS,
                                 model.cfg.num_kv_heads // MODEL_AXIS)]:
            raise AssertionError(f"(7c) rank {r['rank']}: paged launches at (H, KV) "
                                 f"{r['paged_heads']}")
        for n in launches:
            launches[n] += r["launches"][n] + r["split"]["launches"][n] + \
                r["policy"]["launches"][n]
    fleet_near, err, controls = hold_axis_to_one_rank(model, tok, ranks[0], one)
    split_near, split_errs, embed_err = hold_split_to_one_rank(model, tok, reqs[:4], ranks[0], one)
    for r in ranks:
        f = r["fleet"]
        log(f"  rank {r['rank']} on {r['device']}: built in {r['build_s']:.2f} s, {r['cut']} of "
            f"{len(parent)} parameters cut, every block equal to the parent's; weights "
            f"{r['weight_bytes'] / 2**30:.3f} GiB (one rank {one['weight_bytes'] / 2**30:.3f}), "
            f"pool {f['pool_bytes'] / 2**20:.1f} MiB (one rank "
            f"{one['fleet']['pool_bytes'] / 2**20:.1f}); fleet {f['mode']}: "
            f"{f['decode_rounds']} rounds, {f['wall_s']:.2f} s, engine ms a round "
            f"{f['ms_round']:.2f} (one rank, {warm['fleet']['mode']}, warm, after the ranks' "
            f"join: {warm['fleet']['ms_round']:.2f}, {warm['fleet']['wall_s']:.2f} s); "
            f"collectives a decode token {per_token} (2 a layer + the embedding, + the "
            f"logits' gather), in all {f['collectives']} (exact); paged launches at (H, KV) "
            f"{r['paged_heads']}; launches {f['launches']} (exact)")
    f1 = one["fleet"]
    log(f"  ranks equal to each other; against one rank: fleet {len(f1['record'])} chunks, "
        f"{f1['cancelled']} cancels, offloads {int(f1['offloads'].sum())} and rounds equal, "
        f"{fleet_near} robots' chunks inside the {MARGIN_TOL:g} margin, actions of the rest "
        f"equal; first prefill's logits max abs error {err:.4g} (limit 2^-5 of max |logit| "
        f"{np.abs(one['logits']).max():.4g}); a rank skipping the attention output's "
        "all-reduce: " + ", ".join(f"in {n} {e:.4g} ({'caught' if c else 'not caught'})"
                                   for n, (e, c) in controls.items())
        + f"; the ranks took {spawn_s:.1f} s from spawn to join")
    card = card_line()
    for r in ranks:
        sp, pol = r["split"], r["policy"]
        log(f"  (7c split) rank {r['rank']} [{card}]: staggered {len(sp['chunks'])} robots "
            f"{sp['order']} ({len(AXIS_SPLIT_ROBOTS)} on a pipelined lane at cut "
            f"{AXIS_SPLIT_CUT}), {sp['rounds']} rounds ({sp['mixed']} mixed), {sp['mode']}: "
            f"{sp['ms_round']:.2f} ms a round (one rank, warm: {warm_split['ms_round']:.2f}; "
            f"cold {one['split']['ms_round']:.2f}); suffix pools {sp['suffix_pool_bytes']} B "
            f"(one rank {one['split']['suffix_pool_bytes']} B), lane buffers at most "
            f"{sp['lane_peak']} B (one rank {one['split']['lane_peak']} B), freed "
            f"{sp['lane_drops']} times; launches {sp['launches']} (exact); collectives "
            f"{sp['collectives']} (exact, from dist's counts); PartitionedPolicy chunk at cut "
            f"{AXIS_SPLIT_CUT}: {pol['ms']:.1f} ms, {pol['ms'] / 56:.2f} ms a ping-pong token "
            f"(prefill included; {'graph' if pol['graphs'] else 'eager'}; one rank, warm "
            f"{'graph replay' if warm_policy['graphs'] else 'eager'}: "
            f"{warm_policy['ms']:.2f} ms, {warm_policy['ms'] / 56:.3f} ms a token; its first "
            f"call: {one['policy']['ms']:.1f} ms), launches "
            f"{pol['launches']} (exact), collectives {pol['collectives']} (exact)")
    log(f"  (7c split) against one rank: order and rounds equal, {split_near} chunks inside "
        f"the {MARGIN_TOL:g} margin; the lane's first prefill logits max abs error "
        f"{split_errs[0]:.4g}, the first ping-pong token's {split_errs[1]:.4g} (limit 2^-5 of "
        f"max |logit|); an edge embedding without its all-reduce {embed_err:.4g} (caught); "
        f"flash, decode and paged launches at (H, KV) {ranks[0]['split_heads']['paged']}")
    if f1["cancelled"] < 1 or int(f1["offloads"].sum()) <= 8:
        raise AssertionError(f"(7c) the fleet's {AXIS_TICKS} ticks fired no trigger or cancel")


# ---------------------------------------------------------------------------
# phase 7f: data shards and the prefill on ranks of their own
# ---------------------------------------------------------------------------

DATA_RANKS = 2  # phase 7f's data ranks; with its prefill rank, 3 processes on card 0 (gloo)
# its ranks' own limit: started, built, checked, run and joined within it
DATA_RANKS_TIMEOUT_S = 240
# (c): phi3.5-moe at half phase 4's depth, 4 robots staggered at R = 4
PHI35_DATA_LAYERS = PHI35_LAYERS // 2
DATA_MOE_ROBOTS = 4
PHI35 = "phi3.5-moe-42b-a6.6b"
# (d) the rapid fleet with these robots split at this cut, pipelined (the CPU
# tests' ``SPLIT_FLEET``), on the data ranks beside the prefill rank
SPLIT_FLEET_ROBOTS = (1, 3, 5, 7)
SPLIT_FLEET_CUT = 1
# (e) the cloud-only staggered run on a pod grid of POD_RANKS pods of one data
# rank each: its robots and their observations' seed
POD_RANKS = 2
POD_ROBOTS = 6
POD_SEED = 13


class GridScheduler(RecordingScheduler):
    """``RecordingScheduler`` that also keeps every reservation (robot,
    row, pages), each handoff's (prompts, broadcast bytes) and the
    harvests (windows whose cloud tokens were gathered)."""

    def __init__(self, *a, **kw):
        self.reserved, self.handoffs, self.harvests = [], [], 0
        super().__init__(*a, **kw)

    def _reserve(self, req):
        seq = super()._reserve(req)
        self.reserved.append((req.robot_id, seq.row, tuple(seq.pages)))
        return seq

    def _handoff_payload(self, n_new, payload):
        b0 = dist.DATA_BYTES["broadcast"]
        out = super()._handoff_payload(n_new, payload)
        self.handoffs.append((n_new, dist.DATA_BYTES["broadcast"] - b0))
        return out

    def _window_tokens(self, parts, n_steps):
        self.harvests += 1
        return super()._window_tokens(parts, n_steps)


def want_data_calls(cfg, sched, admits, impl="dense", lane_gathers=0):
    """The data axis's and batch group's collectives a run of ``sched``
    must have made, from ``launch.dist``'s counts: each admission prefill's
    and decode token's MoE exchanges over the data ranks, a gather a
    harvest over the ranks the rows are blocked over (and a broadcast to a
    prefill rank), a broadcast a handoff; a doubling of the rows, the
    gathers of the buffers it re-cuts (``sched.grow_gathers``;
    ``sched.page_moves`` of them moved rows and their pages); and
    ``lane_gathers``, those its lanes' doublings counted."""

    batch, prefill = sched._nranks, int(sched._handoff is not None)
    data = sched.data_shards if sched._bgroup is not None else 1
    pre = dist.data_collectives(cfg, data, sharded=False, moe_impl=impl)
    tok = dist.data_collectives(cfg, data, sharded=True, moe_impl=impl)
    steps = sched.decode_rounds * sched.decode_block
    if sched.is_prefill_rank:
        steps, data, batch = 0, 1, 1
    rows0 = sched.data_shards * -(-sched.max_slots // sched.data_shards)
    grows = int(np.log2(sched.rows // rows0))
    rows = (grows * sched.grow_gathers()
            + sched.page_moves * (sched.grow_gathers(True) - sched.grow_gathers()))
    return {"all_reduce": admits * pre["all_reduce"] + steps * tok["all_reduce"],
            "all_gather": admits * pre["all_gather"] + steps * tok["all_gather"]
            + (sched.harvests + rows + lane_gathers) * (batch > 1),
            "broadcast": sched.harvests * prefill + len(sched.handoffs)}


def data_fleet_run(model, tok, mesh, prefill_group, launches):
    """(7f a, b) ``serve_fleet(trigger="rapid")`` on 8 robots x
    ``AXIS_TICKS`` (7c's) through a ``GridScheduler``: exact launches, the
    data axis's collectives against their counts -> a picklable record."""

    serve_mod.ContinuousBatchingScheduler = GridScheduler
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dist.reset_calls()
        t0 = time.perf_counter()
        fl = serve_fleet(model, tok, mesh=mesh, prefill_group=prefill_group, n_robots=8,
                         max_steps=AXIS_TICKS, max_slots=8, scan_rounds=4, trigger="rapid",
                         verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serve_mod.ContinuousBatchingScheduler = ContinuousBatchingScheduler
    fs = fl["sched"]
    counts = check_sched_counts(model, fs, 0, 0, launches)
    calls = dict(dist.DATA_CALLS)
    want = want_data_calls(model.cfg, fs, len(fs.admit_ms))
    if fs._nranks > 1 or fs._handoff is not None:
        if calls != want:
            raise AssertionError(f"(7f) data-axis collectives {calls}, expected {want}")
    st = fs.pool_stats()
    return dict(actions=fl["actions"], offloads=fl["offloads"], cancelled=fl["cancelled"],
                service_rounds=fl["service_rounds"], decode_rounds=fl["decode_rounds"],
                record=[(r, o, np.asarray(t)) for r, o, t in fs.record],
                reserved=fs.reserved, pool=(st.pages_in_use, st.high_water, st.shard_in_use,
                                            st.shard_high_water),
                handoffs=fs.handoffs, harvests=fs.harvests, launches=counts, data_calls=calls,
                data_bytes=dict(dist.DATA_BYTES), mode=fs.round_mode, wall_s=wall,
                admits=len(fs.admit_ms), rows=fs.rows, local_rows=fs._local_rows,
                ms_round=fl["engine_s"] * 1e3 / fs.decode_rounds,
                pool_bytes=0 if fs._pcache is None else
                sum(fs._pcache[k].nbytes for k in ("kp", "vp")))


def data_split_run(model, tok, mesh, prefill_group, launches):
    """(7f d) ``serve_fleet(trigger="rapid")`` on 8 robots x
    ``AXIS_TICKS`` with ``SPLIT_FLEET_ROBOTS`` on a pipelined lane at
    ``SPLIT_FLEET_CUT``, through a ``GridScheduler`` over ``mesh`` beside
    ``prefill_group``: launches exact (``SplitLedger``), the data axis's
    collectives against their counts, the lane's rows, block and buffer
    bytes, the fused rounds' device ms (CUDA events around each fused
    window) -> a picklable record."""

    sched = GridScheduler(model, tok, max_slots=8, scan_rounds=4, mesh=mesh,
                          prefill_group=prefill_group)
    ex = PartitionExecutor(model, SPLIT_FLEET_CUT)
    sched.attach_partition(ex)
    lane = sched._lanes[SPLIT_FLEET_CUT]
    grows, windows = [], []

    def grow():  # the gathers each doubling counts
        moves = lane.page_moves
        type(lane)._grow_rows(lane)
        grows.append(lane.grow_gathers(lane.page_moves > moves))

    lane._grow_rows = grow
    ledger = SplitLedger(sched)
    fused = sched._split_fused_step  # the ledger's

    def timed(lanes, block, rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fused(lanes, block, rounds)
        end.record()
        windows.append((start, end, rounds))
        return out

    sched._split_fused_step = timed
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dist.reset_calls()
        t0 = time.perf_counter()
        fl = serve_fleet(model, tok, n_robots=8, max_steps=AXIS_TICKS, scan_rounds=4,
                         trigger="rapid", verbose=False, partition_executor=ex,
                         split_robots=list(SPLIT_FLEET_ROBOTS), sched=sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ledger.check("(7f d) split fleet", launches)
    finally:
        ledger.release()
        lane.__dict__.pop("_grow_rows", None)
    calls = dict(dist.DATA_CALLS)
    want = want_data_calls(model.cfg, sched, len(sched.admit_ms), lane_gathers=sum(grows))
    if calls != want:
        raise AssertionError(f"(7f d) data-axis collectives {calls}, expected {want}")
    st = sched.pool_stats()
    split = sum(r in SPLIT_FLEET_ROBOTS for r, _, _ in sched.record)
    fused_rounds = sum(r for _, _, r in windows)
    return dict(actions=fl["actions"], offloads=fl["offloads"], cancelled=fl["cancelled"],
                service_rounds=fl["service_rounds"], decode_rounds=fl["decode_rounds"],
                record=[(r, o, np.asarray(t)) for r, o, t in sched.record],
                reserved=sched.reserved, pool=(st.pages_in_use, st.high_water, st.shard_in_use,
                                               st.shard_high_water),
                handoffs=sched.handoffs, harvests=sched.harvests, launches=counts,
                data_calls=calls, data_bytes=dict(dist.DATA_BYTES), mode=sched.round_mode,
                wall_s=wall, mixed=sched.mixed_rounds, split_chunks=split,
                cloud_chunks=len(sched.record) - split, fused_rounds=fused_rounds,
                fused_ms=sum(a.elapsed_time(b) for a, b, _ in windows) / max(fused_rounds, 1),
                lane=(lane.rows, lane.block, lane.peak_bytes, lane.drops),
                lane_grows=len(grows), page_moves=(sched.page_moves, lane.page_moves),
                local_rows=sched._local_rows, rows=sched.rows)


def hold_split_fleet_to_one(model, tok, f, f1):
    """(7f d) a rank's split fleet against one process's: rounds, cancels,
    reservations, ``PoolStats``, chunk order and prompts, actions and
    offloads equal; each chunk's tokens equal or, past the first
    difference, inside ``MARGIN_TOL`` -> the chunks that were not bit for
    bit equal."""

    for k in ("service_rounds", "cancelled", "decode_rounds", "reserved", "pool", "mixed"):
        if f[k] != f1[k]:
            raise AssertionError(f"(7f d) {k}: {f[k]} vs one process {f1[k]}")
    order = [[(r, o.tolist()) for r, o, _ in x["record"]] for x in (f, f1)]
    if order[0] != order[1]:
        raise AssertionError("(7f d) chunk order or prompts differ from one process's")
    differ = 0
    for (r, o, t), (_, _, t1) in zip(f["record"], f1["record"]):
        diff = np.flatnonzero(t != t1)
        if diff.size:
            differ += 1
            gap = top2_gap_at(model, tok, None, None, t1[None], int(diff[0]), obs=o[None])
            if gap > MARGIN_TOL:
                raise AssertionError(f"(7f d) robot {r}: a token differs at step {diff[0]} where "
                                     f"the top-two gap is {gap:.3g}")
    for k in ("actions", "offloads"):
        if not np.array_equal(f[k], f1[k]):
            raise AssertionError(f"(7f d) {k} differ from one process's")
    return differ


def pod_sched_run(model, tok, mesh, launches):
    """(7f e) the cloud-only staggered run (``axis_sched_run``) of
    ``POD_ROBOTS`` robots over ``mesh`` (a pod grid's, or a one-device pod
    mesh's) -> a picklable record with its reservations and pool."""

    reqs = requests(np.random.default_rng(POD_SEED), POD_ROBOTS)
    run, sched = axis_sched_run(model, tok, reqs, launches, mesh)
    st = sched.pool_stats()
    run.update(reserved=sched.reserved, pool=(st.pages_in_use, st.high_water),
               harvests=sched.harvests, local_rows=sched._local_rows,
               page_moves=sched.page_moves)
    if run["data_calls"] != run["want_data"]:
        raise AssertionError(f"(7f e) batch-group collectives {run['data_calls']}, expected "
                             f"{run['want_data']}")
    return run


def hold_fleet_to_one(f, f1, what):
    """A rank's fleet against one process's: rounds, offloads, cancels,
    chunk order and every chunk, actions, reservations and ``PoolStats``
    equal."""

    for k in ("service_rounds", "cancelled", "decode_rounds", "reserved", "pool"):
        if f[k] != f1[k]:
            raise AssertionError(f"(7f {what}) {k}: {f[k]} vs one process {f1[k]}")
    if [(r, o.tolist(), t.tolist()) for r, o, t in f["record"]] != \
            [(r, o.tolist(), t.tolist()) for r, o, t in f1["record"]]:
        raise AssertionError(f"(7f {what}) chunks or their order differ from one process's")
    for k in ("actions", "offloads"):
        if not np.array_equal(f[k], f1[k]):
            raise AssertionError(f"(7f {what}) {k} differ from one process's")


# (7f c) the MoE layer's input: a 14-token prompt's rows [1, 14, D] (seeded)
MOE_X_SEED = 12


def moe_layer_out(model, skip_sum=False):
    """Layer 0's MoE over ``MOE_X_SEED``'s rows, every row replicated over
    the data ranks (an admission prefill's case) -> float32 on the host;
    ``skip_sum``: a data rank that skips the data-axis sum of its experts'
    mixture (every rank alike, so the other collectives still pair), the
    fault the hold must catch."""

    x = np.random.default_rng(MOE_X_SEED).normal(0, 1, (1, 14, model.cfg.d_model))
    x = torch.as_tensor(x, dtype=model.dtype, device=model.device)
    real = moe_lib._finish

    def finish(out, p, rows, dtype):
        return moe_lib.all_reduce_sum(out.to(dtype), p.tp)

    if skip_sum:
        moe_lib._finish = finish
    try:
        return moe_lib.moe_forward(x, model.layers[0].moe, model.cfg)[0].float().cpu().numpy()
    finally:
        moe_lib._finish = real


def expert_layer_bytes(model):
    """The bytes of layer 0's experts (up, gate and down) on this rank."""

    moe = model.layers[0].moe
    return sum(t.nbytes for t in (moe.up, moe.gate, moe.down))


def data_moe_prepare(launches, dev):
    """(7f c) the one-process phi3.5-moe at ``PHI35_DATA_LAYERS`` (phase 4's
    seed), all experts: the first prompt's logits and routes, the
    staggered run, itself teacher-forced along its chunks -> what the data
    ranks are held to, and its parameters (shared with them)."""

    t0 = time.perf_counter()
    cfg = get_config(PHI35).replace(num_layers=PHI35_DATA_LAYERS)
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    tok = EpisodeTokenizer(cfg.vocab_size)
    reqs = requests(np.random.default_rng(11), DATA_MOE_ROBOTS)
    logits, routes = jamba_first(model, tok, reqs)
    run = axis_sched_run(model, tok, reqs, launches)[0]
    gaps, forced = forced_routes(model, tok, reqs, run["chunks"])
    log(f"  (7f c) one process: {PHI35} at {PHI35_DATA_LAYERS} layers, "
        f"{cfg.moe.num_experts} experts ({expert_layer_bytes(model)} B a layer), built and run "
        f"in {time.perf_counter() - t0:.1f} s: {len(run['chunks'])} chunks in {run['rounds']} "
        f"rounds ({run['mode']}, {run['ms_round']:.2f} ms a round), launches {run['launches']} "
        "(exact)")
    one = dict(reqs=reqs, logits=logits, routes=routes, run=run, gaps=gaps, forced=forced,
               cfg=cfg, expert_bytes=expert_layer_bytes(model), moe_out=moe_layer_out(model))
    return one, model, tok


def data_axis_rank(rank, backend, init, device, parent, moe_parent, moe_one, queue):
    """One rank of phase 7f, in a process of its own: joins a world of
    ``DATA_RANKS`` data ranks and a prefill rank, builds openvla-7b at full
    width on ``FLEET_LAYERS`` layers from the phase-6 model's seed (every
    parameter equal to the parent's, shared from the parent's card), runs
    (a) the rapid fleet on the data ranks alone, (b) on the data ranks
    with the prefill rank, (d) the same with ``SPLIT_FLEET_ROBOTS`` on a
    pipelined split lane, each data rank holding its block of the lane's
    rows, and (e, the first ``POD_RANKS`` ranks) the cloud-only scheduler
    on a grid of ``POD_RANKS`` pods; then (c, the data ranks) phi3.5-moe
    with its experts spread over them: each parameter its block of the
    parent's one-process model, the first prompt (its own routes, then the
    one process's; the control without the data-axis sum) and the
    staggered run; puts (rank, record or error) on ``queue``."""

    try:
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        torch.backends.cuda.matmul.allow_tf32 = False
        full = dist.init_rank_grid(rank, data=DATA_RANKS, prefill=1, backend=backend,
                                   init_method=init, device=device)
        alone = dist.rank_grid(DATA_RANKS)
        dev = full.device
        cfg = get_config("openvla-7b").replace(num_layers=FLEET_LAYERS)
        t0 = time.perf_counter()
        groups = {} if full.is_prefill else dict(data_group=full.data_group)
        model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0), **groups)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        for name, p in model.named_parameters():
            if not torch.equal(p, parent[name].to(dev)):
                raise AssertionError(f"rank {rank}: {name} is not the parent's")
        parent.clear()
        tok = EpisodeTokenizer(cfg.vocab_size)
        rec = dict(rank=rank, device=str(dev), build_s=build_s, prefill=full.is_prefill)
        rows = set()  # the rows of each paged launch (a CUDA graph's at its capture)
        paged_kernel = kpa.paged_decode_attention

        def paged(q, *a, **kw):
            rows.add(q.shape[0])
            return paged_kernel(q, *a, **kw)

        kpa.paged_decode_attention = paged
        counts = {n: 0 for n in _lib.KERNELS}
        if alone is not None:
            rec["a"] = data_fleet_run(model, tok, make_rank_mesh(DATA_RANKS, alone), None,
                                      counts)
        rec["b"] = data_fleet_run(model, tok, make_rank_mesh(DATA_RANKS, full), full.handoff,
                                  counts)
        rec["paged_rows"] = sorted(rows)
        rows.clear()
        t0 = time.perf_counter()
        rec["d"] = data_split_run(model, tok, make_rank_mesh(DATA_RANKS, full), full.handoff,
                                  counts)
        rec["d"].update(paged_rows=sorted(rows), phase_s=time.perf_counter() - t0)
        rows.clear()
        t0 = time.perf_counter()
        pod = dist.rank_grid(1, 1, 0, pod=POD_RANKS)  # every process of the world lays it
        if pod is not None:
            rec["e"] = pod_sched_run(model, tok, make_rank_mesh(1, pod), counts)
            rec["e"].update(paged_rows=sorted(rows), phase_s=time.perf_counter() - t0,
                            place=(pod.p, pod.d))
        rec["launches"] = counts
        rec["weight_bytes"] = sum(p.nbytes for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        if alone is not None:
            rows.clear()
            rec["c"] = data_moe_rank(alone, moe_parent, moe_one, dev)
            rec["c"]["paged_rows"] = sorted(rows)
        moe_parent.clear()
        queue.put((rank, rec))
        dist.destroy_rank_grid(full)
    except Exception:  # the rank's failure goes to the parent, which fails the phase
        import traceback

        queue.put((rank, traceback.format_exc()))


def data_moe_rank(grid, moe_parent, one, dev):
    """(7f c) on a data rank: phi3.5-moe from the same seed with the experts
    spread over the data ranks, every block its slice of the parent's,
    then ``jamba_first``, the first prompt and the control with the one
    process's routes, the staggered run over the rank mesh and, where its
    chunks differ, its routes teacher-forced along the one process's."""

    cfg = one["cfg"]
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0),
                  data_group=grid.data_group)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    split = 0
    for name, p in model.named_parameters():
        _, index = block_of(p)
        if not torch.equal(p, moe_parent[name][index].to(dev)):
            raise AssertionError(f"(7f c) data rank {grid.d}: {name} is not its block of the "
                                 "parent's")
        split += tuple(p.shape) != global_shape(p)
    moe_parent.clear()
    tok = EpisodeTokenizer(cfg.vocab_size)
    reqs = one["reqs"]
    logits, routes = jamba_first(model, tok, reqs)
    routes1 = [sets for sets, _ in one["routes"]]
    with ForcedRoutes(routes1):
        forced_logits = first_logits(model, tok, reqs)
    moe_out, moe_control = moe_layer_out(model), moe_layer_out(model, skip_sum=True)
    counts = {n: 0 for n in _lib.KERNELS}
    run = axis_sched_run(model, tok, reqs, counts, make_rank_mesh(DATA_RANKS, grid))[0]
    chunks = one["run"]["chunks"]
    differ = any(not np.array_equal(run["chunks"][r], chunks[r]) for r in chunks)
    forced = forced_routes(model, tok, reqs, chunks)[1] if differ else None
    return dict(build_s=build_s, split=split, expert_bytes=expert_layer_bytes(model),
                weight_bytes=sum(p.nbytes for p in model.parameters()), logits=logits,
                forced_logits=forced_logits, routes=routes, controls={}, run=run,
                forced=forced, launches=counts, moe_out=moe_out, moe_control=moe_control)


def split_fleet_checks(model, tok, ranks, one_d, one_e, card):
    """(7f d) every rank's split fleet held to one process's (the lane's
    block of rows and its bytes, the handoffs' bytes, the collectives
    exact), (e) the pod grid's ranks held to one process's pod mesh; both
    printed."""

    cfg = model.cfg
    rows1, block1, peak1, _ = one_d["lane"]
    bitwise = 0
    for r in ranks:
        d = r["d"]
        differ = hold_split_fleet_to_one(model, tok, d, one_d)
        bitwise += differ == 0
        rows, block, peak, drops = d["lane"]
        if r["prefill"]:
            if peak or d["fused_rounds"] or d["paged_rows"]:
                raise AssertionError(f"(7f d) the prefill rank ran lane work: {d['lane']}, "
                                     f"{d['fused_rounds']} fused rounds")
        elif (rows, block) != (rows1, -(-rows1 // DATA_RANKS)) or peak * rows1 != peak1 * block:
            raise AssertionError(f"(7f d) rank {r['rank']}: lane rows {rows}, block {block}, "
                                 f"{peak} B against one process's {rows1} rows, {peak1} B")
        elif max(d["paged_rows"]) > max(d["local_rows"], block):
            raise AssertionError(f"(7f d) rank {r['rank']}: paged launches over rows "
                                 f"{d['paged_rows']}, past its blocks")
        for n, nbytes in d["handoffs"]:
            if nbytes != dist.handoff_bytes(cfg, 1 << (n - 1).bit_length(), 14):
                raise AssertionError(f"(7f d) a handoff of {n} prompts: {nbytes} B")
        toks = 56 / d["wall_s"]
        log(f"  (7f d) rank {r['rank']}{' (prefill)' if r['prefill'] else ''} [{card}]: "
            f"{d['mode']}; lane at cut {SPLIT_FLEET_CUT}: rows {rows}, this rank's block {block}, "
            f"buffers {peak} B (one process: {rows1} rows, {peak1} B), freed {drops} times; "
            f"{d['fused_rounds']} fused rounds, {d['fused_ms']:.4f} ms a fused split round "
            f"(device, CUDA events; one process {one_d['fused_ms']:.4f}); {d['split_chunks']} "
            f"split and {d['cloud_chunks']} cloud chunks in {d['wall_s']:.2f} s: split "
            f"{d['split_chunks'] * toks:.1f}, cloud {d['cloud_chunks'] * toks:.1f} action "
            f"tokens/s (one process {one_d['split_chunks'] * 56 / one_d['wall_s']:.1f} / "
            f"{one_d['cloud_chunks'] * 56 / one_d['wall_s']:.1f}); {d['mixed']} mixed rounds; "
            f"{d['harvests']} harvests, data-axis collectives {d['data_calls']} (exact), bytes "
            f"{d['data_bytes']}; handoffs (prompts, bytes) {d['handoffs']} (exact); chunks bit for "
            f"bit equal to one process's: {differ == 0} ({differ} inside the margin); launches "
            f"{d['launches']} (exact); {d['phase_s']:.1f} s")
    log(f"  (7f d) ranks equal to one process: {len(one_d['record'])} chunks "
        f"({one_d['split_chunks']} split), {one_d['cancelled']} cancels, offloads "
        f"{int(one_d['offloads'].sum())}, reservations and PoolStats {one_d['pool']}; "
        f"{bitwise} of {len(ranks)} ranks bit for bit; one process {one_d['mode']}")
    pods = [r for r in ranks if "e" in r]
    if len(pods) != POD_RANKS:
        raise AssertionError(f"(7f e) {len(pods)} ranks on the pod grid, expected {POD_RANKS}")
    for r in pods:
        e = r["e"]
        for k in ("order", "reserved", "pool", "rounds", "rows"):
            if e[k] != one_e[k]:
                raise AssertionError(f"(7f e) rank {r['rank']}: {k} {e[k]} vs {one_e[k]}")
        if any(not np.array_equal(e["chunks"][k], one_e["chunks"][k]) for k in one_e["chunks"]):
            raise AssertionError(f"(7f e) rank {r['rank']}: chunks differ from one process's")
        if e["local_rows"] != -(-e["rows"] // POD_RANKS) or max(e["paged_rows"]) != e["local_rows"]:
            raise AssertionError(f"(7f e) rank {r['rank']}: paged rows {e['paged_rows']}, its "
                                 f"block of {e['rows']}")
        log(f"  (7f e) pod {e['place'][0]} rank {r['rank']} [{card}]: {e['mode']}; rows "
            f"{e['local_rows']} of {e['rows']} ({e['page_moves']} doublings moved rows and their "
            f"pages); {len(e['order'])} chunks, {e['rounds']} rounds "
            f"in {e['wall_s']:.2f} s, {e['ms_round']:.2f} ms a round (one process "
            f"{one_e['ms_round']:.2f}, {one_e['mode']}); chunks, order, reservations and pool "
            f"equal bit for bit; batch-group collectives {e['data_calls']} (exact); launches "
            f"{e['launches']} (exact); {e['phase_s']:.1f} s")


def data_axis_phase(model, tok, launches):
    """(7f) data shards and the prefill as ranks: ``DATA_RANKS`` data ranks
    and a prefill rank of ``model`` (each its own process, gloo on card 0)
    serve the rapid fleet without and with the prefill rank, held to one
    process's same runs over a one-device ``(data 2)`` mesh; then
    phi3.5-moe with its experts spread over the data ranks, held to one
    process with every expert."""

    backend, devices = "gloo", [str(model.device)] * (DATA_RANKS + 1)
    log(f"  backend {backend}: {DATA_RANKS} data ranks and a prefill rank on {devices} "
        "(collectives staged through pinned host memory)")
    moe_one, moe_model, _ = data_moe_prepare(launches, model.device)
    parent = {n: p.detach() for n, p in model.named_parameters()}
    moe_parent = {n: p.detach() for n, p in moe_model.named_parameters()}
    t0 = time.perf_counter()
    started = start_model_axis(backend, devices, parent, moe_parent, moe_one,
                               target=data_axis_rank, timeout_s=DATA_RANKS_TIMEOUT_S, what="7f")
    mesh = make_test_mesh(data=DATA_RANKS, devices=[model.device] * DATA_RANKS)
    one_a = data_fleet_run(model, tok, mesh, None, launches)
    one_b = data_fleet_run(model, tok, mesh, [model.device], launches)
    one_d = data_split_run(model, tok, mesh, [model.device], launches)
    pod_mesh = Mesh(np.asarray([model.device] * POD_RANKS, dtype=object).reshape(POD_RANKS, 1, 1),
                    ("pod", "data", "model"))
    one_e = pod_sched_run(model, tok, pod_mesh, launches)
    ranks = join_model_axis(*started)
    spawn_s = time.perf_counter() - t0
    del moe_parent, moe_model
    torch.cuda.empty_cache()
    data_ranks, prefill_rank = ranks[:DATA_RANKS], ranks[DATA_RANKS]
    for r in ranks:
        for n in launches:
            launches[n] += r["launches"][n] + (r["c"]["launches"][n] if "c" in r else 0)
    # (a) and (b): every rank's fleet equal to one process's
    for r in data_ranks:
        hold_fleet_to_one(r["a"], one_a, "a")
        if r["paged_rows"] != [r["a"]["local_rows"]] or r["a"]["local_rows"] * DATA_RANKS != \
                one_a["rows"]:
            raise AssertionError(f"(7f) rank {r['rank']}: paged launches over rows "
                                 f"{r['paged_rows']}, its block of {one_a['rows']} rows")
    for r in ranks:
        hold_fleet_to_one(r["b"], one_b, "b")
        # a dense stack's round makes no data-axis collective: graphs under gloo
        for part in ("a", "b"):
            if part in r and model.graphs and not r[part]["mode"].startswith("cuda graphs"):
                raise AssertionError(f"(7f {part}) rank {r['rank']}: rounds {r[part]['mode']}")
    cfg = model.cfg
    for n, nbytes in prefill_rank["b"]["handoffs"]:
        want = dist.handoff_bytes(cfg, 1 << (n - 1).bit_length(), 14)
        if nbytes != want:
            raise AssertionError(f"(7f b) a handoff of {n} prompts: {nbytes} B, reckoned {want}")
    card = card_line()
    for r in ranks:
        for part in ("a", "b"):
            if part not in r:
                continue
            f, f1 = r[part], (one_a if part == "a" else one_b)
            log(f"  (7f {part}) rank {r['rank']}{' (prefill)' if r['prefill'] else ''} "
                f"[{card}]: {f['mode']}; {f['decode_rounds']} rounds, {f['wall_s']:.2f} s, "
                f"engine ms a round {f['ms_round']:.2f} (one process {f1['ms_round']:.2f}, "
                f"{f1['mode']}); rows {f['local_rows']} of {f['rows']}, pool "
                f"{f['pool_bytes'] / 2**20:.1f} MiB (one process "
                f"{f1['pool_bytes'] / 2**20:.1f}); {f['harvests']} harvests, "
                f"{len(f['handoffs'])} handoffs; data-axis collectives {f['data_calls']} "
                f"(exact), bytes {f['data_bytes']}; launches {f['launches']} (exact)")
    split_fleet_checks(model, tok, ranks, one_d, one_e, card)
    hand = prefill_rank["b"]["handoffs"]
    log(f"  (7f) ranks equal to one process: (a) {len(one_a['record'])} chunks, "
        f"{one_a['cancelled']} cancels, offloads {int(one_a['offloads'].sum())}, reservations "
        f"and PoolStats {one_a['pool']} equal; (b) admissions one window later, "
        f"{len(one_b['record'])} chunks equal; handoffs (prompts, bytes) {hand} equal to "
        f"n x 917,504 B of K/V + n x {2 * model.vocab_padded} B of logits at the bucket n; "
        f"the ranks took {spawn_s:.1f} s from spawn to join, weights a rank "
        f"{data_ranks[0]['weight_bytes'] / 2**30:.3f} GiB")
    # (c) the experts over the data ranks
    one = moe_one
    want_bytes = one["expert_bytes"] // DATA_RANKS
    per_token = dist.data_collectives(one["cfg"], DATA_RANKS, sharded=True)
    for r in data_ranks:
        c = r["c"]
        if c["expert_bytes"] != want_bytes:
            raise AssertionError(f"(7f c) rank {r['rank']}: {c['expert_bytes']} B of experts a "
                                 f"layer, expected {want_bytes}")
        if c["run"]["data_calls"] != c["run"]["want_data"]:
            raise AssertionError(f"(7f c) rank {r['rank']}: data-axis collectives "
                                 f"{c['run']['data_calls']}, expected {c['run']['want_data']}")
        if any(c["run"]["collectives"].values()):
            raise AssertionError(f"(7f c) model-axis collectives {c['run']['collectives']}")
        if c["paged_rows"] != [4 // DATA_RANKS]:
            raise AssertionError(f"(7f c) rank {r['rank']}: paged launches over rows "
                                 f"{c['paged_rows']}, its block of 4")
    # every data rank's runs alike (not the control: each rank's partial
    # mixture stands for the whole there)
    a, b = ({**r["c"], "heads": 0} for r in data_ranks)
    if not same_jamba_runs(a, b) or not np.array_equal(a["moe_out"], b["moe_out"]):
        raise AssertionError("(7f c) the data ranks' runs differ")
    margin, flips, prefill, err, own, _ = hold_jamba_to_one_rank(
        one, a, what="7f c", vocab=one["cfg"].vocab_size)
    want = [torch.as_tensor(one["moe_out"])]
    moe_err, moe_ok = compare([torch.as_tensor(a["moe_out"])], want, [TP_LOGIT_TOL])
    if not moe_ok:
        raise AssertionError(f"(7f c) the MoE layer's output: max abs error {moe_err:.4g} past "
                             "2^-5 of each row's largest |output|")
    controls = {}
    for r in data_ranks:
        c_err, c_ok = compare([torch.as_tensor(r["c"]["moe_control"])], want, [TP_LOGIT_TOL])
        controls[f"rank {r['rank']}"] = (c_err, not c_ok)
        if c_ok:
            raise AssertionError(f"(7f c) rank {r['rank']} without the data-axis sum passes "
                                 f"TP_LOGIT_TOL (max abs error {c_err:.4g})")
    c = a
    log(f"  (7f c) {PHI35} at {PHI35_DATA_LAYERS} layers on {DATA_RANKS} data ranks [{card}]: "
        f"{c['split']} parameters split, every block equal to the parent's; experts "
        f"{c['expert_bytes']} B a layer a rank (one process {one['expert_bytes']}), weights "
        f"{c['weight_bytes'] / 2**30:.3f} GiB; {c['run']['mode']}: {c['run']['rounds']} rounds, "
        f"{c['run']['ms_round']:.2f} ms a round (one process {one['run']['ms_round']:.2f}); "
        f"data-axis collectives {c['run']['data_calls']} (exact: {per_token} a decode token); "
        f"against one process: order and rounds equal, {margin} chunks inside the "
        f"{MARGIN_TOL:g} margin, {len(flips)} past a routing near-tie {flips}; the first "
        f"prefill's tokens routed otherwise {prefill}; its logits with the one process's routes "
        f"max abs error {err:.4g} (own routes {own:.4g}; limit 2^-5 of max |logit| "
        f"{np.abs(one['logits'][:one['cfg'].vocab_size]).max():.4g}, the real vocab); layer "
        f"0's MoE over 14 replicated rows max abs "
        f"error {moe_err:.4g} (limit 2^-5 of each row's largest |output|, max "
        f"{np.abs(one['moe_out']).max():.4g}); without the data-axis sum: "
        + ", ".join(f"{n} {e:.4g} ({'caught' if k else 'not caught'})"
                    for n, (e, k) in controls.items()))


# ---------------------------------------------------------------------------
# phase 7d: MoE and Mamba layers on the model axis (Jamba)
# ---------------------------------------------------------------------------

# phase 7d's own limit: its ranks started, built, checked, run and joined
JAMBA_RANKS_TIMEOUT_S = 240
# the staggered scheduler run phase 7d holds the ranks to: 4 robots, 3 at
# once then one 2 rounds later, R = 4, Jamba's phase-5 (dense) dispatch (8
# robots in its first runs: the time limit)
JAMBA_AXIS_ROBOTS = 4
# a parameter block's digest: the int64 sum (wrapping) of its elements' bit
# patterns, each times its position + 1, taken this many elements at a time
DIGEST_CHUNK = 1 << 24
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def digest(t) -> int:
    """An exact digest of ``t``'s elements in order (``DIGEST_CHUNK``): one
    element changed by any amount changes it."""

    flat = t.detach().contiguous().view(_BITS[t.dtype]).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), DIGEST_CHUNK):
        part = flat[i:i + DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(i + 1, i + 1 + part.numel(), dtype=torch.int64, device=t.device)
        total += (part * pos).sum()
    return int(total)


def block_digests(model, ranks):
    """{parameter: [the digest of rank m's block of it, for m < ranks]} of a
    one-rank ``model``: each rank's index from a meta rank model's
    ``tp_block`` (``Model(group=...)``; ``in_proj`` by halves)."""

    meta = torch.device("meta")
    index = [{n: block_of(p)[1] for n, p in Model(
        model.cfg, device="meta",
        group=dist.ModelGroup(m, ranks, "gloo", meta, (meta,) * ranks)).named_parameters()}
        for m in range(ranks)]
    return {n: [digest(p[index[m][n]]) for m in range(ranks)]
            for n, p in model.named_parameters()}


def jamba_first(model, tok, reqs):
    """``first_logits``, and the routed sets [T, E] and router boundary
    gaps [T] of each of its router calls (numpy)."""

    with RouteLog() as routes:
        logits = first_logits(model, tok, reqs)
    return logits, [(a.cpu().numpy(), g.cpu().numpy()) for a, g in routes.calls]


class ForcedRoutes:
    """While entered, the MoE router takes the given routed sets (one [T,
    E] array a call, in call order) and keeps its own softmax weights over
    them, renormalised as ``router_probs`` renormalises its top k: a path
    held to another's arithmetic with that path's routing decisions."""

    def __init__(self, sets):
        self.sets = sets

    def __enter__(self):
        self.fn, calls = moe_lib.router_probs, iter(self.sets)

        def forced(x, router_w, k):
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
            sel = torch.as_tensor(next(calls), device=probs.device).reshape(probs.shape)
            top = torch.where(sel, probs, torch.zeros_like(probs))
            combine = top / top.sum(-1, keepdim=True)
            lead = tuple(range(probs.dim() - 1))
            density = (combine > 0).float().mean(dim=lead)
            return combine, probs.shape[-1] * torch.sum(density * probs.mean(dim=lead)) / k

        moe_lib.router_probs = forced
        return self

    def __exit__(self, *exc):
        moe_lib.router_probs = self.fn


def axis_sched_run(model, tok, reqs, launches, mesh=None):
    """``staggered`` over ``reqs`` (``max_slots=4``, R = 4) with exact
    launches and every collective counted, the data axis's beside the
    ones ``launch.dist`` counts for the run (``want_data_calls``) -> (a
    picklable record, the scheduler): phases 7d, 7e and 7f."""

    sched = GridScheduler(model, tok, max_slots=4, scan_rounds=4, mesh=mesh,
                          num_pages=len(reqs) * -(-(14 + 56) // 16))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dist.reset_calls()
    t0 = time.perf_counter()
    results = staggered(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = check_sched_counts(model, sched, 0, 0, launches)
    pc = sched._pcache
    return dict(chunks={r.robot_id: np.asarray(r.tokens) for r in results},
                order=[r.robot_id for r in results], launches=counts,
                collectives=dict(dist.CALLS), data_calls=dict(dist.DATA_CALLS),
                want_data=want_data_calls(model.cfg, sched, len(sched.admit_ms)),
                admits=len(sched.admit_ms),
                steps=sched.decode_rounds * sched.decode_block, rounds=sched.decode_rounds,
                wall_s=wall, ms_round=wall * 1e3 / sched.decode_rounds, mode=sched.round_mode,
                pool_bytes=sum(pc[k].nbytes for k in ("kp", "vp") if k in pc),
                state_bytes=sum(pc[k].nbytes for k in model.state_names),
                state={k: pc[k].nbytes for k in model.state_names}, rows=sched.rows), sched


def forced_routes(model, tok, reqs, chunks):
    """``model`` teacher-forced along ``chunks`` (each robot's tokens), the
    robots in one batch -> (the top-two gap over the action bins before
    each token [n, 56], the routed sets and router gaps of every router
    call: the prefill's [n * 14, E], then each step's [n, E])."""

    obs = np.concatenate([np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
                          for _, qd, tau in reqs])
    toks = np.stack([chunks[r] for r, _, _ in reqs])
    dev = model.device
    gaps = []
    with RouteLog() as routes:
        logits, cache = model.prefill({"tokens": torch.as_tensor(obs, device=dev)},
                                      extra=toks.shape[1])
        for j in range(toks.shape[1]):
            top = logits[:, -1, tok.action_base:].float().topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).cpu().numpy())
            if j + 1 < toks.shape[1]:
                logits, cache = model.decode_step(torch.as_tensor(toks[:, j:j + 1], device=dev),
                                                  cache)
    return np.stack(gaps, 1), [(a.cpu().numpy(), g.cpu().numpy()) for a, g in routes.calls]


def skip_mamba_out(model, tok, reqs):
    """``first_logits`` of a rank that skips the Mamba ``out_proj``
    all-reduce in every Mamba layer (every rank alike, so the other
    collectives still pair; the ``dt`` / B / C all-reduce stays)."""

    d, real = model.cfg.d_model, ssm_lib.all_reduce_sum
    ssm_lib.all_reduce_sum = lambda x, g: x if x.shape[-1] == d else real(x, g)
    try:
        return first_logits(model, tok, reqs)
    finally:
        ssm_lib.all_reduce_sum = real


def skip_moe(model, tok, reqs):
    """``first_logits`` of a rank that skips the MoE all-reduce in every
    MoE layer."""

    moes = [blk.moe for blk in model.layers if hasattr(blk, "moe")]
    for m in moes:
        m.tp = None
    try:
        return first_logits(model, tok, reqs)
    finally:
        for m in moes:
            m.tp = model.group


def jamba_axis_prepare(model, tok, launches):
    """(7d), on the one-rank Jamba before it is freed: the first prompt's
    logits and routes, the staggered scheduler run (its ms a round warm,
    from a second run through the same scheduler), the model teacher-forced
    along its own chunks, and the digest of every rank's block of every
    parameter -> what ``jamba_axis_phase`` holds the ranks to."""

    t0 = time.perf_counter()
    reqs = requests(np.random.default_rng(9), JAMBA_AXIS_ROBOTS)
    logits, routes = jamba_first(model, tok, reqs)
    run, sched = axis_sched_run(model, tok, reqs, launches)
    rounds0, t1 = sched.decode_rounds, time.perf_counter()
    staggered(sched, reqs)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t1) * 1e3 / (sched.decode_rounds - rounds0)
    del sched
    gaps, forced = forced_routes(model, tok, reqs, run["chunks"])
    t2 = time.perf_counter()
    digests = block_digests(model, MODEL_AXIS)
    log(f"  (7d) one rank: {len(run['chunks'])} chunks in {run['rounds']} rounds "
        f"({run['mode']}, cold {run['ms_round']:.2f} ms a round, warm {warm_ms:.2f}), launches "
        f"{run['launches']} (exact); teacher-forced routes; digests of {len(digests)} "
        f"parameters x {MODEL_AXIS} blocks in {time.perf_counter() - t2:.1f} s; "
        f"{time.perf_counter() - t0:.1f} s in all")
    return dict(reqs=reqs, logits=logits, routes=routes, run=run, warm_ms=warm_ms, gaps=gaps,
                forced=forced, digests=digests, cfg=model.cfg,
                weight_bytes=sum(p.nbytes for p in model.parameters()))


def jamba_axis_rank(rank, backend, init, device, digests, chunks, routes1, reqs, queue):
    """One rank of phase 7d, in a process of its own: joins the model axis,
    builds Jamba at full width on ``JAMBA_LAYERS`` layers from phase 4's
    seed, checks each parameter block's digest against the parent's (and
    that a block with one element changed fails it), runs ``jamba_first``,
    then the first prompt again and the two controls with the one rank's
    routes (``routes1``, ``ForcedRoutes``), and ``axis_sched_run`` over a
    rank mesh, teacher-forces the one-rank ``chunks`` where its own differ,
    and puts (rank, record or error) on ``queue``."""

    try:
        if backend == "gloo":
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        else:
            os.environ["NCCL_SOCKET_IFNAME"] = "lo"
        torch.backends.cuda.matmul.allow_tf32 = False
        group = dist.init_model_group(rank, MODEL_AXIS, backend=backend, init_method=init,
                                      device=device)
        dev = group.device
        cfg = get_config(JAMBA).replace(num_layers=JAMBA_LAYERS)
        t0 = time.perf_counter()
        model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0), group=group)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        cut = 0
        for name, p in model.named_parameters():
            if digest(p) != digests[name][rank]:
                raise AssertionError(f"rank {rank}: {name}'s digest is not its block's")
            cut += tuple(p.shape) != global_shape(p)
        control = model.layers[0].mamba.in_proj.detach().clone()
        control.view(torch.int16).view(-1)[control.numel() // 3] += 1
        if digest(control) == digests["layers.0.mamba.in_proj"][rank]:
            raise AssertionError(f"rank {rank}: a block with one element changed passes its "
                                 "digest")
        del control
        heads = {"paged": set(), "scan": set()}
        paged_kernel, scan_kernel = kpa.paged_decode_attention, kms.mamba_scan

        def paged(q, k_pages, *a, **kw):
            heads["paged"].add((q.shape[1], k_pages.shape[2]))
            return paged_kernel(q, k_pages, *a, **kw)

        def scan(x, *a, **kw):
            heads["scan"].add(x.shape[2])
            return scan_kernel(x, *a, **kw)

        kpa.paged_decode_attention, kms.mamba_scan = paged, scan
        tok = EpisodeTokenizer(cfg.vocab_size)
        logits, routes = jamba_first(model, tok, reqs)
        with ForcedRoutes(routes1):
            forced_logits = first_logits(model, tok, reqs)
        controls = {}
        for name, skip in (("Mamba out_proj", skip_mamba_out), ("MoE", skip_moe)):
            with ForcedRoutes(routes1):
                controls[name] = skip(model, tok, reqs)
        counts = {n: 0 for n in _lib.KERNELS}
        run = axis_sched_run(model, tok, reqs, counts, make_rank_mesh(1, group))[0]
        differ = any(not np.array_equal(run["chunks"][r], chunks[r]) for r in chunks)
        forced = forced_routes(model, tok, reqs, chunks)[1] if differ else None
        queue.put((rank, dict(
            rank=rank, device=str(dev), build_s=build_s, cut=cut, n_params=len(digests),
            logits=logits, forced_logits=forced_logits, routes=routes, controls=controls,
            run=run, forced=forced,
            heads={k: sorted(v) for k, v in heads.items()}, launches=counts,
            weight_bytes=sum(p.nbytes for p in model.parameters()))))
        dist.destroy_model_group(group)
    except Exception:  # the rank's failure goes to the parent, which fails the phase
        import traceback

        queue.put((rank, traceback.format_exc()))


def same_jamba_runs(a, b):
    """Two ranks' records: the same logits, routes, controls, chunks and
    counts."""

    ra, rb = a["run"], b["run"]
    return (np.array_equal(a["logits"], b["logits"])
            and np.array_equal(a["forced_logits"], b["forced_logits"])
            and len(a["routes"]) == len(b["routes"])
            and all(np.array_equal(x[0], y[0]) for x, y in zip(a["routes"], b["routes"]))
            and all(np.array_equal(a["controls"][n], b["controls"][n]) for n in a["controls"])
            and ra["order"] == rb["order"]
            and all(np.array_equal(ra["chunks"][r], rb["chunks"][r]) for r in ra["chunks"])
            and all(ra[k] == rb[k] for k in ("launches", "collectives", "admits", "steps"))
            and a["heads"] == b["heads"])


def route_flip(one_forced, rank_forced, robot, step, n):
    """At the first router call up to decode step ``step`` whose routed sets
    for ``robot`` differ between the one-rank and the rank path (both
    teacher-forced along the one-rank chunk), the largest one-rank router
    gap over the tokens that differ; None where they all route alike.
    Calls: the prefill's (``n`` robots x 14 prompt rows), then each step's
    (one row a robot), a call a MoE layer."""

    moe_layers = sum(1 for sets, _ in one_forced if sets.shape[0] == n * 14)
    for c, ((sa, ga), (sb, _)) in enumerate(zip(one_forced, rank_forced)):
        prefill = c < moe_layers
        if not prefill and (c - moe_layers) // moe_layers >= step:
            break
        rows = slice(robot * 14, (robot + 1) * 14) if prefill else slice(robot, robot + 1)
        differ = (sa[rows] != sb[rows]).any(-1)
        if differ.any():
            return float(ga[rows][differ].max())
    return None


def prefill_flips(one, rank, what="7d"):
    """The first prefill's tokens that the rank routes otherwise than the
    one rank, as (router call, one-rank router gap) pairs; a flip past
    ``MARGIN_TOL`` fails the phase."""

    flips = []
    for c, ((sa, ga), (sb, _)) in enumerate(zip(one["routes"], rank["routes"])):
        for t in np.flatnonzero((sa != sb).any(-1)):
            if ga[t] > MARGIN_TOL:
                raise AssertionError(f"({what}) first prefill: router call {c} routes token {t} "
                                     f"otherwise than one rank at a gap of {ga[t]:.3g}")
            flips.append((c, round(float(ga[t]), 5)))
    return flips


def hold_jamba_to_one_rank(one, rank, what="7d", vocab=None):
    """Rank 0's record against the one rank's: the harvest order and rounds
    equal; each chunk equal, or differing first at a step where the one
    rank's top-two gap is within ``MARGIN_TOL``, or past a routing near-tie
    (``route_flip`` within it); the first prefill's tokens routed as the one
    rank's, or otherwise only at a near-tie (``prefill_flips``), and its
    logits with the one rank's routes within ``TP_LOGIT_TOL``, both
    controls (with those routes) past it -> (chunks inside the margin,
    chunks past a near-tie, the prefill's flips, the logits' max abs error
    with the one rank's routes and with the rank's own, {control: (max abs
    error, caught)})."""

    run, run1 = rank["run"], one["run"]
    if run["order"] != run1["order"] or run["rounds"] != run1["rounds"]:
        raise AssertionError(f"({what}) harvest order {run['order']} / rounds {run['rounds']} vs "
                             f"one rank {run1['order']} / {run1['rounds']}")
    n = len(one["reqs"])
    margin, flips = 0, []
    for i, (r, _, _) in enumerate(one["reqs"]):
        diff = np.flatnonzero(run["chunks"][r] != run1["chunks"][r])
        if not diff.size:
            continue
        j = int(diff[0])
        if one["gaps"][i, j] <= MARGIN_TOL:
            margin += 1
            continue
        flip = route_flip(one["forced"], rank["forced"], i, j, n)
        if flip is None or flip > MARGIN_TOL:
            raise AssertionError(f"({what}) robot {r}: chunk differs at step {j} where the "
                                 f"top-two gap is {one['gaps'][i, j]:.3g} and the routes "
                                 + ("agree" if flip is None else f"part at a gap of {flip:.3g}"))
        flips.append(round(flip, 4))
    prefill = prefill_flips(one, rank, what)
    # over the real vocab (``vocab``): a padded id's -1e9 would set the
    # row's scale
    want = [torch.as_tensor(one["logits"][:vocab])[None]]
    own = compare([torch.as_tensor(rank["logits"][:vocab])[None]], want, [TP_LOGIT_TOL])[0]
    err, ok = compare([torch.as_tensor(rank["forced_logits"][:vocab])[None]], want,
                      [TP_LOGIT_TOL])
    if not ok:
        raise AssertionError(f"({what}) first prefill's logits with the one rank's routes: max abs "
                             f"error {err:.4g} past 2^-5 of max |logit| "
                             f"{np.abs(one['logits'][:vocab]).max():.4g}")
    if not prefill and not np.array_equal(rank["logits"], rank["forced_logits"]):
        raise AssertionError(f"({what}) the same routes forced moved the first prefill's logits")
    controls = {}
    for name, logits in rank["controls"].items():
        c_err, c_ok = compare([torch.as_tensor(logits[:vocab])[None]], want, [TP_LOGIT_TOL])
        controls[name] = (c_err, not c_ok)
        if c_ok:
            raise AssertionError(f"({what}) a rank that skips the {name} all-reduce passes "
                                 f"TP_LOGIT_TOL (max abs error {c_err:.4g})")
    return margin, flips, prefill, err, own, controls


def jamba_axis_phase(one, tok, launches):
    """(7d) ``MODEL_AXIS`` tensor-parallel ranks of Jamba (4 layers at full
    width: Mamba, MoE, attention), each its own process, held to the
    one-rank model's runs (``jamba_axis_prepare``; that model is freed
    first: the two do not fit on one card together)."""

    backend, devices = axis_plan()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    log(f"  backend {backend}: {MODEL_AXIS} ranks on {devices}; the one-rank model freed "
        f"({held / 2**30:.2f} GiB still allocated here)")
    if held > 4 * 2**30:
        raise AssertionError(f"(7d) {held / 2**30:.2f} GiB held before the ranks start")
    t0 = time.perf_counter()
    started = start_model_axis(backend, devices, one["digests"], one["run"]["chunks"],
                               [sets for sets, _ in one["routes"]], one["reqs"],
                               target=jamba_axis_rank,
                               timeout_s=JAMBA_RANKS_TIMEOUT_S, what="7d")
    ranks = join_model_axis(*started)
    spawn_s = time.perf_counter() - t0
    for r in ranks[1:]:
        if not same_jamba_runs(ranks[0], r):
            raise AssertionError(f"(7d) rank {r['rank']}'s runs differ from rank 0's")
    cfg = one["cfg"]
    per_token = dist.collectives(cfg)
    heads = {"paged": [(cfg.num_heads // MODEL_AXIS, cfg.num_kv_heads // MODEL_AXIS)],
             "scan": [ssm_lib.ssm_dims(cfg)[1] // MODEL_AXIS]}
    for r in ranks:
        run = r["run"]
        want = {k: v * (run["admits"] + run["steps"]) for k, v in per_token.items()}
        if run["collectives"] != want:
            raise AssertionError(f"(7d) rank {r['rank']}: collectives {run['collectives']}, "
                                 f"expected {want}")
        if r["heads"] != heads:
            raise AssertionError(f"(7d) rank {r['rank']}: kernels at heads {r['heads']}, "
                                 f"expected {heads}")
        for n in launches:
            launches[n] += r["launches"][n]
    margin, flips, prefill, err, own, controls = hold_jamba_to_one_rank(one, ranks[0])
    run1 = one["run"]
    for r in ranks:
        run = r["run"]
        log(f"  rank {r['rank']} on {r['device']}: built in {r['build_s']:.2f} s, {r['cut']} of "
            f"{r['n_params']} parameters cut, every block's digest equal to the parent's (one "
            f"element changed: caught); weights {r['weight_bytes'] / 2**30:.3f} GiB (one rank "
            f"{one['weight_bytes'] / 2**30:.3f}), Mamba state {run['state_bytes'] / 2**20:.2f} "
            f"MiB (one rank {run1['state_bytes'] / 2**20:.2f}), pool "
            f"{run['pool_bytes'] / 2**20:.2f} MiB (one rank {run1['pool_bytes'] / 2**20:.2f}); "
            f"scheduler {run['mode']}: {run['rounds']} rounds, {run['wall_s']:.2f} s, "
            f"{run['ms_round']:.2f} ms a round (one rank, {run1['mode']}: cold "
            f"{run1['ms_round']:.2f}, warm {one['warm_ms']:.2f}); collectives a decode token "
            f"{per_token} (2 a Mamba layer, 1 an attention layer, 1 an FFN, 1 the embedding, "
            f"+ the logits' gather), in all {run['collectives']} over {run['admits']} admissions "
            f"and {run['steps']} steps (exact); kernels at heads {r['heads']}; launches "
            f"{run['launches']} (exact)")
    log(f"  ranks equal to each other (logits, routes, controls, chunks, counts); every MoE call "
        f"of the first prefill routes alike on every rank ({len(one['routes'])} calls; against "
        f"one rank {len(prefill)} tokens route otherwise, (call, router gap) {prefill}); "
        f"against one rank: {len(run1['chunks'])} chunks, order and {run1['rounds']} rounds "
        f"equal, {margin} inside the {MARGIN_TOL:g} margin, {len(flips)} past a routing "
        f"near-tie {flips}; first prefill's logits with the one rank's routes max abs error "
        f"{err:.4g} (limit 2^-5 of max |logit| {np.abs(one['logits']).max():.4g}; with its own "
        f"routes {own:.4g}); a rank skipping an all-reduce (the one rank's routes): "
        + ", ".join(f"{n} {e:.4g} ({'caught' if c else 'not caught'})"
                    for n, (e, c) in controls.items())
        + f"; the ranks took {spawn_s:.1f} s from spawn to join")


# ---------------------------------------------------------------------------
# phase 7e: xLSTM and the encoder-decoder stack on the model axis
# ---------------------------------------------------------------------------

# phase 7e's own limit: its ranks started, built, checked, run and joined
XE_RANKS_TIMEOUT_S = 180
# the staggered scheduler run of xlstm-125m: 4 robots at R = 4 (phase 7d's)
XE_ROBOTS = 4
# seamless's decode chunk on the ranks: short, since a token makes 38 gloo
# collectives (each ~2.8-5.3 ms through pinned host memory on one card)
XE_STEPS = 16
# seamless's modes over ranks (cross K/V cached, paged cache): paged with
# the cross K/V cached, dense with them projected each token
XE_MODES = ((True, True), (False, False))
# the collectives of a decode token on a rank (``dist.collectives``)
XE_TOKEN_CALLS = {XLSTM: 26, ENCDEC: 38}


def skip_h_gather(model, tok, reqs):
    """``first_logits`` of a rank whose sLSTM layers skip the h all-gather,
    its own units standing in for every rank's (every rank alike, so the
    other collectives still pair)."""

    real = xlstm_lib._slstm_cell

    def cell(w_rec, bias, units, carry, x_in, tp=None):
        c, n, h, m = real(w_rec, bias, units, carry, x_in, None)
        return c, n, h.repeat(1, tp.size) if tp is not None else h, m

    xlstm_lib._slstm_cell = cell
    try:
        return first_logits(model, tok, reqs)
    finally:
        xlstm_lib._slstm_cell = real


def skip_xattn_wo(model, batch):
    """The prefill's last logits of a rank whose cross-attention skips its
    ``wo`` all-reduce in every decoder layer."""

    xattn = [blk.xattn for blk in model.layers]
    for a in xattn:
        a.tp = None
    try:
        return model.prefill(batch)[0][0, -1].float().cpu().numpy()
    finally:
        for a in xattn:
            a.tp = model.group


def encdec_axis_run(model, batch, paged, floor, launches):
    """seamless's prefill and an ``XE_STEPS``-token chunk (``encdec_chunk``)
    eagerly, launches exact and the collectives counted -> a picklable
    record (prefill logits, tokens, calls of the prefill and of the chunk,
    cross-K/V bytes, ms a decode token)."""

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dist.reset_calls()
    rec = {}
    toks, last = encdec_chunk(model, batch, paged, floor, XE_STEPS, into=rec)
    toks = toks.cpu().numpy()
    t1 = time.perf_counter()
    counts = dict(ops.LAUNCHES)
    want = encdec_launches(model, paged, XE_STEPS)
    if counts != want:
        raise AssertionError(f"(7e) {model.cfg.name} launches {counts}, expected {want}")
    for n in launches:
        launches[n] += counts[n]
    calls = {k: dist.CALLS[k] - rec["prefill_calls"][k] for k in dist.CALLS}
    if toks.shape != (1, XE_STEPS) or (toks < floor).any() or not torch.isfinite(last).all():
        raise AssertionError(f"(7e) {model.cfg.name}: bad chunk {toks}")
    return dict(prefill=rec["prefill"], tokens=toks[0], prefill_calls=rec["prefill_calls"],
                calls=calls, xkv_bytes=rec["xkv_bytes"], launches=counts,
                ms_token=(t1 - rec["t_decode"]) * 1e3 / XE_STEPS)


def xe_batch(cfg, tok):
    """Phase 7e's seamless prompt: 14 tokens and ``ENC_FRAMES`` stub frames
    (numpy, seeded)."""

    rng = np.random.default_rng(47)
    return {"tokens": rng.integers(tok.state_base, tok.action_base, (1, 14)),
            "frontend": rng.standard_normal((1, ENC_FRAMES, cfg.d_model)).astype(np.float32)}


def xe_axis_prepare(launches):
    """(7e), the one-rank runs: xlstm-125m and seamless-m4t-medium at full
    width and depth from phase 4's seed, the xLSTM's first prompt and its
    staggered scheduler run (warm too), seamless's prompt in ``XE_MODES``,
    and the digest of every rank's block of every parameter -> (what the
    ranks are held to, the two models)."""

    t0 = time.perf_counter()
    out = {"reqs": requests(np.random.default_rng(11), XE_ROBOTS)}
    models = {}
    for arch in (XLSTM, ENCDEC):
        cfg = get_config(arch)
        model = models[arch] = Model(cfg, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(0))
        out[arch] = dict(digests=block_digests(model, MODEL_AXIS), cfg=cfg,
                         weight_bytes=sum(p.nbytes for p in model.parameters()))
    # a block with one element changed must fail its digest
    w = models[XLSTM].layers[1].slstm.w_in
    index = block_of(Model(get_config(XLSTM), device="meta", group=dist.ModelGroup(
        0, MODEL_AXIS, "gloo", torch.device("meta"), (torch.device("meta"),) * MODEL_AXIS))
        .layers[1].slstm.w_in)[1]
    control = w[index].clone()
    control.view(torch.int16).view(-1)[control.numel() // 3] += 1
    if digest(control) == out[XLSTM]["digests"]["layers.1.slstm.w_in"][0]:
        raise AssertionError("(7e) a block with one element changed passes its digest")
    model, tok = models[XLSTM], EpisodeTokenizer(get_config(XLSTM).vocab_size)
    out["logits"] = first_logits(model, tok, out["reqs"])
    run, sched = axis_sched_run(model, tok, out["reqs"], launches)
    rounds0, t1 = sched.decode_rounds, time.perf_counter()
    staggered(sched, out["reqs"])
    torch.cuda.synchronize()
    out["warm_ms"] = (time.perf_counter() - t1) * 1e3 / (sched.decode_rounds - rounds0)
    out["run"] = run
    del sched
    model, etok = models[ENCDEC], EpisodeTokenizer(get_config(ENCDEC).vocab_size)
    out["batch"] = xe_batch(model.cfg, etok)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in out["batch"].items()}
    out["modes"] = {mode: encdec_axis_run(enc_twin(model, mode[0]), batch, mode[1],
                                          etok.action_base, launches) for mode in XE_MODES}
    log(f"  (7e) one rank: {XLSTM} {len(run['chunks'])} chunks in {run['rounds']} rounds "
        f"({run['mode']}, cold {run['ms_round']:.2f} ms a round, warm {out['warm_ms']:.2f}); "
        f"{ENCDEC} " + ", ".join(f"{enc_mode(*m)} {r['ms_token']:.2f} ms a token"
                                 for m, r in out["modes"].items())
        + f"; digests of both stacks' blocks; {time.perf_counter() - t0:.1f} s in all")
    return out, models


def xe_axis_rank(rank, backend, init, device, reqs, batch_np, queue):
    """One rank of phase 7e, in a process of its own: joins the model axis,
    builds xlstm-125m, then seamless-m4t-medium, at full width and depth
    from phase 4's seed, sends every parameter block's digest, runs the
    first prompt, its control and the staggered scheduler run on the
    xLSTM over a rank mesh, and seamless's prompt in ``XE_MODES`` and its
    control, recording the attention kernels' heads; puts (rank, record or
    error) on ``queue``."""

    try:
        if backend == "gloo":
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        else:
            os.environ["NCCL_SOCKET_IFNAME"] = "lo"
        torch.backends.cuda.matmul.allow_tf32 = False
        group = dist.init_model_group(rank, MODEL_AXIS, backend=backend, init_method=init,
                                      device=device)
        dev = group.device
        heads = {"flash": set(), "decode": set(), "paged": set()}
        wrap = ((kfa, "flash_attention", "flash"), (kdec, "decode_attention", "decode"),
                (kpa, "paged_decode_attention", "paged"))

        def recorder(fn, name):
            def call(q, k, *a, **kw):  # q [.., H, D], k [.., .., KV, D]
                heads[name].add((q.shape[-2], k.shape[2]))
                return fn(q, k, *a, **kw)
            return call

        for mod, attr, name in wrap:
            setattr(mod, attr, recorder(getattr(mod, attr), name))
        rec = dict(rank=rank, device=str(dev))
        for arch in (XLSTM, ENCDEC):
            cfg = get_config(arch)
            t0 = time.perf_counter()
            model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0),
                          group=group)
            torch.cuda.synchronize(dev)
            tok = EpisodeTokenizer(cfg.vocab_size)
            r = rec[arch] = dict(build_s=time.perf_counter() - t0,
                                 digests={n: digest(p) for n, p in model.named_parameters()},
                                 cut=sum(tuple(p.shape) != global_shape(p)
                                         for p in model.parameters()),
                                 weight_bytes=sum(p.nbytes for p in model.parameters()))
            counts = {n: 0 for n in _lib.KERNELS}
            if arch == XLSTM:
                dist.reset_calls()
                r["logits"] = first_logits(model, tok, reqs)
                r["first_calls"] = dict(dist.CALLS)
                r["control"] = skip_h_gather(model, tok, reqs)
                r["run"] = axis_sched_run(model, tok, reqs, counts, make_rank_mesh(1, group))[0]
            else:
                batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
                r["modes"] = {mode: encdec_axis_run(enc_twin(model, mode[0]), batch, mode[1],
                                                    tok.action_base, counts)
                              for mode in XE_MODES}
                r["control"] = skip_xattn_wo(model, batch)
            r["launches"] = counts
            del model
            gc.collect()
            torch.cuda.empty_cache()
        rec["heads"] = {k: sorted(v) for k, v in heads.items()}
        queue.put((rank, rec))
        dist.destroy_model_group(group)
    except Exception:  # the rank's failure goes to the parent, which fails the phase
        import traceback

        queue.put((rank, traceback.format_exc()))


def same_xe_runs(a, b):
    """Two ranks' records: the same logits, controls, chunks, tokens and
    counts."""

    xa, xb = a[XLSTM], b[XLSTM]
    ea, eb = a[ENCDEC], b[ENCDEC]
    ra, rb = xa["run"], xb["run"]
    return (all(np.array_equal(xa[k], xb[k]) for k in ("logits", "control"))
            and np.array_equal(ea["control"], eb["control"])
            and ra["order"] == rb["order"]
            and all(np.array_equal(ra["chunks"][r], rb["chunks"][r]) for r in ra["chunks"])
            and all(ra[k] == rb[k] for k in ("launches", "collectives", "admits", "steps"))
            and all(np.array_equal(ea["modes"][m][k], eb["modes"][m][k])
                    for m in XE_MODES for k in ("prefill", "tokens"))
            and all(ea["modes"][m][k] == eb["modes"][m][k]
                    for m in XE_MODES for k in ("calls", "prefill_calls", "launches"))
            and a["heads"] == b["heads"])


def hold_logits(what, got, want, vocab):
    """``got``'s first ``vocab`` logits within ``TP_LOGIT_TOL`` of
    ``want``'s, and its padded ids masked (<= -1e8, after the vocab blocks
    were gathered) -> the max abs error.  (The padded ids' -1e9 would set
    the row's scale, so the tolerance reads the real vocab only.)"""

    if not (got[vocab:] <= -1e8).all():
        raise AssertionError(f"(7e) {what}: a padded id past {vocab} is not masked")
    err, ok = compare([torch.as_tensor(got[:vocab])[None]], [torch.as_tensor(want[:vocab])[None]],
                      [TP_LOGIT_TOL])
    if not ok:
        raise AssertionError(f"(7e) {what}: max abs error {err:.4g} past 2^-5 of max |logit| "
                             f"{np.abs(want[:vocab]).max():.4g}")
    return err


def caught(what, got, want, vocab):
    """A control's first ``vocab`` logits must miss ``TP_LOGIT_TOL`` -> its
    max abs error."""

    err, ok = compare([torch.as_tensor(got[:vocab])[None]], [torch.as_tensor(want[:vocab])[None]],
                      [TP_LOGIT_TOL])
    if ok:
        raise AssertionError(f"(7e) a rank that skips {what} passes TP_LOGIT_TOL (max abs "
                             f"error {err:.4g})")
    return err


def hold_xe_to_one_rank(one, models, rank):
    """Rank 0's record against the one rank's: the xLSTM's harvest order
    and rounds equal, each chunk equal or differing first where the one
    rank's top-two gap is within ``MARGIN_TOL``; the first prompt's logits
    and each seamless mode's prefill logits within ``TP_LOGIT_TOL``, its
    tokens held by the greedy-margin rule; both controls outside it ->
    (chunks inside the margin, seamless modes inside it, the logits' max
    abs errors, the controls' max abs errors)."""

    x, run, run1 = rank[XLSTM], rank[XLSTM]["run"], one["run"]
    if run["order"] != run1["order"] or run["rounds"] != run1["rounds"]:
        raise AssertionError(f"(7e) {XLSTM} harvest order {run['order']} / rounds "
                             f"{run['rounds']} vs one rank {run1['order']} / {run1['rounds']}")
    model, tok = models[XLSTM], EpisodeTokenizer(get_config(XLSTM).vocab_size)
    margin = 0
    for r, qd, tau in one["reqs"]:
        diff = np.flatnonzero(run["chunks"][r] != run1["chunks"][r])
        if diff.size:
            obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)[0]
            gap = top2_gap_tokens(model, tok, obs, run1["chunks"][r], int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"(7e) {XLSTM} robot {r}: chunk differs at step {diff[0]} "
                                     f"where the top-two gap is {gap:.3g}")
            margin += 1
    xv, ev = get_config(XLSTM).vocab_size, get_config(ENCDEC).vocab_size
    errs = {XLSTM: hold_logits(f"{XLSTM} first prompt's logits", x["logits"], one["logits"], xv)}
    controls = {"the sLSTM's h all-gather": caught("the sLSTM's h all-gather", x["control"],
                                                   one["logits"], xv)}
    e, enc_near = rank[ENCDEC], 0
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in one["batch"].items()}
    floor = EpisodeTokenizer(get_config(ENCDEC).vocab_size).action_base
    for mode in XE_MODES:
        got, want = e["modes"][mode], one["modes"][mode]
        errs[enc_mode(*mode)] = hold_logits(f"{ENCDEC} {enc_mode(*mode)} prefill logits",
                                            got["prefill"], want["prefill"], ev)
        diff = np.flatnonzero(got["tokens"] != want["tokens"])
        if diff.size:
            gap = encdec_top2_gap(models[ENCDEC], batch, floor,
                                  torch.as_tensor(want["tokens"][None], device="cuda"),
                                  int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"(7e) {ENCDEC} {enc_mode(*mode)}: token {diff[0]} differs "
                                     f"where the top-two gap is {gap:.3g}")
            enc_near += 1
    controls["the cross-attention's wo all-reduce"] = caught(
        "the cross-attention's wo all-reduce", e["control"],
        one["modes"][(False, False)]["prefill"], ev)
    return margin, enc_near, errs, controls


def xe_axis_phase(launches):
    """(7e) ``MODEL_AXIS`` tensor-parallel ranks of xlstm-125m and
    seamless-m4t-medium at full width and depth, each its own process,
    held to the one-rank models' runs (``xe_axis_prepare``)."""

    backend, devices = axis_plan()
    one, models = xe_axis_prepare(launches)
    log(f"  backend {backend}: {MODEL_AXIS} ranks on {devices}")
    t0 = time.perf_counter()
    started = start_model_axis(backend, devices, one["reqs"], one["batch"],
                               target=xe_axis_rank, timeout_s=XE_RANKS_TIMEOUT_S, what="7e")
    ranks = join_model_axis(*started)
    spawn_s = time.perf_counter() - t0
    for r in ranks[1:]:
        if not same_xe_runs(ranks[0], r):
            raise AssertionError(f"(7e) rank {r['rank']}'s runs differ from rank 0's")
    xcfg, ecfg = get_config(XLSTM), get_config(ENCDEC)
    x_tok, x_pre = dist.collectives(xcfg), dist.collectives(xcfg, 14)
    e_tok, e_pre = dist.collectives(ecfg), dist.collectives(ecfg, 14)
    if [sum(x_tok.values()), sum(e_tok.values())] != list(XE_TOKEN_CALLS.values()):
        raise AssertionError(f"(7e) collectives a token {x_tok} / {e_tok}, expected "
                             f"{XE_TOKEN_CALLS}")
    h = ecfg.num_heads // MODEL_AXIS
    want_heads = {"flash": [(h, h)], "decode": [(h, h)], "paged": [(h, h)]}
    for r in ranks:
        for arch in (XLSTM, ENCDEC):
            bad = [n for n, d in r[arch]["digests"].items()
                   if d != one[arch]["digests"][n][r["rank"]]]
            if bad or len(r[arch]["digests"]) != len(one[arch]["digests"]):
                raise AssertionError(f"(7e) rank {r['rank']}: {arch} blocks {bad[:4]} are not "
                                     "the parent's")
        run = r[XLSTM]["run"]
        want = {k: x_pre[k] * run["admits"] + x_tok[k] * run["steps"] for k in x_tok}
        if run["collectives"] != want or r[XLSTM]["first_calls"] != x_pre:
            raise AssertionError(f"(7e) rank {r['rank']}: {XLSTM} collectives "
                                 f"{run['collectives']} (first prompt {r[XLSTM]['first_calls']}),"
                                 f" expected {want} ({x_pre})")
        if any(run["launches"].values()):
            raise AssertionError(f"(7e) {XLSTM} launched {run['launches']}")
        for mode, m in r[ENCDEC]["modes"].items():
            want = {k: n * XE_STEPS for k, n in e_tok.items()}
            if m["prefill_calls"] != e_pre or m["calls"] != want:
                raise AssertionError(f"(7e) rank {r['rank']} {enc_mode(*mode)}: collectives "
                                     f"{m['prefill_calls']} + {m['calls']}, expected {e_pre} + "
                                     f"{want}")
        if r["heads"] != want_heads:
            raise AssertionError(f"(7e) rank {r['rank']}: kernels at (H, KV) {r['heads']}, "
                                 f"expected {want_heads}")
        for arch in (XLSTM, ENCDEC):
            for n in launches:
                launches[n] += r[arch]["launches"][n]
    margin, enc_near, errs, controls = hold_xe_to_one_rank(one, models, ranks[0])
    run1 = one["run"]
    for r in ranks:
        x, e, run = r[XLSTM], r[ENCDEC], r[XLSTM]["run"]
        state = lambda rn, kind: sum(b for k, b in rn["state"].items()  # noqa: E731
                                     if k in STATE_NAMES[kind])
        log(f"  rank {r['rank']} on {r['device']}: {XLSTM} built in {x['build_s']:.2f} s, "
            f"{x['cut']} of {len(x['digests'])} parameters cut, {ENCDEC} built in "
            f"{e['build_s']:.2f} s, {e['cut']} of {len(e['digests'])} cut, every block's digest "
            f"equal to the parent's; weights {x['weight_bytes'] / 2**20:.1f} MiB (one rank "
            f"{one[XLSTM]['weight_bytes'] / 2**20:.1f}) and {e['weight_bytes'] / 2**30:.3f} GiB "
            f"(one rank {one[ENCDEC]['weight_bytes'] / 2**30:.3f}); mLSTM state "
            f"{state(run, 'mlstm') / 2**20:.3f} MiB (one rank {state(run1, 'mlstm') / 2**20:.3f}),"
            f" sLSTM state {state(run, 'slstm') / 2**10:.1f} KiB (one rank "
            f"{state(run1, 'slstm') / 2**10:.1f}) at {run['rows']} rows;"
            f" cross K/V {e['modes'][(True, True)]['xkv_bytes'] / 2**20:.3f} MiB (one rank "
            f"{one['modes'][(True, True)]['xkv_bytes'] / 2**20:.3f})")
        log(f"    {XLSTM} scheduler {run['mode']}: {run['rounds']} rounds, {run['wall_s']:.2f} s, "
            f"{run['ms_round']:.2f} ms a round (one rank, {run1['mode']}: cold "
            f"{run1['ms_round']:.2f}, warm {one['warm_ms']:.2f}); collectives {run['collectives']}"
            f" over {run['admits']} admissions and {run['steps']} steps (exact: {x_pre} a "
            f"prefill, {x_tok} a token); no kernel launched")
        log(f"    {ENCDEC}: " + "; ".join(
            f"{enc_mode(*mode)} {m['ms_token']:.2f} ms a token (one rank "
            f"{one['modes'][mode]['ms_token']:.2f}), launches {m['launches']} (exact)"
            for mode, m in e["modes"].items())
            + f"; collectives {e_pre} a prefill, {e_tok} a token (exact); kernels at (H, KV) "
            f"{r['heads']}")
    log(f"  ranks equal to each other; against one rank: {XLSTM} {len(run1['chunks'])} chunks, "
        f"order and {run1['rounds']} rounds equal, {margin} inside the {MARGIN_TOL:g} margin; "
        f"{ENCDEC} {len(XE_MODES)} modes' {XE_STEPS} tokens, {enc_near} inside the margin; "
        "logits max abs error " + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
        + " (limit 2^-5 of max |logit|); a rank skipping "
        + ", ".join(f"{k}: {v:.4g} (caught)" for k, v in controls.items())
        + f"; the ranks took {spawn_s:.1f} s from spawn to join")
    del models
    gc.collect()
    torch.cuda.empty_cache()


def monitor_path(fleet, launches):
    """The batched monitor entry point over a fleet's bank of episode
    streams; its scores on the first streams must match the port's own
    trigger run tick by tick."""

    cfg = TriggerConfig()
    q, qd, tau = fleet
    m_acc, tau_pow = monitor_features(qd, tau, cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    score_acc, score_tau, _ = ops.rolling_stats(
        m_acc, tau_pow, window_acc=cfg.window_acc, window_tau=cfg.window_tau,
        sigma_floor_acc=cfg.sigma_floor_acc, sigma_floor_tau=cfg.sigma_floor_tau,
    )
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    if counts["rolling_stats"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"monitor launch counts {counts}, expected one rolling_stats")
    launches["rolling_stats"] += 1
    head = 8
    _, out = run_trigger(cfg, kin.KinematicFrame(q[:, :head], qd[:, :head], tau[:, :head]))
    err, ok = compare((score_acc[:head], score_tau[:head]),
                      (out.score_acc.T, out.score_tau.T), [(1e-3, 1e-3, 0.0)] * 2)
    if not ok:
        raise AssertionError(f"monitor scores differ from run_trigger by {err:.3g}")
    log(f"  monitor: ops.rolling_stats over {m_acc.shape[0]} streams x {m_acc.shape[1]} ticks, "
        f"1 launch; scores of the first {head} streams vs run_trigger max err {err:.3g} "
        "(atol = rtol = 1e-3, the JAX package's kernel-vs-trigger tolerance)")


def _dispatch_fields(out):
    """A ``DispatchOutput``'s fields by name, the trigger's flattened."""

    return {**{n: getattr(out, n) for n in out._fields[:-1]},
            **{f"trig.{n}": getattr(out.trig, n) for n in out.trig._fields}}


@torch.inference_mode()
def dispatcher_path(fleet, eps, card):
    """``run_episode`` over the fleet's bank of episodes with each robot's
    cloud and edge-policy chunks, in both modes: (a) its decisions equal to
    the decision core's ``rollout`` (``offloaded`` to ``offload``,
    ``edge_refill`` to ``replayed``); (b) every field bitwise equal to a
    tick loop of ``dispatcher_step``; (c) the first ``DISPATCH_CPU_ROBOTS`` robots
    run on the CPU, decisions equal up to the first flip within
    ``DECISION_RTOL`` of a threshold and actions equal before it.  No hand
    kernel runs here.  The ms a tick is of a run after a warm-up of
    ``DISPATCH_WARMUP`` ticks."""

    cfg = DispatcherConfig()
    frames = kin.KinematicFrame(*fleet)
    t_len, robots = frames.q.shape[:2]
    chunks = dict(zip(("cloud", "edge"), fleet_chunks(eps, t_len, frames.q.device)))
    cpu_robots = DISPATCH_CPU_ROBOTS
    head = kin.KinematicFrame(*(f[:, :cpu_robots].cpu() for f in frames))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for mode in ("cloud", "edge"):
        edge = chunks["edge"] if mode == "edge" else None
        pcfg = PolicyConfig(trigger=cfg.trigger, chunk_len=cfg.chunk_len, on_empty=mode)
        warm = DISPATCH_WARMUP
        run_episode(cfg, kin.KinematicFrame(*(f[:warm] for f in frames)), chunks["cloud"][:warm],
                    edge_chunks=None if edge is None else edge[:warm])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = run_episode(cfg, frames, chunks["cloud"], edge_chunks=edge)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms_tick = (t1 - t0) * 1e3 / t_len
        got = _dispatch_fields(out)
        # (a) the decision core
        _, dec = rollout(pcfg, frames)
        if not (torch.equal(out.offloaded, dec.offload)
                and torch.equal(out.edge_refill, dec.replayed)):
            raise AssertionError(f"dispatcher ({mode}): decisions differ from rollout")
        # (b) the tick loop
        loop_state, outs = dispatcher_init(cfg, (robots,), device=frames.q.device), []
        for t in range(t_len):
            loop_state, o = dispatcher_step(
                loop_state, kin.KinematicFrame(*(f[t] for f in frames)), chunks["cloud"][t], cfg,
                edge_chunk=None if edge is None else edge[t])
            outs.append(_dispatch_fields(o))
        t2 = time.perf_counter()
        for name, want in got.items():
            if not torch.equal(torch.stack([o[name] for o in outs]), want):
                raise AssertionError(f"dispatcher ({mode}): {name} differs from the tick loop")
        if not all(torch.equal(a, b) for a, b in zip(_leaves(state), _leaves(loop_state))):
            raise AssertionError(f"dispatcher ({mode}): the final state differs from the tick loop")
        # (c) the CPU
        t3 = time.perf_counter()
        _, cpu = run_episode(cfg, head, chunks["cloud"][:, :cpu_robots].cpu(),
                             edge_chunks=None if edge is None else edge[:, :cpu_robots].cpu())
        streams = lambda o: {"offload": o.offloaded[:, :cpu_robots].cpu().numpy(),  # noqa: E731
                             "replayed": o.edge_refill[:, :cpu_robots].cpu().numpy()}
        flip = first_decision_flip(streams(out), streams(cpu), pcfg, head)
        upto = t_len if flip is None else flip[0]
        if not torch.equal(out.action[:upto, :cpu_robots].cpu(), cpu.action[:upto]):
            raise AssertionError(f"dispatcher ({mode}): actions differ card vs CPU before "
                                 f"tick {upto}")
        where = ("decisions and actions equal over every tick" if flip is None else
                 f"decisions part ways at tick {flip[0]} robot {flip[1]}, {flip[2]:.3g} from its "
                 f"threshold (within {DECISION_RTOL:g}); actions equal before it")
        log(f"  dispatcher ({mode}): run_episode over {robots} robots x {t_len} ticks: offloads "
            f"{int(out.offloaded.sum())}, edge refills {int(out.edge_refill.sum())}, "
            f"{ms_tick:.4f} ms a tick (host clock, CUDA-synchronised) on {card}; (a) decisions = "
            f"rollout(on_empty={mode!r}), (b) every field bitwise = the dispatcher_step loop, "
            f"(c) first {cpu_robots} robots vs the CPU: {where}; seconds: run {t1 - t0:.2f}, "
            f"(a) + (b) {t3 - t1:.2f} (the loops {t2 - t1:.2f}), (c) {time.perf_counter() - t3:.2f}")
    counts = dict(ops.LAUNCHES)
    if sum(counts.values()):
        raise AssertionError(f"dispatcher: hand kernels launched {counts}, expected none")


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

# The backward kernel against its plain version on the same inputs (the
# kernel forward's out and lse), per element |got - want| <= share *
# max|want| + rtol * |want| + terms * 2^-8 * A.  float32 (share, rtol,
# terms) = (1e-5, 1e-4, 0): both sum in float32, in another order, over up
# to S * G terms; an element whose terms cancel (dq of a row that sees one
# key is 0: ds = dout.v - dout.out = 0) is float32 noise on either side,
# ~1e-6 of the output's scale (measured on one H100), hence the share.
# bf16 (1e-5, 2^-7, 2): the tensor-core kernel rounds P to bf16 before
# dV += P^T dO and dS before dK += dS^T Q and dQ += dS K (the A operands of
# its mma.sync products), where the plain version keeps both in float32.
# Rounding to bf16 moves a value by at most 2^-8 of itself (8 significant
# bits, round to nearest), so each output element moves by at most 2^-8 A,
# A its sum of absolute terms (sum p |dout| for dv, sum |ds| |q| for dk,
# sum |ds| |k| for dq; ``bwd_abs_terms``), i.e. terms = 1; it is doubled
# because A is the plain version's and the kernel's p and ds differ from
# it by float32 noise (ex2.approx, the softcap's tanh, tensor-core sums) on
# which the rounding can land a step apart.  The outputs are rounded once on
# each side, so they differ by one bf16 step, 2^-7 of the value, more.  (An
# emulation of the kernel on the CPU needs terms <= 0.6,
# tests/test_torch_flash_bwd_tiles.py.)  Besides, each output must be as
# near the float64 truth (the plain version in float64 on the same inputs)
# as the others: within 1.5x of the larger of the plain version's largest
# error and SDPA's backward's (on the same q, k, v, dout; it rounds P and
# dS too), plus the share; where SDPA cannot run (a softcap), within 1.5x
# of the plain version's plus the element's bf16 bound taken about the
# truth.  The forward's lse (float32 both ways, the bf16 kernel's from
# tensor-core scores and ex2.approx) to 1e-4 absolute plus 1e-5 relative.
BWD_TOL = {torch.float32: (1e-5, 1e-4, 0.0), torch.bfloat16: (1e-5, 2.0**-7, 2.0)}
LSE_TOL = (1e-4, 1e-5, 0.0)
# the backward's flops: 2.5x the forward's 4 H D a visible pair (five
# products of the FA-2 backward against the forward's two)
BWD_FLOPS_X = 2.5
TRAIN_STEPS = 30               # openvla-7b steps; the last 5's mean loss must be below the first
TRAIN_BATCH, TRAIN_SEQ = 4, 256
XLSTM_TRAIN = ["--steps", "30", "--batch", "8", "--seq", "64", "--data", "episodes",
               "--log-every", "10", "--ckpt-every", "30"]
# f32 smoke twins, card against CPU: the loss to 1e-5 relative, each
# gradient within 1e-4 of its leaf's largest |value| (the embedding's, a
# bf16 scatter-add summed in another order, 2^-7), parameters after one
# AdamW update on the same gradients within an ulp of the leaf plus 1e-3
# of the learning rate
TWIN_LOSS_RTOL, TWIN_LEAF, TWIN_EMBED = 1e-5, 1e-4, 2.0**-7
# jamba-smoke's a_log leaves (the decay rates, whose gradient da sums over
# every step): 1e-3 of their largest |value|.  The CPU twin's plain scan keeps
# float32 prefix sums, the kernels float64; at S = 512 (two chunks of 256)
# that alone moved a_log's gradient by 1.6e-4 of its scale on the CPU (the
# plain scan in float32 against the same in float64), and 2e-5 for dt_bias
TWIN_DECAY = 1e-3
TWIN_SMOKE_SEQ = {JAMBA: 512}  # jamba-smoke's twin over two chunks (else S = 64)
# Jamba at full width, trained: the first 4 layers (mamba, mamba, mamba,
# attn), dense MLPs (one 16-expert layer alone holds 9.66 G parameters,
# which with gradients and two moments cannot train on one card), bf16,
# AdamW with bf16 moments, on B 2 x S 1024 episode tokens (4 chunks of the
# scan a sequence)
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_STEPS, JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ = 4, 30, 2, 1024


def bwd_case(rng, dtype, b, s, h, kv, d, causal=True, window=0, cap=0.0, q_scale=1.0):
    q = _t(rng, (b, s, h, d), dtype).mul_(q_scale)
    k, v = _t(rng, (b, s, kv, d), dtype), _t(rng, (b, s, kv, d), dtype)
    dout = _t(rng, (b, s, h, d), dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out, lse = kfa.flash_attention(q, k, v, with_lse=True, **kw)
    lim = (lambda i: i + 1) if causal else (lambda i: s)
    pairs = sum(min(lim(i), window) if window else lim(i) for i in range(s))
    lib = None
    if not cap:  # SDPA has no softcap
        lib = sdpa_backward(q, k, v, dout, causal, window)
    return dict(
        q=q, k=k, v=v, out=out, lse=lse, dout=dout, kw=kw, library=lib,
        kernel=lambda: kfab.flash_attention_bwd(q, k, v, out, lse, dout, **kw),
        plain=lambda **a: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **dict(kw, **a)),
        # q, out, dout, k, v and lse read once; dq, dk, dv written once
        bytes=4 * nbytes(q) + 4 * nbytes(k) + nbytes(lse),
        flops=BWD_FLOPS_X * 4.0 * b * h * d * pairs,
    )


def sdpa_backward(q, k, v, dout, causal, window):
    """The yardstick: SDPA's backward through autograd on [B, H, S, D]
    views of the same inputs -> (backward alone, retaining its graph;
    forward + backward; forward alone).  The backward alone cannot be
    captured in a CUDA graph (autograd runs it on the stream of its
    forward, and the leaves' gradient nodes keep the stream they were made
    on), so its device time is taken as the difference of the other two's,
    each on leaves made afresh in the call."""

    views = [x.transpose(1, 2).detach() for x in (q, k, v)]
    g = dout.transpose(1, 2)
    s = q.shape[1]
    mask = None
    if window:  # SDPA takes a window only as a boolean mask
        pos = torch.arange(s, device="cuda")
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)

    def fwd(leaves):
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                              is_causal=causal and mask is None,
                                              enable_gqa=q.shape[2] != k.shape[2])

    def fresh():
        return [x.requires_grad_() for x in (t.detach() for t in views)]

    def fwd_bwd():
        leaves = fresh()
        return torch.autograd.grad(fwd(leaves), leaves, g)

    leaves = fresh()
    o = fwd(leaves)
    return (lambda: torch.autograd.grad(o, leaves, g, retain_graph=True), fwd_bwd,
            lambda: fwd(fresh()))


def bwd_cases(rng):
    bf, f32 = torch.bfloat16, torch.float32
    return [
        # (label, dtype, case, main-path shape?)
        ("openvla-7b B=4 S=256 H=KV=32 D=128 causal", bf,
         bwd_case(rng, bf, 4, 256, 32, 32, 128), True),
        ("openvla-7b B=4 S=256 H=KV=32 D=128 causal", f32,
         bwd_case(rng, f32, 4, 256, 32, 32, 128), False),
        ("qwen3-moe heads B=1 S=256 H=64 KV=4 (G=16) D=128", bf,
         bwd_case(rng, bf, 1, 256, 64, 4, 128), False),
        ("gemma2-9b heads B=1 S=1024 H=16 KV=8 D=256 win 256 cap 50", bf,
         bwd_case(rng, bf, 1, 1024, 16, 8, 256, window=256, cap=50.0, q_scale=CAP_Q_SCALE),
         False),
        ("ragged B=1 S=300 H=KV=32 D=128 causal", bf,
         bwd_case(rng, bf, 1, 300, 32, 32, 128), False),
        ("seamless B=2 S=300 H=KV=16 D=64 non-causal", bf,
         bwd_case(rng, bf, 2, 300, 16, 16, 64, causal=False), False),
        ("seamless B=2 S=300 H=KV=16 D=64 non-causal", f32,
         bwd_case(rng, f32, 2, 300, 16, 16, 64, causal=False), False),
    ]


def bwd_abs_terms(q, k, v, out, lse, dout, causal, window, logit_cap):
    """Each output element's sum of absolute terms, the plain arithmetic on
    absolute values, dense over (query, key): (sum |ds| |k|, sum |ds| |q|,
    sum p |dout|) -> like (dq, dk, dv), float32 (the bf16 bound's A)."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    g, scale = h // kv, d**-0.5
    qf, gf = (x.float().reshape(b, s, kv, g, d) for x in (q, dout))
    kf, vf = k.float(), v.float()
    x = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    sc = logit_cap * torch.tanh(x / logit_cap) if logit_cap else x
    pos = torch.arange(s, device=q.device)
    vis = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        vis &= pos[:, None] >= pos[None, :]
    if window:
        vis &= pos[:, None] - pos[None, :] < window
    p = torch.where(vis, torch.exp(sc - lse.float().reshape(b, kv, g, s)[..., None]), 0.0)
    delta = (gf * out.float().reshape(b, s, kv, g, d)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", gf, vf) - delta[..., None])
    if logit_cap:
        ds = ds * (1 - (sc / logit_cap) ** 2)
    ds = (ds * scale).abs()
    return (torch.einsum("bkgqs,bskd->bqkgd", ds, kf.abs()).reshape(b, s, h, d),
            torch.einsum("bkgqs,bqkgd->bskd", ds, qf.abs()),
            torch.einsum("bkgqs,bqkgd->bskd", p, gf.abs()))


def bwd_limits(wants, terms, dtype, about=None):
    """``compare``'s limits of ``BWD_TOL`` for each output, per element,
    about ``wants`` (or the values ``about``, for the float64 check)."""

    share, rtol, c = BWD_TOL[dtype]
    lims = []
    for w, t, a in zip(wants, terms, about or wants):
        lim = share * float(w.abs().max()) + rtol * a.double().abs()
        if c:
            lim = lim + c * 2.0**-8 * t.double()
        lims.append((lim, 0.0, 0.0))
    return lims


def check_bwd_kernel(cases):
    """Each case: the forward's out and lse against the plain forward, the
    backward's dq, dk, dv against the plain backward on the same out and
    lse under ``BWD_TOL``, and against the float64 truth beside the plain
    version's and SDPA's backward's distances; a case with a cap or a
    window must disagree with the plain version run without it.  Times as
    phase 3's."""

    main = None
    fmt = lambda x, n=4: "-" if x is None else f"{x:.{n}f}"  # noqa: E731
    for label, dtype, case, _ in cases:
        kw = case["kw"]
        q, k, v = case["q"], case["k"], case["v"]
        b, s_, h, d = q.shape
        plan = _lib.flash_bwd_plan(b, s_, h, k.shape[2], d, dtype)
        controls = [n for n, key in (("cap", "logit_cap"), ("window", "window")) if kw[key]]
        out_p, lse_p = ref.flash_attention_lse_ref(q, k, v, **kw)
        got = case["kernel"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        f_err, f_ok = compare((case["out"], case["lse"]), (out_p, lse_p),
                              [TOL[dtype] + (0.0,), LSE_TOL])
        args = [case[n] for n in ("q", "k", "v", "out", "lse", "dout")]
        terms = bwd_abs_terms(*args, kw["causal"], kw["window"], kw["logit_cap"])
        lims = bwd_limits(want, terms, dtype)
        err, ok = compare(got, want, lims)
        truth = ref.flash_attention_bwd_ref(*(x.double() for x in args), **kw)
        lib = case["library"]
        lib_grads = None
        if lib:  # SDPA's gradients, [B, H, S, D] views back to [B, S, H, D]
            lib_grads = [x.transpose(1, 2) for x in lib[0]()]
        share = BWD_TOL[dtype][0]
        far, dist = [], []
        t_lims = bwd_limits(want, terms, dtype, about=truth) if lib is None else None
        for i, (name, a, w, t) in enumerate(zip(("dq", "dk", "dv"), got, want, truth)):
            k_t, p_t = float((a.double() - t).abs().max()), float((w.double() - t).abs().max())
            l_t = float((lib_grads[i].double() - t).abs().max()) if lib_grads else None
            dist.append(f"{name} {k_t:.3g}/{p_t:.3g}/{'-' if l_t is None else f'{l_t:.3g}'}")
            atol = share * float(w.abs().max())
            if dtype == torch.float32:
                ok_t = k_t <= 1.5 * p_t + atol
            elif lib_grads:
                ok_t = k_t <= 1.5 * max(p_t, l_t) + atol
            else:
                ok_t = bool(((a.double() - t).abs() <= 1.5 * p_t + t_lims[i][0]).all())
            if not ok_t:
                far.append(f"{name}: {k_t:.3g} from float64 against the plain version's "
                           f"{p_t:.3g}" + (f" and SDPA's {l_t:.3g}" if l_t is not None else ""))
        key = {"cap": "logit_cap", "window": "window"}
        blind = [n for n in controls if compare(got, case["plain"](**{key[n]: 0}), lims)[1]]
        del truth, terms, lims, t_lims, lib_grads
        row = dict(
            max_abs_err=err,
            ms=time_ms(case["kernel"]),
            plain_ms=time_ms(case["plain"]),
            library_ms=time_ms(lib[0]) if lib else None,
            device_ms=device_ms(case["kernel"]),
            host_us=host_us(case["kernel"]),
            library_device_ms=device_ms(lib[1]) - device_ms(lib[2]) if lib else None,
            library_host_us=host_us(lib[0]) if lib else None,
        )
        row["bound_ms"], row["bound_by"] = bound_ms(case["bytes"], case["flops"], dtype)
        fwd_ms = device_ms(lambda: kfa.flash_attention(q, k, v, with_lse=True, **kw))
        log(f"  flash_attention_bwd {label:58s} {str(dtype)[6:]:8s} err={err:.3g} "
            f"splits={plan.splits} grid_dkdv={plan.grid_dkdv} grid_dq={plan.grid_dq} "
            f"f64 dist kernel/plain/sdpa: {', '.join(dist)} "
            f"fwd out/lse err={f_err:.3g} fwd_lse_device_ms={fwd_ms:.5f} ms={row['ms']:.4f} "
            f"device_ms={row['device_ms']:.5f} host_us={row['host_us']:.1f} "
            f"plain_ms={row['plain_ms']:.4f} sdpa_bwd_ms={fmt(row['library_ms'])} "
            f"sdpa_bwd_device_ms={fmt(row['library_device_ms'], 5)} "
            f"sdpa_bwd_host_us={fmt(row['library_host_us'], 1)} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})"
            + (f"; vs plain without {' / '.join(controls)}: disagrees" if controls and not blind
               else ""))
        if main is None:
            train_forward_row(case, dtype)
        if blind:
            raise AssertionError(f"flash_attention_bwd [{label}]: the plain version without "
                                 f"{', '.join(blind)} agrees too: the case cannot tell them apart")
        if not f_ok:
            raise AssertionError(f"flash forward out/lse [{label}, {dtype}] disagree with the "
                                 f"plain forward: max abs err {f_err:.3g}")
        if not ok or far:
            raise AssertionError(f"flash_attention_bwd [{label}, {dtype}] disagrees with its "
                                 f"plain version: max abs err {err:.3g}; {'; '.join(far)}")
        if main is None:
            main = row
    return main


def train_forward_row(case, dtype):
    """The training forward (the flash kernel writing the lse) at the main
    training shape, timed as phase 3 times a kernel, beside the plain
    ``flash_attention_lse_ref`` and SDPA's forward; its bound: q, k, v read
    once, out and the lse written once, 4 H D flops a visible pair."""

    q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
    kernel = lambda: kfa.flash_attention(q, k, v, with_lse=True, **kw)  # noqa: E731
    plain = lambda: ref.flash_attention_lse_ref(q, k, v, **kw)  # noqa: E731
    lib = sdpa(*(x.transpose(1, 2) for x in (q, k, v)), is_causal=kw["causal"])
    ms_, bound_by = bound_ms(2 * nbytes(q) + 2 * nbytes(k) + nbytes(case["lse"]),
                             case["flops"] / BWD_FLOPS_X, dtype)
    log(f"  flash_attention with lse (training forward, the same shape) {str(dtype)[6:]:8s} "
        f"ms={time_ms(kernel):.4f} device_ms={device_ms(kernel):.5f} "
        f"host_us={host_us(kernel):.1f} plain_ms={time_ms(plain):.4f} "
        f"sdpa_ms={time_ms(lib):.4f} sdpa_device_ms={device_ms(lib):.5f} "
        f"sdpa_host_us={host_us(lib):.1f} bound_ms={ms_:.5f} ({bound_by})")


def mamba_bwd_case(rng, b, s, h, p, n, chunk, with_h0=False, with_dht=False, dt_scale=1.0):
    """The backward's inputs, drawn as ``mamba_case`` draws the forward's,
    h_in from the forward kernel (its plain version where P does not divide
    256), dy normal; dh_t normal or None (the
    training path's: the loss does not read hT)."""

    f32 = torch.float32
    x, bm, c = _t(rng, (b, s, h, p), f32), _t(rng, (b, s, n), f32), _t(rng, (b, s, n), f32)
    dt = F.softplus(_t(rng, (b, s, h), f32)) * dt_scale
    a = -torch.exp(_t(rng, (h,), f32))
    h0 = _t(rng, (b, h, p, n), f32) if with_h0 else None
    dy = _t(rng, (b, s, h, p), f32)
    dh_t = _t(rng, (b, h, p, n), f32) if with_dht else None
    # the forward kernel takes P dividing 256; the backward any P <= 64
    fwd = kms.mamba_scan if 256 % p == 0 else ref.mamba_scan_ref
    _, _, h_in = fwd(x, dt, a, bm, c, h0=h0, chunk=chunk, with_states=True)
    args = (x, dt, a, bm, c, h_in, dy, dh_t)
    L = min(chunk, s)
    pairs = L * (L + 1) // 2
    # per causal pair: G = C B^T once for all heads (2N); per pair and head
    # dy_t . x_s and the r sum (2P each), dB and dC (2N each), the weights;
    # per step and head the state terms (dS, r, dB, dC's carry: 2PN each)
    # and V, dx, ddt; per chunk and head the pass
    per_head = pairs * (4 * p + 4 * n + 6) + L * p * (8 * n + 6) + 3 * p * n + 8 * L
    flops = b * (s // L) * (pairs * 2 * n + h * per_head)
    state = b * h * p * n * 4
    return dict(
        args=args, chunk=chunk,
        kernel=lambda: kmsb.mamba_scan_bwd(*args, chunk=chunk),
        plain=lambda: ref.mamba_scan_bwd_ref(*args, chunk=chunk),
        # x, dy read and dx written; dt, ddt; a, da; B, C, dB, dC; h_in; dh_t, dh0
        bytes=3 * nbytes(x) + 2 * nbytes(dt) + 2 * nbytes(a) + 4 * nbytes(bm) + nbytes(h_in)
        + (2 if with_dht else 1) * state,
        flops=float(flops),
    )


def mamba_bwd_cases(rng):
    return [
        # (label, case, main-path shape?)
        ("Jamba train B=2 S=1024 H=256 P=64 N=16 chunk 256 (4 chunks)",
         mamba_bwd_case(rng, 2, 1024, 256, 64, 16, 256), True),
        ("one chunk B=2 S=256 H=256 P=64 N=16", mamba_bwd_case(rng, 2, 256, 256, 64, 16, 256),
         False),
        ("h0 and dh_t B=1 S=512 H=256 P=64 N=16 chunk 256",
         mamba_bwd_case(rng, 1, 512, 256, 64, 16, 256, with_h0=True, with_dht=True), False),
        ("jamba-smoke B=2 S=512 H=8 P=64 N=16 chunk 256",
         mamba_bwd_case(rng, 2, 512, 8, 64, 16, 256), False),
        ("large dt (x30) B=1 S=512 H=64 P=64 N=16 chunk 256",
         mamba_bwd_case(rng, 1, 512, 64, 64, 16, 256, dt_scale=30.0), False),
        ("ragged B=1 S=300 H=5 P=6 N=5 chunk 100, h0 and dh_t",
         mamba_bwd_case(rng, 1, 300, 5, 6, 5, 100, with_h0=True, with_dht=True), False),
    ]


MAMBA_GRADS = ("dx", "ddt", "da", "dbm", "dc", "dh0")


def mamba_bwd_abs_terms(x, dt, a, bm, c, h_in, dy, dh_t, chunk):
    """Each output element's sum of absolute terms, float64: the plain
    backward's arithmetic on |x|, |B|, |C|, |h_in|, |dy|, |dh_t| (dt and the
    decays are positive), dcum's row, column, carry and V terms added
    where the plain version subtracts some, and |a|."""

    ab = [None if t is None else t.double().abs() for t in (x, bm, c, h_in, dy, dh_t)]
    x, bm, c, h_in, dy, dh_t = ab
    t = ref.mamba_bwd_terms(x, dt.double(), a.double(), bm, c, h_in, dy, dh_t, chunk)
    return ref.mamba_bwd_finish(t, t["row"] + t["col"] + t["carry"] + t["v"], a.double().abs())


def launch_split(fn, calls=5):
    """{kernel name: mean device ms a call} of the kernels ``fn`` launches,
    over ``calls`` calls under torch.profiler (None: the profiler saw no
    kernel).  The name is the kernel's own, template arguments dropped."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for name, ms in device_events(prof):
        bare = name.replace("(anonymous namespace)::", "")
        key = (bare.split("(")[0].split("<")[0].split("::")[-1].split() or [name[:40]])[-1]
        per[key] = per.get(key, 0.0) + ms / calls
    return per or None


def check_mamba_bwd(cases):
    """Each case: every gradient of the kernel against the plain backward in
    float64 on the same inputs under ``MAMBA_BWD_TOL``, a rerun bitwise
    equal, and the float32 plain version's distance for scale; times as
    phase 3's (no PyTorch call computes this function)."""

    main = None
    atol, share = MAMBA_BWD_TOL
    for label, case, is_main in cases:
        got = case["kernel"]()
        again = case["kernel"]()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        args, chunk = case["args"], case["chunk"]
        want = ref.mamba_scan_bwd_ref(*(None if t is None else t.double() for t in args),
                                      chunk=chunk)
        terms = mamba_bwd_abs_terms(*args, chunk)
        plain = case["plain"]()
        err, dist, bad = 0.0, [], []
        for name, g, w, t, p32 in zip(MAMBA_GRADS, got, want, terms, plain):
            d = (g.double() - w).abs()
            share_k = float((d / (t + 1e-300)).max())
            share_p = float(((p32.double() - w).abs() / (t + 1e-300)).max())
            err = max(err, float(d.max()))
            dist.append(f"{name} {float(d.max()):.3g} ({share_k:.2g}/{share_p:.2g})")
            if not (bool(torch.isfinite(g).all()) and bool((d <= atol + share * t).all())):
                bad.append(name)
        del want, terms, plain
        b, s_, h, p = args[0].shape
        plan = _lib.mamba_bwd_plan(b, s_, h, p, args[3].shape[-1], chunk)
        row = dict(
            max_abs_err=err,
            ms=time_ms(case["kernel"]),
            plain_ms=time_ms(case["plain"]),
            library_ms=None,
            device_ms=device_ms(case["kernel"]),
            host_us=host_us(case["kernel"]),
        )
        row["bound_ms"], row["bound_by"] = bound_ms(case["bytes"], case["flops"], torch.float32)
        tc_ms = max(case["bytes"] / HBM_BPS, 3 * case["flops"] / TF32_FLOPS) * 1e3
        log(f"  mamba_scan_bwd    {label:58s} err={err:.3g} heads/block={plan.heads} "
            f"chunk_blocks={plan.chunk_blocks} rerun {'bitwise equal' if same else 'DIFFERS'}; "
            f"max err (of its terms, kernel/float32 plain): {', '.join(dist)} "
            f"ms={row['ms']:.4f} device_ms={row['device_ms']:.5f} host_us={row['host_us']:.1f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; "
            f"{case['flops'] / 1e9:.2f} GFLOP, {case['bytes'] / 1e9:.3f} GB) "
            f"tc_bound_ms={tc_ms:.5f} (3xTF32 at {TF32_FLOPS / 1e12:g} TFLOP/s, or the bytes)")
        if not same:
            raise AssertionError(f"mamba_scan_bwd [{label}]: a rerun on the same inputs differs")
        if bad:
            raise AssertionError(f"mamba_scan_bwd [{label}] disagrees with its plain version in "
                                 f"{', '.join(bad)}: max abs err {err:.3g}")
        if is_main:
            main = row
    return main


def scan_bwd_split():
    """The Mamba scan backward's device time at Jamba's training shape
    split by launch (``launch_split``), printed.  Phase 8(a) runs it in a
    process of its own (``scan_bwd_split_apart``)."""

    case = mamba_bwd_case(np.random.default_rng(9), 2, 1024, 256, 64, 16, 256)
    split = launch_split(case["kernel"])
    log("  mamba_scan_bwd launch split, Jamba train B=2 S=1024 H=256 P=64 N=16 chunk 256 "
        "(device ms a call, profiler, 5 calls): " + (
            "not measured (the profiler recorded no CUDA kernels)" if split is None else
            ", ".join(f"{k} {v:.5f}" for k, v in split.items())
            + f"; sum {sum(split.values()):.5f}"))


def scan_bwd_split_apart():
    """``scan_bwd_split`` in a fresh process (the kernels already built):
    after the serving phases this process's profiler recorded no CUDA
    kernel in a whole run on an H100 80GB HBM3 (700 W), and a run that
    profiled it before them saw a later CUDA graph capture fail in cuBLAS."""

    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.scan_bwd_split()"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if "launch split" in ln]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the scan backward's launch split failed (exit {proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    for ln in lines:
        log(ln)


def smoke_train_batch(cfg, rng, b=2, s=64):
    tok = EpisodeTokenizer(cfg.vocab_size)
    data = episode_dataset(tok, tasks=("pick_place",), seeds=(0, 1))
    batch = next(iter(TokenBatchIterator(data, b, s, seed=int(rng.integers(1 << 30)),
                                         action_base=tok.action_base)))
    if cfg.modality == "vision":
        batch["frontend"] = (rng.standard_normal((b, cfg.num_modality_tokens, cfg.d_model))
                             * 0.02).astype(np.float32)
    return batch


def grads_of(model, batch):
    params = trainable_params(model)
    for p in params.values():
        p.grad = None
    loss, _ = model.loss_fn({k: torch.as_tensor(v, device=model.device) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), params, {n: p.grad for n, p in params.items()}


def twin_leaf_tol(name):
    if name == "embed.table":
        return TWIN_EMBED
    return TWIN_DECAY if name.endswith("mamba.a_log") else TWIN_LEAF


def train_card_vs_cpu(arch):
    """The f32 smoke stack's loss and every gradient, card (kernels) against
    CPU (plain versions) on the same weights and batch, then one AdamW
    update (learning-rate factor 1) on each."""

    cfg = get_smoke_config(arch).replace(dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    seq = TWIN_SMOKE_SEQ.get(arch, 64)
    batch = smoke_train_batch(cfg, np.random.default_rng(5), s=seq)
    ops.reset_launch_counts()
    lg, pg, gg = grads_of(gpu, batch)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    lc, pc, gc_ = grads_of(cpu, batch)
    n_attn = sum(spec[0] == "attn" for spec in gpu.specs)
    n_mamba = sum(spec[0] == "mamba" for spec in gpu.specs)
    want = {n: 0 for n in _lib.KERNELS}
    want.update(flash_attention=n_attn, flash_attention_bwd=n_attn, mamba_scan=n_mamba,
                mamba_scan_bwd=n_mamba)
    if counts != want:
        raise AssertionError(f"{cfg.name} f32 loss_fn + backward launches {counts}, expected {want}")
    if abs(float(lg) - float(lc)) > TWIN_LOSS_RTOL * abs(float(lc)):
        raise AssertionError(f"{cfg.name} f32 loss card {float(lg)} vs CPU {float(lc)}")
    worst = 0.0
    for name, g in gc_.items():
        tol = twin_leaf_tol(name) * float(g.abs().max())
        err = float((gg[name].cpu() - g).abs().max())
        worst = max(worst, err / max(float(g.abs().max()), 1e-30))
        if err > tol:
            raise AssertionError(f"{cfg.name} f32 grad {name} card vs CPU err {err:.3g} > {tol:.3g}")
    # the update on the same gradients (the card's): AdamW's g / (|g| + eps)
    # turns a gradient's float32 noise into a full step where |g| ~ eps
    ocfg = AdamWConfig(lr=1e-3)
    adamw_update(gg, adamw_init(pg, ocfg), pg, ocfg, 1.0)
    adamw_update({n: g.cpu() for n, g in gg.items()}, adamw_init(pc, ocfg), pc, ocfg, 1.0)
    p_err = 0.0
    for name, p in pc.items():
        err = float((pg[name].detach().cpu() - p.detach()).abs().max())
        p_err = max(p_err, err)
        if err > 1e-6 * float(p.detach().abs().max()) + 1e-3 * ocfg.lr:
            raise AssertionError(f"{cfg.name} f32 AdamW step {name} card vs CPU err {err:.3g}")
    moe = [i for i, spec in enumerate(gpu.specs) if spec[1]]
    log(f"  {cfg.name} f32 train twin, card kernels vs CPU plain, B=2 S={seq}"
        + (f" (experts in layers {moe})" if moe else "") + f": loss {float(lg):.6f} vs "
        f"{float(lc):.6f}, {len(gc_)} gradients within {TWIN_LEAF:g} of their leaf's max "
        f"(a_log {TWIN_DECAY:g}; worst {worst:.3g} of it), one AdamW update on the card's "
        "gradients: params "
        f"max err {p_err:.3g}; "
        f"launches {dict((k, v) for k, v in counts.items() if v)}")


def train_full_width(launches, cfg, batch_size, seq, steps, per_step):
    """``cfg`` at full width, bf16, ``steps`` AdamW steps (bf16 moments) of
    ``make_train_step`` on ``batch_size`` x ``seq`` episode tokens; the
    hand kernels must launch exactly ``per_step`` a step."""

    name = cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = trainable_params(model)
    n_params = sum(p.numel() for p in params.values())
    ocfg = AdamWConfig(moment_dtype="bfloat16")
    state = adamw_init(params, ocfg)
    step_fn = make_train_step(model, ocfg, steps)
    tok = EpisodeTokenizer(cfg.vocab_size)
    it = iter(TokenBatchIterator(episode_dataset(tok), batch_size, seq,
                                 action_base=tok.action_base))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in next(it).items()}
               for _ in range(steps)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, step_ms, gnorms = [], [], []
    ops.reset_launch_counts()
    for batch in batches:
        t1 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))  # synchronises, as the trainer's loop does
        gnorms.append(float(metrics["grad_norm"]))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # one more step split by the host clock, a synchronise between its
    # parts: loss_fn, backward, the AdamW update (bf16 moments)
    split, t1 = [], time.perf_counter()
    for p in params.values():
        p.grad = None
    for part in ("forward", "backward", "adamw"):
        if part == "forward":
            loss, _ = model.loss_fn(batches[-1])
        elif part == "backward":
            loss.backward()
        else:
            adamw_update({n: p.grad for n, p in params.items()}, state, params, ocfg, 1.0)
        torch.cuda.synchronize()
        split.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
    want = {n: 0 for n in _lib.KERNELS}
    want.update({k: v * steps for k, v in per_step.items()})
    if counts != want:
        raise AssertionError(f"{name} training launches {counts}, expected {want}")
    for k in per_step:
        launches[k] += counts[k]
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise AssertionError(f"{name} training: non-finite loss or grad norm {losses}")
    last = float(np.mean(losses[-5:]))
    if not last < losses[0]:
        raise AssertionError(f"{name} training: loss did not fall ({losses[0]:.4f} -> "
                             f"mean of the last 5 {last:.4f})")
    tokens = batch_size * seq
    steady = float(np.mean(step_ms[1:]))
    pairs = seq * (seq + 1) // 2
    n_attn = sum(spec[0] == "attn" for spec in model.specs)
    attn_flops = (1 + BWD_FLOPS_X) * 4.0 * batch_size * cfg.num_heads * \
        cfg.resolved_head_dim * pairs * n_attn
    flops = 6.0 * n_params * tokens + attn_flops
    share = flops / (steady * 1e-3) / PEAK_FLOPS[torch.bfloat16]
    kinds = "".join(spec[0][0] for spec in model.specs)  # m(amba), a(ttn), ...
    log(f"  {name} train: {cfg.num_layers} layers ({kinds}), {n_params / 1e9:.3f} G params, "
        f"bf16, AdamW bf16 moments, B={batch_size} S={seq}, {steps} steps (set-up "
        f"{setup_s:.1f} s; {held / 2**30:.2f} GiB held by earlier phases)")
    log(f"  losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  grad norms first {gnorms[0]:.3f} last {gnorms[-1]:.3f}; loss {losses[0]:.4f} -> mean "
        f"of the last 5 {last:.4f}")
    log(f"  step_ms first {step_ms[0]:.1f} steady {steady:.1f} (min {min(step_ms[1:]):.1f} "
        f"max {max(step_ms[1:]):.1f}); tokens/s {tokens / (steady * 1e-3):.0f}; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB; "
        f"{flops / 1e12:.2f} TFLOP a step (6 N tokens + attention {attn_flops / 1e12:.3f}) = "
        f"{share * 100:.1f}% of the bf16 dense peak; launches "
        f"{dict((k, v) for k, v in counts.items() if v)} ({per_step} a step; a backward "
        "launch is one call of several kernels)")
    log(f"  one more step, split (host clock, synchronised): forward {split[0]:.1f} ms, "
        f"backward {split[1]:.1f} ms, AdamW update {split[2]:.1f} ms")
    del model, params, state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()


def train_xlstm():
    """xlstm-125m (the reference trainer's default arch) through the
    driver on the card; its checkpoint written by ``save`` found and
    restored equal."""

    ckpt = ROOT / "build" / "train_ckpt"
    if ckpt.exists():
        for f in ckpt.iterdir():
            f.unlink()
    res = train_main(["--arch", XLSTM, "--device", "cuda", "--ckpt-dir", str(ckpt)]
                     + XLSTM_TRAIN)
    if not res["final_loss"] < res["first_loss"] or not np.isfinite(res["losses"]).all():
        raise AssertionError(f"xlstm-125m training: loss {res['first_loss']:.4f} -> "
                             f"{res['final_loss']:.4f}")
    path = latest_checkpoint(str(ckpt))
    if path is None or not path.endswith("ckpt_00000030.npz"):
        raise AssertionError(f"xlstm-125m checkpoint not found: {path}")
    mine = reference_tensors(res["model"])
    back = restore(path, {"params": mine})["params"]
    bad = [k for k, t in mine.items()
           if back[k].dtype != t.dtype or back[k].device != t.device or not torch.equal(back[k], t)]
    if bad:
        raise AssertionError(f"xlstm-125m checkpoint round trip differs at {bad[:4]}")
    log(f"  xlstm-125m train (launch.train.main on the card): loss {res['first_loss']:.4f} -> "
        f"{res['final_loss']:.4f} (mean of the last 10); checkpoint {Path(path).name}: "
        f"{len(mine)} tensors restored equal (dtype, device, values)")
    for f in ckpt.iterdir():
        f.unlink()
    ckpt.rmdir()


def train_phase(launches):
    """Phase 8 -> the two backward kernels' main-shape rows."""

    rows = {"flash_attention_bwd": check_bwd_kernel(bwd_cases(np.random.default_rng(8))),
            "mamba_scan_bwd": check_mamba_bwd(mamba_bwd_cases(np.random.default_rng(9)))}
    scan_bwd_split_apart()
    for arch in ("openvla-7b", XLSTM, JAMBA):
        train_card_vs_cpu(arch)
    layers = get_config("openvla-7b").num_layers
    train_full_width(launches, get_config("openvla-7b"), TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
                     {"flash_attention": layers, "flash_attention_bwd": layers})
    jamba = get_config(JAMBA).replace(num_layers=JAMBA_TRAIN_LAYERS, moe=None)
    pattern = jamba.block_pattern
    n_mamba = sum(pattern[i % len(pattern)] == "mamba" for i in range(JAMBA_TRAIN_LAYERS))
    train_full_width(launches, jamba, JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS,
                     {"mamba_scan": n_mamba, "mamba_scan_bwd": n_mamba,
                      "flash_attention": JAMBA_TRAIN_LAYERS - n_mamba,
                      "flash_attention_bwd": JAMBA_TRAIN_LAYERS - n_mamba})
    train_xlstm()
    return rows


# ---------------------------------------------------------------------------
# phase 8b: the dry run, the roofline and the examples
# ---------------------------------------------------------------------------

DRYRUN_ARGV = ["--arch", "all", "--shape", "all", "--mesh", "both"]
DRYRUN_COUNTS = {"ok": 2 * 2 * 34, "skip": 6, "fail": 0}  # 2 variants x 2 meshes x 34
EXAMPLES = {
    "quickstart": ["examples/quickstart_torch.py"],
    "fleet rapid": ["examples/ecc_serving_torch.py", "--fleet", "4", "--trigger", "rapid",
                    "--scan-rounds", "4"],
    "churn": ["examples/ecc_serving_torch.py", "--fleet", "8", "--arrivals", "poisson"],
    "fleet split": ["examples/ecc_serving_torch.py", "--fleet", "4", "--partition", "auto",
                    "--network", "lan"],
    "single robot": ["examples/ecc_serving_torch.py"],
}
# the kernels each serving example must have launched: the fleet's paged
# rounds and flash prefill, the single robot's dense decode
EXAMPLE_KERNELS = {"fleet rapid": ("flash_attention", "paged_attention"),
                   "churn": ("flash_attention", "paged_attention"),
                   "fleet split": ("flash_attention", "paged_attention"),
                   "single robot": ("flash_attention", "decode_attention")}
SUBPROCESS_S = 600


def spawn(cmd, log_path):
    """``python cmd`` from the repository root, its output into ``log_path``."""

    out = open(log_path, "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env, stdout=out,
                            stderr=subprocess.STDOUT)
    out.close()
    return proc


def wait_all(procs, t0):
    """Wait for every ``{name: (process, log path)}`` -> ``{name: seconds}``;
    raises with the output's tail if one exits nonzero or runs past
    ``SUBPROCESS_S``."""

    secs = {}
    while len(secs) < len(procs):
        for name, (proc, path) in procs.items():
            if name not in secs and proc.poll() is not None:
                secs[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    tail = Path(path).read_text()[-3000:]
                    raise AssertionError(f"{name} exited {proc.returncode}:\n{tail}")
        if time.perf_counter() - t0 > SUBPROCESS_S:
            raise AssertionError(f"still running after {SUBPROCESS_S} s: "
                                 f"{sorted(set(procs) - set(secs))}")
        time.sleep(0.2)
    return secs


def without_timing(results):
    return {k: {f: v for f, v in r.items() if f != "layout_s"} for k, r in results.items()}


def estimate_vs_floor(tokens: int = 56, kv_len: int = 70):
    """(b) ``estimate``'s memory term of openvla-7b decode (batch 1, a
    cache of ``kv_len``) for ``tokens`` steps on ``HW_H100``, against
    ``weight_floor_ms``: the gap is the untied embedding table, which
    ``estimate`` reads and the floor does not, plus the cache read, less
    the parameters the floor counts and ``estimate`` does not (the stub
    projector and the norms)."""

    cfg = get_config("openvla-7b")
    est = estimate(cfg, InputShape("openvla_decode_70", kv_len, 1, "decode"))
    per_ms = tokens / HW_H100.hbm_bw * 1e3
    est_ms, floor = est.hbm_bytes * per_ms, weight_floor_ms(cfg, tokens)
    vpad = -(-cfg.vocab_size // 256) * 256
    table = cfg.vocab_size * cfg.d_model
    only_floor = (cfg.param_count() - vpad * cfg.d_model) - (cfg.param_counts()["total"] - table)
    table_ms, cache_ms = 2.0 * table * per_ms, _decode_cache_bytes(cfg, 1, kv_len) * per_ms
    other_ms = 2.0 * only_floor * per_ms
    gap = est_ms - floor
    log(f"  (b) openvla-7b decode, batch 1, kv {kv_len}, x {tokens} tokens on {HW_H100.name}: "
        f"estimate's memory term {est_ms:.3f} ms, weight_floor_ms {floor:.3f} ms, gap "
        f"{gap:.3f} ms ({gap / floor * 100:.2f}%) = untied embedding table "
        f"{cfg.vocab_size} x {cfg.d_model} bf16 ({2 * table / 1e6:.1f} MB) {table_ms:.3f} + "
        f"cache {cache_ms:.3f} - stub projector and norms {other_ms:.3f} ms")
    if abs(gap - (table_ms + cache_ms - other_ms)) > 1e-9 * floor or \
            abs(gap - table_ms) > cache_ms + other_ms:
        raise AssertionError(f"the gap {gap:.4f} ms is not the table's {table_ms:.4f} ms")


def dryrun_phase():
    """(a) ``python -m repro_torch.launch.dryrun`` over every arch, shape and
    production mesh for both variants, and the same in this process, where
    the card's allocated bytes must not move; (b) ``estimate_vs_floor``; (c)
    the examples on the card, each of which must exit 0.  The subprocesses
    run side by side."""

    (ROOT / "build").mkdir(exist_ok=True)
    procs = {}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            for variant in ("baseline", "optimized"):
                procs[f"dryrun {variant}"] = (spawn(
                    ["-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV, "--variant", variant,
                     "--out", str(tmp / f"cli_{variant}.json")], tmp / f"dryrun_{variant}.log"),
                    tmp / f"dryrun_{variant}.log")
            for name, cmd in EXAMPLES.items():
                path = tmp / f"{name.replace(' ', '_')}.log"
                procs[name] = (spawn(cmd, path), path)

            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                for variant in ("baseline", "optimized"):
                    mine = dryrun.main(DRYRUN_ARGV + ["--variant", variant,
                                                      "--out", str(tmp / "inproc.json")])
            took = time.perf_counter() - t1
            torch.cuda.synchronize()
            after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
            if (after, peak) != (held, held):
                raise AssertionError(f"the dry run moved the card's memory: allocated {held} -> "
                                     f"{after}, peak {peak}")
            counts = {k: sum(r["status"] == k for r in mine.values()) for k in DRYRUN_COUNTS}
            if counts != DRYRUN_COUNTS:
                raise AssertionError(f"dry-run records {counts}, expected {DRYRUN_COUNTS}")
            log(f"  (a) dry run in this process, both variants: {counts['ok']} ok / "
                f"{counts['skip']} skip / {counts['fail']} fail in {took:.1f} s; the card's "
                f"allocated bytes {held} before and after, peak {peak}")
            for key, r in mine.items():
                if r["status"] == "ok":
                    log(f"    {key}: compute {r['compute_s']:.6g} s memory {r['memory_s']:.6g} "
                        f"s ({r['bottleneck']}), {r['mem_per_device_gb']:.3f} GB a device")
            estimate_vs_floor()

            secs = wait_all(procs, t0)
            cli = {}
            for variant in ("baseline", "optimized"):
                cli.update(json.loads((tmp / f"cli_{variant}.json").read_text()))
            if without_timing(cli) != without_timing(mine):
                raise AssertionError("the dry-run CLI's records differ from the in-process run's")
            log(f"  (a) the dry-run CLI, both variants: exit 0, records equal to the in-process "
                f"run's ({secs['dryrun baseline']:.1f} / {secs['dryrun optimized']:.1f} s)")
            for name, cmd in EXAMPLES.items():
                lines = procs[name][1].read_text().splitlines()
                log(f"  (c) {' '.join(cmd)}: exit 0 in {secs[name]:.1f} s (side by side)")
                for line in lines[1:] if name == "quickstart" else lines[-7:]:
                    log(f"      {line}")
                if name in EXAMPLE_KERNELS:
                    counts = json.loads(lines[-1].removeprefix("kernel launches: "))
                    idle = [k for k in EXAMPLE_KERNELS[name] if not counts[k]]
                    if idle:
                        raise AssertionError(f"{name} launched no {idle}: {counts}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main(argv) -> int:
    kernels_only = argv == ["--kernels-only"]
    train_only = argv == ["--train-only"]
    if argv and not (kernels_only or train_only):
        print(f"chip_smoke: unknown arguments {argv}; takes none, --kernels-only or "
              "--train-only", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2

    phase("1. environment")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    phase("2. build")
    secs = _lib.build_all(force=True)
    log(f"  built {list(_lib.KERNELS)} in {secs:.1f} s")
    for name, text in _lib.BUILD_LOG.items():
        fn = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"  {name} {fn}: {line.split(':', 1)[-1].strip()}")

    if train_only:
        phase("8. train")
        train_phase({n: 0 for n in _lib.KERNELS})
        phase()
        log("== --train-only: phases 3-7 skipped, no result line")
        return 0

    phase("3. kernels against their plain versions")
    fleet_eps = fleet_episodes()
    fleet = fleet_streams(fleet_eps)
    main_rows = check_kernels(kernel_cases(np.random.default_rng(0), fleet))
    if kernels_only:
        phase()
        log("== --kernels-only: phases 4-8 skipped, no result line")
        return 0

    launches = {n: 0 for n in _lib.KERNELS}
    stacks = [("openvla-7b", get_config("openvla-7b").replace(num_layers=OPENVLA_LAYERS),
               openvla_scheduler, False),
              (JAMBA, get_config(JAMBA).replace(num_layers=JAMBA_LAYERS), jamba_scheduler, False)]
    stacks += [(arch, get_config(arch).replace(num_layers=NEW_ARCH_LAYERS), dense_arch_scheduler,
                True) for arch in NEW_ARCHS]
    for arch, cfg, sched_phase, brief in stacks:
        phase(f"4. model ({arch})")
        check_small_model_against_cpu(arch)
        serve_stack(cfg, launches, sched_phase, brief)
    phase("4. monitor")
    monitor_path(fleet, launches)
    phase("4. dispatcher")
    dispatcher_path(fleet, fleet_eps, card)
    for arch, layers in MOE_ARCHS.items():
        phase(f"4. model ({arch})")
        for impl in MOE_IMPLS:
            check_small_model_against_cpu(arch, impl)
        serve_moe_stack(get_config(arch).replace(num_layers=layers), launches)
    phase(f"4. model ({XLSTM})")
    check_small_model_against_cpu(XLSTM)
    serve_stack(get_config(XLSTM), launches, xlstm_scheduler, brief=True)
    phase(f"4. model ({ENCDEC})")
    encdec_card_vs_cpu()
    serve_encdec(get_config(ENCDEC), launches)
    phase(f"7e. xLSTM and enc-dec on the model axis ({XLSTM}, {ENCDEC}, {MODEL_AXIS} ranks)")
    xe_axis_phase(launches)
    phase("8. train")
    main_rows.update(train_phase(launches))
    phase("8b. dry run, roofline and examples")
    dryrun_phase()

    phase("9. result")
    rows = []
    for name in _lib.KERNELS:
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name], **main_rows[name],
        ))
    print(f"card: {card}")
    print(f"kernels: {json.dumps(list(_lib.KERNELS))}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
