"""Single-robot serving driver of the port:
``python -m repro_torch.launch.serve [--arch openvla-7b] [--paged] [--device cuda]``.

Counterpart of the single-robot path of ``repro/launch/serve.py``: the RAPID
dispatcher monitors simulated robot kinematics tick by tick, and on each
dispatch the cloud VLA (prefill + greedy decode of an action chunk through
the KV cache) produces a fresh chunk.  ``CloudPolicy`` decodes through dense
per-row slabs (``fused``: no host sync per token; or the per-token loop) or
through the paged KV substrate (``paged=True``); on a CUDA model both
replay a CUDA graph per shape.  The continuous-batching scheduler that
serves many robots is ``runtime.scheduler``; fleet serving and the
partitioned lanes come in later slices.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.dispatcher import DispatcherConfig, dispatcher_init, dispatcher_step
from repro_torch.core.kinematics import KinematicFrame
from repro_torch.data.pipeline import EpisodeTokenizer
from repro_torch.models.model import Model
from repro_torch.obs.clock import clock
from repro_torch.robotics.episodes import generate_episode
from repro_torch.runtime.graphs import GraphedCall
from repro_torch.runtime.kv_cache import PagedSpec


class CloudPolicy:
    """Batched VLA serving: observation tokens -> k-step action chunk.

    ``fused=True`` (default) decodes the ``chunk_len * n_joints`` tokens with
    ``Model.decode_chunk`` (tokens stay on the device until the chunk is
    done); ``fused=False`` keeps the per-token loop that copies each token
    to the host (the reference's own baseline; always eager).
    ``paged=True`` scatters the prompt KV into a page pool of
    ``page_size``-token pages after prefill and decodes through the paged
    attention kernel.  All three give the same greedy chunks up to
    floating-point ties.

    On a CUDA model the fused and the paged chunk (prefill included) replay
    a CUDA graph built per ``(B, prompt_len)`` (the reference jits per
    shape; ``runtime.graphs.GraphedCall``).  A dense chunk's decode lengths
    are host ints (prompt_len .. prompt_len + n_steps - 1), the same at
    every call of a shape, so the graph holds the whole chunk and the
    decode kernel keeps its host-int length path.  On a CPU model the same
    function runs eagerly (``eager_chunk``).
    """

    def __init__(self, model: Model, tokenizer: EpisodeTokenizer, chunk_len: int = 8,
                 n_joints: int = 7, fused: bool = True, paged: bool = False,
                 page_size: int = 16):
        self.model = model
        self.tok = tokenizer
        self.chunk_len = chunk_len
        self.n_joints = n_joints
        self.fused = fused
        self.paged = paged
        self.page_size = page_size
        self.n_steps = chunk_len * n_joints
        self._graphs = {}  # (B, prompt_len) -> (static tokens, GraphedCall)

    def _page_plan(self, b: int, prompt: int):
        """(spec, page table, caps) of a chunk: ``b`` rows, each with its own
        pages for the prompt and the chunk."""

        page = self.page_size
        maxp = -(-(prompt + self.n_steps) // page)
        spec = PagedSpec(num_pages=b * maxp, page_size=page, max_pages_per_seq=maxp)
        i32 = dict(dtype=torch.int32, device=self.model.device)
        pt = torch.arange(b * maxp, **i32).reshape(b, maxp)
        return spec, pt, torch.full((b,), maxp * page, **i32)

    def _chunk(self, tokens, plan=None):
        """Prefill + greedy decode of one chunk -> (tokens [B, n_steps], the
        next logits [B, 1, V])."""

        m, floor = self.model, self.tok.action_base
        if self.paged:
            spec, pt, caps = plan
            logits, dcache = m.prefill({"tokens": tokens}, extra=0)
            cache = m.cache_to_paged(dcache, m.init_paged_cache(tokens.shape[0], spec), pt, caps)
        else:
            logits, cache = m.prefill({"tokens": tokens}, extra=self.n_steps)
        toks, logits, _ = m.decode_chunk(logits, cache, self.n_steps, floor)
        return toks, logits

    def eager_chunk(self, tokens):
        """The chunk that ``chunk`` replays, run eagerly: ``Model.prefill`` and
        ``Model.decode_chunk`` -> (action tokens [B, n_steps], the next
        logits [B, 1, V])."""

        b, prompt = tokens.shape
        return self._chunk(tokens, self._page_plan(b, prompt) if self.paged else None)

    def chunk(self, tokens):
        """tokens [B, S] on the model's device -> (action tokens [B, n_steps],
        the next logits [B, 1, V]); on a CUDA model a graph replay (its
        outputs hold until the next call)."""

        if self.model.device.type != "cuda":
            return self.eager_chunk(tokens)
        b, prompt = tokens.shape
        entry = self._graphs.get((b, prompt))
        if entry is None:
            plan = self._page_plan(b, prompt) if self.paged else None
            static = tokens.clone()
            entry = (static, GraphedCall(lambda: self._chunk(static, plan)))
            self._graphs[(b, prompt)] = entry
        static, call = entry
        static.copy_(tokens)
        return call()

    def chunk_tokens(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        """qd/tau [B, N] -> greedy action tokens [B, chunk_len * n_joints]."""

        obs = np.concatenate([self.tok.encode_state(qd), self.tok.encode_state(tau)], axis=1)
        tokens = torch.as_tensor(obs, device=self.model.device)
        if self.fused or self.paged:
            return self.chunk(tokens)[0].cpu().numpy()
        # per-token loop: mask to the action bins, argmax, sync to host
        logits, cache = self.model.prefill({"tokens": tokens}, extra=self.n_steps)
        floor = torch.arange(logits.shape[-1], device=logits.device) < self.tok.action_base
        acts = []
        for _ in range(self.n_steps):
            tok = logits[:, -1].masked_fill(floor, -1e9).argmax(dim=-1, keepdim=True)
            acts.append(tok.cpu().numpy())
            logits, cache = self.model.decode_step(tok, cache)
        return np.concatenate(acts, axis=1)

    def __call__(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        """qd/tau [B, N] -> action chunk [B, k, N]."""

        toks = self.chunk_tokens(qd, tau)
        return self.tok.decode_action(toks).reshape(-1, self.chunk_len, self.n_joints)


def serve_episode(policy: CloudPolicy, task: str = "pick_place", seed: int = 0,
                  dcfg: Optional[DispatcherConfig] = None, max_steps: int = 400,
                  verbose: bool = True, device="cuda"):
    """Closed loop: the dispatcher decides on ``device``, the model serves
    chunks.  ``cloud_ms`` times each chunk on the host clock, device work
    included (the chunk is copied to the host before the clock stops)."""

    ep = generate_episode(task, seed=seed)
    dcfg = dcfg or DispatcherConfig(chunk_len=policy.chunk_len, action_dim=policy.n_joints)
    state = dispatcher_init(dcfg, batch_shape=(), device=device)

    def dev(a):
        return torch.as_tensor(a, device=device)

    n_off = 0
    cloud_ms = []
    actions = []
    t_len = min(max_steps, ep.q.shape[0])
    cached_chunk = torch.zeros((dcfg.chunk_len, dcfg.action_dim), dtype=torch.float32,
                               device=device)
    for t in range(t_len):
        frame = KinematicFrame(q=dev(ep.q[t]), qd=dev(ep.qd[t]), tau=dev(ep.tau[t]))
        # peek: would the dispatcher offload?  run the step with the cached
        # chunk; if it dispatched, charge a real cloud inference
        state, out = dispatcher_step(state, frame, cached_chunk, dcfg)
        if bool(out.offloaded):
            t0 = clock()
            fresh = policy(ep.qd[t : t + 1], ep.tau[t : t + 1])[0]
            cloud_ms.append((clock() - t0) * 1e3)
            cached_chunk = dev(fresh)
            n_off += 1
        actions.append(out.action.cpu().numpy())
    if verbose:
        print(f"task={task} steps={t_len} offloads={n_off} "
              f"cloud_ms(host)={np.mean(cloud_ms) if cloud_ms else 0:.1f}")
    return {"offloads": n_off, "steps": t_len, "actions": np.stack(actions),
            "cloud_ms": cloud_ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="openvla-7b")
    p.add_argument("--task", default="pick_place")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--paged", action="store_true",
                   help="single-robot decode through the paged KV substrate")
    p.add_argument("--device", default="cuda",
                   help="where the model and the dispatcher run (cuda or cpu)")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    model = Model(cfg, device=args.device)
    policy = CloudPolicy(model, EpisodeTokenizer(cfg.vocab_size), paged=args.paged)
    return serve_episode(policy, task=args.task, max_steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
