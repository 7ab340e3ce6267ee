"""Single-robot serving driver of the port:
``python -m repro_torch.launch.serve [--arch openvla-7b] [--paged] [--device cuda]``.

Counterpart of the single-robot path of ``repro/launch/serve.py``: the RAPID
dispatcher monitors simulated robot kinematics tick by tick, and on each
dispatch the cloud VLA (prefill + greedy decode of an action chunk through
the KV cache) produces a fresh chunk.  ``CloudPolicy`` decodes through dense
per-row slabs (``fused``: no host sync per token; or the per-token loop) or
through the paged KV substrate (``paged=True``).  The fleet scheduler and
the partitioned lanes come in later slices.
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
from repro_torch.runtime.kv_cache import PagedSpec


class CloudPolicy:
    """Batched VLA serving: observation tokens -> k-step action chunk.

    ``fused=True`` (default) decodes the ``chunk_len * n_joints`` tokens with
    ``Model.decode_chunk`` (tokens stay on the device until the chunk is
    done); ``fused=False`` keeps the per-token loop that copies each token
    to the host.  ``paged=True`` scatters the prompt KV into a page pool of
    ``page_size``-token pages after prefill and decodes through the paged
    attention kernel.  All three give the same greedy chunks up to
    floating-point ties.
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

    def _paged_tokens(self, tokens):
        b, prompt = tokens.shape
        page = self.page_size
        maxp = -(-(prompt + self.n_steps) // page)
        spec = PagedSpec(num_pages=b * maxp, page_size=page, max_pages_per_seq=maxp)
        pt = np.arange(b * maxp, dtype=np.int32).reshape(b, maxp)
        caps = np.full((b,), maxp * page, np.int32)
        logits, dcache = self.model.prefill({"tokens": tokens}, extra=0)
        pcache = self.model.cache_to_paged(
            dcache, self.model.init_paged_cache(b, spec), pt, caps
        )
        return self.model.decode_chunk(logits, pcache, self.n_steps, self.tok.action_base)[0]

    def chunk_tokens(self, qd: np.ndarray, tau: np.ndarray) -> np.ndarray:
        """qd/tau [B, N] -> greedy action tokens [B, chunk_len * n_joints]."""

        obs = np.concatenate([self.tok.encode_state(qd), self.tok.encode_state(tau)], axis=1)
        tokens = torch.as_tensor(obs, device=self.model.device)
        if self.paged:
            return self._paged_tokens(tokens).cpu().numpy()
        logits, cache = self.model.prefill({"tokens": tokens}, extra=self.n_steps)
        if self.fused:
            toks, _, _ = self.model.decode_chunk(
                logits, cache, self.n_steps, self.tok.action_base
            )
            return toks.cpu().numpy()
        # per-token loop: mask to the action bins, argmax, sync to host
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
