"""Data pipeline of the port (own copy of ``repro/data/pipeline.py``; numpy
only): VLA episode tokenization and next-token batches.

Per control step: [N state tokens][A action tokens].  Action bins occupy the
TOP ``n_action_bins`` ids of the vocab (OpenVLA convention), state bins the
ids just below them.  ``episode_dataset`` / ``TokenBatchIterator`` make the
training batches of the episodes, ``synthetic_lm_batches`` a Markov-chain
token stream; both draw from ``np.random.default_rng(seed)`` in the
reference's order, so their batches equal the reference's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.robotics.episodes import Episode, generate_episode


@dataclass
class EpisodeTokenizer:
    vocab_size: int
    n_state_bins: int = 128
    n_action_bins: int = 256
    state_clip: float = 4.0
    action_clip: float = 4.0

    @property
    def action_base(self) -> int:
        return self.vocab_size - self.n_action_bins

    @property
    def state_base(self) -> int:
        return self.action_base - self.n_state_bins

    def encode_state(self, x: np.ndarray) -> np.ndarray:
        z = np.clip(x / self.state_clip, -1.0, 1.0)
        bins = ((z + 1.0) / 2.0 * (self.n_state_bins - 1)).astype(np.int64)
        return self.state_base + bins

    def encode_action(self, a: np.ndarray) -> np.ndarray:
        z = np.clip(a / self.action_clip, -1.0, 1.0)
        bins = ((z + 1.0) / 2.0 * (self.n_action_bins - 1)).astype(np.int64)
        return self.action_base + bins

    def decode_action(self, tok: np.ndarray) -> np.ndarray:
        bins = np.clip(tok - self.action_base, 0, self.n_action_bins - 1)
        z = bins.astype(np.float32) / (self.n_action_bins - 1) * 2.0 - 1.0
        return z * self.action_clip

    def episode_tokens(self, ep: Episode, stride: int = 8) -> np.ndarray:
        """[T/stride, N+N+A] tokens: (qd bins, tau bins, action bins)."""

        qd = self.encode_state(ep.qd[::stride])
        tau = self.encode_state(ep.tau[::stride])
        act = self.encode_action(ep.ref_actions[::stride])
        return np.concatenate([qd, tau, act], axis=1)


def episode_dataset(
    tokenizer: EpisodeTokenizer,
    tasks: Sequence[str] = ("pick_place", "drawer_open", "peg_insertion"),
    seeds: Sequence[int] = tuple(range(8)),
    stride: int = 8,
) -> np.ndarray:
    """Token matrix [num_episodes, L, tokens_per_step] (episodes cut to the
    shortest)."""

    rows: List[np.ndarray] = []
    for task in tasks:
        for seed in seeds:
            rows.append(tokenizer.episode_tokens(generate_episode(task, seed=seed), stride))
    min_len = min(r.shape[0] for r in rows)
    return np.stack([r[:min_len] for r in rows])


class TokenBatchIterator:
    """Yields next-token-prediction batches from flattened episode tokens:
    ``tokens`` / ``labels`` [B, seq_len] (labels shifted by one) and, given
    ``action_base``, a ``loss_mask`` over the action-token labels."""

    def __init__(self, data: np.ndarray, batch_size: int, seq_len: int, seed: int = 0,
                 action_base: Optional[int] = None):
        e, l, w = data.shape
        self.flat = data.reshape(e, l * w)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.action_base = action_base

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        e, flat_len = self.flat.shape
        while True:
            rows = self.rng.integers(0, e, self.batch_size)
            starts = self.rng.integers(0, flat_len - self.seq_len - 1, self.batch_size)
            toks = np.stack([self.flat[r, s : s + self.seq_len + 1] for r, s in zip(rows, starts)])
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if self.action_base is not None:
                batch["loss_mask"] = (toks[:, 1:] >= self.action_base).astype(np.float32)
            yield batch


def synthetic_lm_batches(vocab_size: int, batch_size: int, seq_len: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-chain token stream for generic LM smoke training: each token
    follows a fixed random successor of the last with probability 0.8."""

    rng = np.random.default_rng(seed)
    next_tok = rng.integers(0, vocab_size, vocab_size)
    while True:
        toks = [rng.integers(0, vocab_size, (batch_size, 1))]
        for _ in range(seq_len):
            prev = toks[-1]
            toks.append(np.where(rng.random((batch_size, 1)) < 0.8, next_tok[prev],
                                 rng.integers(0, vocab_size, (batch_size, 1))))
        seq = np.concatenate(toks, axis=1)
        yield {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
