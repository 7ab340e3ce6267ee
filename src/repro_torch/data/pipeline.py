"""VLA episode tokenization (own copy of ``EpisodeTokenizer`` from
``repro/data/pipeline.py``; numpy only).

Per control step: [N state tokens][A action tokens].  Action bins occupy the
TOP ``n_action_bins`` ids of the vocab (OpenVLA convention), state bins the
ids just below them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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

    def decode_action(self, tok: np.ndarray) -> np.ndarray:
        bins = np.clip(tok - self.action_base, 0, self.n_action_bins - 1)
        z = bins.astype(np.float32) / (self.n_action_bins - 1) * 2.0 - 1.0
        return z * self.action_clip
