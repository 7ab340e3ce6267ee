"""Visual-noise models for the environment-oriented baseline (paper §III-A);
own copy of ``repro/robotics/noise.py``.

The vision-based strategy triggers on the Shannon entropy of the edge VLA's
action distribution.  We model the entropy stream as a function of the true
scene state plus *visual* disturbance terms — disturbances that, crucially,
never touch the proprioceptive streams RAPID consumes (the paper's central
compatibility argument, Fig. 2 / Table I).

Noise regimes match §VI-A.2: standard / visual_noise / distraction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.robotics.episodes import Episode

REGIMES = ("standard", "visual_noise", "distraction")


@dataclass(frozen=True)
class EntropyModel:
    base_entropy: float = 1.2        # nats, confident policy in clean scenes
    critical_bump: float = 1.2       # true uncertainty rise at interactions
    noise_bump: float = 2.0          # visual-noise induced false uncertainty
    distract_bump: float = 2.8       # moving distractors / occlusions
    noise_rate: float = 0.30         # fraction of steps hit by visual noise
    distract_rate: float = 0.60
    sigma: float = 0.08


def entropy_stream(ep: Episode, regime: str, seed: int = 0, model: EntropyModel = EntropyModel()) -> np.ndarray:
    """Per-step action-distribution entropy for the vision-based trigger."""

    assert regime in REGIMES, regime
    rng = np.random.default_rng(seed + 7)
    t_len = ep.critical.shape[0]
    h = model.base_entropy + model.critical_bump * ep.critical.astype(np.float32)
    if regime == "visual_noise":
        hits = rng.random(t_len) < model.noise_rate
        h = h + model.noise_bump * hits * rng.random(t_len)
    elif regime == "distraction":
        hits = rng.random(t_len) < model.distract_rate
        h = h + model.distract_bump * hits * rng.random(t_len)
    return (h + rng.normal(0, model.sigma, t_len)).astype(np.float32)


def kinematic_streams_under_noise(ep: Episode, regime: str) -> Episode:
    """Proprioception is immune to visual disturbance — identity by design.

    Exists (and is property-tested) to make the compatibility claim explicit:
    the RAPID trigger's inputs are bit-identical across noise regimes.
    """

    return ep
