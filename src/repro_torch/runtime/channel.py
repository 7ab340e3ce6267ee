"""Edge-cloud network channel model (own copy of ``repro/runtime/channel.py``).

Latency of a cloud query = uplink (observation payload) + downlink (action
chunk) + fixed RTT.  Payloads follow the OpenVLA serving setup: one RGB
observation (JPEG ~ 80 KB) + instruction tokens up; a k-step action chunk
(k x 7 float32) down.

The jitter of an offload is an exponential excess drawn from a threefry-2x32
key per (robot, ordinal) pair.  The keys and draws are the JAX package's own,
reproduced bit for bit in numpy (``PRNGKey``, ``fold_in``, ``random_bits``,
``exponential``), so the port's latency streams are the reference's; the
layout is that of ``jax_threefry_partitionable`` (JAX's default since 0.5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ChannelConfig:
    rtt_ms: float = 8.0
    uplink_mbps: float = 200.0     # edge -> cloud
    downlink_mbps: float = 400.0
    obs_bytes: int = 80_000        # compressed 224x224 RGB + tokens
    per_action_bytes: int = 28     # 7 x float32
    jitter_ms: float = 1.5


def ship_ms(nbytes: float, mbps: float) -> float:
    """Serialization time of ``nbytes`` over an ``mbps`` link."""

    return nbytes * 8.0 / (mbps * 1e6) * 1e3


def query_latency_ms(cfg: ChannelConfig, chunk_len: int) -> float:
    """Deterministic mean latency of one offload round-trip."""

    up = ship_ms(cfg.obs_bytes, cfg.uplink_mbps)
    down = ship_ms(chunk_len * cfg.per_action_bytes, cfg.downlink_mbps)
    return cfg.rtt_ms + up + down


def roundtrip_ms(cfg: ChannelConfig, up_bytes: float, down_bytes: float) -> float:
    """One asymmetric-payload round-trip: RTT + up-leg + down-leg serialization."""

    return (
        cfg.rtt_ms
        + ship_ms(up_bytes, cfg.uplink_mbps)
        + ship_ms(down_bytes, cfg.downlink_mbps)
    )


# ---------------------------------------------------------------------------
# threefry-2x32 (Salmon et al. 2011, 20 rounds), vectorised over numpy uint32
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``; all uint32 arrays broadcast together -> (y1, y2)."""

    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, np.uint32) for a in (k1, k2, x1, x2)))
    shape = k1.shape
    # 1-d arrays wrap around silently (numpy scalars would warn)
    k1, k2, x1, x2 = (a.reshape(-1) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""

    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``.
    ``key`` [..., 2] and ``data`` [...] broadcast -> keys [..., 2]."""

    key = np.asarray(key, np.uint32)
    data = np.asarray(data).astype(np.uint32)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack([y1, y2], axis=-1)


def random_bits(key: np.ndarray) -> np.ndarray:
    """``jax.random.bits(key)`` of shape ``()`` per key, 32 bits: the
    partitionable layout hashes the 64-bit counter 0 and xors the words."""

    key = np.asarray(key, np.uint32)
    zero = np.zeros(key.shape[:-1], np.uint32)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    return y1 ^ y2


def exponential(key: np.ndarray) -> np.ndarray:
    """``jax.random.exponential(key)`` per key, float32: ``-log1p(-u)`` with
    ``u`` in [0, 1) from the top 23 bits as a float32 mantissa."""

    bits = random_bits(key)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return -np.log1p(-u)


def sample_latency_ms(cfg: ChannelConfig, chunk_len: int, key) -> float:
    """One stochastic offload round-trip: mean plus exponential jitter.

    ``jitter_ms`` is the MEAN of a one-sided exponential excess (queueing
    delay is non-negative and heavy-tailed), so repeated samples average to
    ``query_latency_ms + jitter_ms``.  ``key`` is a threefry key
    (``PRNGKey``); fold in a counter per offload for independent draws.
    """

    base = query_latency_ms(cfg, chunk_len)
    return base + float(exponential(key)) * cfg.jitter_ms


def sample_latency_ms_batch(cfg: ChannelConfig, chunk_len: int, key, robot_ids, ordinals):
    """Batched ``sample_latency_ms``: one draw per (robot, ordinal) pair,
    element ``i`` keyed ``fold_in(fold_in(key, robot_ids[i]), ordinals[i])``
    as the serial path keys it.  One vectorised call per harvest.  Returns
    a list of floats."""

    if len(robot_ids) == 0:
        return []
    base = query_latency_ms(cfg, chunk_len)
    keys = fold_in(fold_in(key, np.asarray(robot_ids)), np.asarray(ordinals))
    return [base + float(e) * cfg.jitter_ms for e in exponential(keys)]


def bandwidth_bytes_per_episode(cfg: ChannelConfig, n_offloads: int, chunk_len: int) -> int:
    return n_offloads * (cfg.obs_bytes + chunk_len * cfg.per_action_bytes)
