"""The port's channel model (``repro_torch.runtime.channel``) against the JAX
package's ``repro.runtime.channel``.

The jitter draws are threefry-2x32 in numpy: the keys and the 32 random
bits of every (robot, ordinal) pair must equal ``jax.random.fold_in`` /
``jax.random.bits`` exactly, over robots 0..255 x ordinals 0..63 and three
seeds.  The exponential draw is ``-log1p(-u)`` in float32 on both sides,
where numpy's and XLA's ``log1p`` may differ in the last bit, so the
sampled latencies are held to rtol 1e-6.  The deterministic latencies are
plain arithmetic and must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime import channel as jch  # noqa: E402
from repro_torch.runtime import channel as tch  # noqa: E402

ROBOTS = np.arange(256)
ORDINALS = np.arange(64)


@pytest.fixture(scope="module")
def jax_keys():
    """seed -> (the reference's keys [R, O, 2], its 32-bit draws [R, O])."""

    fold = jax.jit(jax.vmap(jax.vmap(
        lambda k, r, o: jax.random.fold_in(jax.random.fold_in(k, r), o),
        in_axes=(None, None, 0)), in_axes=(None, 0, None)))
    bits = jax.jit(jax.vmap(jax.vmap(jax.random.bits)))
    out = {}
    for seed in (0, 1, 7919):
        keys = fold(jax.random.PRNGKey(seed), jnp.asarray(ROBOTS, jnp.int32),
                    jnp.asarray(ORDINALS, jnp.int32))
        out[seed] = (np.asarray(keys), np.asarray(bits(keys)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7919])
def test_prng_key_and_fold_in_match_jax(seed, jax_keys):
    np.testing.assert_array_equal(tch.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))
    keys = tch.fold_in(tch.fold_in(tch.PRNGKey(seed), ROBOTS)[:, None], ORDINALS[None, :])
    assert keys.dtype == np.uint32 and keys.shape == (256, 64, 2)
    np.testing.assert_array_equal(keys, jax_keys[seed][0])


@pytest.mark.parametrize("seed", [0, 1, 7919])
def test_random_bits_match_jax_bits(seed, jax_keys):
    keys, want = jax_keys[seed]
    got = tch.random_bits(keys)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_threefry_known_answer():
    """The Random123 known-answer vectors of threefry-2x32 (20 rounds), as
    JAX's own tests pin them."""

    y = tch.threefry2x32(0, 0, 0, 0)
    assert (int(y[0]), int(y[1])) == (0x6B200159, 0x99BA4EFE)
    y = tch.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    assert (int(y[0]), int(y[1])) == (0x1CB996FC, 0xBB002BE7)
    y = tch.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (int(y[0]), int(y[1])) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", [3 + 7919, 7919])
def test_sample_latency_ms_matches_reference(seed):
    cfg = jch.ChannelConfig()
    jkey, tkey = jax.random.PRNGKey(seed), tch.PRNGKey(seed)
    for r, o in [(0, 0), (5, 2), (0, 1), (1023, 7), (255, 63)]:
        want = jch.sample_latency_ms(cfg, 8, jax.random.fold_in(jax.random.fold_in(jkey, r), o))
        got = tch.sample_latency_ms(tch.ChannelConfig(), 8,
                                    tch.fold_in(tch.fold_in(tkey, r), o))
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("seed", [0, 3 + 7919])
def test_sample_latency_ms_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    robots = rng.integers(0, 1024, 200)
    ords = rng.integers(0, 64, 200)
    want = jch.sample_latency_ms_batch(jch.ChannelConfig(), 8, jax.random.PRNGKey(seed),
                                       robots, ords)
    got = tch.sample_latency_ms_batch(tch.ChannelConfig(), 8, tch.PRNGKey(seed), robots, ords)
    assert isinstance(got, list) and len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # element i is the serial draw under its own key, bit for bit
    key = tch.PRNGKey(seed)
    assert got[:5] == [tch.sample_latency_ms(tch.ChannelConfig(), 8,
                                             tch.fold_in(tch.fold_in(key, r), o))
                       for r, o in zip(robots[:5], ords[:5])]
    assert tch.sample_latency_ms_batch(tch.ChannelConfig(), 8, key, [], []) == []


def test_jitter_long_run_mean():
    """Non-negative jitter whose mean is ``jitter_ms`` (the reference's own
    sampling test, on the port's draws)."""

    cfg = tch.ChannelConfig()
    base = tch.query_latency_ms(cfg, 8)
    lats = np.asarray(tch.sample_latency_ms_batch(cfg, 8, tch.PRNGKey(0), np.zeros(400, int),
                                                  np.arange(400)))
    assert (lats >= base).all() and lats.std() > 0.0
    assert abs(lats.mean() - (base + cfg.jitter_ms)) < 0.35 * cfg.jitter_ms


@pytest.mark.parametrize("kw", [{}, dict(rtt_ms=30.0, uplink_mbps=20.0, jitter_ms=4.0)])
def test_deterministic_latencies_equal(kw):
    jc, tc = jch.ChannelConfig(**kw), tch.ChannelConfig(**kw)
    for k in (1, 4, 8, 16):
        assert tch.query_latency_ms(tc, k) == jch.query_latency_ms(jc, k)
        assert tch.bandwidth_bytes_per_episode(tc, 13, k) == \
            jch.bandwidth_bytes_per_episode(jc, 13, k)
    assert tch.ship_ms(80_000, 200.0) == jch.ship_ms(80_000, 200.0)
    assert tch.roundtrip_ms(tc, 8192.0, 4096.0) == jch.roundtrip_ms(jc, 8192.0, 4096.0)
