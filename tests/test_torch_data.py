"""The port's data pipeline against the JAX package's, bit for bit.

Both are numpy over the same episode generator and draw from
``np.random.default_rng(seed)`` in the same order, so every array must be
equal: ``encode_action`` / ``decode_action`` (a round trip to within a
bin), ``episode_tokens``, ``episode_dataset``, ``TokenBatchIterator``
(tokens, labels, loss mask) and ``synthetic_lm_batches``.
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.robotics.episodes import generate_episode as ref_episode  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.robotics.episodes import generate_episode  # noqa: E402

VOCAB = 32000


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_action_round_trip_within_a_bin():
    tok = pipe.EpisodeTokenizer(VOCAB)
    a = np.random.default_rng(0).uniform(-5.0, 5.0, (64, 7)).astype(np.float32)
    ids = tok.encode_action(a)
    assert ids.min() >= tok.action_base and ids.max() < VOCAB
    _equal(ids, ref_pipe.EpisodeTokenizer(VOCAB).encode_action(a))
    back = tok.decode_action(ids)
    bin_w = 2 * tok.action_clip / (tok.n_action_bins - 1)
    assert np.abs(back - np.clip(a, -tok.action_clip, tok.action_clip)).max() <= bin_w
    _equal(back, ref_pipe.EpisodeTokenizer(VOCAB).decode_action(ids))


@pytest.mark.parametrize("task,seed,stride", [("pick_place", 0, 8), ("peg_insertion", 3, 4)])
def test_episode_tokens_equal_the_reference(task, seed, stride):
    ours = pipe.EpisodeTokenizer(VOCAB).episode_tokens(generate_episode(task, seed=seed), stride)
    theirs = ref_pipe.EpisodeTokenizer(VOCAB).episode_tokens(ref_episode(task, seed=seed),
                                                             stride)
    _equal(ours, theirs)


def test_episode_dataset_and_batches_equal_the_reference():
    tok, rtok = pipe.EpisodeTokenizer(VOCAB), ref_pipe.EpisodeTokenizer(VOCAB)
    kw = dict(tasks=("pick_place", "drawer_open"), seeds=(0, 1, 2))
    data, rdata = pipe.episode_dataset(tok, **kw), ref_pipe.episode_dataset(rtok, **kw)
    _equal(data, rdata)
    it = pipe.TokenBatchIterator(data, 3, 64, seed=5, action_base=tok.action_base)
    rit = ref_pipe.TokenBatchIterator(rdata, 3, 64, seed=5, action_base=rtok.action_base)
    for ours, theirs in itertools.islice(zip(it, rit), 4):
        assert set(ours) == set(theirs) == {"tokens", "labels", "loss_mask"}
        for k in ours:
            _equal(ours[k], theirs[k])
        assert 0 < ours["loss_mask"].mean() < 1
    # without an action base: no mask
    assert set(next(iter(pipe.TokenBatchIterator(data, 2, 16)))) == {"tokens", "labels"}


def test_synthetic_lm_batches_equal_the_reference():
    ours = pipe.synthetic_lm_batches(512, 4, 33, seed=7)
    theirs = ref_pipe.synthetic_lm_batches(512, 4, 33, seed=7)
    for a, b in itertools.islice(zip(ours, theirs), 3):
        for k in ("tokens", "labels"):
            _equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
