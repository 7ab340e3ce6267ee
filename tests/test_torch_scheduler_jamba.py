"""The port's continuous-batching scheduler against the JAX package's on
the f32 jamba-smoke stack (Mamba + attention layers, MLP + MoE FFNs).

The twins of ``test_torch_scheduler.py`` that move Mamba state: the
admission merge writes each admitted row's ``h`` / ``conv`` state, the
rows' state doubles with the rows, and dead rows keep decoding until their
boundary.  Same rules: equal logs, results, counters, and tokens under the
greedy-margin rule.
"""

import pytest

pytest.importorskip("torch")

from test_torch_scheduler import (  # noqa: E402
    PAGES,
    R14,
    beyond_rows,
    cancel_mid_flight,
    make_stacks,
    run_twin,
    staggered,
)


@pytest.fixture(scope="module")
def st():
    return make_stacks("jamba-1.5-large-398b")


@pytest.mark.parametrize("rounds", R14)
def test_staggered_matches_reference(st, rounds):
    _, ts, res = run_twin(st, staggered, max_slots=4, scan_rounds=rounds)
    assert ts.peak_active > 1 and len(res) == 6
    assert "h" in ts._pcache and ts._pcache["h"].shape[1] == ts.rows


@pytest.mark.parametrize("rounds", R14)
def test_admits_beyond_initial_rows(st, rounds):
    _, ts, res = run_twin(st, beyond_rows, seed=8, max_slots=2, num_pages=5 * PAGES,
                          scan_rounds=rounds)
    assert ts.rows == 8 and ts._pcache["conv"].shape[1] == 8 and len(res) == 5


@pytest.mark.parametrize("rounds", R14)
def test_cancel_mid_flight(st, rounds):
    _, ts, res = run_twin(st, cancel_mid_flight, seed=31, max_slots=4, scan_rounds=rounds)
    assert [r.robot_id for r in res] == [1]
