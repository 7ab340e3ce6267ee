"""The port's AdamW and schedules against the JAX package's.

``adamw_update`` over 5 steps on the same numpy parameters and gradients,
with float32 and bfloat16 moments (float32 and bf16 parameters), clipping
active and inactive; ``linear_warmup_cosine`` and ``cosine_schedule`` at
steps 0, 1, 19, 20, 21 and the last.  Tolerance: parameters, moments and
the gradient norm to ``rtol 1e-6`` plus 1e-6 of the tensor's largest
|value| in float32 (the same operations in the same order, but the norm is
summed in another order, so the clip factor may differ by an ulp, and a
moment that cancels towards 0 keeps that ulp of its inputs' size; the
reference takes the schedule's factor in float32, the port in float64, an
ulp of the learning rate); bf16 results equal but for one bf16 step (2^-8
relative, plus 2^-8 of the largest |value| where a value cancels towards
0) where an intermediate rounds the other way.  The schedules to 1e-6
(float32 against float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim import linear_warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    linear_warmup_cosine,
)

SHAPES = {"w": (17, 9), "b": (9,), "emb": (33, 4)}
STEPS = 5


def _draw(rng, scale):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("moments,param_dtype", [("float32", "float32"),
                                                 ("bfloat16", "float32"),
                                                 ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("clipped", [True, False])
def test_adamw_matches_the_reference_over_five_steps(moments, param_dtype, clipped):
    rng = np.random.default_rng(0)
    p0 = _draw(rng, 1.0)
    # clipping on: gradients of norm ~40 against a clip of 1; off: clip 0
    grads = [_draw(rng, 5.0 if clipped else 0.01) for _ in range(STEPS)]
    kw = dict(lr=1e-2, moment_dtype=moments, grad_clip=1.0 if clipped else 0.0)
    jd, td = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    jp = {n: jnp.asarray(x, jd) for n, x in p0.items()}
    tp = {n: torch.as_tensor(x).to(td) for n, x in p0.items()}
    jcfg, tcfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jstate, tstate = jax_adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    update = jax.jit(lambda g, s, p, sc: jax_adamw_update(g, s, p, jcfg, sc))
    for i, g in enumerate(grads):
        scale = jax_warmup_cosine(jstate.step, 2, STEPS)
        jp, jstate, jm = update({n: jnp.asarray(x, jd) for n, x in g.items()}, jstate, jp,
                                scale)
        tstate, tm = adamw_update({n: torch.as_tensor(x).to(td) for n, x in g.items()}, tstate,
                                  tp, tcfg, linear_warmup_cosine(tstate.step, 2, STEPS))
        assert tstate.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for name in SHAPES:
            for got, want in ((tp[name], jp[name]), (tstate.m[name], jstate.m[name]),
                              (tstate.v[name], jstate.v[name])):
                assert str(got.dtype)[6:] == str(want.dtype)
                got = got.float().numpy()
                want = np.asarray(want.astype(jnp.float32))
                exact = moments == "float32" and param_dtype == "float32"
                rel = 1e-6 if exact else 2.0**-8
                np.testing.assert_allclose(got, want, rtol=rel,
                                           atol=rel * float(np.abs(want).max()))
    # the first step's factor is 0: lr 0 at step 0 of the warm-up
    assert linear_warmup_cosine(0, 2, STEPS) == 0.0


def test_first_step_with_scale_zero_only_moves_the_moments():
    tp = {n: torch.as_tensor(x) for n, x in _draw(np.random.default_rng(1), 1.0).items()}
    before = {n: p.clone() for n, p in tp.items()}
    cfg = AdamWConfig()
    state, _ = adamw_update({n: torch.ones_like(p) for n, p in tp.items()}, adamw_init(tp, cfg),
                            tp, cfg, lr_scale=0.0)
    for n in tp:
        assert torch.equal(tp[n], before[n])
        assert float(state.m[n].abs().sum()) > 0


@pytest.mark.parametrize("step", [0, 1, 19, 20, 21, 100])
def test_schedules_match_the_reference(step):
    total, warmup = 100, 20
    np.testing.assert_allclose(linear_warmup_cosine(step, warmup, total),
                               float(jax_warmup_cosine(jnp.int32(step), warmup, total)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cosine_schedule(step, total),
                               float(jax_cosine(jnp.int32(step), total)), rtol=1e-6, atol=1e-7)
