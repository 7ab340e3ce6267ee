"""The port's training path against the JAX package, on the CPU.

``Model.loss_fn`` and every gradient against ``jax.value_and_grad(
model.loss_fn, has_aux=True)`` for all 11 f32 smoke stacks (weights from
the reference's ``Model.init``, bridged; batches built as
``tests/test_models.py`` builds them, from a numpy seed; the gradients
compared through ``bridge.reference_tensors``), a 600-position text whose
cross entropy drops the tail past 512, three ``make_train_step`` steps port
against reference, and ``repro_torch.launch.train.main`` lowering the loss.

Tolerances: the loss to ``rtol 1e-5`` (float32, sums in another order);
each gradient leaf within 1e-4 of its own largest |value|; after a train
step each parameter within 1e-6 of its leaf's largest |value| (an ulp)
plus 1e-3 of the learning rate (AdamW's update is ~lr x sign(g) at first,
so a gradient element near 0 could round its way).  The embedding
table's gradient is a bf16 scatter-add in both packages (the reference
casts the table to bf16 before the lookup), summed in another order: the
rows of tokens that occur more than once may differ by a bf16 step of
their value, so that leaf is held to 2^-7 of its largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.npz import _flatten  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.checkpoint.bridge import load_reference_params, reference_tensors  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models.model import CE_CHUNK, Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a pytest-xdist worker

LOSS_RTOL, LEAF_TOL, EMBED_TOL = 1e-5, 1e-4, 2.0**-7


def _stacks(arch, **over):
    jcfg = jax_smoke(arch).replace(dtype="float32", param_dtype="float32", **over)
    jmodel = JaxModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = Model(get_smoke_config(arch).replace(dtype="float32", **over), device="cpu")
    load_reference_params(tmodel, _flatten(jparams))
    tmodel.requires_grad_(True)
    return jmodel, jparams, tmodel


def _batch(cfg, b=2, s=32, seed=0, loss_mask=False):
    """numpy batch laid out as ``tests/test_models.py``'s ``_batch_for``."""

    rng = np.random.default_rng(seed)
    vlm = cfg.modality != "text" and not cfg.encoder_decoder
    ntok = s - cfg.num_modality_tokens if vlm else s
    toks = rng.integers(0, cfg.vocab_size, (b, ntok))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if vlm:
        batch["frontend"] = (rng.standard_normal((b, cfg.num_modality_tokens, cfg.d_model))
                             * 0.02).astype(np.float32)
    if cfg.encoder_decoder:
        batch["frontend"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.02).astype(np.float32)
    if loss_mask:
        batch["loss_mask"] = (rng.random((b, ntok)) < 0.7).astype(np.float32)
    return batch


def _port_loss_and_grads(tmodel, batch):
    tmodel.zero_grad(set_to_none=True)
    loss, metrics = tmodel.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    grads = reference_tensors(tmodel, {n: p.grad for n, p in tmodel.named_parameters()})
    return loss, metrics, grads


def _check_grads(grads, jgrads):
    want = _flatten(jgrads)
    assert set(grads) == set(want)
    for key, w in want.items():
        got = grads[key].float().numpy()
        assert got.shape == w.shape, key
        scale = float(np.abs(w).max())
        tol = (EMBED_TOL if key == "embed/table" else LEAF_TOL) * max(scale, 1e-30)
        err = float(np.abs(got - w).max())
        assert err <= tol, f"{key}: grad max err {err:.3g} > {tol:.3g} (max|want| {scale:.3g})"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_the_reference(arch):
    jmodel, jparams, tmodel = _stacks(arch)
    batch = _batch(jmodel.cfg, loss_mask=arch == "openvla-7b")
    (jloss, jmet), jgrads = jax.jit(
        lambda p, b: jax.value_and_grad(jmodel.loss_fn, has_aux=True)(p, b)
    )(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    if jmodel.cfg.moe is not None:
        assert float(metrics["aux"]) > 0
    _check_grads(grads, jgrads)


def test_cross_entropy_drops_the_positions_past_the_last_chunk():
    """s = 600: one chunk of 512 counts; the last 88 positions do not."""

    jmodel, jparams, tmodel = _stacks("h2o-danube-3-4b", num_layers=1)
    batch = _batch(jmodel.cfg, b=1, s=600, seed=4)
    (jloss, _), jgrads = jax.jit(
        lambda p, b: jax.value_and_grad(jmodel.loss_fn, has_aux=True)(p, b)
    )(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = _port_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _check_grads(grads, jgrads)
    # the dropped tail: changing its labels changes nothing
    tail = dict(batch, labels=batch["labels"].copy())
    tail["labels"][:, CE_CHUNK:] = (tail["labels"][:, CE_CHUNK:] + 1) % jmodel.cfg.vocab_size
    with torch.no_grad():
        again, _ = tmodel.loss_fn({k: torch.as_tensor(v) for k, v in tail.items()})
    assert float(again) == float(loss)


def test_loss_fn_on_the_cpu_launches_no_kernel():
    _, _, tmodel = _stacks("openvla-7b")
    ops.reset_launch_counts()
    _port_loss_and_grads(tmodel, _batch(tmodel.cfg))
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_three_train_steps_match_the_reference():
    """``make_train_step`` three times on f32 openvla-smoke, port against
    reference: losses, gradient norms and parameters; the first update has
    learning rate 0 and leaves the weights as they were."""

    jmodel, jparams, tmodel = _stacks("openvla-7b")
    total = 3
    jcfg, tcfg = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstep = jax_make_train_step(jmodel, jcfg, total)
    tstep = make_train_step(tmodel, tcfg, total)
    jstate = jax_adamw_init(jparams, jcfg)
    params = dict(tmodel.named_parameters())
    tstate = adamw_init(params, tcfg)
    start = {k: v.clone() for k, v in reference_tensors(tmodel).items()}
    for i in range(total):
        batch = _batch(jmodel.cfg, seed=10 + i, loss_mask=True)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, tstate, tm = tstep(params, tstate,
                                   {k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        got = reference_tensors(tmodel)
        for key, want in _flatten(jparams).items():
            err = float(np.abs(got[key].numpy() - want).max())
            tol = 1e-6 * float(np.abs(want).max()) + 1e-3 * tcfg.lr
            assert err <= tol, f"step {i} {key}: max err {err:.3g} > {tol:.3g}"
        if i == 0:
            assert all(torch.equal(got[k], start[k]) for k in start)


def test_train_main_lowers_the_loss_on_the_cpu():
    """The driver end to end on the CPU (as ``tests/test_system.py`` runs the
    reference's): episodes -> tokenizer -> AdamW -> falling loss."""

    res = train_main(["--arch", "xlstm-125m", "--smoke", "--steps", "60", "--batch", "4",
                      "--seq", "128", "--data", "episodes", "--log-every", "1000",
                      "--device", "cpu"])
    assert res["final_loss"] < res["first_loss"]
    assert len(res["losses"]) == 60 and np.isfinite(res["losses"]).all()
    assert res["model"].device.type == "cpu"
