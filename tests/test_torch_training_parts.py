"""PyTorch port, the training machinery against the JAX package on the same
numpy inputs: every loss (with and without a mask and class weights), every
updater over three steps, every learning-rate policy, every gradient
normalization mode, and the layers' l1/l2 penalty.

Tolerance 1e-6 relative (atol 1e-7): float32 on both sides (inputs are fed
to JAX as explicit f32, since the suite enables x64), elementwise math and
short sums in the same order, transcendental functions from two libraries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import gradnorm as jax_gradnorm
from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.nn import schedules as jax_schedules
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu_torch.nn import gradnorm, losses, schedules, updaters
from deeplearning4j_tpu_torch.nn.conf import GradientNormalization
from deeplearning4j_tpu_torch.nn.layers import DenseLayer

RTOL, ATOL = 1e-6, 1e-7


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
_ACT = {"mcxent": "softmax", "negativeloglikelihood": "softmax",
        "kl_divergence": "softmax", "xent": "sigmoid",
        "reconstruction_crossentropy": "sigmoid", "poisson": "sigmoid",
        "msle": "sigmoid"}
_LOSS_CASES = [(name, _ACT.get(name, "identity"))
               for name in sorted(jax_losses.LOSSES)]
# the non-fused branches of the two fused losses
_LOSS_CASES += [("mcxent", "sigmoid"), ("xent", "softmax"),
                ("mcxent", None), ("xent", None)]


def _loss_inputs(shape, seed):
    r = np.random.default_rng(seed)
    logits = r.normal(size=shape).astype(np.float32)
    e = np.exp(r.normal(size=shape))
    labels = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    weights = r.uniform(0.5, 2.0, size=shape[-1]).tolist()
    mask = (r.uniform(size=shape[:-1]) > 0.3).astype(np.float32)
    return labels, logits, weights, mask


@pytest.mark.parametrize("variant", ["plain", "mask", "weights"])
@pytest.mark.parametrize("shape", [(4, 5), (3, 6, 5)])
@pytest.mark.parametrize("name,act", _LOSS_CASES)
def test_loss_matches_jax(name, act, shape, variant):
    labels, logits, weights, mask = _loss_inputs(shape, seed=len(name))
    kw = {}
    if variant == "mask":
        kw["mask"] = mask
    if variant == "weights":
        kw["weights"] = weights
    want = jax_losses.get(name).score(
        jnp.asarray(labels), jnp.asarray(logits), activation=act,
        **{k: (jnp.asarray(v) if k == "mask" else v) for k, v in kw.items()})
    got = losses.get(name).score(
        torch.from_numpy(labels), torch.from_numpy(logits), activation=act,
        **{k: (torch.from_numpy(v) if k == "mask" else v)
           for k, v in kw.items()})
    assert got.dtype == torch.float32
    _close(got, want, rtol=2e-6, msg=f"{name}/{act}/{variant}")


def test_unknown_loss_raises_named_error():
    with pytest.raises(ValueError, match="Unknown loss 'hingey'"):
        losses.get("hingey")


# ---------------------------------------------------------------------------
# updaters
# ---------------------------------------------------------------------------
_UPDATERS = [
    ("Sgd", dict(learning_rate=0.1)), ("NoOp", {}),
    ("Adam", dict(learning_rate=2e-3)),
    ("Adam", dict(learning_rate=2e-3, state_dtype="bfloat16")),
    ("AdaMax", dict(learning_rate=1e-2)), ("AdaGrad", dict(learning_rate=0.1)),
    ("AdaDelta", dict(rho=0.9)), ("RmsProp", dict(learning_rate=0.05)),
    ("Nesterovs", dict(learning_rate=0.1, momentum=0.9))]


def _tree_close(got, want, msg):
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _tree_close(got[k], want[k], f"{msg}/{k}")
    else:
        _close(got, np.asarray(want, dtype=np.float32), rtol=2e-6,
               atol=1e-7, msg=msg)


@pytest.mark.parametrize("lr", [None, 0.05])
@pytest.mark.parametrize("cls,kw", _UPDATERS,
                         ids=[f"{c}{'-bf16' if k.get('state_dtype') else ''}"
                              for c, k in _UPDATERS])
def test_updater_three_steps_match_jax(cls, kw, lr):
    r = np.random.default_rng(7)
    params = {"W": r.normal(size=(4, 3)).astype(np.float32),
              "b": r.normal(size=(3,)).astype(np.float32)}
    ju = getattr(jax_updaters, cls)(**kw)
    pu = getattr(updaters, cls)(**kw)
    jstate = ju.init({k: jnp.asarray(v) for k, v in params.items()})
    pstate = pu.init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(3):
        g = {k: r.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        jupd, jstate = ju.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jnp.asarray(step, jnp.int32), lr)
        pupd, pstate = pu.update({k: torch.from_numpy(v)
                                  for k, v in g.items()}, pstate, step, lr)
        _tree_close(pupd, jupd, f"{cls} step {step} update")
        _tree_close(pstate, dict(jstate) if jstate != () else {},
                    f"{cls} step {step} state")
    if kw.get("state_dtype"):
        assert pstate["m"]["W"].dtype == torch.bfloat16
        assert pstate["v"]["W"].dtype == torch.float32


def test_updater_json_round_trip_and_unknown_name():
    a = updaters.Adam(1e-3, state_dtype="bfloat16")
    assert updaters.from_dict(a.to_dict()) == a
    assert a.to_dict() == jax_updaters.Adam(1e-3, state_dtype="bfloat16") \
        .to_dict()
    with pytest.raises(ValueError, match="Unknown updater"):
        updaters.get("adamw")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
_POLICIES = [
    ("none", {}), ("exponential", dict(decay_rate=0.9)),
    ("inverse", dict(decay_rate=0.1, power=0.75)),
    ("poly", dict(power=2.0, max_iter=7)),
    ("sigmoid", dict(decay_rate=0.5, steps=3)),
    ("step", dict(decay_rate=0.5, steps=2)),
    ("torchstep", dict(decay_rate=0.3, steps=3)),
    ("schedule", dict(schedule={2: 0.05, 5: 0.01})), ("score", {})]


@pytest.mark.parametrize("policy,kw", _POLICIES, ids=[p for p, _ in _POLICIES])
def test_schedule_matches_jax(policy, kw):
    js = jax_schedules.make_schedule(0.1, policy, **kw)
    ps = schedules.make_schedule(0.1, policy, **kw)
    for step in range(9):
        got = ps(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, js(step), msg=f"{policy} step {step}")
    assert schedules.Schedule.from_dict(ps.to_dict()) == ps


def test_unknown_schedule_policy_raises():
    with pytest.raises(ValueError, match="Unknown learning rate policy"):
        schedules.make_schedule(0.1, "cosine")(0)


# ---------------------------------------------------------------------------
# gradient normalization and regularization
# ---------------------------------------------------------------------------
_GN_MODES = [GradientNormalization.NONE,
             GradientNormalization.RENORMALIZE_L2_PER_LAYER,
             GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE,
             GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE,
             GradientNormalization.CLIP_L2_PER_LAYER,
             GradientNormalization.CLIP_L2_PER_PARAM_TYPE]


@pytest.mark.parametrize("threshold", [0.3, 50.0])
@pytest.mark.parametrize("mode", _GN_MODES)
def test_gradient_normalization_matches_jax(mode, threshold):
    r = np.random.default_rng(3)
    g = {"W": r.normal(size=(5, 4)).astype(np.float32),
         "b": r.normal(size=(4,)).astype(np.float32)}
    want = jax_gradnorm.apply_gradient_normalization(
        mode, threshold, {k: jnp.asarray(v) for k, v in g.items()})
    got = gradnorm.apply_gradient_normalization(
        mode, threshold, {k: torch.from_numpy(v) for k, v in g.items()})
    _tree_close(got, want, mode)


def test_unknown_gradient_normalization_raises():
    with pytest.raises(ValueError, match="Unknown gradient normalization"):
        gradnorm.apply_gradient_normalization("clip_maybe", 1.0,
                                              {"W": torch.ones(2)})


@pytest.mark.parametrize("reg", [dict(l1=0.01), dict(l2=0.02),
                                 dict(l1=0.01, l2=0.02, l1_bias=0.003,
                                      l2_bias=0.004), {}])
def test_reg_score_matches_jax(reg):
    r = np.random.default_rng(4)
    p = {"W": r.normal(size=(6, 3)).astype(np.float32),
         "b": r.normal(size=(3,)).astype(np.float32)}
    want = JaxDense(n_out=3, **reg).reg_score(
        {k: jnp.asarray(v) for k, v in p.items()})
    got = DenseLayer(n_out=3, **reg).reg_score(
        {k: torch.from_numpy(v) for k, v in p.items()})
    _close(got, want, msg=str(reg))
