"""The PPO learner: the port against the JAX package on the CPU, float64
unless noted, parameters and Adam state carried by
convert.ppo_learner_from_numpy.

* ``gae`` and ``discounted_returns`` within 1e-12;
* ``ppo_loss`` and its gradients within 1e-10, feed-forward and LSTM
  encoders (``lstm_impl="xla"``: the canonical ``lstm_scan``);
* one ``update`` of 6 epochs: params, old params and Adam moments within
  1e-10 (optax.adam and torch.optim.Adam order their arithmetic
  differently, so the match is to a tolerance);
* float32: the LSTM encoder through ``lstm_window.lstm_last`` (the K1
  plain version forward, K3's plain version backward) within 1e-3 of
  ``jax.grad`` through the JAX package's Pallas encoder (interpret mode);
* the advantage standardisation uses the population std (ddof 0).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import ppo as jppo
from diral_tpu.config import load_config as jload
from diral_tpu_torch.agents import ppo as tppo
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.convert import ppo_learner_from_numpy
from diral_tpu_torch.models import actor_critic as ac

CONFIG = "configs/ppo_congested.yaml"
D, C, M, T = 25, 5, 48, 6


def _agent(cfg, use_lstm=True, impl="xla", hidden=32, **kw):
    net = dataclasses.replace(cfg.agent.network, use_lstm_input=use_lstm,
                              lstm_impl=impl, layers=(hidden, hidden))
    return dataclasses.replace(cfg.agent, network=net, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def learner_dict(lrn) -> dict:
    adam = lrn.opt_state[0]
    return {"params": _np(lrn.params), "old_params": _np(lrn.old_params),
            "mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


def jax_learner(acfg, dtype, seed=0, perturb=0.1):
    """A JAX learner whose old params differ from its params (so the ratio
    is not 1)."""
    lrn = jppo.init_learner(jax.random.PRNGKey(seed), D, C, acfg, dtype)
    leaves, tdef = jax.tree.flatten(lrn.old_params)
    rng = np.random.RandomState(seed)
    noisy = [p + perturb * jnp.asarray(rng.normal(size=p.shape), p.dtype)
             for p in leaves]
    return lrn.replace(old_params=jax.tree.unflatten(tdef, noisy))


def batch_np(use_lstm, dtype, seed=1):
    rng = np.random.RandomState(seed)
    shape = (M, T, D) if use_lstm else (M, D)
    return {"states": rng.normal(size=shape).astype(dtype),
            "actions": rng.randint(0, C, M).astype(np.int32),
            "advantages": rng.normal(size=M).astype(dtype) * 3 + 0.5,
            "returns": rng.normal(size=M).astype(dtype)}


def _flat(tree):
    return {f"{g}.{k}": np.asarray(v) for g, leaves in tree.items()
            for k, v in leaves.items()}


def test_gae_and_returns():
    rng = np.random.RandomState(0)
    r, v = rng.normal(size=(9, 12)), rng.normal(size=(9, 12))
    last = rng.normal(size=12)
    ja, jr = jppo.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(last),
                      0.9, 0.95)
    ta, tr = tppo.gae(torch.from_numpy(r), torch.from_numpy(v),
                      torch.from_numpy(last), 0.9, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)
    jd = jppo.discounted_returns(jnp.asarray(r), jnp.asarray(last), 0.9)
    td = tppo.discounted_returns(torch.from_numpy(r), torch.from_numpy(last),
                                 0.9)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-12)


@pytest.mark.parametrize("use_lstm", [False, True])
def test_loss_and_grads(use_lstm):
    jcfg, tcfg = (_agent(load(CONFIG), use_lstm) for load in (jload, tload))
    jl = jax_learner(jcfg, jnp.float64)
    b = batch_np(use_lstm, np.float64)
    (jloss, jaux), jg = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        jl.params, jl.old_params, {k: jnp.asarray(v) for k, v in b.items()},
        jcfg)
    tl = ppo_learner_from_numpy(learner_dict(jl))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tloss, taux = tppo.ppo_loss(tl.params, tl.old_params, tb, tcfg)
    tloss.backward()
    for got, want in zip((tloss, *taux), (jloss, *jaux)):
        np.testing.assert_allclose(got.item(), float(want), rtol=0,
                                   atol=1e-10)
    want = _flat(jg)
    for name, p in tl.params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=1e-10, err_msg=name)
    # the old policy is a constant of the loss
    assert all(p.grad is None for p in tl.old_params.parameters())


def test_update_six_epochs():
    jcfg, tcfg = (_agent(load(CONFIG), True, update_step=6)
                  for load in (jload, tload))
    assert jcfg.update_step == 6
    jl = jax_learner(jcfg, jnp.float64, seed=2)
    b = batch_np(True, np.float64, seed=3)
    jl2, jm = jax.jit(jppo.update, static_argnames=("cfg",))(
        jl, {k: jnp.asarray(v) for k, v in b.items()}, cfg=jcfg)
    tl = ppo_learner_from_numpy(learner_dict(jl))
    _, tm = tppo.update(tl, {k: torch.from_numpy(v) for k, v in b.items()},
                        tcfg)
    for k in ("loss", "actor_loss", "critic_loss", "entropy"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=0,
                                   atol=1e-10, err_msg=k)
    want = learner_dict(jl2)
    p_want, o_want = _flat(want["params"]), _flat(want["old_params"])
    mu, nu = _flat(want["mu"]), _flat(want["nu"])
    for name, p in tl.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), p_want[name], rtol=0,
                                   atol=1e-10, err_msg=name)
        st = tl.opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name], rtol=0,
                                   atol=1e-10, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name],
                                   rtol=0, atol=1e-10, err_msg=name)
        assert int(st["step"]) == want["count"] == 6
    # the snapshot is the params at the update's start
    for name, p in tl.old_params.named_parameters():
        np.testing.assert_array_equal(p.numpy(), o_want[name])
        np.testing.assert_array_equal(
            p.numpy(), _flat(learner_dict(jl)["params"])[name])


def test_lstm_encoder_through_the_kernel_path():
    """float32, H = 128: lstm_impl="pallas" routes the port's encoders to
    lstm_window.lstm_last (on the CPU its plain K1 forward and plain K3
    backward) and the JAX package's to pallas_lstm.lstm_last (interpret);
    loss and gradients within 1e-3 of the largest value."""
    jcfg, tcfg = (_agent(load(CONFIG), True, impl="pallas", hidden=128)
                  for load in (jload, tload))
    jl = jax_learner(jcfg, jnp.float32, seed=4, perturb=0.02)
    b = batch_np(True, np.float32, seed=5)
    (jloss, _), jg = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        jl.params, jl.old_params, {k: jnp.asarray(v) for k, v in b.items()},
        jcfg)
    tl = ppo_learner_from_numpy(learner_dict(jl))
    tloss, _ = tppo.ppo_loss(tl.params, tl.old_params,
                             {k: torch.from_numpy(v) for k, v in b.items()},
                             tcfg)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-3 * max(1.0, abs(float(jloss)))
    want = _flat(jg)
    for name, p in tl.params.named_parameters():
        scale = max(np.abs(want[name]).max(), 1e-6)
        gap = np.abs(p.grad.numpy() - want[name]).max()
        assert gap <= 1e-3 * scale, (name, gap, scale)
    assert np.abs(tl.params.actor_lstm.w.grad.numpy()).max() > 0


def test_advantage_std_is_population_std():
    """With M = 4 advantages the ddof-0 and ddof-1 standardisations differ
    by sqrt(4/3); the port's actor loss is the ddof-0 one."""
    tcfg = _agent(tload(CONFIG), False)
    jl = jax_learner(_agent(jload(CONFIG), False), jnp.float64, seed=6)
    tl = ppo_learner_from_numpy(learner_dict(jl))
    b = {k: torch.from_numpy(v[:4]) for k, v in
         batch_np(False, np.float64, seed=7).items()}
    _, (aloss, _, _) = tppo.ppo_loss(tl.params, tl.old_params, b, tcfg)
    with torch.no_grad():
        logp = torch.log_softmax(ac.ppo_policy_logits(tl.params, b["states"],
                                                      tcfg), -1)
        old = torch.log_softmax(ac.ppo_policy_logits(tl.old_params,
                                                     b["states"], tcfg), -1)
        a = b["actions"].long()[:, None]
        ratio = torch.exp(logp.gather(1, a)[:, 0] - old.gather(1, a)[:, 0])

    def want(ddof):
        adv = b["advantages"].numpy()
        adv = (adv - adv.mean()) / (adv.std(ddof=ddof) + 1e-8)
        r = ratio.numpy()
        return -np.mean(np.minimum(r * adv, np.clip(r, 0.8, 1.2) * adv))

    assert aloss.item() == pytest.approx(want(0), abs=1e-12)
    assert abs(want(0) - want(1)) > 1e-3
