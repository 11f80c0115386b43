"""PyTorch port, DreamerV3 (`ray_tpu_torch.rllib.algorithms.dreamerv3`)
against the JAX package, on the CPU, and the rllib port's coverage.

Nano sizes: 4-dim observations, 2 actions, ``deter_size`` 16, ``units``
16, 2 x 4 latents, B = 2 sequences of T = 4 steps (one episode start
mid-sequence), an imagination horizon of 3. The JAX learner is built
once per module and reset before each case; its numpy trees, its three
Adams' counts and moments (read out of optax's states) and its
return-normalization EMA cross into the port with `dreamerv3_from_jax`.

JAX samples every categorical as ``argmax(logits + gumbel(key))``. The
port takes each Gumbel draw through its noise seam by name, and the
tests install JAX's own draws, rebuilt from the keys JAX's ``train``
derives (``split(rng)[1]`` -> ``split(key, 3)`` -> ``split(k_wm, T)`` for
`_observe`, ``split(k_im, H)`` for `_imagine`, one key for the action
and the latent of a step). Each case first checks that the rebuilt draws
reproduce JAX's own sampled indices. Held to JAX on the same inputs:

- `SequenceReplay`'s samples, exactly, with and without a wrapped ring;
- `_observe` (h, the straight-through latents, both log-probs) and the
  GRU within 1e-6 + 1e-5 |JAX|;
- `_wm_loss` and its metrics within 1e-6 + 1e-5 |JAX|, its gradients
  within 1e-5 (|JAX| + max |JAX| of the leaf);
- `_imagine`'s features and actions, the lambda-returns (JAX's
  backwards ``lax.scan``) and the 5/95 percentiles (``jnp.percentile``,
  linear) within 1e-6 + 1e-5 |JAX|;
- one and two whole ``train`` calls: every metric within 1e-6 + 1e-4
  |JAX|, each weight (the slow critic too) within 0.01 x its lr per
  update, ``ret_lo`` / ``ret_hi`` within 1e-6 + 1e-5 |JAX|, Adam's
  counts;
- a JAX state after one ``train`` resuming in the port;
- one recurrent policy step (h, z, the actions).

Held to the port itself: a straight-through sample without the
stop-gradient on ``probs`` fails the gradient gate; checkpoints keep the
four weight trees; a ``step()`` keeps the recurrent state on the
learner's device. No learning loop runs here: chip_smoke's ``rllib-c``
phase trains DreamerV3 on the card.

The gpu case (the default device is the card) runs on the card, where
there is no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_dreamerv3.py -q
"""

import faulthandler
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:        # the card's machine has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib.algorithms import dreamerv3 as jdv
except ImportError:
    jax = None

from ray_tpu_torch import rllib as trllib
from ray_tpu_torch.rllib.algorithms import dreamerv3 as tdv
from ray_tpu_torch.rllib.core.rl_module import tree_leaves

B, T, H, OBS, ACT = 2, 4, 3, 4, 2
G, C = 2, 4
NANO = dict(deter_size=16, units=16, stoch_groups=G, stoch_classes=C,
            imagine_horizon=H)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(60, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x.detach() if torch.is_tensor(x) else x)
            for x in tree_leaves(tree)]


def _adam(opt_state):
    """optax's ScaleByAdamState as the port's ``{"count", "mu", "nu"}``."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return {"count": int(node.count), "mu": _np(node.mu),
                    "nu": _np(node.nu)}
    raise AssertionError("no Adam state")


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _grad_close(got, want, msg="grads"):
    """Within 1e-5 (|JAX| + max |JAX| of the leaf): an element sums the
    batch's terms, so its f32 rounding scales with the largest."""
    _close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
           msg=msg)


def _cfg():
    return jdv.DreamerV3Config().training(**NANO).to_dict()


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"obs": rng.randn(B, T, OBS).astype(np.float32),
            "actions": rng.randint(0, ACT, (B, T)).astype(np.int32),
            "rewards": rng.randn(B, T).astype(np.float32),
            "terminateds": (rng.rand(B, T) < 0.2).astype(np.float32),
            "is_first": np.array([[1, 0, 0, 1], [1, 0, 0, 0]], np.float32)}


def _jstate(jl):
    """Everything a JAX learner's next ``train`` reads."""
    return {"params": jl.get_state(),
            "opt": [jl.wm_opt_state, jl.ac_opt_state, jl.cr_opt_state],
            "ret": (jl.ret_lo, jl.ret_hi), "rng": jl._rng}


def _jrestore(jl, s):
    jl.set_state(s["params"])
    jl.wm_opt_state, jl.ac_opt_state, jl.cr_opt_state = s["opt"]
    jl.ret_lo, jl.ret_hi = s["ret"]
    jl._rng = s["rng"]


def _port(s):
    """A port learner (CPU) carrying a `_jstate`."""
    tl = tdv.DreamerV3Learner(OBS, ACT, tdv.DreamerV3Config().training(
        **NANO).learners(device="cpu").to_dict())
    return tdv.dreamerv3_from_jax(
        tl, _np(s["params"]), [_adam(o) for o in s["opt"]],
        [np.asarray(x) for x in s["ret"]])


@pytest.fixture(scope="module")
def jax_learner():
    """One JAX learner and its first state. Its init draws from numpy
    (eagerly each of JAX's random draws compiles its own program, ~5 s
    in all); the weights cross into the port anyway."""
    rs = np.random.RandomState(0)

    def normal(key, shape=(), dtype=float):
        return jnp.asarray(rs.standard_normal(shape), jnp.float32)

    with mock.patch.object(jax.random, "normal", normal):
        jl = jdv.DreamerV3Learner(OBS, ACT, _cfg())
    return jl, _jstate(jl)


@pytest.fixture
def jl(jax_learner):
    learner, s0 = jax_learner
    _jrestore(learner, s0)
    return learner


def _keys(rng):
    """(the learner's next rng, k_wm, k_im) of JAX's next ``train``."""
    rng, key = jax.random.split(rng)
    k_wm, k_im, _ = jax.random.split(key, 3)
    return rng, k_wm, k_im


def _draws(k_wm, k_im, n=B * T):
    """JAX's Gumbel draws of one ``train``, by the port's names."""
    out = {}
    for t, k in enumerate(jax.random.split(k_wm, T)):
        out[f"observe.{t}"] = np.asarray(jax.random.gumbel(k, (B, G, C)))
    for t, k in enumerate(jax.random.split(k_im, H)):
        out[f"imagine.action.{t}"] = np.asarray(jax.random.gumbel(k, (n,
                                                                       ACT)))
        out[f"imagine.latent.{t}"] = np.asarray(jax.random.gumbel(
            k, (n, G, C)))
    return out


def _feed(tl, draws):
    tl.set_noise(lambda name, shape, kind: np.array(draws[name]))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prev_act(batch):
    acts = np.eye(ACT, dtype=np.float32)[batch["actions"]]
    return np.concatenate([np.zeros_like(acts[:, :1]), acts[:, :-1]], 1)


@pytest.fixture(scope="module")
def jax_train(jax_learner):
    """Two JAX ``train`` calls from the first state: the batches, each
    call's keys, metrics and the state after it."""
    learner, s0 = jax_learner
    _jrestore(learner, s0)
    out = []
    for i in range(2):
        rng, k_wm, k_im = _keys(learner._rng)
        batch = _batch(seed=10 + i)
        metrics = learner.train(batch)
        assert np.array_equal(np.asarray(rng), np.asarray(learner._rng))
        out.append({"batch": batch, "draws": _draws(k_wm, k_im),
                    "metrics": metrics, "after": _jstate(learner)})
    _jrestore(learner, s0)
    return out


def _port_close(tl, s, n_updates):
    """The port learner's state against a `_jstate`."""
    cfg = _cfg()
    lrs = {"wm": cfg["model_lr"], "actor": cfg["actor_lr"],
           "critic": cfg["critic_lr"], "slow_critic": cfg["critic_lr"]}
    want, got = _np(s["params"]), tl.get_state()
    for part, lr in lrs.items():
        for g, w in zip(_leaves(got[part]), _leaves(want[part])):
            _close(g, w, rtol=0, atol=0.01 * lr * n_updates, msg=part)
    for opt, jopt in zip((tl.wm_opt, tl.ac_opt, tl.cr_opt), s["opt"]):
        assert opt.count == _adam(jopt)["count"] == n_updates
    _close(float(tl.ret_lo), float(s["ret"][0]), msg="ret_lo")
    _close(float(tl.ret_hi), float(s["ret"][1]), msg="ret_hi")


# ---------------------------------------------------------------------------
# Replay and building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [40, 100], ids=["filling", "wrapped"])
def test_sequence_replay_matches_jax(steps):
    jr = jdv.SequenceReplay(64 * 4, 4, seed=3)
    tr = tdv.SequenceReplay(64 * 4, 4, seed=3)
    rng = np.random.RandomState(0)
    for t in range(steps):
        step = {"obs": rng.randn(4, 3).astype(np.float32),
                "actions": rng.randint(0, 2, 4).astype(np.int32),
                "is_first": (rng.rand(4) < 0.1).astype(np.float32)}
        jr.add_batch(step)
        tr.add_batch(step)
    assert len(tr) == len(jr)
    for _ in range(3):
        want, got = jr.sample(5, 16), tr.sample(5, 16)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], k)


def test_param_trees_match_jax_layout(jl):
    tl = _port(_jstate(jl))
    want, got = _np(jl.get_state()), tl.get_state()
    for part in ("wm", "actor", "critic", "slow_critic"):
        assert jax.tree_util.tree_structure(got[part]) == \
            jax.tree_util.tree_structure(want[part]), part
        for g, w in zip(_leaves(got[part]), _leaves(want[part])):
            np.testing.assert_array_equal(g, w)


def test_symlog_and_gru_match_jax(jl):
    x = np.array([-100.0, -1.0, 0.0, 0.5, 10.0, 1e4], np.float32)
    _close(tdv.symlog(torch.from_numpy(x)).numpy(),
           np.asarray(jdv.DreamerV3Learner._symlog(x)))
    _close(tdv.symexp(torch.from_numpy(x / 1e3)).numpy(),
           np.asarray(jdv.DreamerV3Learner._symexp(x / 1e3)))
    tl = _port(_jstate(jl))
    rng = np.random.RandomState(1)
    x, h = (rng.randn(8, 16).astype(np.float32) for _ in range(2))
    want = jl._gru(jl.wm_params["gru"], x, h)
    with torch.no_grad():
        got = tl.wm.gru(torch.from_numpy(x), torch.from_numpy(h))
    _close(got.numpy(), np.asarray(want))


def test_latent_matches_jax(jl):
    tl = _port(_jstate(jl))
    logits = np.random.RandomState(2).randn(5, G * C).astype(np.float32)
    key = jax.random.PRNGKey(7)
    st, logp = jl._latent(jnp.asarray(logits), key)
    g = np.asarray(jax.random.gumbel(key, (5, G, C)))
    got_st, got_logp = tl._latent(torch.from_numpy(logits),
                                  torch.from_numpy(np.array(g)))
    _close(got_logp.detach().numpy(), np.asarray(logp))
    _close(got_st.detach().numpy(), np.asarray(st))
    assert np.array_equal(got_st.detach().numpy().reshape(5, G, C).argmax(-1),
                          np.asarray(st).reshape(5, G, C).argmax(-1))


# ---------------------------------------------------------------------------
# World model
# ---------------------------------------------------------------------------

def test_observe_matches_jax(jl):
    batch = _batch()
    _, k_wm, k_im = _keys(jl._rng)
    hs, zs, lp_post, lp_prior = jax.jit(jl._observe)(
        jl.wm_params, batch["obs"], _prev_act(batch), batch["is_first"], k_wm)
    draws = _draws(k_wm, k_im)
    # the rebuilt draws give JAX's own samples
    g = np.stack([draws[f"observe.{t}"] for t in range(T)], 1)
    assert np.array_equal(np.asarray(zs).reshape(B, T, G, C).argmax(-1),
                          (np.asarray(lp_post) + g).argmax(-1))
    tl = _port(_jstate(jl))
    _feed(tl, draws)
    with torch.no_grad():
        got = tl._observe(torch.from_numpy(batch["obs"]),
                          torch.from_numpy(_prev_act(batch)),
                          torch.from_numpy(batch["is_first"]))
    for name, x, w in zip(("h", "z", "post", "prior"), got,
                          (hs, zs, lp_post, lp_prior)):
        _close(x.numpy(), np.asarray(w), msg=name)


@pytest.fixture(scope="module")
def jax_wm(jax_learner):
    """JAX's world-model loss, metrics and gradients on the first state
    and a seeded batch, with the draws of its key."""
    learner, s0 = jax_learner
    _jrestore(learner, s0)
    batch = _batch(1)
    _, k_wm, k_im = _keys(learner._rng)
    (loss, (_, jm)), jg = jax.jit(jax.value_and_grad(
        learner._wm_loss, has_aux=True))(learner.wm_params, _jbatch(batch),
                                         k_wm)
    return batch, _draws(k_wm, k_im), (float(loss), _np(jm),
                                       _leaves(_np(jg)))


def _wm_port(jl, batch, draws, latent=None):
    """The port's world-model (loss, metrics, gradients) on the
    learner's first state."""
    tl = _port(_jstate(jl))
    _feed(tl, draws)
    with mock.patch.object(tdv.DreamerV3Learner, "_latent",
                           latent or tdv.DreamerV3Learner._latent):
        tloss, _, tm = tl._wm_loss(_tbatch(batch))
    tg = torch.autograd.grad(tloss, tl.wm_opt.params, allow_unused=True,
                             materialize_grads=True)
    return (float(tloss.detach()),
            {k: float(v.detach()) for k, v in tm.items()},
            [g.numpy() for g in tg])


def test_wm_loss_metrics_and_grads_match_jax(jl, jax_wm):
    batch, draws, (jloss, jm, jg) = jax_wm
    tloss, tm, tg = _wm_port(jl, batch, draws)
    _close(tloss, jloss)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], msg=k)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        _grad_close(g, w)


def _latent_no_stop_gradient(self, logits, gumbel=None):
    """A planted fault: the straight-through sample without the
    stop-gradient on ``probs`` (no gradient reaches the logits)."""
    logits = logits.reshape(*logits.shape[:-1], G, C)
    probs = 0.99 * torch.softmax(logits, -1) + 0.01 / C
    logp = torch.log(probs)
    if gumbel is None:
        return None, logp
    onehot = F.one_hot(torch.argmax(logp + gumbel, -1), C).to(probs.dtype)
    st = onehot + probs - probs
    return st.reshape(*st.shape[:-2], G * C), logp


def test_straight_through_without_stop_gradient_is_caught(jl, jax_wm):
    """Same loss value, but the world model's gradients leave the gate."""
    batch, draws, (jloss, _, jg) = jax_wm
    tloss, _, tg = _wm_port(jl, batch, draws, _latent_no_stop_gradient)
    _close(tloss, jloss)
    bad = 0
    for g, w in zip(tg, jg):
        try:
            _grad_close(g, w)
        except AssertionError:
            bad += 1
    assert bad > 0


# ---------------------------------------------------------------------------
# Imagination and the actor-critic targets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def imagined(jax_learner):
    """JAX's imagination from posterior features of a seeded batch on
    the first state: (start, draws, feats, acts, logps, returns), the
    lambda-returns by JAX's reverse ``lax.scan`` (the recursion of its
    ``ac_losses``) on the imagined rewards, discounts and slow-critic
    values, and those three."""
    jl, s0 = jax_learner
    _jrestore(jl, s0)
    batch = _batch(2)
    _, k_wm, k_im = _keys(jl._rng)
    _, (feat, _) = jax.jit(jl._wm_loss)(jl.wm_params, _jbatch(batch), k_wm)
    start = np.asarray(feat).reshape(-1, feat.shape[-1])
    feats, acts, logps = jax.jit(jl._imagine)(jl.wm_params, jl.actor_params,
                                              start, k_im)
    lam, gamma = _cfg()["lambda_"], _cfg()["gamma"]

    def targets(wm, slow, feats):
        rew = jl._symexp(jl._mlp(wm["rew"], feats)[..., 0])
        disc = gamma * jax.nn.sigmoid(jl._mlp(wm["cont"], feats)[..., 0])
        v = jl._symexp(jl._mlp(slow, feats)[..., 0])

        def back(nxt, t):
            r_t, d_t, v_t = t
            ret = r_t + d_t * ((1 - lam) * v_t + lam * nxt)
            return ret, ret

        _, rets = jax.lax.scan(back, v[-1], (rew[:-1], disc[:-1], v[1:]),
                               reverse=True)
        return rets, (rew, disc, v)

    rets, inputs = jax.jit(targets)(jl.wm_params, jl.slow_critic, feats)
    return (start, _draws(k_wm, k_im), feats, acts, logps, rets,
            [np.asarray(x) for x in inputs])


def test_imagine_matches_jax(jl, imagined):
    start, draws, feats, acts, logps = imagined[:5]
    g = np.stack([draws[f"imagine.action.{t}"] for t in range(H)])
    assert np.array_equal(np.asarray(acts),
                          (np.asarray(logps) + g).argmax(-1))
    tl = _port(_jstate(jl))
    _feed(tl, draws)
    tf, ta = tl._imagine(torch.from_numpy(np.array(start)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(acts))
    _close(tf.numpy(), np.asarray(feats))
    with torch.no_grad():
        tlogp = F.log_softmax(tdv._mlp_apply(tl.actor, tf), -1)
    _close(tlogp.numpy(), np.asarray(logps))


def test_lambda_returns_and_percentiles_match_jax(jl, imagined):
    """The port's backwards loop against JAX's reverse ``lax.scan`` on
    the same rewards, discounts and slow-critic values;
    ``torch.quantile`` against ``jnp.percentile``."""
    want, inputs = imagined[5], imagined[6]
    tl = _port(_jstate(jl))
    got = tl._lambda_returns(*(torch.from_numpy(np.array(x)) for x in inputs))
    _close(got.numpy(), np.asarray(want))
    flat = torch.from_numpy(np.array(want)).flatten()
    for q in (5, 95):
        _close(float(torch.quantile(flat, q / 100)),
               float(jnp.percentile(want, q)), msg=f"percentile {q}")


# ---------------------------------------------------------------------------
# Whole updates and the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2])
def test_train_matches_jax(jl, jax_train, n):
    """``n`` whole ``train`` calls with JAX's draws installed: the world
    model's step, imagination on the stepped model, both actor-critic
    steps, the slow critic's EMA and the return-normalization EMA (the
    second call's advantages read the first call's EMA)."""
    tl = _port(_jstate(jl))
    for i in range(n):
        ref = jax_train[i]
        _feed(tl, ref["draws"])
        tm = tl.train(ref["batch"])
        assert sorted(tm) == sorted(ref["metrics"])
        for k, v in ref["metrics"].items():
            _close(tm[k], v, rtol=1e-4, msg=k)
    _port_close(tl, jax_train[n - 1]["after"], n)


def test_jax_state_resumes_in_port(jax_train):
    """The JAX learner's state after one ``train`` (weights, Adam's
    counts and moments, the EMA), carried into a fresh port learner,
    gives JAX's second ``train``."""
    tl = _port(jax_train[0]["after"])
    ref = jax_train[1]
    _feed(tl, ref["draws"])
    tm = tl.train(ref["batch"])
    for k, v in ref["metrics"].items():
        _close(tm[k], v, rtol=1e-4, msg=k)
    cfg = _cfg()
    want = _np(ref["after"]["params"])
    for part, lr in (("wm", cfg["model_lr"]), ("actor", cfg["actor_lr"]),
                     ("critic", cfg["critic_lr"])):
        for g, w in zip(_leaves(tl.get_state()[part]), _leaves(want[part])):
            _close(g, w, rtol=0, atol=0.01 * lr, msg=part)
    assert tl.wm_opt.count == 2


def test_policy_step_matches_jax(jl):
    rng = np.random.RandomState(3)
    N = 3
    h = rng.randn(N, 16).astype(np.float32)
    z = np.eye(C, dtype=np.float32)[rng.randint(0, C, (N, G))].reshape(N, -1)
    prev_a = rng.randint(0, ACT, N).astype(np.int32)
    first = np.array([1, 0, 0], np.float32)
    obs = rng.randn(N, OBS).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jh, jz, ja = jax.jit(jl._policy_step)(jl.wm_params, jl.actor_params, h,
                                          z, prev_a, first, obs, key)
    draws = {"policy.latent": np.asarray(jax.random.gumbel(key, (N, G, C))),
             "policy.action": np.asarray(jax.random.gumbel(key, (N, ACT)))}
    tl = _port(_jstate(jl))
    _feed(tl, draws)
    th, tz, ta = tl.policy(*(torch.from_numpy(x)
                             for x in (h, z, prev_a, first, obs)))
    _close(th.numpy(), np.asarray(jh), msg="h")
    _close(tz.numpy(), np.asarray(jz), msg="z")
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


# ---------------------------------------------------------------------------
# The algorithm, its state, and the port's coverage
# ---------------------------------------------------------------------------

def _algo_cfg():
    return (tdv.DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_envs_per_runner=2)
            .training(env_steps_per_iteration=16, num_steps_before_learning=16,
                      sequence_length=4, batch_size_sequences=2,
                      train_updates_per_iteration=1, **NANO)
            .learners(device="cpu").debugging(seed=3))


def test_step_keeps_state_on_device_and_checkpoints(tmp_path, jax_train):
    algo = _algo_cfg().build_algo()
    r = algo.step()
    assert r["num_env_steps"] == 16 and len(algo.replay) == 16
    r = algo.step()
    assert set(jax_train[0]["metrics"]) <= set(r)
    assert torch.is_tensor(algo._h) and algo._h.device == algo.device
    assert torch.is_tensor(algo._z) and algo._z.shape == (2, G * C)
    algo.save_checkpoint(str(tmp_path))
    algo2 = _algo_cfg().build_algo()
    algo2.load_checkpoint(str(tmp_path))
    a, b = algo.learner.get_state(), algo2.learner.get_state()
    for part in ("wm", "actor", "critic", "slow_critic"):
        for g, w in zip(_leaves(b[part]), _leaves(a[part])):
            np.testing.assert_array_equal(g, w)
    assert algo2._iteration == 2 and algo2._env_steps == 32


def test_rllib_exports_the_last_three_algorithms():
    for name in ("QMIX", "QMIXConfig", "AlphaZero", "AlphaZeroConfig",
                 "DreamerV3", "DreamerV3Config"):
        assert name in trllib.__all__ and hasattr(trllib, name), name
    assert trllib.DreamerV3Config().build_algo.__self__.algo_class \
        is trllib.DreamerV3


def test_every_jax_module_has_a_port_counterpart():
    """Every file under ray_tpu/ that imports jax has a file at the same
    path under ray_tpu_torch/; the only others mention jax in comments."""
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    missing = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ray_tpu")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                if not pat.search(fh.read()):
                    continue
            rel = os.path.relpath(path, os.path.join(ROOT, "ray_tpu"))
            if not os.path.exists(os.path.join(ROOT, "ray_tpu_torch", rel)):
                missing.append(rel)
    assert missing == [], missing


def test_runs_on_cuda_by_default():
    assert trllib.DreamerV3Config().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdv.DreamerV3Learner(OBS, ACT, tdv.DreamerV3Config().training(
                **NANO).to_dict())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_builds_on_the_card_by_default(card):
    algo = (tdv.DreamerV3Config().environment("CartPole-v1")
            .training(env_steps_per_iteration=16, **NANO).build_algo())
    assert algo.device.type == "cuda"
    algo.step()
    assert algo._h.device.type == "cuda"
