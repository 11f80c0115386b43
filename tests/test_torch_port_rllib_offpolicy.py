"""PyTorch port, RLlib's off-policy family (`ray_tpu_torch.rllib`: DQN
with prioritized replay, DDPG, TD3, SAC, CQL) against the JAX package,
on the CPU.

Weights cross as numpy trees in JAX's layout; the port's learner takes
the JAX learner's whole state (`_cross`: params, Adam's count and
moments, the target params, TD3's update count), so both packages start
every case on the same numbers (nano sizes: 16-wide hidden layers,
batches of 32). The JAX losses draw from threefry keys, which the port
cannot reproduce: each port loss draws through `TorchLearner.noise`,
and the tests install a source that returns the JAX loss's own draws
from the key its update derives (`split(learner._rng)[1]`; SAC's
``split`` into the next-state and policy keys, CQL's ``fold_in(key,
7)``, TD3's smoothing on the key itself). Held to JAX:

- the replay buffers: equal indices, PER weights and priorities after
  the same adds, samples and updates;
- each learner's loss, metrics and gradients on a seeded batch, with
  the target set apart from the online weights so that the target path
  is exercised. Both losses are also evaluated in float64 on the same
  weights and draws (`_port64`, and `_jax64` under ``jax.enable_x64``
  with the f32 draws patched in): those agree within 1e-10 + 1e-8
  |JAX|, and the f32 values within 1e-6 + 1e-5 |JAX| plus each
  package's own distance from its float64 value (`_close`). The extra
  term matters only for SAC and CQL: their squashed log-prob ``log(1 -
  tanh(x)**2 + 1e-6)`` cancels ~4 digits in f32 where a sample
  saturates, and XLA's and torch's f32 tanh differ by up to ~4 ulp
  there. One ``update`` within
  ``UPDATE_ATOL = 0.01 * LR`` (Adam's first step moves a weight by
  about ``lr * sign(g)``); ``sync_target`` at tau 1.0 and 0.005, bit
  for bit;
- TD3's delayed actor over three updates: Adam's count and moments;
- one ``training_step`` of every algorithm with the runner group's
  sample replaced by the same fixed rollout (CQL: the same offline
  dataset): replay contents, minibatches, metrics, weights and target
  weights after the step (``STEP_ATOL = 0.01 * LR`` per update);
- a learner state written by JAX after two updates, loaded by the port,
  giving the same next update.

Held to the port itself: the target tensors are no parameters of the
learner (not in `tree_paths`, Adam's state or `update_ddp`'s vector),
a target sync made in place on the online weights (no copy) is caught,
and one short local ``train()`` of each algorithm runs.
"""

import copy
import faulthandler
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import ddpg as jddpg
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.core import rl_module as jrlm
from ray_tpu.rllib.utils import replay_buffers as jrb
from ray_tpu_torch import rllib as trllib
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import ddpg as tddpg
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import off_policy as toff
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.core import rl_module as trlm
from ray_tpu_torch.rllib.utils import replay_buffers as trb
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

HIDDEN = (16, 16)
MODEL = {"fcnet_hiddens": HIDDEN}
LR = 1e-3
UPDATE_ATOL = STEP_ATOL = 0.01 * LR
BATCH = 32
CQL_N = 3
BOX = {"action_low": np.array([-2.0], np.float32),
       "action_high": np.array([2.0], np.float32)}

# name -> (JAX learner, port learner, module name, obs dim, actions,
#          loss config)
LEARNERS = {
    "dqn": (jdqn.DQNLearner, tdqn.DQNLearner, "QNetModule", 4, 2,
            {"double_q": True, "gamma": 0.97}),
    "dqn_single": (jdqn.DQNLearner, tdqn.DQNLearner, "QNetModule", 4, 2,
                   {"double_q": False, "gamma": 0.97}),
    "dqn_per": (jdqn.DQNLearner, tdqn.DQNLearner, "QNetModule", 4, 2,
                {"double_q": True, "gamma": 0.97}),
    "ddpg": (jddpg.DDPGLearner, tddpg.DDPGLearner, "DDPGModule", 3, 1,
             {"gamma": 0.97}),
    "td3": (jddpg.DDPGLearner, tddpg.DDPGLearner, "DDPGModule", 3, 1,
            {"gamma": 0.97, "twin_q": True, "target_noise": 0.2,
             "target_noise_clip": 0.5, "policy_delay": 2}),
    "sac": (jsac.SACLearner, tsac.SACLearner, "SACModule", 3, 1,
            {"gamma": 0.97}),
    "cql": (jcql.CQLLearner, tcql.CQLLearner, "SACModule", 3, 1,
            {"gamma": 0.97, "cql_alpha": 0.7, "cql_n_actions": CQL_N}),
}


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
            for x in trlm.tree_leaves(tree)]


def _adam(opt_state):
    """optax's ScaleByAdamState inside chain(clip, adam)'s state."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node
    raise AssertionError("no Adam state")


def _cross(jstate):
    """The port's learner state from a JAX learner's `get_state()`:
    optax's Adam count and moments in the port's layout, the rest as
    is."""
    adam = _adam(jstate["opt_state"])
    out = dict(jstate)
    out["opt_state"] = {"count": int(adam.count), "mu": _np(adam.mu),
                        "nu": _np(adam.nu)}
    return out


def _discrete(name):
    return LEARNERS[name][2] == "QNetModule"


def _learners(name, move_target=True):
    """(JAX learner, port learner) of one case on equal state; the
    target is moved off the online weights (``0.9 t + 0.01``)."""
    jcls, tcls, mod, obs_dim, n_act, extra = LEARNERS[name]
    model = dict(MODEL) if _discrete(name) else dict(MODEL, **BOX)
    cfg = {"seed": 0, "lr": LR, "grad_clip": 10.0, **extra}
    jl = jcls(jrlm.RLModuleSpec(getattr(jrlm, mod), obs_dim, n_act,
                                dict(model)), dict(cfg))
    tl = tcls(trlm.RLModuleSpec(getattr(trlm, mod), obs_dim, n_act,
                                dict(model)), dict(cfg), device="cpu")
    if move_target:
        jl.target_params = jax.tree_util.tree_map(
            lambda x: x * 0.9 + 0.01, jl.target_params)
    tl.set_state(_cross(jl.get_state()))
    return jl, tl


def _batch(name, n=BATCH, seed=0):
    """A seeded numpy replay batch of the case's spaces."""
    _, _, _, obs_dim, n_act, _ = LEARNERS[name]
    rng = np.random.RandomState(seed)
    out = {"obs": rng.randn(n, obs_dim).astype(np.float32),
           "next_obs": rng.randn(n, obs_dim).astype(np.float32),
           "rewards": rng.randn(n).astype(np.float32),
           "terminateds": rng.rand(n) < 0.2}
    if _discrete(name):
        out["actions"] = rng.randint(0, n_act, n).astype(np.int64)
    else:
        out["actions"] = rng.uniform(-2, 2, (n, n_act)).astype(np.float32)
    if name == "dqn_per":
        out["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return out


def _draws(name, key, b=BATCH, act_dim=1):
    """The JAX loss's random draws from its update key, by the names
    the port's losses give them."""
    if name == "td3":
        return {"target": np.asarray(jax.random.normal(key, (b, act_dim)))}
    if name not in ("sac", "cql"):
        return {}
    rng_next, rng_pi = jax.random.split(key)
    out = {"next": np.asarray(jax.random.normal(rng_next, (b, act_dim))),
           "pi": np.asarray(jax.random.normal(rng_pi, (b, act_dim)))}
    if name == "cql":
        rng_u, rng_p = jax.random.split(jax.random.fold_in(key, 7))
        out["cql_uniform"] = np.asarray(
            jax.random.uniform(rng_u, (CQL_N, b, act_dim)))
        out["cql_pi"] = np.stack([
            np.asarray(jax.random.normal(k, (b, act_dim)))
            for k in jax.random.split(rng_p, CQL_N)])
    return out


def _next_key(jl):
    """The key JAX's next ``update`` hands its loss."""
    return jax.random.split(jl._rng)[1]


def _feed(tl, draws):
    tl.set_noise(lambda name, shape, kind: draws[name])


def _jax_batch(jl, batch):
    """The batch JAX's loss reads: the targets threaded through it."""
    out = dict(batch)
    if isinstance(jl, jsac.SACLearner):
        out["target_q1"] = jl.target_params["q1"]
        out["target_q2"] = jl.target_params["q2"]
    else:
        out["target_params"] = jl.target_params
    return out


def _port64(tl, batch, draws):
    """The port learner's loss metrics (``total_loss`` included) and
    gradients evaluated in float64 on its current weights, target,
    ``batch`` and ``draws``."""
    ref = copy.copy(tl)
    ref.module = copy.deepcopy(tl.module).double()
    ref.target_module = copy.deepcopy(tl.target_module).double()
    ref.noise = lambda name, shape, kind="normal": torch.as_tensor(
        np.asarray(draws[name], np.float64))
    tb = {k: torch.as_tensor(np.asarray(v, np.float64)
                             if np.asarray(v).dtype.kind == "f" else v)
          for k, v in batch.items()}
    loss, metrics = ref.loss_fn(tb, None)
    params = [p for _, p in trlm.tree_paths(ref.module)]
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    out = {k: v.detach().numpy() for k, v in metrics.items()}
    out["total_loss"] = loss.detach().numpy()
    return out, [g.numpy() for g in grads]


def _jax64(jl, batch, key, draws):
    """JAX's loss metrics and gradients in float64 (``jax.enable_x64``)
    on the learner's params, target and ``batch``, with the f32 draws
    its f32 loss makes from ``key`` patched in, in the order the loss
    draws them (SAC: next, pi; CQL: then the uniform actions and the
    policy samples; TD3: the smoothing noise)."""
    order = [draws[k] for k in ("target", "next", "pi") if k in draws]
    if "cql_uniform" in draws:
        order += [draws["cql_uniform"], *draws["cql_pi"]]
    order = iter(order)

    def normal(k, shape=(), dtype=None):
        x = next(order)
        assert x.shape == tuple(shape)
        return jax.numpy.asarray(x, jax.numpy.float64)

    def uniform(k, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = normal(k, shape)
        return jax.numpy.maximum(minval, u * (maxval - minval) + minval)

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.numpy.asarray(
                np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f"
                else np.asarray(x)), tree)

    with jax.enable_x64(True), \
            mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jl.loss_fn, has_aux=True))(f64(jl.params),
                                       f64(_jax_batch(jl, batch)), key)
        assert next(order, None) is None
        out = {k: np.asarray(v) for k, v in metrics.items()}
        out["total_loss"] = np.asarray(loss)
        return out, _leaves(_np(grads))


def _close(got, want, got64, want64, err_msg="", rtol=1e-5, atol=1e-6,
           same_state=True):
    """The f32 values within ``atol + rtol |JAX|`` plus each package's
    distance from its float64 value; on the same state
    (``same_state``), the float64 values within 1e-10 + 1e-8 |JAX|."""
    got, want, got64, want64 = (np.asarray(x, np.float64)
                                for x in (got, want, got64, want64))
    if same_state:
        np.testing.assert_allclose(got64, want64, rtol=1e-8, atol=1e-10,
                                   err_msg=f"{err_msg} (float64)")
    slack = np.abs(want - want64) + np.abs(got - got64)
    bad = np.abs(got - want) > atol + rtol * np.abs(want) + slack
    assert not bad.any(), (err_msg, got[bad] if got.ndim else got,
                           want[bad] if want.ndim else want)


def _metrics_close(tm, jm, t64, j64):
    assert sorted(tm) == sorted(jm) == sorted(t64) == sorted(j64)
    for k in jm:
        _close(tm[k], jm[k], t64[k], j64[k], k)


# ---------------------------------------------------------------------------
# Replay buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_replay_buffers_match_jax(per):
    """The same adds (wrapping the ring), samples and priority updates
    give equal indices, columns, PER weights and priorities."""
    def build(mod):
        return (mod.PrioritizedReplayBuffer(40, seed=3) if per
                else mod.ReplayBuffer(40, seed=3))

    jb, tb = build(jrb), build(trb)
    rng = np.random.RandomState(2)
    for step in range(5):
        n = 15
        batch = {"x": np.arange(step * n, (step + 1) * n, dtype=np.float32),
                 "a": rng.randint(0, 3, n)}
        jb.add(SampleBatch(batch))
        tb.add(SampleBatch(batch))
        assert len(tb) == len(jb) and tb._next == jb._next
        want, got = jb.sample(24), tb.sample(24)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if per:
            td = rng.randn(24).astype(np.float32) * (step + 1)
            jb.update_priorities(want["batch_indexes"], td)
            tb.update_priorities(got["batch_indexes"], td)
            np.testing.assert_array_equal(tb._priorities, jb._priorities)
            assert tb._max_priority == jb._max_priority
    assert len(jb) == 40 and jb._cols["x"].min() >= 35


@pytest.mark.parametrize("case", ["ring", "per"])
def test_replay_buffer_pins_match_jax(case):
    """`tests/test_rllib.py`'s two buffer cases on both packages: the
    ring overwrites its oldest rows, and two rows given priority 100
    dominate the samples; the samples are equal."""
    out = []
    for mod in (jrb, trb):
        if case == "ring":
            buf = mod.ReplayBuffer(capacity=10)
            buf.add(SampleBatch({"x": np.arange(8)}))
            buf.add(SampleBatch({"x": np.arange(8, 16)}))
            s = buf.sample(32)
            assert len(buf) == 10 and s["x"].min() >= 6
        else:
            buf = mod.PrioritizedReplayBuffer(capacity=100, seed=1)
            buf.add(SampleBatch({"x": np.arange(50, dtype=np.float32)}))
            buf.update_priorities(np.array([0, 1]), np.array([100.0, 100.0]))
            s = buf.sample(64)
            assert np.isin(s["batch_indexes"], [0, 1]).mean() > 0.3
        out.append(s)
    assert sorted(out[1]) == sorted(out[0])
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k])


# ---------------------------------------------------------------------------
# Learners: loss, gradients, update, target sync
# ---------------------------------------------------------------------------

def _update_flag(name, batch):
    if name in ("ddpg", "td3"):
        batch = dict(batch, update_actor=np.float32(1.0))
    return batch


def _grads_pair(jl, tl, name, batch):
    """Both packages' f32 loss metrics and gradients on ``batch`` (the
    port fed JAX's draws of its next update), and their float64
    evaluations: ((tm, jm, t64, j64), [(got, want, got64, want64)])."""
    key = _next_key(jl)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True))(
        jl.params, jl._shard_batch(_jax_batch(jl, batch)), key)
    draws = _draws(name, key)
    t64, t64_g = _port64(tl, batch, draws)
    j64, j64_g = _jax64(jl, batch, key, draws)
    _feed(tl, draws)
    tg, tm = tl.compute_gradients(batch)
    jm = dict(_np(jm), total_loss=np.asarray(jloss))
    return (tm, jm, t64, j64), list(zip(_leaves(tg), _leaves(_np(jg)),
                                        t64_g, j64_g))


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_loss_metrics_and_grads_match_jax(name):
    jl, tl = _learners(name)
    metrics, grads = _grads_pair(jl, tl, name,
                                 _update_flag(name, _batch(name)))
    _metrics_close(*metrics)
    assert [g.shape for g, w, _, _ in grads] == \
        [w.shape for g, w, _, _ in grads]
    assert any(np.abs(w).max() > 1e-3 for _, w, _, _ in grads)
    for i, args in enumerate(grads):
        _close(*args, err_msg=f"grad {i}")
    if name == "ddpg":      # no twin critic: q2 gets JAX's zero gradient
        tg, _ = tl.compute_gradients(_update_flag(name, _batch(name)))
        assert all(not np.any(g) for g in _leaves(tg["q2"]))


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_update_matches_jax(name):
    """One update: the metrics as in the loss test, and every weight
    within ``UPDATE_ATOL`` of JAX's, except where f32 leaves the
    gradient's sign undetermined (|JAX| within the tolerance plus both
    rounding spreads): Adam's first step is about ``lr * sign(g)``
    there, so those weights are held within ``2 lr``."""
    jl, tl = _learners(name)
    batch = _update_flag(name, _batch(name, seed=1))
    metrics, grads = _grads_pair(jl, tl, name, batch)
    before = _leaves(tl.get_weights())
    jm = jl.update(_jax_batch(jl, batch))
    tm = tl.update(batch)
    _metrics_close(tm, jm, *metrics[2:])
    got, want = _leaves(tl.get_weights()), _leaves(jl.get_weights())
    assert any(np.abs(w - b).max() > 0.5 * LR for w, b in zip(want, before))
    for g, w, (gg, gw, g64, w64) in zip(got, want, grads):
        open_sign = np.abs(gw) <= (1e-6 + 1e-5 * np.abs(gw)
                                   + np.abs(gw - w64) + np.abs(gg - g64))
        diff = np.abs(g - w)
        assert (diff[~open_sign] <= UPDATE_ATOL).all(), diff.max()
        assert (diff[open_sign] <= 2 * LR + UPDATE_ATOL).all()
    # the update leaves the target alone
    for g, w in zip(_leaves(tl.get_state()["target_params"]),
                    _leaves(_np(jl.target_params))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tau", [1.0, 0.005])
@pytest.mark.parametrize("name", ["dqn", "ddpg", "sac"])
def test_sync_target_matches_jax(name, tau):
    """``t * (1 - tau) + p * tau`` bit for bit; tau 1.0 gives the online
    weights exactly; the target tree has JAX's layout (SAC: the critics
    only)."""
    jl, tl = _learners(name)
    jl.sync_target(tau)
    tl.sync_target(tau)
    want = _np(jl.target_params)
    got = tl.get_state()["target_params"]
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w)
    if tau == 1.0:
        online = tl.get_weights()
        online = {k: online[k] for k in got}
        for g, w in zip(_leaves(got), _leaves(online)):
            np.testing.assert_array_equal(g, w)


def test_td3_delayed_actor_adam_state_matches_jax():
    """Three TD3 updates (policy delay 2: actor flag 0, 1, 0): the actor
    is multiplied out, never skipped, so Adam's count ticks on every
    update and the actor's moments decay on critic-only updates; the
    count and every moment equal JAX's."""
    jl, tl = _learners("td3")
    for i in range(3):
        batch = _batch("td3", seed=10 + i)
        key = _next_key(jl)
        draws = _draws("td3", key)
        flagged = dict(batch, update_actor=np.float32(i == 1))
        t64 = _port64(tl, flagged, draws)[0]
        j64 = _jax64(jl, flagged, key, draws)[0]
        _feed(tl, draws)
        jm = jl.update_ddpg(_jax_batch(jl, batch))
        tm = tl.update_ddpg(batch)
        _metrics_close(tm, jm, t64, j64)
        assert (tm["actor_loss"] == 0.0) == (i != 1)
    js, ts = _cross(jl.get_state()), tl.get_state()
    assert ts["opt_state"]["count"] == js["opt_state"]["count"] == 3
    assert ts["update_count"] == jl._update_count == 3
    for key in ("mu", "nu"):
        for g, w in zip(_leaves(ts["opt_state"][key]),
                        _leaves(js["opt_state"][key])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-9)
    # after the first (critic-only) update the actor's mu was 0; the
    # actor update then moved it
    assert np.abs(_leaves(ts["opt_state"]["mu"]["pi"])[0]).max() > 0


@pytest.mark.parametrize("name", ["dqn_per", "td3", "sac", "cql"])
def test_jax_learner_state_resumes_in_port(name):
    """A JAX learner state after two updates (Adam's count 2, a synced
    target, TD3's update count), loaded by the port, gives the next
    update JAX takes."""
    jl, tl = _learners(name, move_target=False)
    for i in range(2):
        jl.update(_jax_batch(jl, _update_flag(name, _batch(name, seed=i))))
        jl.sync_target(0.3)
        if name == "td3":
            jl._update_count += 1
    tl.set_state(_cross(jl.get_state()))
    batch = _batch(name, seed=5)
    key = _next_key(jl)
    draws = _draws(name, key)
    flagged = _update_flag(name, batch)
    if name == "td3":       # update 3 of delay 2: critic only
        flagged["update_actor"] = np.float32(0.0)
    t64 = _port64(tl, flagged, draws)[0]
    j64 = _jax64(jl, flagged, key, draws)[0]
    _feed(tl, draws)
    if name == "td3":
        jm, tm = jl.update_ddpg(_jax_batch(jl, batch)), tl.update_ddpg(batch)
        assert tl._update_count == jl._update_count == 3
    else:
        jm = jl.update(_jax_batch(jl, batch))
        tm = tl.update(batch)
    _metrics_close(tm, jm, t64, j64)
    assert tl.get_state()["opt_state"]["count"] == 3
    for g, w in zip(_leaves(tl.get_weights()), _leaves(jl.get_weights())):
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_ATOL)


def test_set_state_without_targets_copies_online():
    jl, tl = _learners("sac")
    state = _cross(jl.get_state())
    del state["target_params"]
    tl.set_state(state)
    online = tl.get_weights()
    for k in ("q1", "q2"):
        for g, w in zip(_leaves(tl.get_state()["target_params"][k]),
                        _leaves(online[k])):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# One training_step of every algorithm on fixed input
# ---------------------------------------------------------------------------

def _rollout(discrete, n=96, seed=7):
    """A fixed rollout: CartPole's spaces (discrete) or Pendulum's."""
    rng = np.random.RandomState(seed)
    dim = 4 if discrete else 3
    terms = np.zeros(n, bool)
    terms[[30, 70]] = True
    out = {"obs": rng.randn(n, dim).astype(np.float32),
           "next_obs": rng.randn(n, dim).astype(np.float32),
           "rewards": rng.randn(n),
           "terminateds": terms, "truncateds": np.zeros(n, bool),
           "eps_id": np.repeat([0, 1, 2], [31, 40, 25]).astype(np.int64)}
    if discrete:
        out["actions"] = rng.randint(0, 2, n).astype(np.int64)
    else:
        out["actions"] = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    return SampleBatch(out)


def _offline(n=300, seed=4):
    rng = np.random.RandomState(seed)
    return {"obs": rng.randn(n, 3).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.randn(n).astype(np.float32),
            "next_obs": rng.randn(n, 3).astype(np.float32),
            "terminateds": rng.rand(n) < 0.05}


# name -> config builder over one package's algorithm modules
STEPS = {
    "dqn": lambda m: m["dqn"].DQNConfig().environment("CartPole-v1")
    .training(num_steps_sampled_before_learning_starts=64,
              target_network_update_freq=1, updates_per_step=2,
              epsilon_decay_steps=200),
    "dqn_per": lambda m: m["dqn"].DQNConfig().environment("CartPole-v1")
    .training(prioritized_replay=True, double_q=False,
              num_steps_sampled_before_learning_starts=64,
              target_network_update_freq=1000, updates_per_step=2),
    "ddpg": lambda m: m["ddpg"].DDPGConfig().environment("Pendulum")
    .training(num_steps_sampled_before_learning_starts=64,
              updates_per_step=2, tau=0.1),
    "td3": lambda m: m["ddpg"].TD3Config().environment("Pendulum")
    .training(num_steps_sampled_before_learning_starts=64,
              updates_per_step=3, tau=0.1),
    "sac": lambda m: m["sac"].SACConfig().environment("Pendulum")
    .training(num_steps_sampled_before_learning_starts=64,
              updates_per_step=2, tau=0.1),
    "cql": lambda m: m["cql"].CQLConfig().environment("Pendulum")
    .offline_data(dataset=_offline()).training(
        updates_per_step=2, tau=0.1, cql_n_actions=CQL_N),
}
JMODS = {"dqn": jdqn, "ddpg": jddpg, "sac": jsac, "cql": jcql}
TMODS = {"dqn": tdqn, "ddpg": tddpg, "sac": tsac, "cql": tcql}


def _step_pair(name):
    def build(mods, **extra):
        cfg = STEPS[name](mods).training(
            lr=LR, model=dict(MODEL), train_batch_size=BATCH,
            replay_buffer_capacity=500).debugging(seed=4)
        if extra:
            cfg = cfg.learners(**extra)
        return cfg.algo_class(cfg)

    ja, ta = build(JMODS), build(TMODS, device="cpu")
    jl, tl = ja.learner_group._local, ta.learner_group.learner
    tl.set_state(_cross(jl.get_state()))
    return (ja, jl), (ta, tl)


def _fixed_training_step(algo, learner, name, draws, port):
    """One training_step on the fixed rollout; each update's batch
    recorded, the noise of update i taken from (port) or recorded into
    (JAX) ``draws[i]``. Returns (metrics, batches, the float64 metrics
    of the last update)."""
    seen, ref = [], {}
    update = learner.update

    def recording(batch):
        plain = {k: np.array(v) for k, v in batch.items()
                 if k not in ("target_params", "target_q1", "target_q2")}
        seen.append(plain)
        if port:
            ref.update(_port64(learner, plain, draws[len(seen) - 1])[0])
            _feed(learner, draws[len(seen) - 1])
        else:
            key = _next_key(learner)
            draws.append(_draws(name, key))
            ref.update(_jax64(learner, plain, key, draws[-1])[0])
        return update(batch)

    learner.update = recording
    rollout = _rollout(name.startswith("dqn"))
    algo.env_runner_group.sample = \
        lambda n, epsilon=0.0: SampleBatch(rollout)
    return algo.training_step(), seen, ref


@pytest.mark.parametrize("name", sorted(STEPS))
def test_training_step_matches_jax(name):
    """One training_step with the rollout (CQL: the offline draws) fixed:
    equal replay contents and minibatches (the numpy buffers and their
    seeds; PER's weights, which come from the last update's TD errors,
    within 1e-5), metrics close, and the weights and target weights
    after the step within ``STEP_ATOL`` per update."""
    (ja, jl), (ta, tl) = _step_pair(name)
    draws = []
    jm, jseen, j64 = _fixed_training_step(ja, jl, name, draws, port=False)
    tm, tseen, t64 = _fixed_training_step(ta, tl, name, draws, port=True)
    n = len(jseen)
    assert n == len(tseen) == ta.config.updates_per_step > 0
    for g, w in zip(tseen, jseen):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "weights":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if name != "cql":
        jr, tr = ja.replay, ta.replay
        assert (tr._size, tr._next) == (jr._size, jr._next) == (96, 96)
        for k in jr._cols:
            np.testing.assert_array_equal(tr._cols[k], jr._cols[k])
        if name == "dqn_per":
            np.testing.assert_allclose(tr._priorities, jr._priorities,
                                       rtol=1e-5, atol=1e-6)
            assert tr._priorities[:96].std() > 0
    assert sorted(tm) == sorted(jm)
    for k in jm:        # the last update's: the states have parted
        if k in j64:
            _close(tm[k], jm[k], t64[k], j64[k], k, rtol=1e-4, atol=1e-5,
                   same_state=False)
        else:
            assert tm[k] == jm[k], k
    for g, w in zip(_leaves(tl.get_weights()), _leaves(jl.get_weights())):
        np.testing.assert_allclose(g, w, rtol=0, atol=STEP_ATOL * n)
    got, want = tl.get_state()["target_params"], _np(jl.target_params)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=STEP_ATOL * n)
    online = jl.get_weights()
    moved = [np.abs(w - o).max() for w, o in zip(
        _leaves(want), _leaves({k: online[k] for k in want}))]
    if name == "dqn":       # synced after the updates (freq 1): equal
        assert max(moved) == 0.0
    else:                   # polyak, or no sync yet: apart
        assert max(moved) > 1e-4


@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_local_learner_required_as_in_jax(algo):
    for mods in (JMODS, TMODS):
        cfg = (mods["dqn"].DQNConfig() if algo == "dqn"
               else mods["sac"].SACConfig()).environment(
            "CartPole-v1" if algo == "dqn" else "Pendulum")
        cfg.num_learners = 2
        with pytest.raises(ValueError, match="local learner"):
            cfg.algo_class(cfg)


# ---------------------------------------------------------------------------
# The port on its own
# ---------------------------------------------------------------------------

def test_targets_are_not_learner_parameters():
    """The target tensors are outside the learner's parameter list (so
    outside Adam's state and `update_ddp`'s flat vector) and share no
    storage with the online weights."""
    for name in ("dqn", "ddpg", "sac"):
        _, tl = _learners(name)
        online = {p.data_ptr() for p in tl.params}
        assert len(tl.params) == len(trlm.tree_paths(tl.module)) \
            == len(tl.opt.mu) == len(tl.opt.nu)
        targets = [t for _, t, _ in tl._target_pairs()]
        assert targets and not ({t.data_ptr() for t in targets} & online)
        assert not any(t.requires_grad for t in targets)
        n_flat = sum(p.numel() for p in tl.params)
        assert n_flat == trlm.ravel_tree(tl.get_weights())[0].size


def _faulty_target(self):
    return self.module


@pytest.mark.parametrize("name", ["dqn_per", "ddpg", "sac"])
def test_in_place_target_fault_is_caught(name):
    """A target made without a copy (the sync then writes the online
    weights in place) moves the step's target weights, or its weights,
    off JAX's by far more than the tolerance."""
    (ja, jl), _ = _step_pair(name)
    draws = []
    _fixed_training_step(ja, jl, name, draws, port=False)
    with mock.patch.object(toff.TargetNetworkLearner, "_make_target",
                           _faulty_target):
        (_, _), (ta, tl) = _step_pair(name)
    assert tl.target_module is tl.module
    _fixed_training_step(ta, tl, name, draws, port=True)
    n = ta.config.updates_per_step
    err = max(np.abs(g - w).max() for g, w in zip(
        _leaves(tl.get_state()["target_params"]),
        _leaves(_np(jl.target_params))))
    err = max(err, max(np.abs(g - w).max() for g, w in zip(
        _leaves(tl.get_weights()), _leaves(jl.get_weights()))))
    assert err > 10 * STEP_ATOL * n, err


ALGOS = {
    "dqn": lambda: trllib.DQNConfig().environment(
        "GridWorld-v0", env_config={"size": 3}).training(
        num_steps_sampled_before_learning_starts=40,
        rollout_fragment_length=40, train_batch_size=16),
    "dqn_per": lambda: trllib.DQNConfig().environment(
        "GridWorld-v0", env_config={"size": 3}).training(
        prioritized_replay=True, num_steps_sampled_before_learning_starts=40,
        rollout_fragment_length=40, train_batch_size=16),
    "ddpg": lambda: trllib.DDPGConfig().environment("Pendulum").training(
        num_steps_sampled_before_learning_starts=64, train_batch_size=16,
        updates_per_step=2),
    "td3": lambda: trllib.TD3Config().environment("Pendulum").training(
        num_steps_sampled_before_learning_starts=64, train_batch_size=16,
        updates_per_step=2),
    "sac": lambda: trllib.SACConfig().environment("Pendulum").training(
        num_steps_sampled_before_learning_starts=64, train_batch_size=16,
        updates_per_step=2),
    "cql": lambda: trllib.CQLConfig().environment("Pendulum").offline_data(
        dataset=_offline()).training(train_batch_size=16,
                                           updates_per_step=2),
}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_local_train_iteration(name):
    algo = ALGOS[name]().training(model=dict(MODEL)).learners(
        device="cpu").debugging(seed=1).build_algo()
    learner = algo.learner_group.learner
    before = _leaves(learner.get_weights())
    result = algo.train()
    assert algo.iteration == 1 and result["training_iteration"] == 1
    after = _leaves(learner.get_weights())
    assert any(not np.array_equal(x, y) for x, y in zip(before, after))
    metrics = [v for k, v in result.items() if isinstance(v, float)
               and k not in ("episode_return_mean", "time_this_iter_s")]
    assert metrics and np.isfinite(metrics).all(), result
    algo.stop()


def test_checkpoint_roundtrip_keeps_replay_and_targets(tmp_path):
    def build():
        return ALGOS["dqn_per"]().training(model=dict(MODEL)).learners(
            device="cpu").debugging(seed=1).build_algo()

    a = build()
    a.train()
    a.save_checkpoint(str(tmp_path))
    b = build()
    b.load_checkpoint(str(tmp_path))
    sa, sb_ = a.learner_group.get_state(), b.learner_group.get_state()
    for x, y in zip(_leaves(sa), _leaves(sb_)):
        np.testing.assert_array_equal(x, y)
    assert b._env_steps == a._env_steps > 0
    np.testing.assert_array_equal(b.replay._priorities, a.replay._priorities)
    assert b.replay._max_priority == a.replay._max_priority


def test_runs_on_cuda_by_default():
    assert trllib.DQNConfig().device == "cuda"
    spec = trlm.RLModuleSpec(trlm.SACModule, 3, 1, dict(MODEL, **BOX))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsac.SACLearner(spec, {"seed": 0})


def test_sac_exploration_still_draws_from_the_runner():
    """The runner's exploration path draws its own eps (no seam): two
    generators with one seed give one sample, in the bounds."""
    m = trlm.RLModuleSpec(trlm.SACModule, 3, 1, dict(MODEL, **BOX)).build(
        device="cpu")
    obs = torch.from_numpy(np.random.RandomState(0).randn(64, 3).astype(
        np.float32))
    with torch.no_grad():
        a = m.forward_exploration(obs, torch.Generator().manual_seed(3))
        b = m.forward_exploration(obs, torch.Generator().manual_seed(3))
        eps = torch.randn((64, 1), generator=torch.Generator().manual_seed(3))
        c = m.sample_action(obs, eps=eps)
    assert torch.equal(a["actions"], b["actions"])
    assert torch.equal(a["actions"], c[0])
    assert float(a["actions"].abs().max()) <= 2.0
