"""PyTorch port, QMIX (`ray_tpu_torch.rllib.algorithms.qmix`) against the
JAX package, on the CPU, and the host copy of Tune's `Trainable`.

Nano sizes: CoopPress (2 agents, 2-dim observations, 2 actions), a
16-wide agent net, 16-wide hypernetworks, an 8-wide mixer, batches of 16.
The JAX QMIX is built once per module (its jitted update compiles once)
and reset to its first state before each case; its numpy trees and
Adam's count and moments (read out of optax's state) cross into the
port with `qmix_from_jax`, with the target moved off the online weights
(``0.9 t + 0.01``). Held to JAX on the same inputs:

- the agent utilities and the mixer within 1e-6 + 1e-5 |JAX|;
- the TD loss and its metrics within 1e-6 + 1e-5 |JAX|, its gradients
  within 1e-5 (|JAX| + max |JAX| of the leaf);
- one and two updates with the soft target sync: weights and targets
  within ``UPDATE_ATOL = 0.01 * LR`` per update (Adam's first steps move
  a weight by about ``lr * sign(g)``), Adam's moments within 1e-6 +
  1e-4 |JAX|;
- a JAX state after two updates resuming in the port;
- ε-greedy actions and greedy evaluation, exactly (numpy draws);
- one whole ``step()`` (rollout, replay, updates, syncs).

Held to the port itself: the mixer is monotone (every ∂Q_tot/∂Q_a >= 0)
and a mixer without ``abs`` is caught; checkpoints round-trip; remote
collectors raise the A14e error. No learning loop runs here: chip_smoke's
``rllib-c`` phase trains QMIX on the card.

The gpu case (the default device is the card) runs on the card, where
there is no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_qmix.py -q
"""

import faulthandler
import inspect
from unittest import mock

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib.algorithms import qmix as jqmix
    from ray_tpu.rllib.env.multi_agent_env import CoopPress as JCoopPress
    from ray_tpu.rllib.utils import replay_buffers as jrb
    from ray_tpu.tune import trainable as jtrainable
except ImportError:
    jax = None

from ray_tpu_torch import rllib as trllib
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.rllib.algorithms import qmix as tqmix
from ray_tpu_torch.rllib.core.rl_module import tree_leaves
from ray_tpu_torch.rllib.env.multi_agent_env import CoopPress as TCoopPress

LR = 5e-3
UPDATE_ATOL = 0.01 * LR
TAU = 0.3
BATCH = 16
NANO = dict(agent_hidden=(16,), mixing_embed_dim=8, hypernet_hidden=16,
            train_batch_size=BATCH, rollout_fragment_length=32,
            num_steps_sampled_before_learning_starts=32, updates_per_step=2,
            lr=LR, epsilon_decay_steps=64)


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
    """optax's ScaleByAdamState inside chain(clip, adam)'s state, as the
    port's ``{"count", "mu", "nu"}``."""
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


def _grad_close(got, want):
    """A gradient leaf within 1e-5 (|JAX| + max |JAX| of the leaf): each
    element sums the batch's terms, so its f32 rounding scales with the
    largest of them, not with the sum."""
    _close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
           msg="grads")


def _configs(seed=0):
    j = (jqmix.QMIXConfig().environment(JCoopPress,
                                        env_config={"episode_len": 8})
         .training(**NANO).debugging(seed=seed))
    t = (tqmix.QMIXConfig().environment(TCoopPress,
                                        env_config={"episode_len": 8})
         .training(**NANO).learners(device="cpu").debugging(seed=seed))
    return j, t


@pytest.fixture(scope="module")
def jax_qmix():
    """One JAX QMIX (its update and act functions compile once) and its
    first state, target moved off the online weights. Its init draws from
    numpy (eagerly each of JAX's random draws compiles its own program,
    ~7 s in all); the weights cross into the port anyway."""
    rs = np.random.RandomState(0)

    def normal(key, shape=(), dtype=float):
        return jnp.asarray(rs.standard_normal(shape), jnp.float32)

    with mock.patch.object(jax.random, "normal", normal):
        jq = _configs()[0].build_algo()
    jq.target_params = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01,
                                              jq.target_params)
    return jq, (jq.params, jq.target_params, jq.opt_state)


@pytest.fixture
def pair(jax_qmix):
    """(JAX QMIX reset to its first state: weights, optimizer, replay,
    exploration draws, env and counters; port QMIX on the same
    numbers)."""
    jq, (params, target, opt) = jax_qmix
    jq.params, jq.target_params, jq.opt_state = params, target, opt
    jq._replay = jrb.ReplayBuffer(jq.config.replay_buffer_capacity, seed=0)
    jq._explore_rng = np.random.default_rng(0)
    jq._env_steps = jq._iteration = 0
    jq._recent_team_returns = []
    jq._obs, _ = jq.env.reset(seed=0)
    jq._episode_return = 0.0
    tq = _configs()[1].build_algo()
    tqmix.qmix_from_jax(tq, _np(params), _np(target), _adam(opt))
    return jq, tq


def _batch(n=BATCH, seed=0):
    """A seeded joint-transition batch of CoopPress's spaces."""
    rng = np.random.RandomState(seed)
    return {"obs": rng.randn(n, 2, 2).astype(np.float32),
            "actions": rng.randint(0, 2, (n, 2)).astype(np.int32),
            "rewards": rng.randn(n).astype(np.float32),
            "next_obs": rng.randn(n, 2, 2).astype(np.float32),
            "dones": (rng.rand(n) < 0.2).astype(np.float32)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _state_close(tq, jq, atol):
    ts = tq.get_state()
    for g, w in zip(_leaves(ts["params"]), _leaves(_np(jq.params))):
        _close(g, w, rtol=0, atol=atol, msg="params")
    for g, w in zip(_leaves(ts["target_params"]),
                    _leaves(_np(jq.target_params))):
        _close(g, w, rtol=0, atol=atol, msg="target")
    ja = _adam(jq.opt_state)
    assert ts["opt_state"]["count"] == ja["count"]
    for k in ("mu", "nu"):
        for g, w in zip(_leaves(ts["opt_state"][k]), _leaves(ja[k])):
            _close(g, w, rtol=1e-4, atol=1e-6, msg=k)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def test_param_tree_matches_jax_layout(pair):
    jq, tq = pair
    jt, tt = _np(jq.params), tq.get_state()["params"]
    assert jax.tree_util.tree_structure(jt) == \
        jax.tree_util.tree_structure(tt)
    for g, w in zip(_leaves(tt), _leaves(jt)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_agent_qs_match_jax(pair, seed):
    jq, tq = pair
    obs = np.random.RandomState(seed).randn(8, 2, 2).astype(np.float32)
    want = np.stack([np.asarray(jq._agent_qs(jq.params, o)) for o in obs])
    with torch.no_grad():
        got = tq.module.agent_qs(_t(obs)).numpy()
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixer_matches_jax(pair, seed):
    jq, tq = pair
    rng = np.random.RandomState(seed)
    q = rng.randn(16, 2).astype(np.float32)
    state = rng.randn(16, 4).astype(np.float32)
    want = np.asarray(jq._mix(jq.params, q, state))
    with torch.no_grad():
        got = tq.module.mix(_t(q), _t(state)).numpy()
    _close(got, want)


def _dq_tot(module, seed=3):
    """∂Q_tot/∂Q_a of every row and agent on seeded inputs."""
    rng = np.random.RandomState(seed)
    q = _t(rng.randn(64, 2).astype(np.float32)).requires_grad_(True)
    state = _t(rng.randn(64, 4).astype(np.float32))
    return torch.autograd.grad(module.mix(q, state).sum(), q)[0]


def test_mixer_is_monotone_and_no_abs_is_caught(pair):
    """Every ∂Q_tot/∂Q_a >= 0 (what makes per-agent argmax the joint
    argmax); a mixer whose hypernetwork weights skip ``abs`` fails the
    same check."""
    _, tq = pair
    assert (_dq_tot(tq.module) >= 0).all()
    with mock.patch.object(tqmix.torch, "abs", lambda x: x):
        assert (_dq_tot(tq.module) < 0).any()


# ---------------------------------------------------------------------------
# Learning
# ---------------------------------------------------------------------------

def test_loss_metrics_and_grads_match_jax(pair):
    jq, tq = pair
    batch = _batch()
    jb = dict(batch, target_params=jq.target_params)
    (loss, jm), jg = jax.jit(jax.value_and_grad(jq._loss, has_aux=True))(
        jq.params, jb)
    tg, tm = tq._grads(batch)
    _close(float(tm["td_loss"]), float(loss))
    for k in jm:
        _close(float(tm[k]), float(jm[k]), msg=k)
    for g, w in zip(tg, _leaves(_np(jg))):
        _grad_close(g.numpy(), w)


@pytest.mark.parametrize("n", [1, 2])
def test_updates_with_target_sync_match_jax(pair, n):
    jq, tq = pair
    for i in range(n):
        b = _batch(seed=10 + i)
        jm = jq._update(b)
        jq._sync_target(TAU)
        tm = tq._update(b)
        tq._sync_target(TAU)
        for k in jm:
            _close(float(tm[k]), jm[k], msg=k)
    _state_close(tq, jq, UPDATE_ATOL * n)


def test_jax_state_resumes_in_port(pair):
    """A JAX state after two updates and syncs (Adam's count 2), carried
    into a fresh port QMIX, gives the next update JAX takes."""
    jq, _ = pair
    for i in range(2):
        jq._update(_batch(seed=20 + i))
        jq._sync_target(TAU)
    tq = _configs()[1].build_algo()
    tqmix.qmix_from_jax(tq, _np(jq.params), _np(jq.target_params),
                        _adam(jq.opt_state))
    assert tq.get_state()["opt_state"]["count"] == 2
    b = _batch(seed=22)
    jm = jq._update(b)
    tm = tq._update(b)
    for k in jm:
        _close(float(tm[k]), jm[k], msg=k)
    _state_close(tq, jq, UPDATE_ATOL)


@pytest.mark.parametrize("eps", [0.0, 0.5, 1.0])
def test_epsilon_greedy_actions_match_jax(pair, eps):
    jq, tq = pair
    rng = np.random.RandomState(4)
    for _ in range(20):
        obs = {a: rng.randn(2).astype(np.float32) for a in ("a0", "a1")}
        assert tq._act(obs, eps) == jq._act(obs, eps)
    assert tq._explore_rng.random() == jq._explore_rng.random()


def test_greedy_evaluation_matches_jax(pair):
    jq, tq = pair
    assert tq.evaluate(4) == jq.evaluate(4)


def test_step_matches_jax(pair):
    """One whole step on equal state (a 32-step rollout into replay, two
    updates and syncs): the rollout, the replay, the metrics and the
    weights."""
    jq, tq = pair
    jr, tr = jq.step(), tq.step()
    assert sorted(jr) == sorted(tr)
    for k in jr:
        _close(tr[k], jr[k], msg=k)
    for k, v in jq._compact_replay().items():
        np.testing.assert_array_equal(tq._compact_replay()[k], v, k)
    assert tq._env_steps == jq._env_steps == 32
    _state_close(tq, jq, UPDATE_ATOL * 2)


# ---------------------------------------------------------------------------
# State, configuration and device
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(pair, tmp_path):
    _, tq = pair
    tq.step()
    tq._update(_batch())
    before = tq.get_state()
    tq.save_checkpoint(str(tmp_path))
    tq2 = _configs()[1].build_algo()
    tq2.load_checkpoint(str(tmp_path))
    after = tq2.get_state()
    for part in ("params", "target_params"):
        for g, w in zip(_leaves(after[part]), _leaves(before[part])):
            np.testing.assert_array_equal(g, w)
    assert after["opt_state"]["count"] == before["opt_state"]["count"] == 3
    for k in ("mu", "nu"):
        for g, w in zip(_leaves(after["opt_state"][k]),
                        _leaves(before["opt_state"][k])):
            np.testing.assert_array_equal(g, w)
    assert len(tq2._replay) == len(tq._replay) == 32
    assert tq2._env_steps == 32
    assert tq2.step()["num_env_steps_total"] == 64


def test_remote_collectors_raise_a14e():
    cfg = _configs()[1].env_runners(num_env_runners=2)
    with pytest.raises(NotImplementedError, match="A14e"):
        cfg.build_algo()
    with pytest.raises(NotImplementedError, match="A14e"):
        tqmix.QMIXRolloutWorker({}, 1)


def test_trainable_is_jax_class_api():
    """The host copy of Tune's class API: the same methods and
    signatures as JAX's ``Trainable``, ``train`` counting iterations,
    and QMIX and AlphaZero built through it."""
    names = ("__init__", "setup", "step", "save_checkpoint",
             "load_checkpoint", "reset_config", "cleanup", "train")
    for name in names:
        assert inspect.signature(getattr(ttune.Trainable, name)) == \
            inspect.signature(getattr(jtrainable.Trainable, name)), name

    class Count(ttune.Trainable):
        def setup(self, config):
            self.seen = dict(config)

        def step(self):
            return {"i": self.iteration}

    c = Count({"a": 1})
    assert c.seen == {"a": 1}
    assert [c.train()["i"] for _ in range(3)] == [0, 1, 2]
    assert c.iteration == 3 and c.reset_config({}) is False
    assert issubclass(trllib.QMIX, ttune.Trainable)
    assert issubclass(trllib.AlphaZero, ttune.Trainable)


def test_runs_on_cuda_by_default():
    assert trllib.QMIXConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trllib.QMIXConfig().environment(TCoopPress).build_algo()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_builds_on_the_card_by_default(card):
    tq = trllib.QMIXConfig().environment(TCoopPress).build_algo()
    assert tq.device.type == "cuda"
    assert {p.device.type for p in tq.module.parameters()} == {"cuda"}
    assert np.isfinite(tq.step()["num_env_steps_total"])
