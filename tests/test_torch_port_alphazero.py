"""PyTorch port, AlphaZero (`ray_tpu_torch.rllib.algorithms.alphazero`)
against the JAX package, on the CPU.

Nano sizes: TicTacToe, a 16 x 16 torso, 8 simulations a move, 2 games
and 2 updates of 16 rows an iteration. The JAX AlphaZero is built once
per module (its jitted update compiles once) and reset to its first
state before each case; its numpy params and Adam's count and moments
(read out of optax's state) cross into the port with
`alphazero_from_jax`. Held to JAX on the same inputs:

- the game's rules on random playouts, exactly;
- the net's logits and value, and the predictor's priors and value,
  within 1e-6 + 1e-5 |JAX|; the transposition cache;
- the loss and its metrics within 1e-6 + 1e-5 |JAX|, its gradients
  within 1e-5 (|JAX| + max |JAX| of the leaf);
- one and two updates: weights within ``UPDATE_ATOL = 0.01 * LR`` per
  update, Adam's moments within 1e-6 + 1e-4 |JAX|; a JAX state after
  two updates resuming in the port;
- MCTS visit counts, values and priors, and `_play_one_game`'s rows,
  exactly, with both searches driven by one numpy predictor (the
  Dirichlet noise and the move draws come from numpy in both);
- one whole ``step()`` (self-play on that predictor, then updates on
  the nets), and ``play_vs_random`` on the nets.

Held to the port itself: a value head without ``tanh`` is caught by the
forward gate; checkpoints round-trip; distributed self-play raises the
A14e error. No learning loop runs here: chip_smoke's ``rllib-c`` phase
trains AlphaZero on the card.

The gpu case (the default device is the card) runs on the card, where
there is no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_alphazero.py -q
"""

import faulthandler
from unittest import mock

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib.algorithms import alphazero as jaz
    from ray_tpu.rllib.utils import replay_buffers as jrb
except ImportError:
    jax = None

from ray_tpu_torch import rllib as trllib
from ray_tpu_torch.rllib.algorithms import alphazero as taz
from ray_tpu_torch.rllib.core.rl_module import _mlp_apply, tree_leaves

LR = 3e-3
UPDATE_ATOL = 0.01 * LR
NANO = dict(num_simulations=8, games_per_iteration=2,
            updates_per_iteration=2, train_batch_size=16, lr=LR,
            model={"fcnet_hiddens": (16, 16)})


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


def _configs(seed=0):
    return (jaz.AlphaZeroConfig().training(**NANO).debugging(seed=seed),
            taz.AlphaZeroConfig().training(**NANO).learners(device="cpu")
            .debugging(seed=seed))


class _NumpyPredictor:
    """One deterministic numpy predictor for both searches: priors a
    softmax of a fixed linear map of the board, value a tanh."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.w = rng.randn(9, 9).astype(np.float32)
        self.v = rng.randn(9).astype(np.float32)
        self.calls = 0

    def set_params(self, params):
        pass

    def __call__(self, state):
        self.calls += 1
        logits = state @ self.w
        p = np.exp(logits - logits.max())
        return (p / p.sum()).astype(np.float32), float(np.tanh(state @ self.v))


@pytest.fixture(scope="module")
def jax_az():
    """One JAX AlphaZero (its update compiles once) and its first state.
    Its init draws from numpy (eagerly each of JAX's random draws
    compiles its own program); the weights cross into the port anyway."""
    rs = np.random.RandomState(0)

    def normal(key, shape=(), dtype=float):
        return jnp.asarray(rs.standard_normal(shape), jnp.float32)

    with mock.patch.object(jax.random, "normal", normal):
        ja = _configs()[0].build_algo()
    ja._predictor(np.zeros(9, np.float32))     # compiles its forward
    return ja, (ja.params, ja.opt_state, ja._predictor._fn)


@pytest.fixture
def pair(jax_az):
    """(JAX AlphaZero reset to its first state: weights, optimizer,
    replay, numpy draws and counters; port AlphaZero on the same
    numbers)."""
    ja, (params, opt, predict_fn) = jax_az
    ja.params, ja.opt_state = params, opt
    ja._replay = jrb.ReplayBuffer(ja.config.replay_buffer_capacity, seed=0)
    ja._rng = np.random.default_rng(0)
    ja._games_played = ja._iteration = 0
    ja._predictor = jaz._NetPredictor(jaz._az_forward)
    ja._predictor._fn = predict_fn
    ja._predictor.set_params(params)
    ta = _configs()[1].build_algo()
    taz.alphazero_from_jax(ta, _np(params), _adam(opt))
    return ja, ta


def _batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(9), n).astype(np.float32)
    return {"obs": rng.randint(-1, 2, (n, 9)).astype(np.float32), "pi": pi,
            "z": rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _state_close(ta, ja, atol):
    ts = ta.get_state()
    for g, w in zip(_leaves(ts["params"]), _leaves(_np(ja.params))):
        _close(g, w, rtol=0, atol=atol, msg="params")
    jad = _adam(ja.opt_state)
    assert ts["opt_state"]["count"] == jad["count"]
    for k in ("mu", "nu"):
        for g, w in zip(_leaves(ts["opt_state"][k]), _leaves(jad[k])):
            _close(g, w, rtol=1e-4, atol=1e-6, msg=k)


def _boards(n, seed):
    """Boards from random legal playouts."""
    g, rng, out = taz.TicTacToe(), np.random.RandomState(seed), []
    while len(out) < n:
        s = g.initial_state()
        while g.terminal_value(s) is None and len(out) < n:
            out.append(s.copy())
            s = g.next_state(s, int(rng.choice(g.legal_actions(s))))
    return np.stack(out)


# ---------------------------------------------------------------------------
# Game, net and predictor
# ---------------------------------------------------------------------------

def test_tictactoe_matches_jax():
    jg, tg = jaz.TicTacToe(), taz.TicTacToe()
    rng = np.random.RandomState(0)
    for _ in range(30):
        s = tg.initial_state()
        np.testing.assert_array_equal(s, jg.initial_state())
        while True:
            assert tg.terminal_value(s) == jg.terminal_value(s)
            if tg.terminal_value(s) is not None:
                break
            legal = tg.legal_actions(s)
            np.testing.assert_array_equal(legal, jg.legal_actions(s))
            a = int(rng.choice(legal))
            s2 = tg.next_state(s, a)
            np.testing.assert_array_equal(s2, jg.next_state(s, a))
            s = s2


def test_param_tree_matches_jax_layout(pair):
    ja, ta = pair
    jt, tt = _np(ja.params), ta.get_state()["params"]
    assert jax.tree_util.tree_structure(jt) == \
        jax.tree_util.tree_structure(tt)
    for g, w in zip(_leaves(tt), _leaves(jt)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(pair, seed):
    ja, ta = pair
    obs = _boards(24, seed)
    jl, jv = ja._forward(ja.params, obs)
    with torch.no_grad():
        tl, tv = ta.module(_t(obs))
    _close(tl.numpy(), np.asarray(jl), msg="logits")
    _close(tv.numpy(), np.asarray(jv), msg="value")


def test_predictor_matches_jax_and_caches(pair):
    ja, ta = pair
    for s in _boards(12, 2):
        jp, jv = ja._predictor(s)
        tp, tv = ta._predictor(s)
        assert tp.dtype == np.float32 and isinstance(tv, float)
        _close(tp, jp, msg="priors")
        _close(tv, jv, msg="value")
        assert ta._predictor(s) is ta._predictor(s)
    assert len(ta._predictor._cache) == len(ja._predictor._cache) > 0
    ta._update(_batch())
    assert not ta._predictor._cache


def _no_tanh_forward(self, obs):
    """A planted fault: the value head without ``tanh``."""
    feat = _mlp_apply(self.torso, obs, final_activation=True)
    return _mlp_apply(self.pi, feat), _mlp_apply(self.v, feat)[..., 0]


def test_value_head_without_tanh_is_caught(pair):
    ja, ta = pair
    obs = _boards(24, 3)
    _, jv = ja._forward(ja.params, obs)
    with mock.patch.object(taz.AlphaZeroModule, "forward",
                           _no_tanh_forward), torch.no_grad():
        _, tv = ta.module(_t(obs))
    with pytest.raises(AssertionError):
        _close(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# Learning
# ---------------------------------------------------------------------------

def test_loss_metrics_and_grads_match_jax(pair):
    ja, ta = pair
    batch = _batch()
    (loss, jm), jg = jax.jit(jax.value_and_grad(ja._loss, has_aux=True))(
        ja.params, batch)
    tg, tm = ta._grads(batch)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), msg=k)
    _close(float(tm["policy_loss"] + tm["value_loss"]), float(loss))
    for g, w in zip(tg, _leaves(_np(jg))):
        _close(g.numpy(), w, atol=1e-5 * float(np.abs(w).max()),
               msg="grads")


@pytest.mark.parametrize("n", [1, 2])
def test_updates_match_jax(pair, n):
    ja, ta = pair
    for i in range(n):
        b = _batch(seed=10 + i)
        jm, tm = ja._update(b), ta._update(b)
        for k in jm:
            _close(float(tm[k]), jm[k], msg=k)
    _state_close(ta, ja, UPDATE_ATOL * n)


def test_jax_state_resumes_in_port(pair):
    ja, _ = pair
    for i in range(2):
        ja._update(_batch(seed=20 + i))
    ta = _configs()[1].build_algo()
    taz.alphazero_from_jax(ta, _np(ja.params), _adam(ja.opt_state))
    b = _batch(seed=22)
    jm, tm = ja._update(b), ta._update(b)
    for k in jm:
        _close(float(tm[k]), jm[k], msg=k)
    _state_close(ta, ja, UPDATE_ATOL)


# ---------------------------------------------------------------------------
# Search and self-play
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise", [True, False])
def test_mcts_visit_counts_equal(noise):
    cfg = _configs()[1]
    pj, pt = _NumpyPredictor(1), _NumpyPredictor(1)
    jm = jaz._MCTS(jaz.TicTacToe(), pj, cfg, np.random.default_rng(5))
    tm = taz._MCTS(taz.TicTacToe(), pt, cfg, np.random.default_rng(5))
    s = taz.TicTacToe().initial_state()
    for a in (4, 0, 8):
        np.testing.assert_array_equal(tm.policy(s, noise),
                                      jm.policy(s, noise))
        s = taz.TicTacToe().next_state(s, a)
    assert pt.calls == pj.calls > 0
    for d in ("N", "W", "P"):
        want, got = getattr(jm, d), getattr(tm, d)
        assert list(got) == list(want), d
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], d)


@pytest.mark.parametrize("seed", [0, 1])
def test_play_one_game_rows_equal(seed):
    cfg = _configs()[1]
    jr = jaz._play_one_game(jaz.TicTacToe(), _NumpyPredictor(seed), cfg,
                            np.random.default_rng(seed))
    tr = taz._play_one_game(taz.TicTacToe(), _NumpyPredictor(seed), cfg,
                            np.random.default_rng(seed))
    assert len(tr) == len(jr) >= 5
    for (to, tp, tz), (jo, jp, jz) in zip(tr, jr):
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tp, jp)
        assert tz == jz and tz.dtype == jz.dtype


def test_step_matches_jax(pair):
    """One whole step: self-play on one numpy predictor (two games into
    replay, equal rows), then two updates on the nets."""
    ja, ta = pair
    ja._predictor, ta._predictor = _NumpyPredictor(2), _NumpyPredictor(2)
    for _ in range(3):      # fill replay past one batch
        jr, tr = ja.step(), ta.step()
    assert sorted(jr) == sorted(tr)
    for k in jr:
        _close(tr[k], jr[k], msg=k)
    for k, v in ja._replay._cols.items():
        np.testing.assert_array_equal(ta._replay._cols[k], v, k)
    assert tr["games_played"] == 6 and "policy_loss" in tr
    _state_close(ta, ja, UPDATE_ATOL * ta.opt.count)


def test_play_vs_random_matches_jax(pair):
    ja, ta = pair
    assert ta.play_vs_random(4, simulations=4) == \
        ja.play_vs_random(4, simulations=4)


# ---------------------------------------------------------------------------
# State, configuration and device
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(pair, tmp_path):
    _, ta = pair
    ta._update(_batch())
    ta._games_played, ta._iteration = 5, 2
    before = ta.get_state()
    ta.save_checkpoint(str(tmp_path))
    ta2 = _configs()[1].build_algo()
    ta2.load_checkpoint(str(tmp_path))
    after = ta2.get_state()
    for g, w in zip(_leaves(after["params"]), _leaves(before["params"])):
        np.testing.assert_array_equal(g, w)
    assert after["opt_state"]["count"] == 1
    for k in ("mu", "nu"):
        for g, w in zip(_leaves(after["opt_state"][k]),
                        _leaves(before["opt_state"][k])):
            np.testing.assert_array_equal(g, w)
    assert (ta2._games_played, ta2._iteration) == (5, 2)
    s = np.zeros(9, np.float32)
    _close(ta2._predictor(s)[0], ta._predictor(s)[0], rtol=0, atol=0)


def test_distributed_self_play_raises_a14e():
    with pytest.raises(NotImplementedError, match="A14e"):
        _configs()[1].env_runners(num_env_runners=2).build_algo()
    with pytest.raises(NotImplementedError, match="A14e"):
        taz.AlphaZeroSelfPlayWorker({}, 1)


def test_runs_on_cuda_by_default():
    assert trllib.AlphaZeroConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trllib.AlphaZeroConfig().build_algo()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_builds_on_the_card_by_default(card):
    ta = trllib.AlphaZeroConfig().training(**NANO).build_algo()
    assert ta.device.type == "cuda"
    assert {p.device.type for p in ta.module.parameters()} == {"cuda"}
    priors, value = ta._predictor(np.zeros(9, np.float32))
    assert priors.shape == (9,) and abs(value) <= 1.0
