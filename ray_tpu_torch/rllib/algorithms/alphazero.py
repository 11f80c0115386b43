"""AlphaZero — self-play MCTS with a learned policy/value net.

Port of `ray_tpu/rllib/algorithms/alphazero.py` (reference:
rllib_contrib alpha_zero, Silver et al. 2017: PUCT tree search guided
by a policy/value network, trained from self-play targets — visit-count
policies pi and game outcomes z).

The game (`TicTacToe`), the search (`_MCTS`) and the self-play rules
(`_play_one_game`) are host copies of the JAX package's numpy code,
unchanged in behaviour. The policy/value net (`AlphaZeroModule`, named
as JAX's tree) lives on ``config.device`` ("cuda" unless set to
"cpu"). The search evaluates one leaf at a time through `_NetPredictor`:
one forward and one device -> host copy (priors and value together) per
uncached state, so it is latency-bound on any card. An update is
cross-entropy(policy, pi) + MSE(value, z), then optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))`` (`Adam`).
Distributed self-play (``num_env_runners > 0``) is not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib._unported import unported
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (Adam, _tensor, scalars,
                                              to_tensors)
from ray_tpu_torch.rllib.core.rl_module import (_mlp, _mlp_apply,
                                                params_from_numpy,
                                                params_to_numpy)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch
from ray_tpu_torch.tune.trainable import Trainable


class TicTacToe:
    """Two-player zero-sum board game in canonical form: the
    observation always shows +1 for the player TO MOVE. Any game
    exposing this interface plugs in."""

    n_actions = 9
    obs_dim = 9

    def initial_state(self) -> np.ndarray:
        return np.zeros(9, np.float32)

    def legal_actions(self, state: np.ndarray) -> np.ndarray:
        return np.nonzero(state == 0)[0]

    def next_state(self, state: np.ndarray, action: int) -> np.ndarray:
        """Apply the move for the player to move, then flip the canonical
        view so the opponent becomes +1."""
        nxt = state.copy()
        nxt[action] = 1.0
        return -nxt

    def terminal_value(self, state: np.ndarray) -> Optional[float]:
        """From the perspective of the player TO MOVE: -1 if the
        opponent (who just moved) won, 0 draw, None if not terminal."""
        b = state.reshape(3, 3)
        lines = list(b) + list(b.T) + [np.diag(b), np.diag(b[:, ::-1])]
        for line in lines:
            if line.sum() == -3:
                return -1.0  # opponent completed a line
        if (state != 0).all():
            return 0.0
        return None


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.game: Any = TicTacToe
        self.num_simulations: int = 32     # MCTS sims per move
        self.c_puct: float = 1.5
        self.dirichlet_alpha: float = 0.6
        self.dirichlet_eps: float = 0.25
        self.temperature_moves: int = 4    # sample pi early, argmax after
        self.games_per_iteration: int = 8
        self.replay_buffer_capacity: int = 20_000
        self.train_batch_size = 128
        self.updates_per_iteration: int = 8
        self.value_loss_coeff: float = 1.0
        self.lr = 3e-3

    @property
    def algo_class(self):
        return AlphaZero


class _MCTS:
    """PUCT search over canonical states. Node key = state bytes."""

    def __init__(self, game, predict, cfg, rng):
        self.game = game
        self.predict = predict     # state [obs] -> (priors [A], value)
        self.cfg = cfg
        self.rng = rng
        self.P: Dict[bytes, np.ndarray] = {}
        self.N: Dict[bytes, np.ndarray] = {}
        self.W: Dict[bytes, np.ndarray] = {}

    def _apply_root_noise(self, state: np.ndarray, key: bytes) -> None:
        """Fresh Dirichlet noise on the CURRENT root's priors — every
        move, not just on first expansion (with tree reuse across moves
        the root is usually already expanded by the previous search)."""
        legal = self.game.legal_actions(state)
        if not len(legal):
            return
        priors = self.P[key]
        noise = np.zeros(self.game.n_actions, np.float32)
        noise[legal] = self.rng.dirichlet(
            [self.cfg.dirichlet_alpha] * len(legal))
        self.P[key] = (1 - self.cfg.dirichlet_eps) * priors + \
            self.cfg.dirichlet_eps * noise

    def policy(self, state: np.ndarray, add_noise: bool) -> np.ndarray:
        if add_noise and state.tobytes() in self.P:
            self._apply_root_noise(state, state.tobytes())
        for _ in range(self.cfg.num_simulations):
            self._simulate(state.copy(), root=state.tobytes(),
                           add_noise=add_noise)
        n = self.N[state.tobytes()]
        total = n.sum()
        if total == 0:
            legal = self.game.legal_actions(state)
            pi = np.zeros(self.game.n_actions, np.float32)
            pi[legal] = 1.0 / len(legal)
            return pi
        return (n / total).astype(np.float32)

    def _expand(self, state: np.ndarray, key: bytes,
                add_noise: bool) -> float:
        priors, value = self.predict(state)
        legal = self.game.legal_actions(state)
        mask = np.zeros(self.game.n_actions, np.float32)
        mask[legal] = 1.0
        priors = priors * mask
        s = priors.sum()
        priors = priors / s if s > 0 else mask / mask.sum()
        if add_noise and len(legal):
            noise = np.zeros(self.game.n_actions, np.float32)
            noise[legal] = self.rng.dirichlet(
                [self.cfg.dirichlet_alpha] * len(legal))
            priors = (1 - self.cfg.dirichlet_eps) * priors + \
                self.cfg.dirichlet_eps * noise
        self.P[key] = priors
        self.N[key] = np.zeros(self.game.n_actions, np.float32)
        self.W[key] = np.zeros(self.game.n_actions, np.float32)
        return float(value)

    def _simulate(self, state: np.ndarray, root: bytes,
                  add_noise: bool) -> None:
        path: List[Tuple[bytes, int]] = []
        value = None
        while True:
            key = state.tobytes()
            term = self.game.terminal_value(state)
            if term is not None:
                value = term
                break
            if key not in self.P:
                value = self._expand(state, key,
                                     add_noise and key == root)
                break
            p, n, w = self.P[key], self.N[key], self.W[key]
            q = np.where(n > 0, w / np.maximum(n, 1), 0.0)
            u = self.cfg.c_puct * p * np.sqrt(n.sum() + 1) / (1 + n)
            scores = q + u
            legal = self.game.legal_actions(state)
            action = legal[np.argmax(scores[legal])]
            path.append((key, int(action)))
            state = self.game.next_state(state, int(action))
        # Backup: value is from the LEAF player's perspective; each step
        # up the tree flips sides.
        for key, action in reversed(path):
            value = -value
            self.N[key][action] += 1
            self.W[key][action] += value


class AlphaZeroModule(nn.Module):
    """Policy/value net: torso MLP (with its final activation), a
    policy head, and ``tanh`` on the value head; named as JAX's tree."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = tuple(hidden)
        self.torso = _mlp((obs_dim,) + hidden, generator)
        self.pi = _mlp((hidden[-1], n_actions), generator)
        self.v = _mlp((hidden[-1], 1), generator)

    def forward(self, obs: torch.Tensor):
        """obs [..., obs_dim] -> (logits [..., A], value [...])."""
        feat = _mlp_apply(self.torso, obs, final_activation=True)
        logits = _mlp_apply(self.pi, feat)
        value = torch.tanh(_mlp_apply(self.v, feat))[..., 0]
        return logits, value


class _NetPredictor:
    """Softmax + transposition cache around the net: one forward and
    one device -> host copy per uncached state."""

    # FIFO eviction bound: TicTacToe never gets near it, but a long
    # self-play run of a bigger game must not keep every state.
    CACHE_MAX = 100_000

    def __init__(self, module: Optional[nn.Module] = None):
        self._module = module
        self._cache: Dict[bytes, tuple] = {}

    def set_params(self, module: nn.Module) -> None:
        """The net to evaluate (its weights changed): clears the cache."""
        self._module = module
        self._cache.clear()

    def __call__(self, state: np.ndarray):
        key = state.tobytes()
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        device = next(self._module.parameters()).device
        with torch.no_grad():
            logits, value = self._module(_tensor(state, device)[None])
            host = torch.cat([torch.softmax(logits, -1)[0],
                              value]).cpu().numpy()
        out = (host[:-1], float(host[-1]))
        while len(self._cache) >= self.CACHE_MAX:
            del self._cache[next(iter(self._cache))]
        self._cache[key] = out
        return out


def _play_one_game(game, predict, cfg, rng) -> List[tuple]:
    """One self-play game: MCTS policies as targets, outcome z walked
    back with per-move sign flips."""
    mcts = _MCTS(game, predict, cfg, rng)
    state = game.initial_state()
    history: List[Tuple[np.ndarray, np.ndarray]] = []
    rows: List[tuple] = []
    move = 0
    while True:
        term = game.terminal_value(state)
        if term is not None:
            z = term
            for obs, pi in reversed(history):
                z = -z
                rows.append((obs, pi, np.float32(z)))
            return rows
        pi = mcts.policy(state, add_noise=True)
        history.append((state.copy(), pi))
        if move < cfg.temperature_moves:
            action = int(rng.choice(len(pi), p=pi))
        else:
            action = int(np.argmax(pi))
        state = game.next_state(state, action)
        move += 1


class AlphaZeroSelfPlayWorker:
    """Remote self-play worker of the JAX package: needs the actor
    runtime."""

    def __init__(self, config: dict, worker_index: int):
        raise unported("AlphaZero with num_env_runners > 0")


class AlphaZero(Trainable):
    config_class = AlphaZeroConfig

    def setup(self, config) -> None:
        self.config = config if isinstance(config, AlphaZeroConfig) \
            else AlphaZeroConfig().update_from_dict(dict(config or {}))
        cfg = self.config
        if cfg.num_env_runners > 0:
            raise unported("AlphaZero with num_env_runners > 0")
        self.device = resolve_device(cfg.device)
        self.game = cfg.game() if isinstance(cfg.game, type) else cfg.game
        hidden = tuple(cfg.model.get("fcnet_hiddens", (64, 64))) \
            if cfg.model else (64, 64)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        self.module = AlphaZeroModule(self.game.obs_dim, self.game.n_actions,
                                      hidden, generator=gen).to(self.device)
        self.opt = Adam(self.module, cfg.lr, cfg.grad_clip)
        self._replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                    seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._iteration = 0
        self._games_played = 0
        # set_params clears the cache on every weight change.
        self._predictor = _NetPredictor(self.module)

    # ---- self-play ----

    def _self_play_game(self) -> List[tuple]:
        return _play_one_game(self.game, self._predictor, self.config,
                              self._rng)

    # ---- learning ----

    def _loss(self, batch: Dict[str, torch.Tensor]):
        logits, value = self.module(batch["obs"])
        logp = F.log_softmax(logits, -1)
        policy_loss = -(batch["pi"] * logp).sum(-1).mean()
        value_loss = ((value - batch["z"]) ** 2).mean()
        total = policy_loss + self.config.value_loss_coeff * value_loss
        return total, {"policy_loss": policy_loss.detach(),
                       "value_loss": value_loss.detach()}

    def _grads(self, batch: Dict[str, np.ndarray]):
        loss, metrics = self._loss(to_tensors(batch, self.device))
        grads = torch.autograd.grad(loss, self.opt.params, allow_unused=True,
                                    materialize_grads=True)
        return list(grads), metrics

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on the batch; the metrics stay tensors
        (the step copies them to the host once)."""
        grads, metrics = self._grads(batch)
        self.opt.step(grads)
        self._predictor.set_params(self.module)
        return metrics

    # ---- Trainable ----

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        new_rows = 0
        for _ in range(cfg.games_per_iteration):
            rows = self._self_play_game()
            self._games_played += 1
            new_rows += len(rows)
            self._replay.add(SampleBatch({
                "obs": np.stack([r[0] for r in rows]),
                "pi": np.stack([r[1] for r in rows]),
                "z": np.stack([r[2] for r in rows]),
            }))
        metrics: Dict[str, Any] = {
            "games_played": self._games_played,
            "replay_size": len(self._replay),
            "new_rows": new_rows,
        }
        if len(self._replay) >= cfg.train_batch_size:
            last: Dict[str, torch.Tensor] = {}
            for _ in range(cfg.updates_per_iteration):
                batch = dict(self._replay.sample(cfg.train_batch_size))
                last = self._update(batch)
            metrics.update(scalars(last))
        self._iteration += 1
        metrics["training_iteration"] = self._iteration
        return metrics

    # ---- state ----

    def get_state(self) -> Dict[str, Any]:
        """Weights and Adam's count and moments as numpy trees in JAX's
        layout."""
        return {"params": params_to_numpy(self.module),
                "opt_state": self.opt.state()}

    def set_state(self, state: Dict[str, Any]) -> None:
        """`get_state`'s inverse; without ``opt_state`` Adam restarts."""
        params_from_numpy(self.module, state["params"])
        self._predictor.set_params(self.module)
        if state.get("opt_state") is None:
            self.opt.reset()
        else:
            self.opt.load(state["opt_state"])

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        state = self.get_state()
        state.update(games_played=self._games_played,
                     iteration=self._iteration)
        with open(os.path.join(checkpoint_dir, "az_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "az_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.set_state(state)
        self._games_played = state["games_played"]
        self._iteration = state["iteration"]

    stop = Trainable.cleanup

    # ---- evaluation ----

    def play_vs_random(self, num_games: int = 20,
                       simulations: Optional[int] = None
                       ) -> Dict[str, float]:
        """Agent (MCTS, no noise) vs a uniform-random opponent,
        alternating who moves first. Returns win/draw/loss rates from
        the agent's perspective."""
        cfg = self.config
        sims = simulations if simulations is not None \
            else cfg.num_simulations
        wins = draws = losses = 0
        rng = np.random.default_rng(123)
        for g in range(num_games):
            mcts = _MCTS(self.game, self._predictor, cfg, rng)
            state = self.game.initial_state()
            agent_to_move = (g % 2 == 0)
            while True:
                term = self.game.terminal_value(state)
                if term is not None:
                    # term: to-move player's result. agent_to_move says
                    # whose perspective that is.
                    if term == 0:
                        draws += 1
                    elif (term < 0) == agent_to_move:
                        losses += 1
                    else:
                        wins += 1
                    break
                legal = self.game.legal_actions(state)
                if agent_to_move:
                    for _ in range(sims):
                        mcts._simulate(state.copy(),
                                       root=state.tobytes(),
                                       add_noise=False)
                    n = mcts.N[state.tobytes()]
                    action = legal[np.argmax(n[legal])]
                else:
                    action = rng.choice(legal)
                state = self.game.next_state(state, int(action))
                agent_to_move = not agent_to_move
        return {"win_rate": wins / num_games,
                "draw_rate": draws / num_games,
                "loss_rate": losses / num_games}


def alphazero_from_jax(algo: AlphaZero, params,
                       opt_state: Optional[Dict[str, Any]] = None
                       ) -> AlphaZero:
    """Carry a JAX AlphaZero's numpy ``params`` tree (and Adam's
    ``{"count", "mu", "nu"}`` read out of its optax state) into the
    port's ``algo``, in place. Returns ``algo``."""
    algo.set_state({"params": params, "opt_state": opt_state})
    return algo
