"""PyTorch port, RLlib (`ray_tpu_torch.rllib`): the core and the on-policy
and imitation algorithms against the JAX package, on the CPU.

Weights cross as numpy trees in JAX's layout (`params_from_numpy`), so
both packages compute on the same numbers (nano sizes: CartPole's 4
observations and 2 actions, 16-wide hidden layers). Held to JAX:

- each module's ``forward_train`` / ``forward_inference`` (f32, rtol
  1e-5), and the flat vector's order (``ravel_pytree``'s, exactly);
- each learner's loss, metrics and gradients on a seeded numpy batch
  (rtol 1e-5, atol 1e-6), and one ``update``. Adam's first step moves a
  weight by about ``lr * sign(g)``, so the updated weights are held to
  ``UPDATE_ATOL = 0.01 * LR``, with the global-norm clip off and on;
- the V-trace scan and advantages, ``compute_gae`` and ``standardize``;
- a greedy rollout on seeded CartPole (1 and 4 envs): the policy head
  is scaled until every sampled action is the argmax (checked on the
  rollout's observations), then observations, actions, rewards and the
  episode bookkeeping are equal and the values and log-probs close;
- ES's perturbed returns for given seeds, and one ES step;
- one ``training_step`` of every algorithm (PPO, A2C, APPO, IMPALA, BC,
  MARWIL, multi-agent PPO with a module per agent and with one shared
  module, ES) with its sampling replaced by the same fixed input in both
  packages: the same minibatches in the same order (the host-side batch
  preparation), and the weights after the step within
  ``STEP_ATOL = 0.01 * LR`` per update taken;
- a TwoAgentGrid rollout against JAX's ``MultiAgentEnvRunner``, its
  policies' heads scaled until every sampled action is the argmax;
- a two-rank gloo `update_ddp` (fresh interpreters through
  ``torch_port_helpers.rank_main``) against JAX's `compute_gradients`
  per shard, averaged, then `apply_gradients`.

Held to the port itself (its sampling does not reproduce JAX's threefry
bits): sampled actions' log-probs equal ``forward_train``'s, the action
frequencies follow the policy's probabilities, and one short local
``train()`` iteration of every algorithm runs.
"""

import faulthandler
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ray_tpu.rllib.algorithms import a2c as ja2c
from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import es as jes
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.algorithms import multi_agent_ppo as jmappo
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.core import rl_module as jrlm
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JRunner
from ray_tpu.rllib.env.multi_agent_env_runner import \
    MultiAgentEnvRunner as JMARunner
from ray_tpu.rllib.utils import postprocessing as jpost
from ray_tpu_torch import rllib as trllib
from ray_tpu_torch.rllib.algorithms import a2c as ta2c
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import es as tes
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.algorithms import multi_agent_ppo as tmappo
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.core import rl_module as trlm
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner as TRunner
from ray_tpu_torch.rllib.env.multi_agent_env_runner import \
    MultiAgentEnvRunner as TMARunner
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.utils import postprocessing as tpost
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch
from torch_port_helpers import child_env, flat_layers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (16, 16)
MODEL = {"fcnet_hiddens": HIDDEN}
LR = 1e-3
UPDATE_ATOL = STEP_ATOL = 0.01 * LR
OBS_DIM, N_ACT = 4, 2

# name -> (JAX learner, port learner, loss config)
LEARNERS = {
    "ppo": (jppo.PPOLearner, tppo.PPOLearner,
            {"clip_param": 0.2, "vf_clip_param": 0.5, "vf_loss_coeff": 0.5,
             "entropy_coeff": 0.01, "use_kl_loss": True, "kl_coeff": 0.2}),
    "a2c": (ja2c.A2CLearner, ta2c.A2CLearner,
            {"vf_loss_coeff": 0.5, "entropy_coeff": 0.01}),
    "impala": (jimpala.IMPALALearner, timpala.IMPALALearner,
               {"vtrace_clip_rho_threshold": 1.0,
                "vtrace_clip_c_threshold": 0.9, "vf_loss_coeff": 0.5,
                "entropy_coeff": 0.01, "gamma": 0.97}),
    "appo": (jappo.APPOLearner, tappo.APPOLearner,
             {"vtrace_clip_rho_threshold": 1.0,
              "vtrace_clip_c_threshold": 0.9, "vf_loss_coeff": 0.5,
              "entropy_coeff": 0.01, "gamma": 0.97, "clip_param": 0.3}),
    "bc": (jbc.BCLearner, tbc.BCLearner, {}),
    "marwil": (jmarwil.MARWILLearner, tmarwil.MARWILLearner,
               {"beta": 1.0, "vf_coeff": 1.0, "max_advantage_weight": 5.0}),
}
# name -> (JAX module, port module, obs dim, actions, model config)
BOX = {"action_low": np.array([-2.0], np.float32),
       "action_high": np.array([2.0], np.float32)}
MODULES = {
    "discrete": (jrlm.DiscreteMLPModule, trlm.DiscreteMLPModule, 4, 2, {}),
    "qnet": (jrlm.QNetModule, trlm.QNetModule, 4, 3, {}),
    "sac": (jrlm.SACModule, trlm.SACModule, 3, 1, BOX),
    "ddpg": (jrlm.DDPGModule, trlm.DDPGModule, 3, 1, BOX),
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


def _batch(n=64, seed=0):
    """A seeded numpy batch with every column the losses read."""
    rng = np.random.RandomState(seed)
    boundary = (rng.rand(n) < 0.1).astype(np.float32)
    boundary[-1] = 1.0
    return {
        "obs": rng.randn(n, OBS_DIM).astype(np.float32),
        "actions": rng.randint(0, N_ACT, n).astype(np.int64),
        "action_logp": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "value_targets": rng.randn(n).astype(np.float32),
        "rewards": rng.rand(n).astype(np.float32),
        "boundary": boundary,
        "next_value_override": rng.randn(n).astype(np.float32),
        "returns": rng.randn(n).astype(np.float32),
    }


def _learners(name, grad_clip=10.0):
    """(JAX learner, port learner) of one algorithm on equal weights."""
    jcls, tcls, extra = LEARNERS[name]
    cfg = {"seed": 0, "lr": LR, "grad_clip": grad_clip, **extra}
    jl = jcls(jrlm.RLModuleSpec(jrlm.DiscreteMLPModule, OBS_DIM, N_ACT,
                                dict(MODEL)), dict(cfg))
    tl = tcls(trlm.RLModuleSpec(trlm.DiscreteMLPModule, OBS_DIM, N_ACT,
                                dict(MODEL)), dict(cfg), device="cpu")
    tl.set_weights(jl.get_weights())
    return jl, tl


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _module_pair(name, seed=3):
    jcls, tcls, obs_dim, n_act, extra = MODULES[name]
    cfg = dict(MODEL, **extra)
    jm = jcls(obs_dim, n_act, cfg)
    tree = _np(jm.init_params(jax.random.PRNGKey(seed)))
    tm = trlm.RLModuleSpec(tcls, obs_dim, n_act, cfg).build(device="cpu")
    trlm.params_from_numpy(tm, tree)
    obs = np.random.RandomState(seed).randn(32, obs_dim).astype(np.float32)
    return jm, tree, tm, obs


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_forwards_match_jax(name):
    jm, tree, tm, obs = _module_pair(name)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    x = torch.from_numpy(obs)
    with torch.no_grad():
        for fn in ("forward_train", "forward_inference"):
            want = getattr(jm, fn)(jp, jnp.asarray(obs))
            got = getattr(tm, fn)(x)
            assert sorted(got) == sorted(want), fn
            for k in want:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{fn}/{k}")
        if name in ("sac", "ddpg"):
            a = np.random.RandomState(1).uniform(-2, 2, (32, 1)).astype(
                np.float32)
            for g, w in zip(tm.q_values(x, torch.from_numpy(a)),
                            jm.q_values(jp, jnp.asarray(obs),
                                        jnp.asarray(a))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_weights_layout_and_ravel_order_match_jax(name):
    """`params_to_numpy` gives JAX's tree back; `ravel_tree` and the
    module's parameter order are ``ravel_pytree``'s."""
    _, tree, tm, _ = _module_pair(name)
    back = trlm.params_to_numpy(tm)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(g, w)
    want, unravel = ravel_pytree(tree)
    flat, t_unravel = trlm.ravel_tree(tree)
    np.testing.assert_array_equal(flat, np.asarray(want))
    np.testing.assert_array_equal(
        torch.cat([p.detach().reshape(-1)
                   for _, p in trlm.tree_paths(tm)]).numpy(), flat)
    for g, w in zip(jax.tree_util.tree_leaves(t_unravel(flat * 2)),
                    jax.tree_util.tree_leaves(_np(unravel(want * 2)))):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Learners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_loss_metrics_and_grads_match_jax(name):
    jl, tl = _learners(name)
    batch = _batch()
    jg, jm = jl.compute_gradients(batch)
    tg, tm = tl.compute_gradients(batch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    got, want = _leaves(tg), _leaves(_np(jg))
    assert [g.shape for g in got] == [w.shape for w in want]
    assert any(np.abs(w).max() > 1e-3 for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grad_clip", [10.0, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_update_matches_jax(name, grad_clip):
    """One optimizer step: optax's clip_by_global_norm + adam, written
    out; the clip fires at 0.05 (the gradients' global norm is above)."""
    jl, tl = _learners(name, grad_clip)
    batch = _batch(seed=1)
    grads, _ = tl.compute_gradients(batch)
    norm = np.sqrt(sum(float(np.sum(g ** 2)) for g in _leaves(grads)))
    assert (norm > grad_clip) == (grad_clip < 1), norm
    before = _leaves(tl.get_weights())
    jm = jl.update(batch)
    tm = tl.update(batch)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6)
    got, want = _leaves(tl.get_weights()), _leaves(jl.get_weights())
    assert any(np.abs(w - b).max() > 0.5 * LR for w, b in zip(want, before))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_ATOL)
    st = tl.get_state()
    assert st["opt_state"]["count"] == 1


def test_vtrace_scan_matches_lax_scan():
    rng = np.random.RandomState(4)
    T = 50
    deltas = rng.randn(T).astype(np.float32)
    c = rng.uniform(0, 1, T).astype(np.float32)
    nd = (rng.rand(T) > 0.2).astype(np.float32)
    gamma = 0.97

    def scan_fn(carry, xs):
        delta, ci, ndi = xs
        acc = delta + gamma * ci * ndi * carry
        return acc, acc

    _, want = jax.lax.scan(scan_fn, jnp.zeros((), jnp.float32),
                           (deltas, c, nd), reverse=True)
    got = timpala.vtrace_scan(torch.from_numpy(deltas), torch.from_numpy(c),
                              torch.from_numpy(nd), gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_vtrace_advantages_match_jax():
    jl, tl = _learners("appo")
    batch = _batch(seed=2)
    want = jl._vtrace_advantages(jl.params, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = tl.module.forward_train(tb["obs"])
        logp = torch.log_softmax(out["action_dist_inputs"], -1).gather(
            -1, tb["actions"][:, None])[:, 0]
        _, vs, adv = timpala.vtrace(tl.config, out["vf_preds"], logp, tb)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(vs.numpy()).all()


@pytest.mark.parametrize("boot", ["dict", "scalar"])
def test_gae_and_standardize_match_jax(boot):
    rng = np.random.RandomState(6)
    n = 40
    eps = np.repeat([7, 8, 9, 10], [12, 9, 11, 8]).astype(np.int64)
    terms = np.zeros(n, bool)
    terms[11] = terms[31] = True
    batch = SampleBatch({
        "rewards": rng.rand(n).astype(np.float32),
        "vf_preds": rng.randn(n).astype(np.float32),
        "terminateds": terms, "eps_id": eps})
    bootstrap = {8: 0.5, 10: -1.25} if boot == "dict" else 0.75
    want = jpost.compute_gae(SampleBatch(batch), 0.99, 0.95, bootstrap)
    got = tpost.compute_gae(SampleBatch(batch), 0.99, 0.95, bootstrap)
    for k in ("advantages", "value_targets"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tpost.standardize(got["advantages"]),
                                  jpost.standardize(want["advantages"]))


# ---------------------------------------------------------------------------
# Env runners, ES
# ---------------------------------------------------------------------------

def _runners(num_envs, tree):
    base = {"env": "CartPole-v1", "num_envs_per_runner": num_envs,
            "seed": 0}
    jr = JRunner(dict(base, module_spec=jrlm.RLModuleSpec(
        jrlm.DiscreteMLPModule, OBS_DIM, N_ACT, dict(MODEL))), 0)
    tr = TRunner(dict(base, module_spec=trlm.RLModuleSpec(
        trlm.DiscreteMLPModule, OBS_DIM, N_ACT, dict(MODEL))), 0,
        device="cpu")
    jr.set_weights(tree)
    tr.set_weights(tree)
    return jr, tr


def _tree(seed=0, pi_scale=1.0):
    tree = _np(jrlm.DiscreteMLPModule(OBS_DIM, N_ACT, dict(MODEL))
               .init_params(jax.random.PRNGKey(seed)))
    for layer in tree["pi"]:
        layer["w"] = layer["w"] * np.float32(pi_scale)
        layer["b"] = layer["b"] * np.float32(pi_scale)
    return tree


@pytest.mark.parametrize("num_envs", [1, 4])
def test_greedy_rollout_matches_jax(num_envs):
    tree = _tree(pi_scale=1e4)
    jr, tr = _runners(num_envs, tree)
    want = jr.sample(120, explore=False)
    got = tr.sample(120, explore=False)
    # the precondition: every action is its policy's argmax by a margin
    # no sampler crosses (logit gap > 30, probability < 1e-13)
    logits = np.asarray(jrlm.DiscreteMLPModule(OBS_DIM, N_ACT, dict(MODEL))
                        .forward_train(jax.tree_util.tree_map(
                            jnp.asarray, tree), jnp.asarray(
                            want["obs"]))["action_dist_inputs"])
    assert np.abs(logits[:, 1] - logits[:, 0]).min() > 30
    np.testing.assert_array_equal(want["actions"], logits.argmax(-1))
    assert sorted(got) == sorted(want)
    for k in ("obs", "next_obs", "actions", "rewards", "terminateds",
              "truncateds", "eps_id"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("vf_preds", "action_logp"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    jb, tb = jr.bootstrap_value(), tr.bootstrap_value()
    assert sorted(tb) == sorted(jb)
    for e in jb:
        np.testing.assert_allclose(tb[e], jb[e], rtol=1e-5, atol=1e-6)
    assert tr.get_metrics() == jr.get_metrics()
    assert jr.get_metrics()["num_episodes"] >= 2
    assert (tr.sample_episodes(3, explore=False)
            == jr.sample_episodes(3, explore=False))


def test_es_perturbations_match_jax():
    """The same seeds perturb the same weights (ravel_pytree's order) and
    give the same greedy returns."""
    tree = _tree(seed=1)
    jr, tr = _runners(1, tree)
    seeds = [11, 12, 13]
    want = jr.evaluate_perturbations(tree, seeds, 0.5, 1)
    got = tr.evaluate_perturbations(tree, seeds, 0.5, 1)
    assert got == want
    assert len({r for _, a, b in want for r in (a, b)}) > 1
    assert tr.get_metrics() == jr.get_metrics()


def _es_configs():
    def cfg(mod):
        return (mod.ESConfig().environment("CartPole-v1")
                .training(num_perturbations=3, es_stdev=0.3,
                          es_step_size=0.5, model=dict(MODEL))
                .debugging(seed=2))
    return cfg(jes), cfg(tes).learners(device="cpu")


def test_es_training_step_matches_jax():
    jcfg, tcfg = _es_configs()
    ja, ta = jcfg.build_algo(), tcfg.build_algo()
    ta.learner_group.set_weights(ja.learner_group.get_weights())
    ta.env_runner_group.sync_weights(ta.learner_group.get_weights())
    jm, tm = ja.training_step(), ta.training_step()
    assert tm == jm
    for g, w in zip(_leaves(ta.learner_group.get_weights()),
                    _leaves(ja.learner_group.get_weights())):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# One training_step of every algorithm on fixed input; the multi-agent runner
# ---------------------------------------------------------------------------

def _fixed_rollout(n=96, seed=7):
    rng = np.random.RandomState(seed)
    eps = np.repeat([0, 1, 2], [40, 30, 26]).astype(np.int64)
    terms = np.zeros(n, bool)
    terms[39] = True
    return SampleBatch({
        "obs": rng.randn(n, OBS_DIM).astype(np.float32),
        "next_obs": rng.randn(n, OBS_DIM).astype(np.float32),
        "actions": rng.randint(0, N_ACT, n).astype(np.int64),
        "rewards": np.ones(n, np.float32),
        "terminateds": terms, "truncateds": np.zeros(n, bool),
        "eps_id": eps,
        "action_logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
        "vf_preds": rng.randn(n).astype(np.float32)}), {1: 0.25, 2: -0.5}


def _grid_rollout(env_config, n=48, seed=3):
    """A fixed TwoAgentGrid rollout of ``n`` steps an agent: per-agent
    batches (two episodes each, the first terminated) and per-agent
    bootstraps, as `MultiAgentEnvRunner.sample` / `bootstrap_values`
    give them."""
    env = make_env("TwoAgentGrid", env_config)
    rng = np.random.RandomState(seed)
    batches, boots = {}, {}
    for j, aid in enumerate(env.agent_ids):
        dim = env.observation_space_of(aid).shape[0]
        terms = np.zeros(n, bool)
        terms[n // 2 - 1] = True
        batches[aid] = SampleBatch({
            "obs": rng.rand(n, dim).astype(np.float32),
            "actions": rng.randint(0, 4, n).astype(np.int64),
            "rewards": rng.randn(n).astype(np.float32),
            "terminateds": terms, "truncateds": np.zeros(n, bool),
            "eps_id": np.repeat([j * 100_000, j * 100_000 + 1],
                                n // 2).astype(np.int64),
            "action_logp": np.log(rng.uniform(0.2, 0.6, n)).astype(
                np.float32),
            "vf_preds": rng.randn(n).astype(np.float32)})
        boots[aid] = float(rng.randn())
    return batches, boots


def _shared(aid):
    return "shared"


# name -> config builder over one package's algorithms module(s); every
# case trains on fixed input: rollout pieces (a vector runner's exact
# per-episode bootstraps and a scalar tail bootstrap), an offline log,
# a two-agent rollout, or fixed perturbation returns
STEPS = {
    "ppo": lambda m: m["ppo"].PPOConfig().training(
        train_batch_size=192, minibatch_size=64, num_epochs=2,
        entropy_coeff=0.01),
    "a2c": lambda m: m["a2c"].A2CConfig().training(
        train_batch_size=192, entropy_coeff=0.01),
    "appo": lambda m: m["appo"].APPOConfig().training(
        train_batch_size=192, entropy_coeff=0.01),
    "impala": lambda m: m["impala"].IMPALAConfig().training(
        train_batch_size=192, entropy_coeff=0.01),
    "bc": lambda m: m["bc"].BCConfig().offline_data(
        dataset=_offline()).training(train_batch_size=64),
    "marwil": lambda m: m["marwil"].MARWILConfig().offline_data(
        dataset=_offline()).training(train_batch_size=64),
    "multi_agent_ppo": lambda m: m["mappo"].MultiAgentPPOConfig()
    .environment("TwoAgentGrid").training(
        train_batch_size=48, minibatch_size=32, num_epochs=2,
        entropy_coeff=0.01),
    "multi_agent_ppo_shared": lambda m: m["mappo"].MultiAgentPPOConfig()
    .environment("TwoAgentGrid", env_config={"size_a0": 4, "size_a1": 4})
    .multi_agent(policy_mapping_fn=_shared).training(
        train_batch_size=48, minibatch_size=32, num_epochs=2,
        entropy_coeff=0.01),
    "es": lambda m: m["es"].ESConfig().training(num_perturbations=4,
                                                es_stdev=0.1),
}
JMODS = {"ppo": jppo, "a2c": ja2c, "appo": jappo, "impala": jimpala,
         "bc": jbc, "marwil": jmarwil, "mappo": jmappo, "es": jes}
TMODS = {"ppo": tppo, "a2c": ta2c, "appo": tappo, "impala": timpala,
         "bc": tbc, "marwil": tmarwil, "mappo": tmappo, "es": tes}


def _build_step_pair(name):
    """(JAX algorithm, port algorithm) of one STEPS case on equal
    weights, with their learners: {module id: learner}."""
    def build(mods, **extra):
        cfg = STEPS[name](mods)
        if cfg.env is None:
            cfg = cfg.environment("CartPole-v1")
        cfg = cfg.training(lr=LR, model=dict(MODEL)) \
            .debugging(seed=4)
        if extra:
            cfg = cfg.learners(**extra)
        return cfg.algo_class(cfg)

    ja, ta = build(JMODS), build(TMODS, device="cpu")
    if name.startswith("multi_agent"):
        jl, tl = ja.learners, ta.learners
    else:
        jl = {"": ja.learner_group._local}
        tl = {"": ta.learner_group.learner}
    assert sorted(jl) == sorted(tl)
    for mid in jl:
        tl[mid].set_weights(jl[mid].get_weights())
    return (ja, jl), (ta, tl)


def _fixed_training_step(algo, learners, name):
    """One training_step of ``algo`` on the fixed input of its case:
    returns its metrics and the (module id, minibatch) of each update
    its learners took, in order."""
    seen = []
    for mid, learner in learners.items():
        update = learner.update

        def recording(mb, mid=mid, update=update):
            seen.append((mid, {k: np.array(v) for k, v in mb.items()}))
            return update(mb)
        learner.update = recording
    group = algo.env_runner_group
    batch, boot = _fixed_rollout()
    tail = SampleBatch({k: np.array(v[:64]) for k, v in batch.items()})
    tail["eps_id"] = tail["eps_id"] + 5
    tail["terminateds"] = np.zeros(64, bool)    # its first episode cut
    tail["truncateds"] = np.arange(64) == 39
    group.sample_with_bootstraps = lambda n, epsilon=0.0: [
        (SampleBatch(batch), dict(boot)), (tail, 0.75)]
    if name.startswith("multi_agent"):
        per_agent, boots = _grid_rollout(algo.config.env_config)
        mapping = algo.config.policy_mapping_fn or (lambda aid: aid)
        batches = {}
        for aid, b in per_agent.items():
            batches.setdefault(mapping(aid), {})[aid] = b
        group.sample_multi = lambda n: [(batches, dict(boots))]
        return algo.step(), seen
    if name == "es":
        group.evaluate_perturbations = lambda params, seeds, *a: [
            (s, 10.0 + s % 7, 12.0 - s % 5) for s in seeds]
    return algo.training_step(), seen


def _assert_metrics_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_metrics_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("name", sorted(STEPS))
def test_training_step_matches_jax(name):
    """One training_step of every algorithm with its sampling replaced
    by the same fixed input in both packages: the host-side batch
    preparation (GAE and standardize per piece and per agent, IMPALA's
    seams and bootstrap overrides, the offline draws, the grouping of
    agents into modules, the minibatch order) gives equal minibatches,
    the metrics agree and the weights after the step lie within
    ``STEP_ATOL`` per update taken (ES: its host update, 1e-6)."""
    (ja, jl), (ta, tl) = _build_step_pair(name)
    jm, jseen = _fixed_training_step(ja, jl, name)
    tm, tseen = _fixed_training_step(ta, tl, name)
    assert [m for m, _ in tseen] == [m for m, _ in jseen]
    assert (len(jseen) == 0) == (name == "es")
    for (_, g), (_, w) in zip(tseen, jseen):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if name in ("impala", "appo"):        # both bootstrap branches ran
        b = jseen[0][1]
        seams = np.nonzero(b["boundary"])[0]
        np.testing.assert_array_equal(seams, [39, 69, 95, 135, 159])
        np.testing.assert_array_equal(b["next_value_override"][seams],
                                      [0.0, 0.25, -0.5, b["vf_preds"][135],
                                       0.75])
    _assert_metrics_close(tm, jm)
    for mid in jl:
        n = sum(m == mid for m, _ in jseen)
        for g, w in zip(_leaves(tl[mid].get_weights()),
                        _leaves(jl[mid].get_weights())):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=STEP_ATOL * n if n else 1e-6)


@pytest.mark.parametrize("shared", [False, True], ids=["two", "shared"])
def test_multi_agent_rollout_matches_jax(shared):
    """A TwoAgentGrid rollout whose policies' heads are scaled until
    every sampled action is its argmax (checked on the rollout's
    observations): per-agent observations, actions, rewards, flags and
    episode ids equal JAX's `MultiAgentEnvRunner`'s, values and
    log-probs close, the bootstraps and the episode bookkeeping equal.
    ``shared`` maps both agents onto one module."""
    env_config = {"size_a0": 3, "size_a1": 3 if shared else 4}
    env = make_env("TwoAgentGrid", env_config)
    mapping = _shared if shared else (lambda aid: aid)
    trees, jspecs, tspecs = {}, {}, {}
    for j, aid in enumerate(env.agent_ids):
        mid = mapping(aid)
        if mid in trees:
            continue
        dim = env.observation_space_of(aid).shape[0]
        jspecs[mid] = jrlm.RLModuleSpec(jrlm.DiscreteMLPModule, dim, 4,
                                        dict(MODEL))
        tspecs[mid] = trlm.RLModuleSpec(trlm.DiscreteMLPModule, dim, 4,
                                        dict(MODEL))
        tree = _np(jspecs[mid].build().init_params(
            jax.random.PRNGKey(10 + j)))
        for layer in tree["pi"]:
            layer["w"] = layer["w"] * np.float32(1e4)
            layer["b"] = layer["b"] * np.float32(1e4)
        trees[mid] = tree
    base = {"env": "TwoAgentGrid", "env_config": env_config, "seed": 2,
            "policy_mapping_fn": mapping}
    jr = JMARunner(dict(base, module_specs=jspecs), 0)
    tr = TMARunner(dict(base, module_specs=tspecs), 0, device="cpu")
    jr.set_weights(trees)
    tr.set_weights(trees)
    want, got = jr.sample(150), tr.sample(150)
    assert sorted(got) == sorted(want)
    for mid, per_agent in want.items():
        fwd = jspecs[mid].build()
        jp = jax.tree_util.tree_map(jnp.asarray, trees[mid])
        assert sorted(got[mid]) == sorted(per_agent)
        for aid, w in per_agent.items():
            g = got[mid][aid]
            logits = np.sort(np.asarray(fwd.forward_train(
                jp, jnp.asarray(w["obs"]))["action_dist_inputs"]), -1)
            assert (logits[:, -1] - logits[:, -2]).min() > 30
            assert sorted(g) == sorted(w)
            for k in ("obs", "next_obs", "actions", "rewards",
                      "terminateds", "truncateds", "eps_id"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ("vf_preds", "action_logp"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           atol=1e-5)
    jb, tb = jr.bootstrap_values(), tr.bootstrap_values()
    assert sorted(tb) == sorted(jb)
    for aid in jb:
        np.testing.assert_allclose(tb[aid], jb[aid], rtol=1e-5, atol=1e-6)
    assert repr(tr.get_metrics()) == repr(jr.get_metrics())
    assert jr.get_metrics()["num_episodes"] >= 2


# ---------------------------------------------------------------------------
# Data-parallel update over a gloo world
# ---------------------------------------------------------------------------

def test_update_ddp_matches_jax_grads(tmp_path):
    """Two gloo ranks each take `update_ddp` on their half of the batch:
    both end on the weights JAX reaches by averaging `compute_gradients`
    over the halves and applying the mean."""
    world = 2
    jl, _ = _learners("ppo")
    tree = jl.get_weights()
    batch = _batch(n=64, seed=9)
    npz = str(tmp_path / "inputs.npz")
    np.savez(npz, **{f"params/{k}": v for k, v in flat_layers(tree).items()},
             **{f"batch/{k}": v for k, v in batch.items()})
    job = str(tmp_path / "job.json")
    with open(job, "w") as f:
        json.dump({"world": world, "store": f"file://{tmp_path}/store",
                   "inputs": npz, "out": str(tmp_path),
                   "rllib": {"learner": "PPOLearner", "obs_dim": OBS_DIM,
                             "num_actions": N_ACT, "model": dict(MODEL),
                             "config": {"seed": 0, "lr": LR,
                                        "grad_clip": 10.0,
                                        **LEARNERS["ppo"][2]}}}, f)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import torch_port_helpers as h; h.rank_main()", job, str(r)],
        cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(world)]
    # JAX meanwhile: per-shard gradients, averaged, applied once
    half = 64 // world
    grads = [jl.compute_gradients({k: v[r * half:(r + 1) * half]
                                   for k, v in batch.items()})[0]
             for r in range(world)]
    jl.apply_gradients(jax.tree_util.tree_map(
        lambda *g: sum(g) / world, *grads))
    want, _ = ravel_pytree(jl.get_weights())
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=50)
            errs.append(err.decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    ranks = [json.load(open(tmp_path / f"rank{r}.json"))
             for r in range(world)]
    assert ranks[0]["flat"] == ranks[1]["flat"]
    np.testing.assert_allclose(np.asarray(ranks[0]["flat"], np.float32),
                               np.asarray(want), rtol=0, atol=UPDATE_ATOL)
    assert not np.allclose(np.asarray(ranks[0]["flat"]),
                           np.asarray(ravel_pytree(tree)[0]))


# ---------------------------------------------------------------------------
# The port on its own
# ---------------------------------------------------------------------------

def test_sampled_logp_matches_forward_train():
    _, tr = _runners(4, _tree(seed=2))
    b = tr.sample(64)
    with torch.no_grad():
        logits = tr.module.forward_train(torch.from_numpy(b["obs"]))[
            "action_dist_inputs"]
    logp = torch.log_softmax(logits, -1).numpy()
    np.testing.assert_allclose(
        b["action_logp"], logp[np.arange(len(b["actions"])), b["actions"]],
        rtol=1e-6, atol=1e-7)
    assert len(set(b["actions"].tolist())) == N_ACT


def test_exploration_follows_the_policy():
    """Sampled actions' frequencies match softmax(logits) (4 sigma), and
    the DDPG/SAC samples stay inside the action bounds."""
    tm = trlm.RLModuleSpec(trlm.DiscreteMLPModule, OBS_DIM, 3,
                           dict(MODEL)).build(seed=5, device="cpu")
    obs = torch.from_numpy(np.random.RandomState(0).randn(
        1, OBS_DIM).astype(np.float32)).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = tm.forward_exploration(obs, gen)
        probs = torch.softmax(tm.forward_train(obs[:1])[
            "action_dist_inputs"], -1)[0].numpy()
    freq = np.bincount(out["actions"].numpy(), minlength=3) / len(obs)
    assert np.all(np.abs(freq - probs)
                  < 4 * np.sqrt(probs * (1 - probs) / len(obs)))
    for name in ("sac", "ddpg"):
        _, _, m, o = _module_pair(name)
        with torch.no_grad():
            a = m.forward_exploration(torch.from_numpy(o), gen)["actions"]
        assert a.shape == (32, 1) and float(a.abs().max()) <= 2.0


def _offline(n=200):
    rng = np.random.RandomState(0)
    return {"obs": rng.randn(n, OBS_DIM).astype(np.float32),
            "actions": rng.randint(0, N_ACT, n),
            "rewards": np.ones(n, np.float32),
            "terminateds": rng.rand(n) < 0.05}


ALGOS = {
    "ppo": lambda: trllib.PPOConfig().training(
        train_batch_size=64, minibatch_size=32, num_epochs=1),
    "a2c": lambda: trllib.A2CConfig().training(train_batch_size=64),
    "appo": lambda: trllib.APPOConfig().training(train_batch_size=64),
    "impala": lambda: trllib.IMPALAConfig().training(train_batch_size=64),
    "bc": lambda: trllib.BCConfig().offline_data(dataset=_offline())
    .training(train_batch_size=32),
    "marwil": lambda: trllib.MARWILConfig().offline_data(
        dataset=_offline()).training(train_batch_size=32),
    "es": lambda: trllib.ESConfig().training(num_perturbations=2),
    "ars": lambda: trllib.ARSConfig().training(num_perturbations=2,
                                               top_directions=1),
    "multi_agent_ppo": lambda: trllib.MultiAgentPPOConfig().environment(
        "TwoAgentGrid").training(train_batch_size=32, minibatch_size=16,
                                 num_epochs=1),
}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_local_train_iteration(name):
    cfg = ALGOS[name]()
    if cfg.env is None:
        cfg = cfg.environment("CartPole-v1")
    algo = cfg.training(model=dict(MODEL)).learners(device="cpu") \
        .debugging(seed=1).build_algo()
    learners = (list(algo.learners.values()) if name == "multi_agent_ppo"
                else [algo.learner_group.learner])
    before = [_leaves(lr.get_weights()) for lr in learners]
    result = algo.train()
    assert algo.iteration == 1 and result["training_iteration"] == 1
    after = [_leaves(lr.get_weights()) for lr in learners]
    for b, a in zip(before, after):
        assert any(not np.array_equal(x, y) for x, y in zip(b, a))
    metrics = [v for k, v in result.items() if isinstance(v, float)
               and k not in ("episode_return_mean", "time_this_iter_s")]
    for m in result.values():      # multi-agent: per module
        if isinstance(m, dict):
            metrics += [v for v in m.values() if isinstance(v, float)]
    assert metrics and np.isfinite(metrics).all(), result
    algo.stop()


def test_checkpoint_roundtrip(tmp_path):
    def build():
        return (trllib.PPOConfig().environment("CartPole-v1")
                .training(train_batch_size=64, minibatch_size=32,
                          num_epochs=1, model=dict(MODEL))
                .learners(device="cpu").debugging(seed=1).build_algo())

    a = build()
    a.train()
    a.save_checkpoint(str(tmp_path))
    b = build()
    b.load_checkpoint(str(tmp_path))
    sa, sb_ = a.learner_group.get_state(), b.learner_group.get_state()
    assert sa["opt_state"]["count"] == sb_["opt_state"]["count"] > 0
    for x, y in zip(_leaves(sa), _leaves(sb_)):
        np.testing.assert_array_equal(x, y)
    assert b._iteration == 1
    ev = b.evaluate(2)["evaluation"]
    assert ev["num_episodes"] == 2 and ev["episode_return_mean"] >= 1.0


@pytest.mark.parametrize("knob", [{"num_env_runners": 1},
                                  {"num_learners": 2},
                                  {"num_devices_per_learner": 2}],
                         ids=["env_runners", "learners", "learner_devices"])
def test_remote_groups_raise(knob):
    cfg = (trllib.PPOConfig().environment("CartPole-v1")
           .learners(device="cpu"))
    cfg._apply(knob)
    with pytest.raises(NotImplementedError, match="A14e"):
        cfg.build_algo()


def test_learner_runs_on_cuda_by_default():
    """The entry points run on the card unless the caller asks for the
    CPU; without one, asking for it is an error, never a fallback."""
    spec = trlm.RLModuleSpec(trlm.DiscreteMLPModule, OBS_DIM, N_ACT,
                             dict(MODEL))
    assert trllib.PPOConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tppo.PPOLearner(spec, {"seed": 0})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spec.build()
