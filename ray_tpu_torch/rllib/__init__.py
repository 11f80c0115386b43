"""ray_tpu_torch.rllib — the reinforcement learning library on PyTorch.

Port of `ray_tpu/rllib/`: the new API stack's core (AlgorithmConfig /
Algorithm / EnvRunnerGroup / RLModule / Learner / LearnerGroup) with a
``TorchLearner`` on the card (``device="cuda"``, or ``"cpu"``), and the
on-policy and imitation algorithms: PPO (single and multi-agent), A2C,
APPO, IMPALA, BC, MARWIL, ES and ARS. Runner and learner groups run in
local mode; remote groups, the off-policy family (DQN/APEX, DDPG/TD3,
SAC, CQL) and QMIX, AlphaZero and DreamerV3 are not ported yet
(ROADMAP.md, Queue A items A14b, A14c and A14e).
"""

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
    MultiAgentPPO, MultiAgentPPOConfig)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv
from ray_tpu_torch.rllib.env.registry import register_env

__all__ = [
    "A2C", "A2CConfig", "APPO", "APPOConfig", "ARS", "ARSConfig",
    "Algorithm", "AlgorithmConfig", "BC", "BCConfig", "ES", "ESConfig",
    "IMPALA", "IMPALAConfig", "MARWIL", "MARWILConfig", "MultiAgentEnv",
    "MultiAgentPPO", "MultiAgentPPOConfig", "PPO", "PPOConfig",
    "register_env",
]
