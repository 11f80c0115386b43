"""ray_tpu_torch.rllib — the reinforcement learning library on PyTorch.

Port of `ray_tpu/rllib/`: the new API stack's core (AlgorithmConfig /
Algorithm / EnvRunnerGroup / RLModule / Learner / LearnerGroup) with a
``TorchLearner`` on the card (``device="cuda"``, or ``"cpu"``), the
on-policy and imitation algorithms (PPO single and multi-agent, A2C,
APPO, IMPALA, BC, MARWIL, ES and ARS) and the off-policy family with
its target networks and replay buffers (DQN with prioritized replay,
DDPG, TD3, SAC, CQL), and QMIX, AlphaZero and DreamerV3. Runner and
learner groups run in local mode; remote groups, APEX-DQN and QMIX's
and AlphaZero's remote workers are not ported yet (ROADMAP.md, Queue A
item A14e).
"""

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.alphazero import (AlphaZero,
                                                      AlphaZeroConfig)
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.ddpg import (DDPG, DDPGConfig, TD3,
                                                 TD3Config)
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (DreamerV3,
                                                      DreamerV3Config)
from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
    MultiAgentPPO, MultiAgentPPOConfig)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.qmix import QMIX, QMIXConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv
from ray_tpu_torch.rllib.env.registry import register_env

__all__ = [
    "A2C", "A2CConfig", "APPO", "APPOConfig", "ARS", "ARSConfig",
    "Algorithm", "AlgorithmConfig", "AlphaZero", "AlphaZeroConfig", "BC",
    "BCConfig", "CQL", "CQLConfig", "DDPG", "DDPGConfig", "DQN",
    "DQNConfig", "DreamerV3", "DreamerV3Config", "ES", "ESConfig",
    "IMPALA", "IMPALAConfig", "MARWIL", "MARWILConfig", "MultiAgentEnv",
    "MultiAgentPPO", "MultiAgentPPOConfig", "PPO", "PPOConfig", "QMIX",
    "QMIXConfig", "SAC", "SACConfig", "TD3", "TD3Config", "register_env",
]
