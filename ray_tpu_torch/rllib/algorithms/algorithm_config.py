"""AlgorithmConfig — fluent builder for algorithm hyperparameters.

Reference: rllib/algorithms/algorithm_config.py (AlgorithmConfig with
.environment()/.env_runners()/.training()/.learners() chained setters,
.build_algo() producing the Algorithm).

A copy of `ray_tpu/rllib/algorithms/algorithm_config.py` with one key
more: ``device``, where the learner and the local env runner put their
modules (``"cuda"`` unless set to ``"cpu"``, e.g. with
``.learners(device="cpu")``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type


class AlgorithmConfig:
    algo_class: Optional[type] = None

    def __init__(self):
        # environment
        self.env: Any = None
        self.env_config: Dict[str, Any] = {}
        self.seed: int = 0
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_runner: int = 1  # vector-env width per runner
        # ConnectorV2 pipeline FACTORIES (reference: rllib/connectors/):
        # callables returning a ConnectorV2, a list of them, or a
        # ConnectorPipelineV2 — built per runner/learner process.
        self.env_to_module_connector = None   # obs -> module inputs
        self.module_to_env_connector = None   # module outputs -> actions
        self.learner_connector = None         # train batch (pre-GAE)
        self.num_cpus_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        # training
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 4000
        self.minibatch_size: int = 128
        self.num_epochs: int = 8
        self.grad_clip: float = 10.0
        self.model: Dict[str, Any] = {}
        # learners
        self.num_learners: int = 0
        self.num_cpus_per_learner: int = 1
        self.num_tpus_per_learner: float = 0
        self.num_devices_per_learner: int = 1
        # the learner's and the local env runner's torch device
        self.device: str = "cuda"
        # evaluation (reference: AlgorithmConfig.evaluation())
        self.evaluation_interval: int = 0       # iterations; 0 = off
        self.evaluation_num_env_runners: int = 0  # 0 = local eval runner
        self.evaluation_duration: int = 5       # episodes per evaluation
        # fault tolerance
        self.restart_failed_env_runners: bool = True

    # ---- chained setters (reference API shape) ----

    def environment(self, env=None, *, env_config: Optional[dict] = None,
                    **kwargs) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        self._apply(kwargs)
        return self

    def env_runners(self, **kwargs) -> "AlgorithmConfig":
        self._apply(kwargs)
        return self

    def evaluation(self, **kwargs) -> "AlgorithmConfig":
        self._apply(kwargs)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        self._apply(kwargs)
        return self

    def learners(self, **kwargs) -> "AlgorithmConfig":
        self._apply(kwargs)
        return self

    def fault_tolerance(self, **kwargs) -> "AlgorithmConfig":
        self._apply(kwargs)
        return self

    def debugging(self, *, seed: Optional[int] = None,
                  **kwargs) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        self._apply(kwargs)
        return self

    def _apply(self, kwargs: Dict[str, Any]) -> None:
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(
                    f"unknown config key {k!r} for "
                    f"{type(self).__name__}")
            setattr(self, k, v)

    # ---- build ----

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            if hasattr(self, k):
                setattr(self, k, v)
        return self

    def build_algo(self):
        if self.algo_class is None:
            raise ValueError("config class does not name an algo_class")
        return self.algo_class(config=self)

    # Back-compat alias (reference has both).
    build = build_algo
