"""BC — behavior cloning from offline data.

Port of `ray_tpu/rllib/algorithms/bc.py`: supervised imitation of
logged actions (MARWIL with beta = 0). The offline dataset is a dict of
numpy arrays ({obs, actions}) or any object with ``take_all()`` rows;
the env is used only to size the module and for evaluation.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms._losses import action_logp
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.offline_dataset: Any = None
        self.train_batch_size = 256
        self.num_env_runners = 0

    def offline_data(self, *, dataset=None, **kwargs) -> "BCConfig":
        if dataset is not None:
            self.offline_dataset = dataset
        self._apply(kwargs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        # the dataset stays with the driver
        d = super().to_dict()
        d.pop("offline_dataset", None)
        return d

    @property
    def algo_class(self):
        return BC


class BCLearner(TorchLearner):
    def loss_fn(self, batch, generator):
        logits = self.module.forward_train(
            batch[sb.OBS])["action_dist_inputs"]
        actions = batch[sb.ACTIONS].long()
        _, logp = action_logp(logits, actions)
        nll = -logp
        accuracy = (logits.argmax(-1) == actions).float().mean()
        return nll.mean(), {"bc_nll": nll.mean(), "accuracy": accuracy}


class BC(Algorithm):
    config_class = BCConfig
    learner_class = BCLearner
    module_class = DiscreteMLPModule

    def setup(self, config) -> None:
        super().setup(config)
        ds = self.config.offline_dataset
        if ds is None:
            raise ValueError("BCConfig.offline_data(dataset=...) required")
        if hasattr(ds, "take_all"):  # a Dataset of rows
            rows = ds.take_all()
            self._obs = np.stack([np.asarray(r["obs"]) for r in rows])
            self._actions = np.asarray([r["actions"] for r in rows])
        else:
            self._obs = np.asarray(ds["obs"])
            self._actions = np.asarray(ds["actions"])
        self._rng = np.random.default_rng(self.config.seed)

    def training_step(self) -> Dict[str, Any]:
        n = len(self._obs)
        idx = self._rng.integers(0, n, self.config.train_batch_size)
        batch = SampleBatch({sb.OBS: self._obs[idx].astype(np.float32),
                             sb.ACTIONS: self._actions[idx]})
        # no weight broadcast: BC never samples from env runners
        return self.learner_group.update(batch)
