"""LearnerGroup — the learner of an algorithm, local mode.

Port of `ray_tpu/rllib/core/learner_group.py` with ``num_learners ==
0``: one learner in this process, on the config's device. A gang of
learner actors runs on the ``ray_tpu`` runtime, which the port cannot
import; ``num_learners > 0`` raises until that glue is ported. Its
step, `TorchLearner.update_ddp`, is ported and runs over any
``torch.distributed`` group.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib._unported import unported
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class LearnerGroup:
    def __init__(self, learner_class: type, module_spec, config: dict):
        self.config = config
        self.num_learners = int(config.get("num_learners", 0))
        if self.num_learners:
            raise unported(f"num_learners={self.num_learners} (learner "
                           "actors)")
        self._local = learner_class(module_spec, config)

    @property
    def learner(self):
        return self._local

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        """One SGD step."""
        return self._local.update(batch)

    def get_weights(self):
        return self._local.get_weights()

    def set_weights(self, params) -> None:
        self._local.set_weights(params)

    def get_state(self) -> Dict[str, Any]:
        return self._local.get_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        self._local.set_state(state)

    def stop(self) -> None:
        pass
