"""EnvRunnerGroup — the env runners of an algorithm, local mode.

Port of `ray_tpu/rllib/env/env_runner_group.py` with
``num_env_runners == 0``: one local runner in this process, on the
config's device. Remote runners are actors of the ``ray_tpu`` runtime,
which the port cannot import; ``num_env_runners > 0`` raises until that
glue is ported.
"""

from __future__ import annotations

from typing import Any, Dict, List


from ray_tpu_torch.rllib._unported import unported
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class EnvRunnerGroup:
    def __init__(self, config: dict, runner_cls: type = None):
        self.config = config
        runner_cls = runner_cls or SingleAgentEnvRunner
        self.num_remote = int(config.get("num_env_runners", 0))
        if self.num_remote:
            raise unported(f"num_env_runners={self.num_remote} (remote env "
                           "runner actors)")
        self._local_runner = runner_cls(config, 0)

    # ---- weights ----

    def sync_weights(self, params) -> None:
        self._local_runner.set_weights(params)

    # ---- sampling ----

    def sample(self, total_steps: int,
               epsilon: float = 0.0) -> SampleBatch:
        batches = [b for b, _ in
                   self.sample_with_bootstraps(total_steps, epsilon)]
        return SampleBatch.concat_samples(batches)

    def sample_with_bootstraps(self, total_steps: int, epsilon: float = 0.0
                               ) -> List[tuple]:
        """[(batch, bootstrap_value)]: the runner's batch and its exact
        value estimate for its rollout's final steps."""
        batch = self._local_runner.sample(total_steps, epsilon=epsilon)
        return [(batch, self._local_runner.bootstrap_value())]

    def sample_multi(self, total_steps: int) -> List[tuple]:
        """Multi-agent variant (runner_cls=MultiAgentEnvRunner):
        [(per_module_batches, per_agent_bootstraps)]."""
        batches = self._local_runner.sample(total_steps)
        return [(batches, self._local_runner.bootstrap_values())]

    def sample_episodes(self, num_episodes: int,
                        explore: bool = False) -> List[float]:
        """Whole-episode returns (evaluation path)."""
        return self._local_runner.sample_episodes(num_episodes,
                                                  explore=explore)

    def evaluate_perturbations(self, params, seeds: List[int],
                               stdev: float,
                               episodes_per: int = 1) -> List[tuple]:
        """ES/ARS: each seed's antithetic pair of returns."""
        return self._local_runner.evaluate_perturbations(
            params, list(seeds), stdev, episodes_per)

    # ---- health / metrics ----

    def restore_failed(self, params_fn=None) -> int:
        return 0                        # a local runner does not fail over

    def num_healthy(self) -> int:
        return 1

    def aggregate_metrics(self) -> Dict[str, Any]:
        m = self._local_runner.get_metrics()
        return {
            "episode_return_mean": (m["episode_return_mean"]
                                    if m["num_episodes"] > 0
                                    else float("nan")),
            "num_episodes": m["num_episodes"],
            "num_env_steps": m["num_env_steps"],
            "num_healthy_env_runners": 1,
        }

    def stop(self) -> None:
        pass
