from ray_tpu_torch.rllib.connectors.connector import (ConnectorPipelineV2,
                                                ConnectorV2, EpsilonGreedy,
                                                FrameStackObs,
                                                RunningRewardNorm)

__all__ = ["ConnectorV2", "ConnectorPipelineV2", "FrameStackObs",
           "EpsilonGreedy", "RunningRewardNorm"]
