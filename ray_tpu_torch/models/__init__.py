"""Models of the PyTorch/CUDA port: Llama, cached generation, the
DecodeEngine (dense or paged, speculative, multi-LoRA with its adapter
pool), the serving fleet over N engines (routing, autoscaling, health
and failover, disaggregated prefill/decode) with its fault injector,
LoRA and the train steps."""

from ray_tpu_torch.models.fault_injection import FaultInjector, InjectedFault
from ray_tpu_torch.models.fleet import (DRAINING, RETIRED, RUNNING, SUSPECT,
                                        UNHEALTHY, EngineStatsAutoscaler,
                                        FleetAutoscalingConfig, FleetError,
                                        FleetHealthConfig, FleetRouter,
                                        LLMFleet, PowerOfTwoAffinityRouter,
                                        ReplicaUnavailable, RetriesExhausted,
                                        RoundRobinRouter, make_router,
                                        replica_score)

__all__ = ["DRAINING", "RETIRED", "RUNNING", "SUSPECT", "UNHEALTHY",
           "EngineStatsAutoscaler", "FaultInjector", "FleetAutoscalingConfig",
           "FleetError", "FleetHealthConfig", "FleetRouter", "InjectedFault",
           "LLMFleet", "PowerOfTwoAffinityRouter", "ReplicaUnavailable",
           "RetriesExhausted", "RoundRobinRouter", "make_router",
           "replica_score"]
