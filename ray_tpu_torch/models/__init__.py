"""Models of the PyTorch/CUDA port: Llama, cached generation, the
DecodeEngine (dense or paged, speculative, multi-LoRA with its adapter
pool), the serving fleet over N engines (routing, autoscaling, health
and failover, disaggregated prefill/decode) with its fault injector,
LoRA, the train steps, and the other families: Mixtral-style MoE, ViT,
T5 (with its cached generation) and the MLP."""

from ray_tpu_torch.models.fault_injection import FaultInjector, InjectedFault
from ray_tpu_torch.models.fleet import (DRAINING, RETIRED, RUNNING, SUSPECT,
                                        UNHEALTHY, EngineStatsAutoscaler,
                                        FleetAutoscalingConfig, FleetError,
                                        FleetHealthConfig, FleetRouter,
                                        LLMFleet, PowerOfTwoAffinityRouter,
                                        ReplicaUnavailable, RetriesExhausted,
                                        RoundRobinRouter, make_router,
                                        replica_score)
from ray_tpu_torch.models.mlp import (MLPConfig, mlp_forward, mlp_init,
                                      mlp_loss)
from ray_tpu_torch.models.moe import (MoeConfig, moe_flops_per_token,
                                      moe_forward, moe_init, moe_loss,
                                      moe_param_specs)
from ray_tpu_torch.models.t5 import (T5Config, t5_decode, t5_encode,
                                     t5_forward, t5_generate, t5_init,
                                     t5_loss, t5_param_specs)
from ray_tpu_torch.models.vit import (ViTConfig, vit_forward, vit_init,
                                      vit_loss, vit_param_specs)

__all__ = ["DRAINING", "RETIRED", "RUNNING", "SUSPECT", "UNHEALTHY",
           "EngineStatsAutoscaler", "FaultInjector", "FleetAutoscalingConfig",
           "FleetError", "FleetHealthConfig", "FleetRouter", "InjectedFault",
           "LLMFleet", "MLPConfig", "MoeConfig", "PowerOfTwoAffinityRouter",
           "ReplicaUnavailable", "RetriesExhausted", "RoundRobinRouter",
           "T5Config", "ViTConfig", "make_router", "mlp_forward", "mlp_init",
           "mlp_loss", "moe_flops_per_token", "moe_forward", "moe_init",
           "moe_loss", "moe_param_specs", "replica_score", "t5_decode",
           "t5_encode", "t5_forward", "t5_generate", "t5_init", "t5_loss",
           "t5_param_specs", "vit_forward", "vit_init", "vit_loss",
           "vit_param_specs"]
