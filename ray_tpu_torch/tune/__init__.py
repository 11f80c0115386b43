"""ray_tpu_torch.tune — the class API of a trainable.

Port of the part of `ray_tpu/tune/` that the RLlib port needs: the
host-side `Trainable` interface (setup / step / checkpoints /
``train()``), which QMIX and AlphaZero subclass. The function API
(``report``, ``FunctionTrainable``, ``wrap_function``) and the trial
actor need a Train session and the actor runtime, and are not ported
yet (ROADMAP.md, Queue A item A14e).
"""

from ray_tpu_torch.tune.trainable import Trainable

__all__ = ["Trainable"]
