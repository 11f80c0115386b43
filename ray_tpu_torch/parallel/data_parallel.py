"""The train step's batch split, as a model sees it.

JAX's train step is one GSPMD program over the global batch, so a model
that reduces over the batch — MoE routing's capacity count and its
load-balancing means (`models/moe.py`), a pad-masked token mean
(`models/t5.py`) — computes the global quantity there. The port's step
runs the loss_fn on each rank's rows, so it publishes its split of the
batch while the loss_fn runs (`batch_split`), and a model asks for the
global quantity here:

- `current()`: the `BatchSplit` of the step running now, or None
  outside a step (the model keeps its single-device semantics). A model
  reads it in its forward and hands it on to the functions below: the
  backward, and with it a checkpoint's recompute, may run on another
  thread (autograd's device thread on the card), which does not see
  the context of the step's;
- `sum_over_batch(x)`: ``x`` summed over the batch ranks (no gradient);
- `SumOverBatch`: the differentiable sum, whose backward sums the
  cotangents over the batch ranks too: under the step's ``1/n`` weight
  each rank's share of a replicated global term then gets its full
  gradient;
- `gather_over_batch(x)`: every batch rank's ``x`` stacked in the order
  of the rows they hold;
- `count_tokens(n)`: a loss_fn that is a mean over a data-dependent
  count reports this rank's count, and the step weights its loss by its
  share of the global count (`training._Mesh.weight`);
- `refuse_model_split(name)`: a model without an sp layer refuses to
  run under a step whose mesh splits the sequence (ROADMAP A13b).

A split of one rank runs no collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class BatchSplit:
    """The batch as one rank of a train step holds it: ``size`` ranks
    over the step's batch axes, this rank's rows the ``rank``-th block
    of the global batch; ``group`` is None for one rank. ``sizes`` are
    the mesh's axis sizes; ``count`` what `count_tokens` reported."""

    group: object
    rank: int
    size: int
    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    count: Optional[torch.Tensor] = None


_CURRENT = contextvars.ContextVar("batch_split", default=None)


@contextlib.contextmanager
def batch_split(split: BatchSplit):
    """The block runs a train step's loss_fn on this rank's rows."""
    token = _CURRENT.set(split)
    try:
        yield split
    finally:
        _CURRENT.reset(token)


def current() -> Optional[BatchSplit]:
    return _CURRENT.get()


def _split(split: Optional[BatchSplit]) -> bool:
    return split is not None and split.size > 1


def sum_over_batch(x: torch.Tensor,
                   split: Optional[BatchSplit]) -> torch.Tensor:
    """A new tensor: ``x`` summed over the batch ranks (no gradient)."""
    x = x.detach().clone()
    if _split(split):
        import torch.distributed as dist

        dist.all_reduce(x, group=split.group)
    return x


class SumOverBatch(torch.autograd.Function):
    """All-reduce forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return sum_over_batch(x, split)

    @staticmethod
    def backward(ctx, g):
        return sum_over_batch(g, ctx.split), None


def summed_over_batch(x: torch.Tensor,
                      split: Optional[BatchSplit]) -> torch.Tensor:
    """`SumOverBatch` over a split of several ranks, else ``x``."""
    return SumOverBatch.apply(x, split) if _split(split) else x


def gather_over_batch(x: torch.Tensor,
                      split: Optional[BatchSplit]) -> torch.Tensor:
    """[ranks, *x.shape]: every batch rank's ``x`` in batch order (no
    gradient); ``x[None]`` for a split of one rank or none."""
    if not _split(split):
        return x.detach()[None]
    import torch.distributed as dist

    flat = x.detach().reshape(-1).contiguous()
    staged = flat.is_cuda and "nccl" not in str(dist.get_backend(split.group))
    if staged:            # gloo gathers host tensors
        flat = flat.cpu()
    out = flat.new_empty((split.size * flat.numel(),))
    dist.all_gather_into_tensor(out, flat, group=split.group)
    return out.to(x.device).reshape((split.size,) + x.shape)


def count_tokens(n: torch.Tensor) -> None:
    """Report the count this rank's loss is a mean over (see the module
    docstring); nothing outside a step."""
    split = current()
    if split is not None:
        n = n.detach().to(torch.float32)
        split.count = n if split.count is None else split.count + n


def refuse_model_split(name: str) -> None:
    """Raise NotImplementedError under a step whose mesh splits sp:
    ``name`` has no sequence-parallel layer yet, and would compute
    within sequence blocks."""
    split = current()
    if split is not None and split.sizes.get("sp", 1) > 1:
        raise NotImplementedError(
            f"{name} under a train step over sp={split.sizes['sp']}: the "
            "model has no sequence-parallel layer yet, ROADMAP A13b")
