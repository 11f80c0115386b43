"""Pipeline parallelism: the GPipe schedule over a mesh's "pp" axis.

Port of `ray_tpu/parallel/pipeline.py`. In JAX the whole pipeline is one
`shard_map` program: each pp rank holds one stage's params, a
`lax.scan` over ``n_microbatches + n_stages - 1`` ticks runs the stage
on its microbatch of the tick, activations hop to the next stage with
`ppermute` after every tick, and a `psum` replicates the last stage's
outputs over pp. The port runs one process per rank, so the same tick
schedule runs in Python with the hand-offs as point-to-point transfers
over the pp group: `batch_isend_irecv` on NCCL, waited on by the
caller's stream (an event, no host sync); over gloo, CUDA tensors are
staged through host memory. A stage skips the bubble ticks (their work
never reaches the output in JAX either).

`make_pipelined_fn` returns one differentiable function (`_Pipeline`, a
`torch.autograd.Function`): its forward runs every microbatch of the
rank's stage under autograd and keeps each microbatch's graph, and its
backward runs the ticks in reverse, each stage taking its outputs'
cotangent from the next stage and handing its input's cotangent to the
previous one, so the backward is pipelined too and every rank runs
every hand-off in one order. The result is replicated over pp (a
broadcast from the last stage), and so is the input's gradient (a
broadcast from the first stage): a leaf used before the pipeline on
every pp rank (an embedding) or after it (a head) gets the same
gradient on every rank, never summed over pp.

Bubble fraction is GPipe's (S - 1) / (T + S - 1) for S stages and T
microbatches.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ray_tpu_torch.parallel.sequence_parallel import (Pending, SPGroup,
                                                      is_split, sp_group)

Pytree = Any


def _leaves(tree: Pytree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def _unflatten(tree: Pytree, leaves: List[Any]) -> Pytree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(tree)


def stack_stage_params(per_stage_params: list) -> Pytree:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim (shard it over ``pp`` via the "stage" logical axis)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params))


def _global(pp: SPGroup, rank: int) -> int:
    import torch.distributed as dist

    return dist.get_global_rank(pp.group, rank)


def _hand_off(pp: SPGroup, send: Optional[torch.Tensor], dst: int,
              like: Optional[torch.Tensor], src: int) -> Pending:
    """One tick's hand-offs of this rank: ``send`` to stage ``dst`` and
    a tensor shaped as ``like`` from stage ``src`` (either may be None).
    Returns the exchange in flight (`Pending.wait` gives [received])."""
    import torch.distributed as dist

    if send is None and like is None:
        return Pending([], [], None)
    send = None if send is None else send.detach().contiguous()
    if pp.nccl:
        recv = None if like is None else torch.empty_like(like)
        ops = ([] if send is None else
               [dist.P2POp(dist.isend, send, _global(pp, dst), pp.group)])
        ops += ([] if recv is None else
                [dist.P2POp(dist.irecv, recv, _global(pp, src), pp.group)])
        return Pending(dist.batch_isend_irecv(ops),
                       [] if recv is None else [recv], send)
    device = None
    works, received = [], []
    if send is not None:
        host = send.cpu() if send.is_cuda else send
        works.append(dist.isend(host, _global(pp, dst), group=pp.group))
        send = host
    if like is not None:
        device = like.device if like.is_cuda else None
        recv = torch.empty(like.shape, dtype=like.dtype)
        works.append(dist.irecv(recv, _global(pp, src), group=pp.group))
        received.append(recv)
    return Pending(works, received, send, device)


def _broadcast(pp: SPGroup, x: torch.Tensor, src: int) -> torch.Tensor:
    """Stage ``src``'s ``x`` on every pp rank (in place on NCCL; gloo
    stages a CUDA tensor through the host)."""
    import torch.distributed as dist

    if pp.nccl or not x.is_cuda:
        dist.broadcast(x, src=_global(pp, src), group=pp.group)
        return x
    host = x.cpu()
    dist.broadcast(host, src=_global(pp, src), group=pp.group)
    return host.to(x.device)


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one pp rank's stage; see the module
    docstring. ``leaves`` are the stage's params (this rank's block)."""

    @staticmethod
    def forward(ctx, stage_fn, pp, n_micro, tree, x, *leaves):
        S, s = pp.size, pp.rank
        M = n_micro
        mb = x.shape[0] // M
        micro = x.detach().reshape((M, mb) + x.shape[1:])
        ins: List[Optional[torch.Tensor]] = [None] * M
        ys: List[Optional[torch.Tensor]] = [None] * M
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
            params = _unflatten(tree, ps)
            pending = _hand_off(pp, None, 0, None, 0)
            sends = []
            for t in range(M + S - 1):
                m = t - s
                if 0 <= m < M:
                    x_in = micro[m] if s == 0 else pending.wait()[0]
                    x_in = x_in.detach().requires_grad_(
                        s > 0 or x.requires_grad)
                    y = stage_fn(params, x_in)
                    if y.shape != x_in.shape or y.dtype != x_in.dtype:
                        raise ValueError(
                            f"stage output {tuple(y.shape)} {y.dtype} != "
                            f"its input {tuple(x_in.shape)} {x_in.dtype}: "
                            "activations keep their shape across stages")
                    ins[m], ys[m] = x_in, y
                nxt = t + 1 - s      # the microbatch of this stage's next tick
                like = micro[0] if s > 0 and 0 <= nxt < M else None
                pending = _hand_off(
                    pp, ys[m] if s < S - 1 and 0 <= m < M else None, s + 1,
                    like, s - 1)
                if like is None:    # a send no later receive waits for
                    sends.append(pending)
        for p in sends:             # every send done before its buffer goes
            p.wait()
        out = micro.new_empty(micro.shape)
        if s == S - 1:
            torch.stack([y.detach() for y in ys], out=out)
        if S > 1:
            out = _broadcast(pp, out, S - 1)
        ctx.stage = (pp, M, mb, x.requires_grad)
        ctx.graph = (ins, ys, ps)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        pp, M, mb, x_grad = ctx.stage
        ins, ys, ps = ctx.graph
        ctx.graph = None
        S, s = pp.size, pp.rank
        g = g.reshape((M, mb) + g.shape[1:])
        wanted = [p for p in ps if p.requires_grad]
        dps: List[Optional[torch.Tensor]] = [None] * len(wanted)
        dx = torch.zeros_like(g) if x_grad else None
        pending = _hand_off(pp, None, 0, None, 0)
        sends = []
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = None
            if 0 <= m < M:
                dy = g[m] if s == S - 1 else pending.wait()[0]
                first = [ins[m]] if ins[m].requires_grad else []
                grads = torch.autograd.grad(ys[m], first + wanted, dy,
                                            allow_unused=True)
                if first:
                    send = grads[0] if grads[0] is not None \
                        else torch.zeros_like(ins[m])
                    if s == 0:
                        dx[m] = send
                ins[m] = ys[m] = None
                for i, d in enumerate(grads[len(first):]):
                    if d is not None:
                        dps[i] = d if dps[i] is None else dps[i] + d
            nxt = t - 1 - s          # the microbatch of the next reverse tick
            like = g[0] if s < S - 1 and 0 <= nxt < M else None
            pending = _hand_off(pp, send if s > 0 else None, s - 1, like,
                                s + 1)
            if like is None:
                sends.append(pending)
        for p in sends:
            p.wait()
        if x_grad and S > 1:
            dx = _broadcast(pp, dx.contiguous(), 0)
        it = iter(dps)
        param_grads = [next(it) if p.requires_grad else None for p in ps]
        return (None, None, None, None,
                None if dx is None else dx.reshape((M * mb,) + g.shape[2:]),
                *param_grads)


def make_pipelined_fn(stage_fn: Callable[[Pytree, torch.Tensor],
                                         torch.Tensor],
                      mesh, n_microbatches: int, axis: str = "pp"):
    """Builds pipelined(params, x) -> y (collective: every rank calls it
    and the result in the same order).

    stage_fn(stage_params, x_microbatch) -> y_microbatch: one stage's
    compute (e.g. a loop over its layers). Activations keep their shape
    and dtype across stages.

    params: a tree whose leaves have a leading stage dim: this rank's
    block (size 1, as `make_sharded_train_step` holds a leaf split over
    pp) or the whole stack (size n_stages: the rank takes its own
    stage's block). x: [global_batch, ...] with global_batch %
    n_microbatches == 0, the same on every pp rank. Returns y of x's
    shape, the same on every pp rank. A mesh without the axis, or with
    it of size 1, runs every stage of the stack in turn on each
    microbatch."""
    pp = sp_group(mesh, axis)
    n_stages = pp.size
    if pp.nccl:
        # the pp group's communicator, made by every rank at once before
        # the first hand-off (in which some ranks take no part)
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device="cuda"), group=pp.group)

    def pipelined(params: Pytree, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_microbatches:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{n_microbatches} microbatches")
        leaves = _leaves(params)
        held = {p.shape[0] for p in leaves}
        if len(held) != 1 or held.pop() not in (1, n_stages):
            raise ValueError(
                f"stage params need one leading stage dim of 1 (this "
                f"rank's block) or {n_stages}; got "
                f"{sorted({p.shape[0] for p in leaves})}")
        if not is_split(pp):
            stacked = leaves[0].shape[0]
            micro = x.reshape((n_microbatches, -1) + x.shape[1:])
            outs = []
            for xm in micro:
                for i in range(stacked):
                    xm = stage_fn(_unflatten(params,
                                             [p[i] for p in leaves]), xm)
                outs.append(xm)
            return torch.stack(outs).reshape(x.shape)
        block = [p[0] if p.shape[0] == 1 else p[pp.rank] for p in leaves]
        return _Pipeline.apply(stage_fn, pp, n_microbatches, params, x,
                               *block)

    return pipelined
