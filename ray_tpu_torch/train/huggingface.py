"""HuggingFace Transformers integration: fine-tune a torch causal LM.

Port of the Flax path of `ray_tpu/train/huggingface.py`
(``flax_causal_lm_loss``, ``flax_train_step``, ``save_flax_checkpoint``
/ ``load_flax_checkpoint``) for the ``transformers`` torch model of the
same config: the loss is next-token cross-entropy in f32 through
``torch.func.functional_call`` over a tree of the model's parameters
(``{name: tensor}``, `model_params`; tied weights appear once and stay
tied), and the step is the port's own `models.training.
make_sharded_train_step`. `load_flax_params` carries a Flax params tree
of the same config into the torch model in numpy, as transformers'
``load_flax_weights_in_pytorch_model`` does (which imports flax, so the
port does not call it). transformers is imported only where a function
needs it.

``RayTrainReportCallback`` and ``prepare_trainer`` report through a
Train session of the runtime and are not ported (ROADMAP.md, Queue A
item A14e).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import resolve_device


def _transformers():
    import transformers

    return transformers


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters as a tree for the train step: ``{name:
    detached tensor}`` (a tied weight once, under its first name)."""
    return {name: p.detach() for name, p in model.named_parameters()}


def causal_lm_loss(model: torch.nn.Module) -> Callable:
    """Next-token cross-entropy loss over a torch causal LM.

    ``loss_fn(params, batch)``: the batch is ``{"input_ids": [B, S+1]}``;
    the logits of ``model(inputs)`` with ``params`` in place of its
    parameters, cast to f32. Dropout is off, as in JAX's step
    (``train=False``): this puts ``model`` in eval mode."""
    model.eval()

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["input_ids"])
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        out = torch.func.functional_call(model, params, (inputs,),
                                         {"use_cache": False})
        logits = out.logits if hasattr(out, "logits") else out[0]
        return F.cross_entropy(
            logits.to(torch.float32).reshape(-1, logits.shape[-1]),
            targets.reshape(-1).long())

    return loss_fn


def hf_train_step(model: torch.nn.Module, optimizer, mesh=None,
                  param_specs: Any = None,
                  loss_fn: Optional[Callable] = None):
    """(init_fn, step_fn) for fine-tuning a transformers torch model.

    Defaults: fully replicated params on a one-axis dp mesh over every
    rank of the process group (`parallel.initialize_distributed` first)
    on the model's device type. ``init_fn(model_params(model))`` starts
    the step; ``model`` stays where it is (its buffers are used)."""
    from ray_tpu_torch.models.training import make_sharded_train_step

    if mesh is None:
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import create_mesh

        device = next(model.parameters()).device
        mesh = create_mesh({"dp": dist.get_world_size()},
                           device_type=device.type)
    if param_specs is None:
        param_specs = {name: () for name in model_params(model)}
    return make_sharded_train_step(
        loss_fn or causal_lm_loss(model), optimizer, mesh, param_specs)


def _flax_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flax_leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def load_flax_params(model: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Copy a Flax params tree of the same config into ``model``, in
    place: a 2-d ``kernel`` transposed and a 4-d one permuted (3, 2, 0,
    1) into ``weight``, ``scale`` and ``embedding`` into ``weight``; the
    base model's prefix is added or dropped as the two trees need.
    Raises if a torch parameter has no source or another shape."""
    src = {}
    for path, x in _flax_leaves(flax_params):
        *head, last = path
        if last == "kernel" and x.ndim == 4:
            x, last = np.transpose(x, (3, 2, 0, 1)), "weight"
        elif last == "kernel":
            x, last = x.T, "weight"
        elif last in ("scale", "embedding"):
            last = "weight"
        src[".".join(head + [last])] = x
    prefix = getattr(model, "base_model_prefix", "") + "."
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name if name in src else (
                name[len(prefix):] if name.startswith(prefix)
                else prefix + name)
            if key not in src:
                raise KeyError(f"{name}: not in the Flax params")
            x = torch.from_numpy(np.array(src[key]))
            if tuple(x.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(x)
    return model


def save_hf_checkpoint(model: torch.nn.Module, params, directory: str
                       ) -> str:
    """Persist the HF config and ``params`` as a reloadable directory
    checkpoint (an array checkpoint under ``torch_params``)."""
    from ray_tpu_torch.train.array_checkpoint import save_pytree

    os.makedirs(directory, exist_ok=True)
    model.config.save_pretrained(directory)
    save_pytree(params, os.path.join(directory, "torch_params"))
    return directory


def load_hf_checkpoint(model_cls, directory: str, device="cuda"):
    """Rebuild (model, params) from `save_hf_checkpoint`: the restored
    weights become the model's own, on ``device``."""
    from ray_tpu_torch.train.array_checkpoint import restore_pytree

    config = _transformers().AutoConfig.from_pretrained(directory)
    model = model_cls(config)
    params = restore_pytree(model_params(model),
                            os.path.join(directory, "torch_params"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    model = model.to(resolve_device(device))
    return model, model_params(model)
