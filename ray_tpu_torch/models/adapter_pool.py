"""Device adapter residency for multi-LoRA serving (S-LoRA / Punica
style).

Port of `ray_tpu/models/adapter_pool.py`, with the same ledger. Many
fine-tunes of ONE base model are served by one engine: the base matmul
stays shared and each row adds its own low-rank delta, which turns
adapter weights into CACHE STATE. A small working set lives on the
device, stacked along a slot axis so one gather serves every row of a
mixed batch; the rest stays on the host until traffic warms it.

- Device stacks ``{name: {"a": [L, A, n_in, r], "b": [L, A, r,
  n_out]}}`` with A = max_live_adapters + 1, allocated once and NEVER
  reallocated: the engine's decode loop is captured as CUDA graphs that
  read these tensors' storage, so every write is in place. Slot 0 is
  the NULL adapter (all zeros: base-only rows gather an exactly-zero
  delta, so one program serves mixed adapter/base batches with no
  branch). The b factors are pre-scaled by ``alpha/rank`` in f32 at
  registration, then cast to the stack dtype.
- Residency: LRU over refcount-0 residents. A slot acquired by a live
  row (`alloc`/`incref`) is pinned until every holder `decref`s: the
  paged-KV block discipline applied to adapter slots.
- Prefetch: registration keeps the pre-scaled host copies, in pinned
  memory on the card. `prefetch` starts a non-blocking host-to-device
  copy of a cold adapter into a staging tensor on a side stream and
  records an event; `drain_prefetches` makes the compute stream wait on
  that event and commits the staged tensors into a slot in place (the
  JAX pool's donated `_adapter_commit`). The engine drains only with no
  decode dispatch in flight, and defers the waiting request meanwhile.

- Tensor parallelism (``mesh=`` with a "tp" axis, ``rules=`` the
  engine's pruned serving rules): each rank's stacks hold its region
  under `lora_stack_specs` — the a-stacks of wo / w_down split on
  their input, the b-stacks of q/k/v and gate/up on their output — and
  when the kv axis replicates, the wk/wv b-stacks hold the kv heads
  this rank's q heads read, as the engine's pool does. Registration
  cuts the host copies once; commits copy into the local ``[:, slot]``.

Telemetry flows through the engine's metrics plane
(``llm_engine_adapter_*``, see engine_metrics.py) and the request
tracer ("adapter_prefetch" / "adapter_evict" instants).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig, resolve_device
from ray_tpu_torch.models.lora import LoraConfig, lora_dims, tp_cut

Params = Dict[str, Any]

# `AdapterPool.stats()`'s keys, in order; an engine without a pool
# reports each as 0.0
ADAPTER_STATS_KEYS = ("adapters_registered", "adapter_slots",
              "adapter_slots_resident", "adapter_slots_pinned",
              "adapter_lookups", "adapter_hits", "adapter_hit_rate",
              "adapter_prefetches", "adapter_evictions")


def _width(cut, n: int) -> int:
    """How many of ``n`` entries a slice or an index array keeps."""
    return len(range(n)[cut]) if isinstance(cut, slice) else len(cut)


def _host_f32(x) -> np.ndarray:
    """An adapter factor (torch tensor or array-like) as a NEW f32 numpy
    array: the registry never aliases the caller's memory."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, np.float32)


class _Staged:
    """An adapter on its way to the device: its per-target tensors on
    the device, and the event recorded after their copy on the side
    stream (None on the CPU, where the host copies are used as is)."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: Params, event):
        self.tensors = tensors
        self.event = event


class AdapterPool:
    """LRU residency manager for stacked LoRA adapters on the device.

    Ownership contract (mirrors block_pool.py's KV blocks): `alloc`
    returns a slot with one reference taken; the holder must `decref`
    exactly once (row retirement, preemption) or hand the slot to
    another owner. `incref` adds holders. Slot 0 (null adapter) is
    refcount-exempt: it is never evicted and never freed.
    """

    def __init__(self, cfg: LlamaConfig, lora_cfg: LoraConfig, *,
                 max_live_adapters: int = 4, device="cuda", metrics=None,
                 trace=None, mesh=None, rules=None):
        if max_live_adapters < 1:
            raise ValueError(
                f"max_live_adapters must be >= 1, got {max_live_adapters}")
        self.cfg = cfg
        self.lora_cfg = lora_cfg
        self.max_live_adapters = max_live_adapters
        self.n_slots = max_live_adapters + 1    # + slot 0 = null adapter
        self.device = resolve_device(device)
        self.dtype = cfg.dtype          # the engine's serving dtype
        self.metrics = metrics
        self.trace = trace
        self._dims: Dict[str, Tuple[int, int]] = lora_dims(cfg, lora_cfg)
        self._cuts = self._tp_cuts(mesh, rules)
        L, A, r = cfg.n_layers, self.n_slots, lora_cfg.rank
        self.stacks: Params = {
            name: {"a": torch.zeros((L, A, _width(self._cuts[name][0], n_in),
                                     r),
                                    dtype=self.dtype, device=self.device),
                   "b": torch.zeros((L, A, r,
                                     _width(self._cuts[name][1], n_out)),
                                    dtype=self.dtype, device=self.device)}
            for name, (n_in, n_out) in self._dims.items()}
        self._cuda = self.device.type == "cuda"
        # the staging copies' stream
        self._stream = torch.cuda.Stream(self.device) if self._cuda \
            else None

        # Host-side ledger. _registry holds pre-scaled host copies (the
        # "disk tier"); _slot_of/_slot_aid map residency; _refs pins;
        # _lru orders refcount-0 residents for eviction; _fetching holds
        # in-flight host->device stages.
        self._registry: Dict[str, Params] = {}
        self._slot_of: Dict[str, int] = {}
        self._slot_aid: List[Optional[str]] = [None] * self.n_slots
        self._refs = [0] * self.n_slots
        self._free: List[int] = list(range(self.n_slots - 1, 0, -1))
        self._lru: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._fetching: Dict[str, _Staged] = {}
        self._doomed: set = set()

        self.lookups = 0
        self.hits = 0
        self.prefetches = 0
        self.evictions = 0
        # the staged tensors' signatures every commit has seen (the slot
        # is not part of one): a new one after warm-up is a new program,
        # which an armed sanitizer counts
        self.commit_keys: set = set()

    def _tp_cuts(self, mesh, rules) -> Dict[str, Tuple[object, object]]:
        """name -> (in, out) slices (or, for kv heads replicated over tp,
        an index array) of the flattened weight that this rank's stacks
        hold: ``slice(None)`` without a tp axis."""
        from ray_tpu_torch.models.llama import _layer_shapes, llama_param_specs
        from ray_tpu_torch.parallel.sharding import mesh_axis_sizes
        from ray_tpu_torch.parallel.tensor_parallel import local_heads

        size = 1 if mesh is None else mesh_axis_sizes(mesh).get("tp", 1)
        rank = 0 if size == 1 else int(mesh.get_local_rank("tp"))
        # the base weight's spec splits the stacks as `lora_stack_specs`
        # does: its input axis the a-stack's, its output axis the b's
        specs = llama_param_specs(self.cfg, rules)["layers"]
        shapes = _layer_shapes(self.cfg)
        cuts = {}
        for name, (n_in, n_out) in self._dims.items():
            shape, _, fan_in = shapes[name]
            cut = tp_cut(shape, fan_in, specs[name][1:], size, rank)
            c_in, c_out = cut or (slice(None), slice(None))
            if name in ("wk", "wv") and size > 1 \
                    and _width(c_out, n_out) == n_out:
                # kv replicated: the heads this rank's q heads read
                hd = self.cfg.head_dim
                _, kv = local_heads(self.cfg, rules, rank, size)
                c_out = np.concatenate([np.arange(j * hd, (j + 1) * hd)
                                        for j in kv])
            cuts[name] = (c_in, c_out)
        return cuts

    # -- registration ------------------------------------------------------

    def register(self, adapter_id: str, lora: Params) -> None:
        """Admit an adapter's weights to the host tier. ``lora`` is a
        `lora_init`-shaped tree ({"layers": {name: {"a","b"}}}) of
        tensors or arrays; the b factors are pre-scaled by alpha/rank
        in f32 here, then cast to the stack dtype, so decode gathers
        need no scale multiply. Host copies only (pinned memory on the
        card): the device is touched by `prefetch`, not registration."""
        if not adapter_id:
            raise ValueError("adapter_id must be a non-empty string")
        layers = lora.get("layers", lora)
        missing = set(self._dims) - set(layers)
        if missing:
            raise ValueError(
                f"adapter {adapter_id!r} missing targets {sorted(missing)} "
                f"(pool targets: {sorted(self._dims)})")
        host: Params = {}
        scale = self.lora_cfg.scale
        for name, (n_in, n_out) in self._dims.items():
            a = _host_f32(layers[name]["a"])
            b = _host_f32(layers[name]["b"])
            want_a = (self.cfg.n_layers, n_in, self.lora_cfg.rank)
            want_b = (self.cfg.n_layers, self.lora_cfg.rank, n_out)
            if a.shape != want_a or b.shape != want_b:
                raise ValueError(
                    f"adapter {adapter_id!r} {name}: shapes "
                    f"{a.shape}/{b.shape}, want {want_a}/{want_b}")
            c_in, c_out = self._cuts[name]
            host[name] = {"a": self._to_host(a[:, c_in]),
                          "b": self._to_host(b[:, :, c_out]
                                             * np.float32(scale))}
        self._registry[adapter_id] = host
        self._doomed.discard(adapter_id)

    def _to_host(self, x: np.ndarray) -> torch.Tensor:
        """An f32 host array as a host tensor of the stack dtype, pinned
        on the card so the prefetch copy does not block."""
        t = torch.from_numpy(x).to(self.dtype)
        return t.pin_memory() if self._cuda else t

    def unregister(self, adapter_id: str) -> bool:
        """Drop an adapter. If it is pinned by live rows the removal is
        DEFERRED until the last decref (returns False); otherwise it
        leaves the registry, and its slot if resident, immediately
        (returns True). Stale stack bytes in a freed slot are
        unreachable: no row holds its index and the next commit
        overwrites it."""
        if adapter_id not in self._registry:
            return True
        slot = self._slot_of.get(adapter_id)
        if slot is not None and self._refs[slot] > 0:
            self._doomed.add(adapter_id)
            return False
        self._fetching.pop(adapter_id, None)
        if slot is not None:
            self._release_slot(adapter_id, slot)
        del self._registry[adapter_id]
        self._doomed.discard(adapter_id)
        return True

    def registered(self, adapter_id: str) -> bool:
        return adapter_id in self._registry

    def adapter_ids(self) -> List[str]:
        return sorted(self._registry)

    # -- residency queries -------------------------------------------------

    def resident(self, adapter_id: Optional[str]) -> bool:
        return adapter_id is None or adapter_id in self._slot_of

    def fetching(self, adapter_id: str) -> bool:
        return adapter_id in self._fetching

    # -- slot ownership (kv-refcount discipline) ---------------------------

    def alloc(self, adapter_id: Optional[str]) -> Optional[int]:
        """Acquire a slot for one row. None adapter -> slot 0 (no
        reference taken; the null slot is permanent). A resident
        adapter returns its slot with one reference added (pinning it
        against eviction); a cold adapter returns None: call `prefetch`
        and retry after `drain_prefetches` commits."""
        if adapter_id is None:
            return 0
        if adapter_id not in self._registry:
            raise KeyError(f"unknown adapter_id {adapter_id!r}")
        self.lookups += 1
        slot = self._slot_of.get(adapter_id)
        hit = slot is not None
        if self.metrics is not None:
            self.metrics.on_adapter_lookup(hit)
        if not hit:
            return None
        self.hits += 1
        self._lru.pop(adapter_id, None)
        self._refs[slot] += 1
        return slot

    def incref(self, slot: int) -> None:
        if slot == 0:
            return
        aid = self._slot_aid[slot]
        if aid is None:
            raise ValueError(f"incref on unowned slot {slot}")
        self._lru.pop(aid, None)
        self._refs[slot] += 1

    def decref(self, slot: int) -> None:
        if slot == 0:
            return
        aid = self._slot_aid[slot]
        if aid is None or self._refs[slot] <= 0:
            raise ValueError(f"decref on unheld slot {slot}")
        self._refs[slot] -= 1
        if self._refs[slot] == 0:
            if aid in self._doomed:
                self._release_slot(aid, slot)
                self._registry.pop(aid, None)
                self._doomed.discard(aid)
            else:
                self._lru[aid] = slot       # newest eviction candidate

    def _release_slot(self, adapter_id: str, slot: int) -> None:
        self._slot_of.pop(adapter_id, None)
        self._lru.pop(adapter_id, None)
        self._slot_aid[slot] = None
        self._refs[slot] = 0
        self._free.append(slot)

    # -- prefetch / commit -------------------------------------------------

    def prefetch(self, adapter_id: str) -> bool:
        """Begin warming a cold adapter: on the card, a non-blocking
        copy of its pinned host tensors into fresh device staging
        tensors on the side stream, then an event. Returns at once; the
        commit into a stack slot happens at the next `drain_prefetches`.
        Returns True if the adapter is already resident (nothing to
        do)."""
        if adapter_id in self._slot_of:
            return True
        if adapter_id not in self._registry:
            raise KeyError(f"unknown adapter_id {adapter_id!r}")
        if adapter_id in self._fetching:
            return False
        host = self._registry[adapter_id]
        if self._cuda:
            # The side stream does not wait for the compute stream: the
            # copy overlaps in-flight decode work. Its staging memory is
            # fresh (the allocator keeps a committed stage's memory until
            # the compute stream has run the commit that read it).
            with torch.cuda.stream(self._stream):
                staged = {name: {k: x.to(self.device, non_blocking=True)
                                 for k, x in ab.items()}
                          for name, ab in host.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
            self._fetching[adapter_id] = _Staged(staged, event)
        else:
            self._fetching[adapter_id] = _Staged(host, None)
        self.prefetches += 1
        if self.metrics is not None:
            self.metrics.on_adapter_prefetch()
        if self.trace is not None and self.trace.enabled:
            self.trace.instant("adapter_prefetch", lane="events",
                               args={"adapter_id": adapter_id})
        return False

    def drain_prefetches(self) -> int:
        """Commit every staged adapter that can get a slot (free slot
        first, else the LRU refcount-0 resident is evicted). Staged
        adapters left slotless (every slot pinned) stay in flight and
        retry next drain. Returns the number committed."""
        if not self._fetching:
            return 0
        committed = 0
        for aid in list(self._fetching):
            slot = self._take_slot()
            if slot is None:
                break                       # every slot pinned
            self._commit(self._fetching.pop(aid), slot)
            self._slot_of[aid] = slot
            self._slot_aid[slot] = aid
            self._refs[slot] = 0
            self._lru[aid] = slot
            committed += 1
        if committed and self.metrics is not None:
            self.metrics.on_adapter_slots(self.n_slots - 1,
                                          len(self._slot_of),
                                          self.pinned_slots())
        return committed

    def _commit(self, staged: _Staged, slot: int) -> None:
        """Copy one staged adapter into stack slot ``slot`` IN PLACE, on
        the current stream, after its staging copy (the stream waits on
        its event). The staging tensors were made on the side stream,
        so each is marked as used by this stream: the caching allocator
        then keeps its memory from reuse until the commit has run."""
        cur = torch.cuda.current_stream(self.device) if self._cuda else None
        self.commit_keys.add(tuple(
            (name, k, tuple(x.shape), x.dtype)
            for name, ab in staged.tensors.items() for k, x in ab.items()))
        if staged.event is not None:
            cur.wait_event(staged.event)
        for name, ab in staged.tensors.items():
            for k, x in ab.items():
                self.stacks[name][k][:, slot].copy_(x)
                if cur is not None:
                    x.record_stream(cur)

    def _take_slot(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if not self._lru:
            return None
        victim_aid, slot = self._lru.popitem(last=False)   # coldest
        del self._slot_of[victim_aid]
        self._slot_aid[slot] = None
        self.evictions += 1
        if self.metrics is not None:
            self.metrics.on_adapter_evict()
        if self.trace is not None and self.trace.enabled:
            self.trace.instant("adapter_evict", lane="events",
                               args={"adapter_id": victim_aid})
        return slot

    # -- introspection -----------------------------------------------------

    def pinned_slots(self) -> int:
        return sum(1 for r in self._refs[1:] if r > 0)

    def stats(self) -> Dict[str, float]:
        values = (len(self._registry), self.n_slots - 1, len(self._slot_of),
                  self.pinned_slots(), self.lookups, self.hits,
                  self.hits / self.lookups if self.lookups else 0.0,
                  self.prefetches, self.evictions)
        return {k: float(v) for k, v in zip(ADAPTER_STATS_KEYS, values)}
