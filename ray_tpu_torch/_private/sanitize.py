"""Runtime sanitizer: steady-state new dispatch keys + device->host
transfer gating.

Port of `ray_tpu/_private/sanitize.py`. With ``RAY_TPU_SANITIZE=1`` (or
an explicit ``DecodeEngine(sanitize=True)``) the engine builds a
:class:`Sanitizer`, runs its normal warm-up, then **arms** it:

* **new-key counter** — JAX counts growth of the jit caches of the
  engine's entry points; PyTorch runs eagerly and compiles nothing, so
  the port counts what takes a compile's place: a new dispatch key (a
  decode loop of a new (horizon, all-greedy) or ("spec", W, all-greedy)
  key, recorded per dispatch on every device), a new CUDA-graph capture
  on the card, and a new staged-tensor signature of the adapter pool's
  commit. Each watched counter is snapshotted at arm time;
  :meth:`Sanitizer.retraces` reports any growth. The steady decode path
  must stay at zero.

* **transfer interposition** — the pulls of ``torch.Tensor``
  (``__array__``, ``__bool__``, ``__float__``, ``__int__``,
  ``__index__``, ``item``, ``tolist``, ``numpy``) are wrapped while
  armed. Any pull not run through the engine's choke points
  (`_device_get`, `_host_async`, which call :meth:`expected_get` /
  :meth:`expected_copy_async`) raises :class:`SanitizerError` (strict
  mode, the default) or is tallied in ``unexpected_transfers``. Every
  tensor counts, on every device: on the CPU, where the engine's device
  tensors are host memory, this is the JAX CPU backend's behaviour (its
  arrays count as device arrays there too), and the engine keeps its
  host bookkeeping in numpy.

* **sync debug mode** — on the card, ``torch.cuda.set_sync_debug_mode``
  is additionally set while armed (``"error"`` in strict mode, ``"warn"``
  in counting mode, whose warnings are tallied in ``unexpected_syncs``),
  so a synchronizing CUDA op that is not a tensor pull (a blocking copy,
  a stream synchronize, a data-dependent shape) is caught too. Expected
  pulls run with the mode off. It is the counterpart of JAX's device to
  host transfer guard; torch raises its own ``RuntimeError`` for it.

An interposition that cannot be installed raises: nothing falls back
silently.

Environment knobs (read by :func:`resolve`):

* ``RAY_TPU_SANITIZE=1``      — build a sanitizer when the engine doesn't pass one
* ``RAY_TPU_SANITIZE_STRICT=0`` — count unexpected transfers instead of raising
* ``RAY_TPU_SANITIZE_WARMUP=N`` — auto-arm after N engine steps (default 8)

Only one sanitizer may be armed at a time (the interposition is
process-global). The off path costs one module-global ``is None`` check
in each choke point, nothing else.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Callable, Dict, List, Optional, TypeVar

import torch

ENV_SANITIZE = "RAY_TPU_SANITIZE"
ENV_STRICT = "RAY_TPU_SANITIZE_STRICT"
ENV_WARMUP = "RAY_TPU_SANITIZE_WARMUP"

DEFAULT_WARMUP_STEPS = 8

_PATCHED_ATTRS = (
    "__array__",
    "__bool__",
    "__float__",
    "__int__",
    "__index__",
    "item",
    "tolist",
    "numpy",
)

# The text torch gives a synchronizing op under sync debug mode "warn".
_SYNC_WARNING = "called a synchronizing CUDA operation"

# The process-global armed sanitizer (None = sanitizing off; the engine's
# choke points do exactly one read of this via active()).
_ACTIVE: Optional["Sanitizer"] = None

T = TypeVar("T")


class SanitizerError(RuntimeError):
    """An unexpected device->host transfer while the sanitizer was armed."""


def active() -> Optional["Sanitizer"]:
    return _ACTIVE


def _env_true(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip().lower() not in (
        "", "0", "false", "no")


def warmup_steps() -> int:
    try:
        return max(0, int(os.environ.get(ENV_WARMUP, DEFAULT_WARMUP_STEPS)))
    except ValueError:
        return DEFAULT_WARMUP_STEPS


def resolve(spec) -> Optional["Sanitizer"]:
    """Engine-facing constructor mirroring ``engine_trace.resolve_tracer``:

    * ``Sanitizer`` instance — used as-is
    * truthy (``True``/``1``/``"strict"``) — fresh strict sanitizer
    * ``None`` — consult ``RAY_TPU_SANITIZE`` (off unless set)
    * falsy — off
    """
    if isinstance(spec, Sanitizer):
        return spec
    if spec is None:
        if not _env_true(ENV_SANITIZE):
            return None
        return Sanitizer(strict=_env_true(ENV_STRICT, default="1"))
    if spec:
        return Sanitizer()
    return None


class Sanitizer:
    """New-key counter + transfer interposition for one engine's hot
    loop."""

    def __init__(self, *, strict: bool = True, label: str = ""):
        self.strict = strict
        self.label = label
        self.armed = False
        self.expected_pulls = 0
        self.expected_async = 0
        self.unexpected_transfers: List[str] = []
        self.unexpected_syncs: List[str] = []
        self._watched: Dict[str, Callable[[], int]] = {}
        self._baseline: Dict[str, int] = {}
        self._in_expected = 0
        self._saved_attrs: Dict[str, tuple] = {}
        self.sync_debug = False        # armed on the card at least once
        self._cuda = False
        self._saved_sync_mode = 0
        self._warnings = None

    # -- watch list ---------------------------------------------------------

    def watch(self, name: str, count: Optional[Callable[[], int]]) -> None:
        """Register a counter of keys (a zero-argument callable returning
        how many distinct dispatch keys, captures or commit signatures
        the watched entry point has seen) for new-key accounting
        (idempotent; None is skipped, as JAX skips an object without a
        compile cache)."""
        if count is None:
            return
        if not callable(count):
            raise TypeError(f"watch({name!r}): need a callable counter, "
                            f"got {type(count).__name__}")
        self._watched[name] = count
        if self.armed:
            self._baseline[name] = count()

    # -- arm / disarm -------------------------------------------------------

    def arm(self, device=None) -> None:
        """Snapshot the counters and install the interposition. On a
        ``cuda`` ``device`` the sync debug mode is set as well."""
        global _ACTIVE
        if self.armed:
            return
        if _ACTIVE is not None:
            raise RuntimeError(
                "another Sanitizer is already armed (the transfer "
                "interposition is process-global); disarm it first")
        self._baseline = {name: count()
                          for name, count in self._watched.items()}
        self._patch_tensor()
        try:
            if device is not None and torch.device(device).type == "cuda":
                self._arm_sync_debug()
        except BaseException:
            self._unpatch_tensor()
            raise
        self.armed = True
        _ACTIVE = self

    def disarm(self) -> None:
        global _ACTIVE
        if not self.armed:
            return
        self._unpatch_tensor()
        self._disarm_sync_debug()
        self.armed = False
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "Sanitizer":
        self.arm()
        return self

    def __exit__(self, *exc) -> None:
        self.disarm()

    # -- the expected choke points ------------------------------------------

    def expected_get(self, pull: Callable[[], T]) -> T:
        """The sanctioned blocking pull (the engine's `_device_get` runs
        its wait-and-read here)."""
        with self.expected():
            out = pull()
        self.expected_pulls += 1
        return out

    def expected_copy_async(self, copy: Callable[[], T]) -> T:
        """The sanctioned async host copy (the engine's dispatch ring)."""
        with self.expected():
            out = copy()
        self.expected_async += 1
        return out

    @contextlib.contextmanager
    def expected(self):
        """A scope of the engine's own that may sync or pull without
        counting as a pull: a first-use CUDA-graph capture, which the
        capture counter reports instead."""
        self._in_expected += 1
        mode = None
        if self._cuda:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            self._in_expected -= 1

    # -- accounting ---------------------------------------------------------

    def retraces(self) -> Dict[str, int]:
        """Watched counters that grew since arm(): the new keys."""
        out: Dict[str, int] = {}
        for name, count in self._watched.items():
            base = self._baseline.get(name)
            if base is None:
                continue
            delta = count() - base
            if delta:
                out[name] = delta
        return out

    def total_retraces(self) -> int:
        return sum(self.retraces().values())

    def stats(self) -> Dict[str, object]:
        return {
            "armed": self.armed,
            "strict": self.strict,
            "expected_pulls": self.expected_pulls,
            "expected_async": self.expected_async,
            "unexpected_transfers": len(self.unexpected_transfers),
            "unexpected_syncs": len(self.unexpected_syncs),
            "sync_debug": self.sync_debug,
            "retraces": self.retraces(),
            "watched": sorted(self._watched),
        }

    # -- interposition ------------------------------------------------------

    def _on_transfer(self, kind: str) -> None:
        if self._in_expected:
            return
        msg = (
            f"unexpected device->host transfer via Tensor.{kind} while the "
            f"sanitizer was armed{(' (' + self.label + ')') if self.label else ''}; "
            "hot-path pulls must route through _device_get")
        self.unexpected_transfers.append(msg)
        if self.strict:
            raise SanitizerError(msg)

    def _patch_tensor(self) -> None:
        cls = torch.Tensor
        try:
            for attr in _PATCHED_ATTRS:
                orig = getattr(cls, attr)
                self._saved_attrs[attr] = (attr in cls.__dict__,
                                           cls.__dict__.get(attr))

                def _make(orig=orig, attr=attr):
                    def _guarded(t, *args, **kwargs):
                        san = _ACTIVE
                        if san is None:
                            return orig(t, *args, **kwargs)
                        san._on_transfer(attr)
                        # a pull made of pulls (``__array__`` reads
                        # ``numpy``) is reported once
                        san._in_expected += 1
                        try:
                            return orig(t, *args, **kwargs)
                        finally:
                            san._in_expected -= 1

                    _guarded.__name__ = attr
                    return _guarded

                guarded = _make()
                setattr(cls, attr, guarded)
                if getattr(cls, attr) is not guarded:
                    raise RuntimeError(f"torch.Tensor.{attr} did not take "
                                       "the sanitizer's wrapper")
        except BaseException:
            self._unpatch_tensor()
            raise

    def _unpatch_tensor(self) -> None:
        cls = torch.Tensor
        for attr, (own, orig) in self._saved_attrs.items():
            if own:
                setattr(cls, attr, orig)
            elif attr in cls.__dict__:
                delattr(cls, attr)
        self._saved_attrs.clear()

    # -- sync debug mode (the card only) -------------------------------------

    def _arm_sync_debug(self) -> None:
        self._saved_sync_mode = torch.cuda.get_sync_debug_mode()
        if not self.strict:
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
            show = warnings.showwarning

            def counted(message, category, *args, **kwargs):
                if _SYNC_WARNING in str(message) and not self._in_expected:
                    self.unexpected_syncs.append(str(message))
                return show(message, category, *args, **kwargs)

            warnings.showwarning = counted
        torch.cuda.set_sync_debug_mode("error" if self.strict else "warn")
        self._cuda = self.sync_debug = True

    def _disarm_sync_debug(self) -> None:
        if not self._cuda:
            return
        torch.cuda.set_sync_debug_mode(self._saved_sync_mode)
        if self._warnings is not None:
            self._warnings.__exit__(None, None, None)
            self._warnings = None
        self._cuda = False
