"""Counter / Gauge / Histogram over a process-local registry.

Own copy of the three instruments of `ray_tpu/util/metrics.py` (same
tag_keys / default-tags shape). The JAX package records into its
runtime's registry, which pushes to the cluster's GCS; the port serves
without a cluster, so every series stays in this process and
`snapshots()` reads it back.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000]

_lock = threading.Lock()
_registry: Dict[tuple, Dict[str, Any]] = {}


def _series(name: str, kind: str, description: str,
            tags: Dict[str, str],
            boundaries: Optional[List[float]] = None) -> Dict[str, Any]:
    key = (name, tuple(sorted(tags.items())))
    with _lock:
        s = _registry.get(key)
        if s is None:
            s = _registry[key] = {
                "name": name, "kind": kind, "description": description,
                "tags": dict(tags), "value": 0.0}
            if kind == "histogram":
                s.update(boundaries=list(boundaries),
                         bucket_counts=[0] * (len(boundaries) + 1),
                         sum=0.0, count=0)
        return s


def snapshots() -> List[Dict[str, Any]]:
    """Every series recorded in this process: rows of ``{name, kind,
    description, tags, value}`` (histograms add ``boundaries /
    bucket_counts / sum / count``)."""
    with _lock:
        return [dict(s) for s in _registry.values()]


class _Base:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        bad = set(tags) - set(self._tag_keys)
        if bad:
            raise ValueError(f"tags {sorted(bad)} not in tag_keys")
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            bad = set(tags) - set(self._tag_keys)
            if bad:
                raise ValueError(f"tags {sorted(bad)} not in tag_keys")
            merged.update(tags)
        return merged


class Counter(_Base):
    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value <= 0:
            raise ValueError("Counter.inc value must be positive")
        s = _series(self._name, "counter", self._description,
                    self._merged(tags))
        with _lock:
            s["value"] += value


class Gauge(_Base):
    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        s = _series(self._name, "gauge", self._description,
                    self._merged(tags))
        with _lock:
            s["value"] = value


class Histogram(_Base):
    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Optional[Tuple[str, ...]] = None):
        super().__init__(name, description, tag_keys)
        self._boundaries = list(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        s = _series(self._name, "histogram", self._description,
                    self._merged(tags), self._boundaries)
        with _lock:
            s["sum"] += value
            s["count"] += 1
            idx = 0
            while idx < len(self._boundaries) and \
                    value > self._boundaries[idx]:
                idx += 1
            s["bucket_counts"][idx] += 1
