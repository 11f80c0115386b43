"""Offline experience IO.

Reference: rllib/offline/ (json_writer.py / json_reader.py — sample
batches as JSON-lines files; dataset-based offline input for
BC/MARWIL/CQL). Arrays are stored column-wise per batch with base64
numpy payloads (exact dtype/shape roundtrip, unlike float-text JSON).

A copy of `ray_tpu/rllib/offline.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

import base64
import glob as _glob
import io
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def _encode(arr: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return {"__npy__": base64.b64encode(buf.getvalue()).decode()}


def _decode(obj):
    if isinstance(obj, dict) and "__npy__" in obj:
        return np.load(io.BytesIO(base64.b64decode(obj["__npy__"])),
                       allow_pickle=False)
    return obj


class JsonWriter:
    """Append sample batches to JSON-lines files (reference:
    offline/json_writer.py). One file per writer; rolls at
    max_file_size bytes."""

    def __init__(self, path: str, max_file_size: int = 64 << 20):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_file_size = max_file_size
        self._f = None
        self._bytes = 0

    def _open(self):
        name = f"experiences_{int(time.time() * 1000)}_{os.getpid()}.json"
        self._f = open(os.path.join(self.path, name), "a")
        self._bytes = 0

    def write(self, batch: Dict[str, Any]) -> None:
        """batch: column dict (obs/actions/rewards/... -> arrays)."""
        if self._f is None or self._bytes > self.max_file_size:
            if self._f is not None:
                self._f.close()
            self._open()
        line = json.dumps({k: _encode(v) if isinstance(
            v, (np.ndarray, list)) else v for k, v in batch.items()})
        self._f.write(line + "\n")
        self._bytes += len(line) + 1
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JsonReader:
    """Read experience files back as column batches (reference:
    offline/json_reader.py)."""

    def __init__(self, paths):
        if isinstance(paths, str):
            if os.path.isdir(paths):
                paths = sorted(_glob.glob(os.path.join(paths, "*.json")))
            else:
                paths = sorted(_glob.glob(paths)) or [paths]
        self.files: List[str] = list(paths)
        if not self.files:
            raise FileNotFoundError("no experience files found")

    def read_batches(self) -> Iterator[Dict[str, Any]]:
        for f in self.files:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    raw = json.loads(line)
                    yield {k: _decode(v) for k, v in raw.items()}

    def read_all(self) -> Dict[str, np.ndarray]:
        """All batches concatenated column-wise."""
        cols: Dict[str, list] = {}
        for batch in self.read_batches():
            for k, v in batch.items():
                cols.setdefault(k, []).append(np.asarray(v))
        return {k: np.concatenate(v) for k, v in cols.items()}

    def as_dataset(self, parallelism: int = 8):
        """A Data-library Dataset of per-step rows. The Data library is
        not ported: pass `read_all()`'s column dict to
        ``offline_data(dataset=...)`` instead."""
        raise NotImplementedError(
            "JsonReader.as_dataset needs the Data library, which is not "
            "ported to ray_tpu_torch yet (ROADMAP.md, Queue A item A14d); "
            "use read_all()")


def collect_experiences(algorithm, path: str, steps_per_round: int = 512,
                        num_rounds: int = 1) -> str:
    """Sample the algorithm's env runners and persist the rollouts
    (reference: the `output` config writing rollouts during training).
    Returns the output dir."""
    with JsonWriter(path) as writer:
        for _ in range(num_rounds):
            batch = algorithm.env_runner_group.sample(steps_per_round)
            writer.write(dict(batch))
    return path
