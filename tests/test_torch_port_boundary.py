"""PyTorch port, package boundary and the host-side own copies.

The port imports nothing of JAX or of the JAX package (an AST walk over
every module and `chip_smoke.py`), importing it builds and probes
nothing (a fresh interpreter), and its own copies of the block pool and
the scheduler policies behave as the JAX package's originals on the
same operation sequences.
"""

import ast
import faulthandler
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu.models import block_pool as jbp
from ray_tpu.models import scheduler as jsched
from ray_tpu_torch.models import block_pool as tbp
from ray_tpu_torch.models import scheduler as tsched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ray_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(60, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def test_no_jax_or_ray_tpu_import_in_port():
    sources = _port_sources()
    assert len(sources) > 10
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}: {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_import_builds_and_probes_nothing():
    """A fresh interpreter imports the package: no JAX module is loaded,
    no kernel library is built or loaded, and CUDA is not initialised."""
    code = (
        "import sys, torch, ray_tpu_torch\n"
        "from ray_tpu_torch import _build\n"
        "import ray_tpu_torch.models.engine, ray_tpu_torch.convert\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu')"
        " for m in sys.modules), 'jax/ray_tpu imported'\n"
        "assert not _build._libs, 'a kernel library was loaded'\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr


def _pool_ops(pool, seed):
    """A seeded sequence of alloc/incref/decref; returns every result
    and the final ledger."""
    rng = np.random.RandomState(seed)
    held, log = [], []
    for _ in range(200):
        op = rng.randint(3)
        if op == 0:
            ids = pool.alloc(int(rng.randint(0, 4)))
            log.append(("alloc", ids))
            if ids:
                held.append(ids)
        elif op == 1 and held:
            ids = held[rng.randint(len(held))]
            pool.incref(ids)
            held.append(ids)
            log.append(("incref", ids))
        elif held:
            ids = held.pop(rng.randint(len(held)))
            log.append(("decref", pool.decref(ids)))
    return log, pool.snapshot(), [pool.ref(b) for b in range(pool.n_blocks)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_copy_matches_original(seed):
    assert _pool_ops(tbp.BlockPool(12), seed) == \
        _pool_ops(jbp.BlockPool(12), seed)


@pytest.mark.parametrize("case", ["tiny", "decref_free", "incref_free",
                                  "negative"])
def test_block_pool_copy_rejects(case):
    pool = tbp.BlockPool(4)
    with pytest.raises(ValueError):
        if case == "tiny":
            tbp.BlockPool(1)
        elif case == "decref_free":
            pool.decref([1])
        elif case == "incref_free":
            pool.incref([2])
        else:
            pool.alloc(-1)


class _Req:
    def __init__(self, i, priority):
        self.req_id, self.seq, self.priority = i, i, priority


@pytest.mark.parametrize("policy", ["fifo", "priority"])
def test_scheduler_copy_orders_like_original(policy):
    prio = [3, 0, 3, 1, 0, 2]
    orders = []
    for mod in (tsched, jsched):
        p = mod.make_policy(policy)
        for i, pr in enumerate(prio):
            p.push(_Req(i, pr))
        p.push_front(_Req(99, 5))
        first = p.pop().req_id
        hints = (p.horizon_hint(free_slots=1, max_horizon=8),
                 p.horizon_hint(free_slots=0, max_horizon=8))
        orders.append((first, [p.pop().req_id for _ in range(len(p))],
                       hints,
                       p.choose_victim([4, 1, 2], None)))
    assert orders[0] == orders[1]


def test_scheduler_copy_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        tsched.make_policy("prefix")
    assert isinstance(tsched.make_policy(tsched.FIFOPolicy()),
                      tsched.FIFOPolicy)
