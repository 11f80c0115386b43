"""PyTorch port, the runtime sanitizer (`ray_tpu_torch._private.sanitize`).

The port's counterparts of the JAX package's sanitizer gates
(tests/test_perf_gates.py, test_engine_lora.py, test_fleet_disagg.py):
after a warm-up of two passes of the steady workload, an armed pass over
the same workload must add no new decode dispatch key (the port's
counterpart of a jit retrace), make no device->host pull outside the
engine's `_device_get` / `_host_async` choke points, and emit the JAX
package's solo greedy `generate` tokens (quantized pools: the budget
only, as in JAX). Planted faults show each counter works: a stray
``.item()`` on the decode path raises in strict mode and is counted in
counting mode, and a horizon first seen after arm counts one new key.
On the CPU every tensor counts as a device tensor, as every array does
on JAX's CPU backend. The tp = 2 combo runs in the gloo world of
tests/test_torch_port_tp.py.
"""

import faulthandler
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import sanitize as jsanitize
from ray_tpu.models import generate as jgen
from ray_tpu.models import llama as jllama
from ray_tpu_torch import DecodeEngine
from ray_tpu_torch._private import sanitize
from ray_tpu_torch._private.sanitize import SanitizerError
from ray_tpu_torch.convert import lora_from_numpy, params_from_numpy
from ray_tpu_torch.models import engine as tengine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from torch_port_helpers import numpy_params

JCFG = jllama.LlamaConfig.nano()
TCFG = tllama.LlamaConfig.nano()

# tests/test_perf_gates.py's combos, tp = 2 apart (see the docstring)
SANITIZER_COMBOS = {
    "dense": {},
    "prefix": {"prefix_cache": True},
    "paged": {"paged": True},
    "paged_prefix": {"paged": True, "prefix_cache": True},
    "pipeline": {"pipeline_depth": 3},
    "spec": {"spec": True},
    "spec_paged": {"spec": True, "paged": True},
    "paged_quant": {"paged": True, "kv_quant": "int8"},
    "paged_prefix_quant": {"paged": True, "prefix_cache": True,
                           "kv_quant": "int8"},
    "spec_paged_quant": {"spec": True, "paged": True,
                         "kv_quant": "int8"},
}
SAN_PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5]]
SAN_BUDGET = 10
LCFG = tlora.LoraConfig(rank=4, alpha=8.0)
HANDOFF_PROMPTS = [[5, 6, 7, 8, 9], [1, 2, 3]]


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


@pytest.fixture(autouse=True)
def _disarm_leftover_sanitizer(monkeypatch):
    """Never leak an armed sanitizer (process-global interposition) into
    other tests, even when an assertion fires mid-gate."""
    monkeypatch.delenv("RAY_TPU_SANITIZE", raising=False)
    yield
    san = sanitize.active()
    if san is not None:
        san.disarm()


@pytest.fixture(scope="module")
def model():
    """(numpy tree, JAX params, port params)."""
    tree = numpy_params(JCFG, seed=0)
    return (tree, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, TCFG, device="cpu"))


def _jax_solo(jparams, prompt, n):
    out = np.asarray(jgen.generate(jparams, jnp.asarray([prompt], jnp.int32),
                                   JCFG, max_new_tokens=n))
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def solo(model):
    """JAX solo greedy tokens of each prompt the gates serve."""
    jp = model[1]
    return {tuple(p): _jax_solo(jp, p, SAN_BUDGET)
            for p in SAN_PROMPTS + HANDOFF_PROMPTS}


def _san_engine(params, combo, **extra):
    kw = dict(combo)
    if kw.pop("spec", False):
        kw.update(draft_params=params, draft_cfg=TCFG, spec_window=4)
    return DecodeEngine(params, TCFG, batch_slots=2, max_len=64,
                        decode_horizon=4, **kw, **extra)


def _san_workload(eng, budget=SAN_BUDGET):
    rids = [eng.submit(p, budget) for p in SAN_PROMPTS]
    got = eng.run()
    return [got[r] for r in rids]


@pytest.mark.parametrize("combo", sorted(SANITIZER_COMBOS))
def test_gate_sanitizer_steady_decode(model, solo, combo):
    """Gate: zero new keys + zero unexpected transfers on steady
    decode, with sanitized output token-identical to JAX solo
    generate."""
    eng = _san_engine(model[2], SANITIZER_COMBOS[combo])
    _san_workload(eng)           # pass 1: cold keys (+ prefix commits)
    _san_workload(eng)           # pass 2: warm-hit paths
    san = eng.arm_sanitizer()
    try:
        emitted = _san_workload(eng)   # armed pass: only known keys
    except SanitizerError as exc:
        pytest.fail(f"[{combo}] unexpected device->host transfer on the "
                    f"steady decode path: {exc}")
    finally:
        eng.disarm_sanitizer()

    assert san.total_retraces() == 0, (
        f"[{combo}] steady-decode new keys: {san.retraces()}")
    assert san.unexpected_transfers == [], san.unexpected_transfers
    assert san.expected_pulls > 0, "armed pass should pull via _device_get"
    assert san.expected_async > 0
    assert "decode_keys" in san.stats()["watched"]
    quant_on = "kv_quant" in SANITIZER_COMBOS[combo]
    for prompt, toks in zip(SAN_PROMPTS, emitted):
        assert len(toks) == SAN_BUDGET, (combo, toks)
        if not quant_on:
            assert toks == solo[tuple(prompt)], (
                f"[{combo}] sanitized engine diverged from solo generate")


def test_gate_sanitizer_env_auto_arm(model, monkeypatch):
    """RAY_TPU_SANITIZE=1 builds the sanitizer at engine construction
    and auto-arms it after RAY_TPU_SANITIZE_WARMUP steps."""
    monkeypatch.setenv("RAY_TPU_SANITIZE", "1")
    monkeypatch.setenv("RAY_TPU_SANITIZE_WARMUP", "3")
    eng = _san_engine(model[2], {})
    assert eng.sanitizer is not None and not eng.sanitizer.armed
    assert eng.sanitizer.strict
    eng.submit(SAN_PROMPTS[0], 24)
    steps = 0
    while eng.pending():
        eng.step()
        steps += 1
        if steps <= 3:
            assert not eng.sanitizer.armed    # still warming up
    assert steps >= 4 and eng.sanitizer.armed  # armed mid-flight, no trips
    assert eng.sanitizer.unexpected_transfers == []
    stats = eng.sanitizer_stats()
    assert stats["expected_pulls"] > 0
    eng.disarm_sanitizer()
    assert sanitize.active() is None


@pytest.mark.parametrize("env", [
    {}, {"RAY_TPU_SANITIZE": "1"}, {"RAY_TPU_SANITIZE": "0"},
    {"RAY_TPU_SANITIZE": "yes", "RAY_TPU_SANITIZE_STRICT": "0"},
    {"RAY_TPU_SANITIZE": "1", "RAY_TPU_SANITIZE_WARMUP": "x"},
    {"RAY_TPU_SANITIZE_WARMUP": "-4"}, {"RAY_TPU_SANITIZE_WARMUP": "2"}],
    ids=["unset", "on", "off", "counting", "bad-warmup", "neg-warmup",
         "warmup2"])
def test_env_knobs_match_jax(monkeypatch, env):
    """`resolve` and `warmup_steps` read the environment as JAX's do."""
    for k in ("RAY_TPU_SANITIZE", "RAY_TPU_SANITIZE_STRICT",
              "RAY_TPU_SANITIZE_WARMUP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert sanitize.warmup_steps() == jsanitize.warmup_steps()
    for spec in (None, True, False, 0, 1, "strict"):
        got, want = sanitize.resolve(spec), jsanitize.resolve(spec)
        assert (got is None) == (want is None), spec
        if got is not None:
            assert got.strict == want.strict, spec
    own = sanitize.Sanitizer(strict=False)
    assert sanitize.resolve(own) is own


def test_stray_item_on_decode_path_raises_in_strict_mode(model):
    """A planted ``.item()`` inside the decode loop raises
    `SanitizerError`; disarm restores torch.Tensor exactly."""
    before = {a: torch.Tensor.__dict__.get(a) for a in sanitize._PATCHED_ATTRS}
    eng = _san_engine(model[2], {"paged": True})
    _san_workload(eng)
    orig = tengine._decode_multi_paged

    def stray(*args, **kw):
        args[5][0].item()              # row_len read on the host
        return orig(*args, **kw)

    eng.arm_sanitizer()
    try:
        with mock.patch.object(tengine, "_decode_multi_paged", stray):
            with pytest.raises(SanitizerError, match="Tensor.item"):
                _san_workload(eng)
        with pytest.raises(SanitizerError, match="Tensor.tolist"):
            torch.arange(4).tolist()
        with pytest.raises(SanitizerError, match="Tensor.__float__"):
            float(torch.ones(()) * 3)
    finally:
        eng.disarm_sanitizer()
    assert {a: torch.Tensor.__dict__.get(a)
            for a in sanitize._PATCHED_ATTRS} == before
    assert sanitize.active() is None
    assert torch.arange(3).tolist() == [0, 1, 2]
    assert len(eng.sanitizer.unexpected_transfers) == 3


def test_stray_pull_counted_in_counting_mode(model):
    """Counting mode tallies each stray pull (a pull made of pulls,
    ``np.asarray`` through ``__array__``, once) and serves on with the
    same tokens."""
    eng = _san_engine(model[2], {}, sanitize=sanitize.Sanitizer(
        strict=False))
    want = _san_workload(eng)
    orig = tengine._decode_multi

    def stray(*args, **kw):
        np.asarray(args[3])            # row_len
        return orig(*args, **kw)

    san = eng.arm_sanitizer()
    try:
        with mock.patch.object(tengine, "_decode_multi", stray):
            got = _san_workload(eng)
    finally:
        eng.disarm_sanitizer()
    assert got == want
    dispatches = san.stats()["unexpected_transfers"]
    assert dispatches == len(san.unexpected_transfers) > 0
    assert all("Tensor.__array__" in m for m in san.unexpected_transfers)
    assert san.total_retraces() == 0


def test_new_horizon_after_arm_counts_one_key(model):
    """A horizon the warm-up never ran is a new dispatch key: one."""
    eng = _san_engine(model[2], {"paged": True})
    _san_workload(eng)
    known = set(eng._dispatch_keys)
    san = eng.arm_sanitizer()
    try:
        eng.submit(SAN_PROMPTS[0], 6)
        while eng.pending():
            eng.step(horizon=3)        # warm-up horizons are powers of 2
    finally:
        eng.disarm_sanitizer()
    assert san.retraces() == {"decode_keys": 1}
    assert eng._dispatch_keys - known == {(3, True)}


def test_only_one_sanitizer_armed():
    a, b = sanitize.Sanitizer(), sanitize.Sanitizer()
    a.arm()
    try:
        with pytest.raises(RuntimeError, match="already armed"):
            b.arm()
    finally:
        a.disarm()
    with b:
        assert sanitize.active() is b
    assert sanitize.active() is None


def _rand_lora(seed, scale=0.05):
    rng = np.random.RandomState(seed)
    L = TCFG.n_layers
    return {"layers": {name: {
        "a": (rng.standard_normal((L, n_in, LCFG.rank)) * scale
              ).astype(np.float32),
        "b": (rng.standard_normal((L, LCFG.rank, n_out)) * scale
              ).astype(np.float32)}
        for name, (n_in, n_out) in tlora.lora_dims(TCFG, LCFG).items()}}


def test_sanitizer_clean_on_multi_adapter_churn(model):
    """Armed run over adapter churn (hits, misses, prefetch commits,
    evictions): no new key, no new commit signature (the commit takes
    its slot as data), no unexpected device->host transfer."""
    eng = DecodeEngine(model[2], TCFG, batch_slots=2, max_len=32,
                       greedy=True, lora=LCFG, max_live_adapters=2)
    for i in range(3):
        eng.register_adapter(f"ad{i}", lora_from_numpy(
            _rand_lora(10 + i), TCFG, LCFG, device="cpu"))
    prompts = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2]] * 2
    churn_aids = ["ad0", "ad1", "ad2", None, "ad0", "ad2"]

    def churn():
        ids = [eng.submit(p, 4, adapter_id=a)
               for p, a in zip(prompts, churn_aids)]
        out = eng.run()
        return [out[r] for r in ids]

    churn()                      # cold keys + first commits
    want = churn()               # warm-hit paths
    evictions = eng.adapter_pool.evictions
    san = eng.arm_sanitizer()
    try:
        got = churn()
    except SanitizerError as exc:
        pytest.fail(f"unexpected transfer on adapter churn: {exc}")
    finally:
        eng.disarm_sanitizer()
    assert "_adapter_commit" in san.stats()["watched"]
    assert san.total_retraces() == 0, san.retraces()
    assert san.unexpected_transfers == [], san.unexpected_transfers
    assert eng.adapter_pool.evictions > evictions >= 1
    assert got == want


def test_sanitizer_clean_on_handoff_path(model, solo):
    """Armed pass over export->import->decode: no new key, no
    device->host pull outside the choke points (the export's wait runs
    through `_host_wait`)."""
    params = model[2]

    def handoff_workload(pre, dec):
        rids = [pre.submit(p, 4) for p in HANDOFF_PROMPTS]
        for _ in range(30):
            pre.step()
            if len(pre.handoff_ready()) == len(rids):
                break
        moved = [dec.import_request(pre.export_request(rid))
                 for rid in list(pre.handoff_ready())]
        out = dec.run()
        return [out[r] for r in moved]

    pre = DecodeEngine(params, TCFG, batch_slots=2, max_len=32,
                       paged=True, kv_block_tokens=4, engine_id="sp")
    pre.prefill_only = True
    dec = DecodeEngine(params, TCFG, batch_slots=2, max_len=32,
                       paged=True, kv_block_tokens=4, engine_id="sd")
    handoff_workload(pre, dec)          # cold keys
    handoff_workload(pre, dec)          # warm-hit paths
    san = pre.arm_sanitizer()
    # the interposition is process-global: dec's keys are watched too
    keys = dec._dispatch_keys
    san.watch("decoder_keys", lambda: len(keys))
    try:
        emitted = handoff_workload(pre, dec)
    except SanitizerError as exc:
        pytest.fail(f"unexpected transfer on the handoff path: {exc}")
    finally:
        pre.disarm_sanitizer()
    assert san.total_retraces() == 0, san.retraces()
    assert san.unexpected_transfers == [], san.unexpected_transfers
    assert san.expected_pulls >= 2 * len(HANDOFF_PROMPTS)
    for p, toks in zip(HANDOFF_PROMPTS, emitted):
        assert toks == solo[tuple(p)][:4]
