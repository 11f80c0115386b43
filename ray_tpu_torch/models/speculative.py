"""Speculative decoding without an engine: a small draft model proposes,
the target model verifies, with greedy output identical to target-only
greedy decoding.

Port of `ray_tpu/models/speculative.py`: `SpecStats`, `SpecMetrics` (on
the port's own `util.metrics`), the draft and verify steps and
`speculative_generate`, on `generate.forward_cached_rows`. Caches are
updated in place. `DecodeEngine(draft_params=...)` runs the same round
inside continuous batching (`models/engine.py`); this is the solo path.

Each round the draft consumes a fixed-width chunk of 2 tokens at slot
``n - lag`` and then proposes ``window`` greedy tokens; the target
verifies ``[last, d_1..d_window]`` in one pass at slot ``n`` and the
host accepts the longest prefix of proposals that equal the target's
argmax, then the target's own next token. No cache is rolled back:
attention only reaches slots at or below a query's own slot, and a
rejected candidate's K/V lies exactly where the next round writes
first. ``lag`` is 1 after a fully accepted window (the draft never fed
its last proposal, which the chunk then carries first) and 0 otherwise
(the chunk's second token is a duplicate whose K/V the first proposal
overwrites before anything attends it), so the chunk is always 2 wide.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.generate import (forward_cached,
                                           forward_cached_rows, init_cache)
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.util.metrics import Counter, Gauge

Params = Dict[str, Any]


@dataclasses.dataclass
class SpecStats:
    """Per-call acceptance telemetry (drives draft-model/window tuning)."""
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


_spec_ids = itertools.count()


class SpecMetrics:
    """Publishes SpecStats as ``spec``-tagged counters and an
    acceptance-rate gauge on `ray_tpu_torch.util.metrics`, beside the
    engine's llm_engine_* series: pass one instance to
    `speculative_generate(..., metrics=...)` (the engine makes one per
    draft plane, tagged with its engine id). `stats()` returns the flat
    numeric snapshot."""

    def __init__(self, *, spec_id: Optional[str] = None):
        self.spec_id = spec_id or f"spec-{next(_spec_ids)}"
        self.calls = 0
        self.rounds = 0
        self.proposed = 0
        self.accepted = 0

        tag = {"spec": self.spec_id}
        keys = ("spec",)

        def counter(name, desc):
            return Counter(name, desc, tag_keys=keys).set_default_tags(tag)

        self._m_calls = counter("llm_spec_calls_total",
                                "speculative_generate invocations")
        self._m_rounds = counter("llm_spec_rounds_total",
                                 "Draft-propose / target-verify rounds")
        self._m_proposed = counter("llm_spec_proposed_total",
                                   "Draft tokens proposed for verification")
        self._m_accepted = counter("llm_spec_accepted_total",
                                   "Draft tokens accepted by the target")
        self._m_rate = Gauge(
            "llm_spec_acceptance_rate",
            "Cumulative accepted / proposed (0..1)",
            tag_keys=keys).set_default_tags(tag)

    def observe(self, stats: SpecStats) -> None:
        """Fold one call's SpecStats into the cumulative series."""
        self.calls += 1
        self.rounds += stats.rounds
        self.proposed += stats.proposed
        self.accepted += stats.accepted
        self._m_calls.inc()
        if stats.rounds > 0:
            self._m_rounds.inc(stats.rounds)
        if stats.proposed > 0:
            self._m_proposed.inc(stats.proposed)
        if stats.accepted > 0:
            self._m_accepted.inc(stats.accepted)
        self._m_rate.set(self.acceptance_rate)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def stats(self) -> Dict[str, float]:
        """Flat numeric snapshot (every ratio 0.0 before any call)."""
        return {
            "calls": float(self.calls),
            "rounds": float(self.rounds),
            "proposed": float(self.proposed),
            "accepted": float(self.accepted),
            "acceptance_rate": self.acceptance_rate,
            "rounds_per_call": (self.rounds / self.calls
                                if self.calls else 0.0),
        }


@torch.no_grad()
def _draft_propose_rows(params: Params, chunk2: torch.Tensor, cache,
                        starts: torch.Tensor, lag: torch.Tensor,
                        cfg: LlamaConfig, width: int) -> torch.Tensor:
    """Consume the 2-wide chunk [pending-or-last, last] at per-row slot
    ``starts`` = n - lag, then roll ``width`` greedy proposals; row b's
    first follows its LAST token, logits column ``lag[b]``. Returns the
    proposals [B, width]; the cache gains the chunk's K/V and the first
    width-1 proposals' (the last proposal is never an input)."""
    B = chunk2.shape[0]
    logits, _ = forward_cached_rows(params, chunk2, cache, starts, cfg)
    tok = torch.argmax(logits[torch.arange(B, device=chunk2.device),
                              lag.long()], dim=-1)
    frontier = starts + lag          # == n: proposal j writes at n+1+j
    toks = [tok]
    for j in range(width - 1):
        logits, _ = forward_cached_rows(params, toks[-1][:, None], cache,
                                        frontier + 1 + j, cfg)
        toks.append(torch.argmax(logits[:, 0], dim=-1))
    return torch.stack(toks, dim=1)


@torch.no_grad()
def _verify_rows(params: Params, chunk: torch.Tensor, cache,
                 starts: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Target forward over [last_emitted, d_1..d_w] at per-row slot
    ``starts``; returns the argmax tokens [B, w+1]: entry i is the
    target's greedy continuation of chunk[:, :i+1]."""
    logits, _ = forward_cached_rows(params, chunk, cache, starts, cfg)
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def speculative_generate(
    target_params: Params, target_cfg: LlamaConfig,
    draft_params: Params, draft_cfg: LlamaConfig,
    prompt, *, max_new_tokens: int = 32, window: int = 4,
    eos_id: Optional[int] = None,
    metrics: Optional[SpecMetrics] = None,
) -> Tuple[torch.Tensor, SpecStats]:
    """prompt [B, P] int -> (tokens, stats). B=1 returns [1, P + n],
    n <= max_new_tokens (an early eos stops short); B>1 returns the
    rectangular [B, P + max_new_tokens] with each finished row
    eos-filled past its eos (0-filled without eos_id). The tokens lie on
    the target params' device.

    Greedy only: each row's tokens equal greedy ``generate`` of the
    target on that row up to eos / max_new_tokens. Rows advance
    independently (the host accept loop is vectorized over the batch;
    finished rows ride along frozen). Draft and target must share the
    vocabulary. A `SpecMetrics` publishes the call's acceptance."""
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    device = target_params["tok_embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=device)
    B, P = prompt.shape
    # +window+1 margin: the last round may overshoot before trimming
    max_len = P + max_new_tokens + window + 1
    for name, c in (("target", target_cfg), ("draft", draft_cfg)):
        if max_len > c.max_seq_len:
            raise ValueError(f"{name} max_seq_len {c.max_seq_len} < "
                             f"required {max_len}")

    t_cache = init_cache(target_cfg, B, max_len, device=device)
    d_cache = init_cache(draft_cfg, B, max_len, device=device)
    t_logits, _ = forward_cached(target_params, prompt, t_cache, 0,
                                 target_cfg)
    forward_cached(draft_params, prompt, d_cache, 0, draft_cfg)

    stats = SpecStats()
    # one pull of the prefill's tokens before the round loop
    first = torch.argmax(t_logits[:, -1], dim=-1).cpu().numpy()
    emitted: List[List[int]] = [[int(first[b])] for b in range(B)]
    # seq_b = prompt + emitted[b]. Before each round: the target cache
    # row b holds K/V for seq_b[:-1] (slots [0, n_b)); the draft's
    # holds seq_b[:n_b - lag_b].
    n = np.full(B, P, np.int64)      # == len(seq_b) - 1
    lag = np.zeros(B, np.int64)

    def _done(b: int) -> bool:
        e = emitted[b]
        return len(e) >= max_new_tokens or \
            (eos_id is not None and e[-1] == eos_id)

    def dev(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device)

    while not all(_done(b) for b in range(B)):
        last = np.array([e[-1] for e in emitted], np.int64)
        pend = np.array([e[-2] if lag[b] else e[-1]
                         for b, e in enumerate(emitted)], np.int64)
        proposals = _draft_propose_rows(
            draft_params, dev(np.stack([pend, last], axis=1)), d_cache,
            dev(n - lag), dev(lag), draft_cfg, window)
        chunk = torch.cat([dev(last)[:, None], proposals], dim=1)
        verdict = _verify_rows(target_params, chunk, t_cache, dev(n),
                               target_cfg)
        # the host accept loop: one pull of proposals and verdict a round
        prop = proposals.cpu().numpy()
        ver = verdict.cpu().numpy()
        match = prop == ver[:, :window]
        accept = np.cumprod(match, axis=1).sum(axis=1)  # [B], 0..window
        stats.rounds += 1
        for b in range(B):
            if _done(b):
                continue              # frozen row rode along; no emits
            a = int(accept[b])
            stats.proposed += window
            stats.accepted += a
            # accepted drafts, then the target's correction (or bonus)
            emitted[b].extend(int(t) for t in prop[b, :a])
            emitted[b].append(int(ver[b, a]))
            n[b] += a + 1
            lag[b] = 1 if a == window else 0
            if eos_id is not None and eos_id in emitted[b]:
                del emitted[b][emitted[b].index(eos_id) + 1:]
        for b in range(B):
            del emitted[b][max_new_tokens:]

    if metrics is not None:
        metrics.observe(stats)
    if B == 1:
        tail = torch.tensor([emitted[0]], dtype=prompt.dtype, device=device)
        return torch.cat([prompt, tail], dim=1), stats
    fill = eos_id if eos_id is not None else 0
    rect = np.full((B, max_new_tokens), fill, np.int64)
    for b in range(B):
        rect[b, :len(emitted[b])] = emitted[b]
    return torch.cat([prompt, dev(rect)], dim=1), stats
