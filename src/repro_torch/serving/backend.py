"""Execution backends: the mechanism half of the engine/backend split
(port of `repro.serving.backend`).

`SpeculativeEngine` is policy (routing, fusion, scheduling, admission);
an `ExecutionBackend` is mechanism: every model execution, every cache
admit/evict and the serving clock. `SimulatedBackend` runs the model
calls synchronously in engine order and keeps time on the engine's
discrete-event simulated clock.

The wall-clock backend (`backend="async"`) is not ported yet and raises.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.runner import ModelRunner

ASYNC_ROADMAP = ("the asynchronous wall-clock backend is not ported yet "
                 "(ROADMAP queue 1 item 12)")


class VerifyHandle:
    """Verification result handed from `verify_dispatch` to the engine's
    walk; `result()` gives the (B, Gmax, V) logits. The simulated backend
    resolves it at dispatch (the reference's deferred, timed form serves
    the async backend, which is not ported yet)."""

    def __init__(self, value: np.ndarray):
        self._value = value

    def result(self) -> np.ndarray:
        """The verification logits."""
        return self._value


class ExecutionBackend(ABC):
    """Mechanism interface the engine serves against.

    Implementations own the target and drafter `ModelRunner`s (exposed as
    `.target` / `.drafters`) plus the serving clock. Request-addressed:
    every method takes rids; slot bookkeeping is internal to the
    runners."""

    target: ModelRunner
    drafters: List[ModelRunner]
    #: True when `now_ms()` is wall time (not ported yet)
    is_wallclock = False

    def __init__(self, target, drafter_specs, max_len: int,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: int = 0, device=None):
        tcfg, tparams = target
        kw = dict(paged=paged, page_size=page_size, pool_pages=pool_pages,
                  device=device)
        self.target = ModelRunner(tcfg, tparams, max_len, **kw)
        self.drafters = [ModelRunner(c, p, max_len, **kw)
                         for c, p, _ in drafter_specs]
        self._engine = None

    def bind(self, engine):
        """Attach the engine (clock source for the simulated backend)."""
        self._engine = engine

    # ------------------------------------------------------------ clock
    @abstractmethod
    def now_ms(self) -> float:
        """Current serving time (simulated or wall, ms)."""

    # ------------------------------------------------- target lifecycle
    @abstractmethod
    def prefill_target(self, reqs: Dict[int, Sequence[int]],
                       batched: bool = False
                       ) -> Dict[int, Tuple[Optional[np.ndarray], float]]:
        """Admit + prefill each request's context on the target; returns
        {rid: (last-position logits, mean next-token logprob)}."""

    @abstractmethod
    def verify_dispatch(self, rids: Sequence[int], tokens: np.ndarray,
                        rel_pos: np.ndarray, seg_mask: np.ndarray
                        ) -> VerifyHandle:
        """Start a tree verification forward; returns a lazy handle."""

    @abstractmethod
    def commit_target(self, committed: Dict[int, List[int]]
                      ) -> Dict[int, np.ndarray]:
        """Extend the target's slot caches with the accepted tokens;
        returns each request's post-commit tail logits."""

    def commit_target_async(self, committed: Dict[int, List[int]]) -> Future:
        """Non-blocking commit variant; default: synchronous."""
        fut: Future = Future()
        fut.set_result(self.commit_target(committed))
        return fut

    # ------------------------------------------------------ drafter ops
    @abstractmethod
    def prefill_drafters(self, reqs: Dict[int, Sequence[int]],
                         batched: bool = False) -> Dict[int, List[float]]:
        """One-behind drafter prefill (context WITHOUT its last token);
        returns {rid: per-drafter mean logprobs} (the routing prior)."""

    @abstractmethod
    def draft_snapshot(self, di: int, rids: Sequence[int]):
        """Speculative slot snapshot for drafter `di` (discard = rollback)."""

    @abstractmethod
    def draft_extend(self, di: int, snap, tokens: np.ndarray):
        """Teacher-force `tokens` (B, T) into a snapshot; returns the
        advanced snapshot."""

    @abstractmethod
    def draft_decode(self, di: int, rids: Sequence[int],
                     tokens: np.ndarray, snap):
        """One drafting step on a snapshot; returns (logits, snapshot)."""

    @abstractmethod
    def commit_drafters(self, committed: Dict[int, List[int]]) -> None:
        """Extend every drafter's slot caches (one-behind commit)."""

    # -------------------------------------------------------- eviction
    @abstractmethod
    def drop_request(self, rid: int) -> None:
        """Release the request's slots on the target and every drafter.
        No-op for unknown rids."""

    def shutdown(self) -> None:
        """Release backend resources."""


class SimulatedBackend(ExecutionBackend):
    """Synchronous host execution in engine call order, simulated time;
    each method is exactly the runner call the engine would make."""

    def now_ms(self) -> float:
        """Simulated engine clock (ms)."""
        return self._engine.clock_ms if self._engine is not None else 0.0

    def prefill_target(self, reqs, batched=False):
        """Prefill the target for {rid: ctx}, optionally as one burst."""
        if batched and len(reqs) > 1:
            return self.target.prefill_requests(reqs)
        return {rid: self.target.prefill_request(rid, ctx)
                for rid, ctx in reqs.items()}

    def prefill_drafters(self, reqs, batched=False):
        """Prefill every drafter; returns {rid: [mean logprob per drafter]}."""
        out: Dict[int, List[float]] = {rid: [] for rid in reqs}
        if batched and len(reqs) > 1:
            for d in self.drafters:
                res = d.prefill_requests(reqs)
                for rid in reqs:
                    out[rid].append(res[rid][1])
            return out
        for rid, ctx in reqs.items():
            for d in self.drafters:
                _, ll = d.prefill_request(rid, ctx)
                out[rid].append(ll)
        return out

    def verify_dispatch(self, rids, tokens, rel_pos, seg_mask):
        """Run tree verification synchronously; handle is pre-resolved."""
        return VerifyHandle(
            value=self.target.verify(rids, tokens, rel_pos, seg_mask))

    def commit_target(self, committed):
        """Commit accepted tokens into the target cache; returns tails."""
        return self.target.extend_committed(committed)

    def commit_drafters(self, committed):
        """Commit accepted tokens into every drafter cache."""
        for d in self.drafters:
            d.extend_committed(committed)

    def draft_snapshot(self, di, rids):
        """Rollback-safe speculative cache copy from drafter `di`."""
        return self.drafters[di].speculative_caches(rids)

    def draft_extend(self, di, snap, tokens):
        """Teacher-force `tokens` into a drafter snapshot."""
        return self.drafters[di].extend_snapshot(snap, tokens)[1]

    def draft_decode(self, di, rids, tokens, snap):
        """One greedy decode step on a drafter snapshot."""
        return self.drafters[di].decode(rids, tokens, caches=snap)

    def drop_request(self, rid):
        """Evict `rid` from the target and every drafter cache."""
        self.target.drop(rid)
        for d in self.drafters:
            d.drop(rid)


def make_backend(spec, target, drafter_specs, max_len: int,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: int = 0, device=None) -> ExecutionBackend:
    """Resolve a backend spec: None/"sim" -> SimulatedBackend, or a ready
    ExecutionBackend instance. "async" is not ported yet and raises.
    `paged` (CoSineConfig.paged_pool), `page_size` and `pool_pages` select
    the paged KV pool in every runner."""
    if isinstance(spec, ExecutionBackend):
        return spec
    if spec in (None, "sim"):
        return SimulatedBackend(target, drafter_specs, max_len, paged=paged,
                                page_size=page_size, pool_pages=pool_pages,
                                device=device)
    if spec == "async":
        raise NotImplementedError(ASYNC_ROADMAP)
    raise ValueError(f"unknown backend {spec!r} (expected 'sim' or 'async')")
