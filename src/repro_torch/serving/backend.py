"""Execution backends: the mechanism half of the engine/backend split
(port of `repro.serving.backend`).

`SpeculativeEngine` is policy (routing, fusion, scheduling, admission);
an `ExecutionBackend` is mechanism: every model execution, every cache
admit/evict and the serving clock.

  * `SimulatedBackend` runs the model calls synchronously in engine
    order and keeps time on the engine's discrete-event simulated clock.
  * `AsyncTorchBackend` is the wall-clock serving loop: a verification
    server thread owns every target-model operation (verify forwards,
    prefill writes, commit extends and slot drops run there in FIFO
    order, so the target's in-place caches see them in engine order),
    while the drafters run on the engine thread. On CUDA each side has a
    stream of its own: the server enqueues its tasks on `target_stream`,
    the engine enters `draft_stream` for the whole of `run()`
    (`engine_stream`), and neither uses the legacy default stream, so a
    verification forward is in flight on the card while the engine
    drafts the next cohort. Driven by `serving/async_loop.WallClockExecutor`.

The losslessness contract is backend-independent: both backends execute
identical token-level math, so greedy tree acceptance + correction
always commits exactly the target's greedy continuation.
"""
from __future__ import annotations

import contextlib
import time
from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.wall import (SERVER, WallTracer, counting_host_reads,
                                  note_host_read)
from repro_torch.serving.runner import ModelRunner


def _verify_to_host(lg, B: int, vocab: int) -> np.ndarray:
    """The verification logits of the cohort's B rows, read to the host
    (one counted host read: bytes from the shape, no device read)."""
    out = lg[:B, :, :vocab].float()
    note_host_read("verify", out.numel() * 4)
    return out.cpu().numpy()


class VerifyHandle:
    """Lazy verification result. `result()` materializes the (B, Gmax, V)
    logits on the caller; `times()` reports the measured wall span of the
    forward (None under the simulated backend, where the span lives on
    the simulated verify StageClock instead)."""

    def __init__(self, value: Optional[np.ndarray] = None,
                 future: Optional[Future] = None,
                 convert: Optional[Callable] = None,
                 span: Optional[dict] = None):
        self._value = value
        self._future = future
        self._convert = convert
        self._span = span

    def result(self) -> np.ndarray:
        """Materialize (blocking) and cache the verification logits."""
        if self._value is None:
            raw = self._future.result()
            self._value = self._convert(raw) if self._convert else raw
        return self._value

    def times(self) -> Optional[Tuple[float, float]]:
        """Measured wall (t0, t1) of the forward, or None if simulated."""
        if self._span is None:
            return None
        return self._span["t0"], self._span["t1"]


class ExecutionBackend(ABC):
    """Mechanism interface the engine serves against.

    Implementations own the target and drafter `ModelRunner`s (exposed as
    `.target` / `.drafters`) plus the serving clock. Request-addressed:
    every method takes rids; slot bookkeeping is internal to the
    runners."""

    target: ModelRunner
    drafters: List[ModelRunner]
    #: True when `now_ms()` is wall time and model calls may be in
    #: flight concurrently (selects the WallClockExecutor)
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

    def engine_stream(self):
        """Context the engine thread serves in (`SpeculativeEngine.run`):
        nothing here; the wall-clock backend's drafter stream."""
        return contextlib.nullcontext()

    def shutdown(self) -> None:
        """Release backend resources (worker threads)."""


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


class AsyncTorchBackend(ExecutionBackend):
    """Wall-clock backend: a single-worker verification server thread
    owns every target-model operation (totally ordered, so the target's
    in-place slot caches and slot bookkeeping are race-free), drafters run
    on the engine thread, and verify forwards are genuinely in flight
    while the engine drafts ahead.

    On CUDA the server runs each task under `torch.cuda.stream(
    target_stream)` and ends it with `target_stream.synchronize()`, so a
    span's t1 is device completion and what the task returns can be read
    on the engine thread without a race; the wait covers the server's
    stream only, never the drafters' (`draft_stream`). Every tensor a
    target task uses is built inside the task (the runner's inputs, slot
    indices, page views), on the server's stream. On the CPU (`device=
    "cpu"`, asked for by the caller) the same two threads run with no
    streams.

    `timeline` records each target task's measured span ({kind, t0, t1},
    appended by the worker); the executor drains it to attribute
    busy/idle time and emit wall-clock spans through the same trace
    schema the simulated clocks use.

    With the engine's tracing on, each task is also traced on the server
    thread as two wall spans, ``<kind>.launch`` (the host's dispatch of
    its work) and ``<kind>.sync`` (the wait for the server's stream),
    with the cohort of the engine's span that queued it (``cause`` its
    seq), and the task's host reads count under ``thread=server``."""

    is_wallclock = True

    def __init__(self, target, drafter_specs, max_len: int,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: int = 0, device=None):
        super().__init__(target, drafter_specs, max_len, paged=paged,
                         page_size=page_size, pool_pages=pool_pages,
                         device=device)
        self.device = self.target.device
        if self.device.type == "cuda":
            self.target_stream = torch.cuda.Stream(self.device)
            self.draft_stream = torch.cuda.Stream(self.device)
            # the weights and caches were written on the caller's stream
            cur = torch.cuda.current_stream(self.device)
            self.target_stream.wait_stream(cur)
            self.draft_stream.wait_stream(cur)
        else:
            self.target_stream = self.draft_stream = None
        self._t0 = time.monotonic()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="verify-server")
        self.timeline: List[dict] = []
        self._timeline_pos = 0
        self.tracer = WallTracer(enabled=False)
        self.metrics = None

    def bind(self, engine):
        """Attach the engine; its tracer and metrics trace the server."""
        super().bind(engine)
        self.tracer, self.metrics = engine.tracer, engine.metrics

    def now_ms(self) -> float:
        """Wall-clock ms since backend construction."""
        return (time.monotonic() - self._t0) * 1e3

    def engine_stream(self):
        """The drafters' stream, entered by the engine thread for the
        whole of `run()` (nothing on the CPU)."""
        if self.draft_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.draft_stream)

    # ---------------------------------------------------- target worker
    def submit_target(self, kind: str, fn: Callable) -> Tuple[Future, dict]:
        """Queue `fn` on the verification server thread; returns (future,
        span) where span's t0/t1 are filled in by the worker."""
        span = {"kind": kind, "t0": 0.0, "t1": 0.0}
        stream = self.target_stream
        tr = self.tracer
        cause = tr.current()
        tag = (dict(cohort=cause.cohort, cause=cause.seq)
               if cause is not None else {})
        counting = (counting_host_reads(self.metrics, SERVER)
                    if tr.clock is not None else contextlib.nullcontext())

        def _task():
            span["t0"] = self.now_ms()
            try:
                with counting:
                    with tr.wall(kind + ".launch", SERVER, **tag):
                        if stream is None:
                            out = fn()
                        else:
                            with torch.cuda.stream(stream):
                                out = fn()
                    with tr.wall(kind + ".sync", SERVER, **tag):
                        if stream is not None:
                            stream.synchronize()
                return out
            finally:
                span["t1"] = self.now_ms()
                self.timeline.append(span)

        return self._pool.submit(_task), span

    def drain_timeline(self) -> List[dict]:
        """Completed target-task spans since the last drain (the list is
        append-only from the single worker, so reading a prefix is safe)."""
        end = len(self.timeline)
        out = self.timeline[self._timeline_pos:end]
        self._timeline_pos = end
        return out

    # ----------------------------------------------------- target ops
    def prefill_target(self, reqs, batched=True):
        """Blocking burst prefill (see `prefill_target_async`)."""
        return self.prefill_target_async(reqs).result()

    def prefill_target_async(self, reqs) -> Future:
        """Non-blocking burst prefill: queued on the verification server
        (FIFO — it lands before any later-dispatched verify that needs
        it). The future resolves to {rid: (logits, mean logprob)}."""
        reqs = dict(reqs)
        fut, _ = self.submit_target(
            "prefill", lambda: self.target.prefill_requests(reqs))
        return fut

    def verify_dispatch(self, rids, tokens, rel_pos, seg_mask):
        """Queue tree verification on the server thread; lazy handle. The
        logits stay on the device until the acceptance walk reads them
        (the server has waited for its stream, so the copy on the
        engine's stream reads finished values)."""
        B = len(rids)
        vocab = self.target.cfg.vocab
        fut, span = self.submit_target(
            "verify", lambda: self.target.verify_device(rids, tokens,
                                                        rel_pos, seg_mask))
        return VerifyHandle(
            future=fut, span=span,
            convert=lambda lg: _verify_to_host(lg, B, vocab))

    def commit_target(self, committed):
        """Blocking cache commit (see `commit_target_async`)."""
        return self.commit_target_async(committed).result()

    def commit_target_async(self, committed) -> Future:
        """Non-blocking cache commit: the slot-extend forward is queued on
        the verification server and overlaps the drafter commit + next
        draft on the engine thread. FIFO order guarantees it executes
        before the next verification reads the extended slots; the future
        resolves to the post-commit tail logits, which the engine only
        consumes at the *next* acceptance walk (`_resolve_tails`)."""
        committed = dict(committed)
        fut, _ = self.submit_target(
            "commit", lambda: self.target.extend_committed(committed))
        return fut

    def drop_request(self, rid):
        """Evict `rid`; the target-side release is queued FIFO."""
        # target slot release must serialize behind any queued prefill
        # that may still admit this rid (shed-after-queued-prefill)
        self.submit_target("drop", lambda: self.target.drop(rid))
        for d in self.drafters:
            d.drop(rid)

    # ---------------------------------------------------- drafter ops
    def prefill_drafters(self, reqs, batched=True):
        """Prefill every drafter on the engine thread (drafters are
        engine-thread-owned; only target ops route to the server)."""
        out: Dict[int, List[float]] = {rid: [] for rid in reqs}
        for d in self.drafters:
            res = d.prefill_requests(reqs) if (batched and len(reqs) > 1) \
                else {rid: d.prefill_request(rid, ctx)
                      for rid, ctx in reqs.items()}
            for rid in reqs:
                out[rid].append(res[rid][1])
        return out

    def draft_snapshot(self, di, rids):
        """Rollback-safe speculative cache copy from drafter `di`."""
        return self.drafters[di].speculative_caches(rids)

    def draft_extend(self, di, snap, tokens):
        """Teacher-force `tokens` into a drafter snapshot."""
        return self.drafters[di].extend_snapshot(snap, tokens)[1]

    def draft_decode(self, di, rids, tokens, snap):
        """One greedy decode step on a drafter snapshot."""
        return self.drafters[di].decode(rids, tokens, caches=snap)

    def commit_drafters(self, committed):
        """Commit accepted tokens into every drafter cache."""
        for d in self.drafters:
            d.extend_committed(committed)

    def shutdown(self):
        """Drain and join the verification server thread."""
        self._pool.shutdown(wait=True)


def make_backend(spec, target, drafter_specs, max_len: int,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: int = 0, device=None) -> ExecutionBackend:
    """Resolve a backend spec: None/"sim" -> SimulatedBackend, "async" ->
    AsyncTorchBackend, or a ready ExecutionBackend instance. `paged`
    (CoSineConfig.paged_pool), `page_size` and `pool_pages` select the
    paged KV pool in every runner; `device` is where the runners run
    (CUDA unless "cpu")."""
    if isinstance(spec, ExecutionBackend):
        return spec
    kw = dict(paged=paged, page_size=page_size, pool_pages=pool_pages,
              device=device)
    if spec in (None, "sim"):
        return SimulatedBackend(target, drafter_specs, max_len, **kw)
    if spec == "async":
        return AsyncTorchBackend(target, drafter_specs, max_len, **kw)
    raise ValueError(f"unknown backend {spec!r} (expected 'sim' or 'async')")
