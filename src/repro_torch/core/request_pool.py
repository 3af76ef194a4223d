"""Request pool for continuous batching (paper §4.1/§4.3).

Requests live in the pool between iterations; the scheduler regroups a
batch every iteration (Alg. 2 line 3), so completions never stall the
pipeline and new arrivals join at the next iteration boundary.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (P,) int32
    max_new_tokens: int
    domain: Optional[str] = None          # ground-truth domain (for eval only)
    arrival_ms: float = 0.0
    # --- SLO / admission (DESIGN.md §2.5) ---
    deadline_ms: float = float("inf")     # absolute SLO deadline
    priority: int = 1                     # class: 0 high, 1 normal, 2 low
    # --- mutable serving state ---
    generated: List[int] = field(default_factory=list)
    gamma: int = 4                        # current per-request draft length
    l_acc_ema: float = 0.0                # recent acceptance length (EMA)
    done: bool = False
    finish_ms: float = 0.0
    first_token_ms: float = -1.0
    shed_ms: float = -1.0                 # >= 0 once admission shed it
    n_preemptions: int = 0                # slot evictions by admission
    n_iterations: int = 0
    n_accepted_total: int = 0
    n_drafted_total: int = 0

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def was_shed(self) -> bool:
        return self.shed_ms >= 0.0

    @property
    def slo_met(self) -> bool:
        """Finished within its deadline (shed requests never meet it)."""
        return self.done and not self.was_shed \
            and self.finish_ms <= self.deadline_ms

    def headroom_ms(self, now_ms: float) -> float:
        """Remaining SLO budget (inf when no deadline was set)."""
        return self.deadline_ms - now_ms

    def record_acceptance(self, n_committed: int, gamma_used: int):
        self.n_iterations += 1
        self.n_accepted_total += n_committed
        self.n_drafted_total += gamma_used
        self.l_acc_ema = 0.7 * self.l_acc_ema + 0.3 * n_committed


class RequestPool:
    def __init__(self):
        self._requests: Dict[int, Request] = {}
        self._ids = itertools.count()
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.n_submitted = 0

    def add(self, prompt, max_new_tokens: int, domain=None,
            arrival_ms: float = 0.0, deadline_ms: float = float("inf"),
            priority: int = 1) -> Request:
        rid = next(self._ids)
        r = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=max_new_tokens, domain=domain,
                    arrival_ms=arrival_ms, deadline_ms=deadline_ms,
                    priority=priority)
        self._requests[rid] = r
        self.n_submitted += 1
        return r

    def get(self, rid: int) -> Optional[Request]:
        return self._requests.get(rid)

    def pending(self, now_ms: float = float("inf")) -> List[Request]:
        return [r for r in self._requests.values()
                if not r.done and r.arrival_ms <= now_ms]

    def finish(self, rid: int, now_ms: float):
        r = self._requests.pop(rid)
        r.done = True
        r.finish_ms = now_ms
        self.completed.append(r)

    def shed_request(self, rid: int, now_ms: float) -> Request:
        """Admission rejected the request: it leaves the pool whole —
        never half-committed (admission only sheds zero-token requests)
        — and is accounted on the `shed` list, so
        n_submitted == len(completed) + len(shed) + len(pool) always."""
        r = self._requests.pop(rid)
        assert not r.generated, "shedding a half-committed request"
        r.done = True
        r.shed_ms = now_ms
        r.finish_ms = now_ms
        self.shed.append(r)
        return r

    def __len__(self):
        return len(self._requests)

    @property
    def empty(self) -> bool:
        return not self._requests
