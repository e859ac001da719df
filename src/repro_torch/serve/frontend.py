"""Serving frontend: continuous batching of search requests into
power-of-two batch classes over the streaming index (a port of the
reference's `serve/frontend.py`).

Request lifecycle::

    caller thread:      submit(vec) -> Future    (admission queue)
    dispatcher thread:  drain queue -> expire dead requests -> pad batch
                        to its pow2 class -> ONE index search per batch
                        -> respond queue
    responder thread:   materialize on host, slice per request,
                        resolve futures, record latency

The dispatcher always takes everything currently queued (up to
`max_batch`) as one batch — continuous batching, no fixed timer slots —
and rounds the batch up to the next power of two, padding with copies
of the first row. Query shapes therefore come from a closed set of
O(log2 max_batch) classes; `start()` dispatches every class once against
the live snapshot, one after another, which builds and loads the
kernel library, fills the query engine's stacked-batch cache and the
kernel wrappers' per-shape launch-geometry caches — timed on the
``serve.frontend.warmup_seconds`` gauge — so no caller pays a
first-call stall. The dispatcher thread makes the index's
CUDA device its current one (the current device is per thread), and
every launch goes to the device's default stream, so kernels of two
threads run in their enqueue order. The respond backlog runs on its own
thread:
device dispatch for batch N+1 is never blocked behind host
materialization/future resolution of batch N, and slow callers never
block either thread.

Admission control: the queue is bounded (`max_queue`) with a
configurable overload policy —

  * ``"block"``        submit() blocks until space frees (backpressure
                       by stalling the caller; the legacy behavior);
  * ``"reject"``       submit() raises `OverloadError` immediately
                       (backpressure as an error the client can retry);
  * ``"shed_oldest"``  the oldest queued request is failed with
                       `OverloadError` to admit the new one (freshest
                       traffic wins under overload).

Every request carries an optional deadline; the dispatcher fails
expired requests with `DeadlineExceededError` BEFORE spending a device
dispatch on them. `RetryingClient` wraps the client side: retryable
failures (`OverloadError`, injected transient faults — anything with
``retryable = True``) are resubmitted with seeded, jittered exponential
backoff.

Shutdown hygiene: `stop()` drains gracefully, but `submit()` after
`stop()` began raises `FrontendStopped` immediately, and any request
still queued past `drain_timeout_s` is failed with `FrontendStopped`
rather than orphaned (a Future that never resolves is a deadlock
planted in the caller).

Works over any index with the streaming search surface
(`constrained_knn(queries, k, r)` + `dim`): a `StreamingIndex`, a
`ShardedStreamingIndex`, or anything API-compatible. A degraded-mode
`partial` flag on the index result (sharded failover) is propagated
onto each `SearchReply`.

Observability (the serving-smoke + chaos acceptance surface):

  * ``serve.frontend.requests`` — submissions (attempted);
  * ``serve.admission.accepted / rejected / shed / deadline_expired``
    — every admission outcome, so overload behavior is countable;
  * ``serve.frontend.dispatches{qclass=B}`` — batches dispatched per
    pow2 class;
  * ``serve.frontend.warmup_dispatches`` — startup warmup, counted
    apart from live traffic; ``serve.frontend.warmup_seconds`` — how
    long start() spent warming;
  * ``serve.frontend.batch_occupancy`` — histogram of real (unpadded)
    batch sizes;
  * ``serve.frontend.latency_ms`` — submit→resolve latency histogram;
  * ``serve.client.retries`` — client-side resubmissions.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..index import faults


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class OverloadError(RuntimeError):
    """The admission queue is full (policy "reject"), or this request
    was shed to admit a newer one (policy "shed_oldest"). Retryable:
    backing off and resubmitting is exactly the right response."""

    retryable = True


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it was dispatched. Not
    retryable as-is — the deadline is gone; the caller must decide
    whether a fresh deadline is meaningful."""

    retryable = False


class FrontendStopped(RuntimeError):
    """The frontend is stopping or stopped: submitted after stop()
    began, or still queued past the drain timeout."""

    retryable = False


_OVERLOAD_POLICIES = ("block", "reject", "shed_oldest")


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    k: int = 8
    radius: float = float("inf")
    # largest batch one dispatch serves; also caps how much of the
    # queue one iteration drains. Must be a power of two.
    max_batch: int = 64
    # bound on queued-but-undispatched requests; what happens at the
    # bound is the overload_policy's call
    max_queue: int = 4096
    overload_policy: str = "block"
    # deadline applied to submissions that don't carry their own
    # (None = no deadline): seconds from submit time
    default_deadline_s: Optional[float] = None
    # stop(): how long to wait for the dispatcher to drain gracefully
    # before failing the still-queued requests with FrontendStopped.
    # None (the default) drains without a deadline — the first dispatch
    # on a cold process can legitimately take a kernel build's time
    drain_timeout_s: Optional[float] = None
    # dispatch every batch class once at start()
    warmup: bool = True
    # the reference's option to warm the classes from concurrent threads
    # (there, to overlap XLA compiles). The port refuses True: with
    # nothing to compile, the threads only contend for the GIL over the
    # traversal's many small tensor operations and serialise on the
    # device's default stream, so the classes warm one after another
    warmup_parallel: bool = False

    def __post_init__(self) -> None:
        if self.warmup_parallel:
            raise ValueError(
                "warmup_parallel is not supported: the port warms the batch "
                "classes one after another (concurrent warm-up threads only "
                "contend for the GIL and the device's default stream)"
            )
        if self.max_batch < 1 or next_pow2(self.max_batch) != self.max_batch:
            raise ValueError("max_batch must be a power of two >= 1")
        if self.overload_policy not in _OVERLOAD_POLICIES:
            raise ValueError(
                f"overload_policy must be one of {_OVERLOAD_POLICIES}"
            )

    @property
    def batch_classes(self) -> Tuple[int, ...]:
        out, b = [], 1
        while b <= self.max_batch:
            out.append(b)
            b *= 2
        return tuple(out)


class SearchReply(NamedTuple):
    gids: np.ndarray       # (k,) global ids, -1 = no result
    distances: np.ndarray  # (k,) +inf where no result
    # True when a degraded sharded index skipped a failed shard: the
    # answer covers only the surviving shards' points
    partial: bool = False


class _Request(NamedTuple):
    vec: np.ndarray
    future: Future
    t_submit: float
    deadline: Optional[float]  # absolute perf_counter time, or None


_STOP = object()  # queue sentinel: drains FIFO behind pending requests


class _AdmissionQueue:
    """Bounded FIFO with the three overload policies. The sentinel
    bypasses the bound (stop() must always be able to enqueue it), and
    `close()` wakes blocked putters so they fail fast instead of
    waiting on a frontend that will never drain them."""

    def __init__(self, maxsize: int, policy: str) -> None:
        self._dq: collections.deque = collections.deque()
        self._maxsize = maxsize
        self._policy = policy
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._closed = False

    def __len__(self) -> int:
        with self._mu:
            return len(self._dq)

    def put(self, item: _Request) -> List[_Request]:
        """Admit `item` per the policy. Returns the requests shed to
        make room (empty except under "shed_oldest" at the bound)."""
        with self._mu:
            if self._policy == "block":
                while len(self._dq) >= self._maxsize and not self._closed:
                    self._not_full.wait()
            if self._closed:
                raise FrontendStopped("frontend is stopping")
            shed: List[_Request] = []
            if len(self._dq) >= self._maxsize:
                if self._policy == "reject":
                    raise OverloadError(
                        f"admission queue full ({self._maxsize})"
                    )
                # shed_oldest: evict from the front until there is room
                while len(self._dq) >= self._maxsize:
                    old = self._dq.popleft()
                    if old is _STOP:  # never shed the sentinel
                        self._dq.appendleft(old)
                        break
                    shed.append(old)
            self._dq.append(item)
            self._not_empty.notify()
            return shed

    def put_sentinel(self) -> None:
        with self._mu:
            self._dq.append(_STOP)
            self._not_empty.notify()

    def get(self, block: bool = True):
        with self._mu:
            while not self._dq:
                if not block:
                    raise queue.Empty
                self._not_empty.wait()
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._not_full.notify_all()

    def drain_requests(self) -> List[_Request]:
        """Remove and return every queued request, leaving sentinels in
        place (the dispatcher still needs its exit signal)."""
        with self._mu:
            kept, out = [], []
            while self._dq:
                item = self._dq.popleft()
                (kept if item is _STOP else out).append(item)
            self._dq.extend(kept)
            self._not_full.notify_all()
            return out


class SearchFrontend:
    def __init__(self, index, config: Optional[FrontendConfig] = None):
        self.index = index
        self.config = config or FrontendConfig()
        # the index's device, if it has one (a StreamingIndex does)
        self._device = getattr(index, "device", None)
        self._queue = _AdmissionQueue(
            self.config.max_queue, self.config.overload_policy
        )
        self._respond: "queue.Queue" = queue.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._responder: Optional[threading.Thread] = None
        self._started = False
        self._stopping = False
        reg = obs.REGISTRY
        self._c_requests = reg.counter("serve.frontend.requests")
        self._c_warmup = reg.counter("serve.frontend.warmup_dispatches")
        self._g_warmup_s = reg.gauge("serve.frontend.warmup_seconds")
        self._c_accepted = reg.counter("serve.admission.accepted")
        self._c_rejected = reg.counter("serve.admission.rejected")
        self._c_shed = reg.counter("serve.admission.shed")
        self._c_expired = reg.counter("serve.admission.deadline_expired")
        self._c_dispatch = {
            b: reg.counter("serve.frontend.dispatches", qclass=str(b))
            for b in self.config.batch_classes
        }
        self._h_occupancy = reg.histogram(
            "serve.frontend.batch_occupancy", unit="requests"
        )
        self._h_latency = reg.histogram(
            "serve.frontend.latency_ms", unit="ms"
        )

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SearchFrontend":
        if self._started:
            return self
        if self._stopping:
            raise FrontendStopped("frontend already stopped")
        if self.config.warmup:
            self._warmup()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="repro-serve-dispatch",
            daemon=True,
        )
        self._responder = threading.Thread(
            target=self._respond_loop, name="repro-serve-respond",
            daemon=True,
        )
        self._dispatcher.start()
        self._responder.start()
        self._started = True
        return self

    def stop(self) -> None:
        """Graceful drain: everything submitted before stop() is
        answered — unless `drain_timeout_s` is set and passes first, in
        which case still-queued requests are FAILED with
        `FrontendStopped` (never orphaned: a Future that never resolves
        deadlocks its caller). New `submit()` calls raise immediately
        from the moment stop() begins."""
        if not self._started:
            return
        self._stopping = True       # submit() fast-fails from here on
        self._queue.put_sentinel()  # FIFO: drains behind pending work
        self._queue.close()         # wake any blocked putters -> raise
        self._dispatcher.join(timeout=self.config.drain_timeout_s)
        if self._dispatcher.is_alive():
            # past the drain deadline (e.g. a wedged/slow index): fail
            # what is still queued so no caller waits forever, then
            # join for real — bounded by the one in-flight batch
            self._fail_requests(self._queue.drain_requests())
            self._dispatcher.join()
        # nothing new could have been admitted since close(); clear any
        # request that slipped in between the joins anyway
        self._fail_requests(self._queue.drain_requests())
        self._respond.put(_STOP)
        self._responder.join()
        self._dispatcher = self._responder = None
        self._started = False

    def _fail_requests(self, reqs: List[_Request]) -> None:
        for req in reqs:
            req.future.set_exception(
                FrontendStopped("frontend stopped before dispatch")
            )

    def __enter__(self) -> "SearchFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _pin_device(self) -> None:
        """Make the index's CUDA device the calling thread's current one:
        CUDA's current device is per thread, and the kernels launch on
        it."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)

    def _warmup(self) -> None:
        """One dispatch per batch class against the live snapshot: the
        kernel library is then loaded and the engine's and wrappers'
        caches hold every query shape serving will see, so no live
        request pays a first call. Classes warm one after another."""
        t0 = time.perf_counter()
        for b in self.config.batch_classes:
            self._search_batch(np.zeros((b, self.index.dim), np.float32))
            self._c_warmup.inc()
        self._g_warmup_s.set(time.perf_counter() - t0)

    # -- client surface ------------------------------------------------------
    def submit(
        self, vec: np.ndarray, deadline_s: Optional[float] = None
    ) -> Future:
        """Enqueue one query; returns a Future resolving to a
        `SearchReply`. `deadline_s` (seconds from now; falls back to
        config.default_deadline_s) bounds how long the request may wait
        for dispatch. Under policy "block" this blocks at max_queue;
        under "reject" it raises `OverloadError`; under "shed_oldest"
        it always lands, at the cost of the oldest queued request."""
        if not self._started or self._stopping:
            raise FrontendStopped("frontend not running")
        v = np.asarray(vec, np.float32).reshape(self.index.dim)
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        now = time.perf_counter()
        deadline = None if deadline_s is None else now + float(deadline_s)
        fut: Future = Future()
        self._c_requests.inc()
        try:
            shed = self._queue.put(_Request(v, fut, now, deadline))
        except OverloadError:
            self._c_rejected.inc()
            raise
        self._c_accepted.inc()
        if shed:
            self._c_shed.inc(len(shed))
            for old in shed:
                old.future.set_exception(
                    OverloadError("shed by a newer request under overload")
                )
        return fut

    def search(self, vec: np.ndarray, timeout: Optional[float] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(vec).result(timeout)

    # -- dispatcher ----------------------------------------------------------
    def _search_batch(self, qarr: np.ndarray):
        cfg = self.config
        faults.fire("frontend.dispatch")
        return self.index.constrained_knn(qarr, cfg.k, cfg.radius)

    def _take_batch(self, first) -> List[_Request]:
        """The continuous-batching drain: the triggering request plus
        whatever else is already queued, up to max_batch."""
        batch = [first]
        while len(batch) < self.config.max_batch:
            try:
                item = self._queue.get(block=False)
            except queue.Empty:
                break
            if item is _STOP:
                # push back so the outer loop terminates after this batch
                self._queue.put_sentinel()
                break
            batch.append(item)
        return batch

    def _expire(self, batch: List[_Request]) -> List[_Request]:
        """Fail requests whose deadline passed while queued — BEFORE
        the batch spends a device dispatch on them."""
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self._c_expired.inc()
                req.future.set_exception(
                    DeadlineExceededError(
                        "deadline expired before dispatch"
                    )
                )
            else:
                live.append(req)
        return live

    def _dispatch_loop(self) -> None:
        self._pin_device()
        while True:
            first = self._queue.get()
            if first is _STOP:
                return
            batch = self._expire(self._take_batch(first))
            if not batch:
                continue
            n = len(batch)
            b_cls = next_pow2(n)
            qarr = np.empty((b_cls, self.index.dim), np.float32)
            for i, req in enumerate(batch):
                qarr[i] = req.vec
            qarr[n:] = batch[0].vec  # pad rows: answered, then dropped
            try:
                res = self._search_batch(qarr)
            except BaseException as e:  # fail the batch, keep serving
                for req in batch:
                    req.future.set_exception(e)
                continue
            self._c_dispatch[b_cls].inc()
            self._h_occupancy.observe(n)
            self._respond.put((batch, res))

    # -- responder -----------------------------------------------------------
    def _respond_loop(self) -> None:
        while True:
            item = self._respond.get()
            if item is _STOP:
                return
            batch, res = item
            # materialize once per batch (np.asarray is a no-op when the
            # index already returned host arrays), then slice per request
            gids = np.asarray(res.gids)
            dists = np.asarray(res.distances)
            partial = bool(getattr(res, "partial", False))
            now = time.perf_counter()
            for i, req in enumerate(batch):
                req.future.set_result(
                    SearchReply(gids[i], dists[i], partial)
                )
                self._h_latency.observe((now - req.t_submit) * 1e3)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry: seeded, jittered exponential backoff. Only
    errors carrying ``retryable = True`` (OverloadError, injected
    transient faults) are retried — a deadline miss or a stopped
    frontend is final."""

    max_attempts: int = 4
    base_backoff_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 0.25
    jitter: float = 0.5  # +/- fraction of each delay, uniform
    seed: int = 0


class RetryingClient:
    def __init__(
        self, frontend: SearchFrontend, policy: Optional[RetryPolicy] = None
    ) -> None:
        self.frontend = frontend
        self.policy = policy or RetryPolicy()
        self._rng = np.random.default_rng(self.policy.seed)
        self._c_retries = obs.REGISTRY.counter("serve.client.retries")

    def search(
        self,
        vec: np.ndarray,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> SearchReply:
        pol = self.policy
        delay = pol.base_backoff_s
        for attempt in range(pol.max_attempts):
            try:
                fut = self.frontend.submit(vec, deadline_s=deadline_s)
                return fut.result(timeout)
            except BaseException as e:
                final = attempt + 1 >= pol.max_attempts
                if final or not getattr(e, "retryable", False):
                    raise
                self._c_retries.inc()
                jit = 1.0 + pol.jitter * (2.0 * self._rng.random() - 1.0)
                time.sleep(min(delay, pol.max_backoff_s) * jit)
                delay *= pol.multiplier
        raise AssertionError("unreachable")  # pragma: no cover


__all__ = [
    "DeadlineExceededError",
    "FrontendConfig",
    "FrontendStopped",
    "OverloadError",
    "RetryPolicy",
    "RetryingClient",
    "SearchFrontend",
    "SearchReply",
    "next_pow2",
]
