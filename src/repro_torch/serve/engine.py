"""Batched serving engines: MATE discovery batching + LLM decode slots.

Port of ``repro.serve.engine``.  Two request classes share the
slot-batching philosophy (fixed-size groups, one device launch per group):

  * ``DiscoveryEngine`` — multi-query online join discovery on top of a
    ``core.session.MateSession``.  ``submit`` returns a request carrying a
    ``concurrent.futures.Future``; ``pump`` (the per-tick scheduling step)
    serves arrival-window groups — a group launches when it fills to
    ``batch`` requests OR when its oldest request has waited
    ``flush_after`` seconds (minus a ``deadline_margin`` so the group is
    SERVED by its deadline, not merely started at it).  Each group's
    candidate rows and query keys concatenate into ONE filter launch
    (``MateSession.plan_and_count``: on CUDA under the default
    'fused-gather' backend, kernel B.2), so concurrent requests amortise
    the launch.  Results are bit-identical to per-request ``discover``.

    The serving tier on top (all knobs in ``DiscoveryConfig``):

      - bounded submit queue + admission control: at ``max_queue`` waiting
        requests, ``submit`` either SHEDS (the future is rejected with
        ``AdmissionError`` — never silently hung) or DEGRADES (the request
        is admitted flagged for ``degrade_bits`` lane-prefix filtering —
        B.2 probing the first lanes of the full-width device store, a pure
        relaxation, so results stay bit-identical while filter bandwidth
        drops; a hard shed still applies at 2×``max_queue``);
      - ``serve.cache`` in front of the filter: a query-result cache
        answers repeated queries at ``submit`` time and a hot-table bound
        cache lets repeated queries skip ``gather_candidates`` + the
        filter launch, both invalidated by §5.4 index mutations via
        ``MateIndex.mutation_epoch``;
      - cancellation: a request whose future is cancelled never launches
        and stops holding a window slot.

  * ``AsyncDiscoveryEngine`` — the asyncio serving tier proper: a
    background pump task (a coroutine on the caller's event loop, no
    thread, so every CUDA launch stays on the caller's thread and stream)
    that wakes on submit or the next group deadline and SURVIVES group
    failures (each failed group rejects its own futures; the loop keeps
    serving).  Time is injected via ``serve.clock`` so the whole tier runs
    deterministically under a fake clock in tests.

  * ``ServeEngine`` — prefill + decode with slot-based batching for the
    dense LM.  The reference's behaviour is kept as it is: prompts are
    left-padded with token 0 to the group's longest prompt, positions are
    ``arange(plen)`` with no pad mask, and each decode step first appends
    the current token, then computes the next one (so the last step's
    token is never appended).  Greedy decoding is ``argmax``; temperature
    sampling draws from a ``torch.Generator`` seeded with 0 at each
    ``generate`` (the reference starts from ``PRNGKey(0)``) and does not
    reproduce ``jax.random``'s bits.  ``extra_inputs`` (encoder frames,
    vision patches) go to every prefill, as in the reference.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core.batched import PlanCounts
from repro_torch.core.corpus import Table
from repro_torch.core.discovery import DiscoveryStats, TopKEntry
from repro_torch.core.index import MateIndex
from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import cache as cache_lib
from repro_torch.serve.clock import SystemClock


class AdmissionError(RuntimeError):
    """Request rejected by admission control (bounded queue at capacity,
    or the engine stopped with a non-draining shutdown).  Carried by the
    request's future — awaiters observe the shed instead of hanging."""


@dataclasses.dataclass
class DiscoveryRequest:
    """One top-k join-discovery request flowing through ``DiscoveryEngine``.

    ``future`` resolves to ``(results, stats)`` when the request's group is
    served — the async handle a caller can await (``asyncio.wrap_future``)
    or block on (``future.result()``) while the engine keeps ticking;
    ``results``/``stats`` mirror it for synchronous callers.
    """

    query: Table
    q_cols: list[int]
    k: int = 10
    arrival: float = 0.0
    results: list[TopKEntry] | None = None
    stats: DiscoveryStats | None = None
    future: Future = dataclasses.field(default_factory=Future, repr=False)
    # serving-tier bookkeeping:
    degraded: bool = False  # admitted under pressure → degrade_bits filtering
    from_cache: bool = False  # answered from the query-result cache at submit
    fingerprint: bytes | None = dataclasses.field(default=None, repr=False)
    bounds: PlanCounts | None = dataclasses.field(default=None, repr=False)
    # bound-cache hit: phase A (gather + filter) is already paid for

    @property
    def done(self) -> bool:
        return self.results is not None

    def cancel(self) -> bool:
        """Cancel the future; a cancelled request never launches (the
        engine purges it before grouping) and frees its window slot."""
        return self.future.cancel()

    @property
    def cancelled(self) -> bool:
        return self.future.cancelled()


class DiscoveryEngine:
    """Arrival-window batching loop over a ``MateSession``.

    Construction: pass a ``MateSession`` (preferred — the engine adopts its
    config's ``window``/``flush_after``), or a bare ``MateIndex`` plus an
    optional ``DiscoveryConfig``.  The engine serves whatever hash width and
    backend the session resolved — pin the backend via
    ``DiscoveryConfig(backend=...)``.

    Scheduling: ``submit`` queues a request (its ``k`` may differ per
    request; None takes the config default).  ``pump(now)`` — the unit a
    serving tick calls between decode steps — launches every DUE group:
    a group is due when ``batch`` requests are waiting (window full) or the
    oldest waiting request is ``flush_after`` seconds old (deadline).  With
    ``flush_after=None`` only full windows launch; ``flush()`` always
    drains everything (the synchronous path, unchanged from earlier PRs).
    """

    def __init__(
        self,
        index: MateIndex | MateSession | None = None,
        batch: int | None = None,
        *,
        session: MateSession | None = None,
        config: DiscoveryConfig | None = None,
        flush_after: float | None = None,
        clock=time.monotonic,
    ):
        if isinstance(index, MateSession):
            session, index = index, None
        if session is None:
            if index is None:
                raise TypeError("DiscoveryEngine needs a MateSession or a MateIndex")
            session = MateSession(index, config)
        elif index is not None or config is not None:
            raise TypeError("pass either session= or index/config, not both")
        self.session = session
        self.batch = batch if batch is not None else session.config.window
        self.flush_after = (
            flush_after if flush_after is not None else session.config.flush_after
        )
        self.clock = clock
        self.queue: list[DiscoveryRequest] = []
        cfg = session.config
        self.max_queue = cfg.max_queue
        self.pressure_policy = cfg.pressure_policy
        # degrade width in uint32 lanes, clamped to the index width (a
        # 128-bit index cannot degrade below itself — degrade is a no-op)
        self.degrade_lanes = min(cfg.degrade_bits // 32, session.index.cfg.lanes)
        self.deadline_margin = cfg.deadline_margin  # None: auto (EWMA below)
        self._service_ewma: float | None = None  # observed group service time
        self.result_cache = (
            cache_lib.QueryResultCache(cfg.result_cache) if cfg.result_cache else None
        )
        self.bound_cache = (
            cache_lib.BoundCache(cfg.bound_cache) if cfg.bound_cache else None
        )

    @property
    def index(self) -> MateIndex:
        return self.session.index

    @property
    def bits(self) -> int:
        """Superkey hash width of the underlying index."""
        return self.session.bits

    @property
    def backend(self):
        """The session's resolved filter backend."""
        return self.session.backend

    def submit(
        self,
        query: Table,
        q_cols: list[int],
        k: int | None = None,
        now: float | None = None,
    ) -> DiscoveryRequest:
        """Queue a request (or answer/reject it immediately).

        In order: a query-result cache hit resolves the future RIGHT HERE
        (bit-identical replay, no queue slot, no index work); then admission
        control applies at ``max_queue`` waiting requests — 'shed' rejects
        the future with ``AdmissionError``, 'degrade' admits the request
        flagged for ``degrade_bits`` filtering (hard shed at 2×); finally a
        bound-cache hit rides along on the queued request so its group
        launch skips gather+filter for it.  The returned request's future
        is thus always eventually resolved: result, error, or shed."""
        req = DiscoveryRequest(
            query=query,
            q_cols=q_cols,
            k=self.session.config.k if k is None else k,
            arrival=self.clock() if now is None else now,
        )
        st = self.session.stats
        if self.result_cache is not None or self.bound_cache is not None:
            req.fingerprint = cache_lib.query_fingerprint(
                query, q_cols, self.session.config.init_mode,
                rank=self.session.config.rank,
                profile_gate=self.session.config.profile_gate,
            )
            epoch = self.index.mutation_epoch
            if self.result_cache is not None:
                hit = self.result_cache.get(req.fingerprint, req.k, epoch)
                if hit is not None:
                    entries, stats = hit
                    req.results, req.stats, req.from_cache = entries, stats, True
                    req.future.set_result((entries, stats))
                    st.requests += 1
                    st.cache_hits += 1
                    return req
            if self.bound_cache is not None:
                req.bounds = self.bound_cache.get(req.fingerprint, epoch)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # degraded filtering relieves filter bandwidth, not an unbounded
            # backlog — past 2×max_queue even 'degrade' sheds.
            if self.pressure_policy == "shed" or len(self.queue) >= 2 * self.max_queue:
                st.shed += 1
                req.future.set_exception(
                    AdmissionError(
                        f"queue full: {len(self.queue)} waiting >= "
                        f"max_queue={self.max_queue} (policy="
                        f"{self.pressure_policy!r})"
                    )
                )
                return req
            req.degraded = True
            st.degraded += 1
        self.queue.append(req)
        self._notify_submit()
        return req

    def _notify_submit(self) -> None:
        """Hook for the async engine: wake the pump task on new work."""

    def _purge_cancelled(self) -> None:
        self.queue = [r for r in self.queue if not r.future.cancelled()]

    def _serve_group(self, group: list[DiscoveryRequest]) -> None:
        group = [r for r in group if not r.future.cancelled()]
        if not group:
            return
        t0 = self.clock()
        epoch = self.index.mutation_epoch
        # warm requests replay cached phase-A bounds (skip gather+filter);
        # a stale-epoch bounds object is discarded — it was cached before a
        # §5.4 mutation that may have changed this query's candidates.
        warm: list[DiscoveryRequest] = []
        cold: list[DiscoveryRequest] = []
        for r in group:
            (warm if r.bounds is not None and r.bounds.epoch == epoch else cold).append(r)
        lanes = self.degrade_lanes if any(r.degraded for r in cold) else None
        try:
            pcs = (
                self.session.plan_and_count(
                    [(r.query, r.q_cols) for r in cold], filter_lanes=lanes
                )
                if cold
                else []
            )
            st = self.session.stats
            for req, pc in zip(cold, pcs):
                entries, stats = self.session.score_from_counts(pc, req.k)
                if req.fingerprint is not None:
                    if self.result_cache is not None:
                        self.result_cache.put(
                            req.fingerprint, req.k, pc.epoch, entries, stats
                        )
                    # degraded counts are valid (looser) bounds, but don't
                    # cache them: a hot entry would keep replaying the wide
                    # survivor set long after the pressure spike ended.
                    if self.bound_cache is not None and not req.degraded:
                        self.bound_cache.put(req.fingerprint, pc)
                self._resolve(req, entries, stats)
            for req in warm:
                entries, stats = self.session.score_from_counts(
                    req.bounds, req.k, from_cache=True
                )
                st.bound_hits += 1
                if self.result_cache is not None and req.fingerprint is not None:
                    self.result_cache.put(
                        req.fingerprint, req.k, req.bounds.epoch, entries, stats
                    )
                self._resolve(req, entries, stats)
        except BaseException as e:
            # the group is already dequeued: reject every future so sibling
            # awaiters see the failure instead of polling forever, then let
            # the pump caller observe the exception too.  (The background
            # pump task catches it and keeps serving later groups.)
            for req in group:
                if not req.future.done():
                    req.future.set_exception(e)
            raise
        dt = self.clock() - t0
        self._service_ewma = (
            dt if self._service_ewma is None else 0.7 * self._service_ewma + 0.3 * dt
        )

    def _resolve(self, req: DiscoveryRequest, entries, stats) -> None:
        req.results, req.stats = entries, stats
        if not req.future.done():  # done: cancelled between launch and here
            req.future.set_result((entries, stats))

    def _margin(self) -> float:
        """Seconds before a deadline to launch a partial group, so it is
        SERVED by the deadline: the configured ``deadline_margin``, or the
        observed group-service-time EWMA when configured as None (auto)."""
        if self.deadline_margin is not None:
            return self.deadline_margin
        return self._service_ewma or 0.0

    def _due(self, now: float) -> bool:
        if len(self.queue) >= self.batch:
            return True
        return bool(
            self.queue
            and self.flush_after is not None
            and now - self.queue[0].arrival >= self.flush_after - self._margin()
        )

    def next_deadline(self) -> float | None:
        """Absolute time the oldest queued request's group should LAUNCH by
        (its ``flush_after`` deadline minus the margin), or None when
        nothing is waiting / no deadline policy is set."""
        if not self.queue or self.flush_after is None:
            return None
        return self.queue[0].arrival + self.flush_after - self._margin()

    def pump(self, now: float | None = None) -> list[DiscoveryRequest]:
        """One scheduling step: launch every due group; returns requests
        served THIS call (submission order).  O(1) when nothing is due —
        cheap enough to call between every decode tick.  Cancelled requests
        are purged first: they never launch and never hold a window open."""
        now = self.clock() if now is None else now
        self._purge_cancelled()
        served: list[DiscoveryRequest] = []
        while self._due(now):
            group, self.queue = self.queue[: self.batch], self.queue[self.batch :]
            self._serve_group(group)
            served.extend(r for r in group if not r.future.cancelled())
        return served

    def flush(self) -> list[DiscoveryRequest]:
        """Serve every queued request NOW (deadline ignored); returns them
        in submission order.  Groups dequeue one at a time, so a failing
        group launch rejects only ITS requests' futures — later groups stay
        queued (futures pending) for a retry pump/flush."""
        self._purge_cancelled()
        served: list[DiscoveryRequest] = []
        while self.queue:
            group, self.queue = self.queue[: self.batch], self.queue[self.batch :]
            self._serve_group(group)
            served.extend(r for r in group if not r.future.cancelled())
        return served

    def discover(
        self, query: Table, q_cols: list[int], k: int | None = None
    ) -> DiscoveryRequest:
        """One-shot convenience: submit + flush a single request."""
        req = self.submit(query, q_cols, k)
        self.flush()
        return req

    async def discover_async(
        self, query: Table, q_cols: list[int], k: int | None = None
    ) -> DiscoveryRequest:
        """Submit and await: yields to the event loop until the request's
        group is served.  The engine itself has no background thread — some
        task must keep calling ``pump()`` (a serving tick, or a sibling
        ``discover_async`` waiter: each waiter pumps when its own deadline
        or window comes due, so a loop full of awaiting requests makes
        progress by itself).

        With NO deadline policy (``flush_after=None``) nothing would ever
        launch a partial group, so an async waiter must not wait on the
        window alone — it yields once (letting sibling submits land and the
        window fill) and then drains its group immediately.  Set
        ``flush_after`` to actually hold a window open for stragglers."""
        req = self.submit(query, q_cols, k)
        if self.flush_after is None:
            await asyncio.sleep(0)  # let concurrently-spawned waiters queue
            self.pump()
            if not req.future.done():
                self.flush()  # no deadline will ever fire: drain, don't spin
        else:
            while not req.future.done():
                self.pump()
                if req.future.done():
                    break
                deadline = self.next_deadline()
                now = self.clock()
                # sleep to the group deadline (or a short poll while our own
                # group is not yet the oldest), yielding to decode ticks
                delay = 0.001 if deadline is None else max(deadline - now, 0.0)
                await asyncio.sleep(min(delay, 0.05))
        req.future.result()  # propagate a group failure to THIS awaiter
        return req


class AsyncDiscoveryEngine(DiscoveryEngine):
    """The asyncio serving tier: a ``DiscoveryEngine`` driven by a
    BACKGROUND pump task instead of caller-side pumping.

    ``start()`` spawns the pump loop on the running event loop: it wakes
    whenever a request is submitted or the next group deadline arrives,
    launches every due group, and goes back to sleep until the next signal
    — callers just ``await discover_async(...)``.  The loop OUTLIVES group
    failures: a failing launch rejects that group's futures (see
    ``_serve_group``) and is counted in ``pump_errors``, then the loop
    keeps serving later groups — one poisoned query must not orphan every
    future queued behind it.

    Time comes from a ``serve.clock`` object (``SystemClock`` by default);
    pass ``ManualClock`` and the whole tier — deadlines, wake-ups, EWMA —
    runs under virtual time (``tests/test_torch_serving.py``).

    Use as an async context manager::

        async with AsyncDiscoveryEngine(session=session) as eng:
            entries, stats = (await eng.discover_async(q, cols)).future.result()
    """

    def __init__(
        self,
        index: MateIndex | MateSession | None = None,
        batch: int | None = None,
        *,
        session: MateSession | None = None,
        config: DiscoveryConfig | None = None,
        flush_after: float | None = None,
        clock=None,
    ):
        self.aclock = clock if clock is not None else SystemClock()
        super().__init__(
            index, batch, session=session, config=config,
            flush_after=flush_after, clock=self.aclock.now,
        )
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._stopping = False
        self.pump_errors = 0  # failed group launches the pump survived

    def _notify_submit(self) -> None:
        if self._wake is not None:
            self._wake.set()

    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("pump task already running")
        self._wake = asyncio.Event()
        self._stopping = False
        self._task = asyncio.get_running_loop().create_task(self._pump_loop())

    async def stop(self, drain: bool = True) -> None:
        """Stop the pump task.  ``drain=True`` serves the backlog first
        (synchronously, deadline ignored); ``drain=False`` rejects every
        still-pending queued future with ``AdmissionError`` — either way no
        future is left hanging."""
        if self._task is None:
            return
        self._stopping = True
        self._wake.set()
        try:
            await self._task
        finally:
            self._task = None
            self._wake = None
        if drain:
            self.flush()
        else:
            for req in self.queue:
                if not req.future.done():
                    req.future.set_exception(AdmissionError("engine stopped"))
            self.queue.clear()

    async def __aenter__(self) -> "AsyncDiscoveryEngine":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def _pump_loop(self) -> None:
        while not self._stopping:
            try:
                self.pump()
            except asyncio.CancelledError:
                raise
            except BaseException:
                # the failed group's futures are already rejected; the loop
                # must survive to serve everything queued behind it.
                self.pump_errors += 1
            timeout = None  # no queued deadline: sleep until a submit
            deadline = self.next_deadline()
            if deadline is not None:
                timeout = max(deadline - self.clock(), 0.0)
            await self.aclock.wait(self._wake, timeout)
            self._wake.clear()

    async def discover_async(
        self, query: Table, q_cols: list[int], k: int | None = None
    ) -> DiscoveryRequest:
        """Submit and await — the background pump serves the group, so this
        just parks on the future (no caller-side pumping).  Raises what the
        future carries: ``AdmissionError`` on shed, the group's exception
        on a failed launch."""
        if self._task is None:
            raise RuntimeError("pump task not running — use 'async with' or start()")
        req = self.submit(query, q_cols, k)
        await asyncio.wrap_future(req.future)
        return req


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def make_serve_step(model: TransformerLM, temperature: float = 0.0):
    """Returns serve_step(cache, token[B], generator) -> (next_token[B], cache)."""

    def serve_step(cache, token, generator):
        logits, cache = model.decode_step(token, cache)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), cache

    return serve_step


class ServeEngine:
    """Host-side loop around prefill / serve_step.

    ``extra_inputs`` (optional) are passed to every prefill: the stub
    frontends' ``frames`` (whisper) or ``patches`` (the VLM), [batch, n,
    D] — one row per slot, as ``data.pipeline.stub_inputs`` makes them.
    ``on_tick`` (optional, ``callable(step)``) runs between decode steps —
    the interleave point for another host-side scheduler while the freshly
    launched decode step is in flight.  ``timings`` holds, after
    ``generate``, the host seconds of each group's prefill (through the
    first token's readback) and of each decode step (through its token's
    readback).
    """

    def __init__(self, model: TransformerLM, batch: int, max_seq: int, temperature: float = 0.0,
                 extra_inputs: dict | None = None):
        self.model = model
        self.batch, self.max_seq = batch, max_seq
        self.extra = extra_inputs or {}
        self.on_tick = None
        self.step_fn = make_serve_step(model, temperature)
        self.timings: dict[str, list[float]] = {"prefill_s": [], "decode_s": []}

    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve requests in slot batches of ``self.batch``."""
        gen = torch.Generator(device=self.model.device).manual_seed(0)
        self.timings = {"prefill_s": [], "decode_s": []}
        for start in range(0, len(requests), self.batch):
            group = requests[start : start + self.batch]
            plen = max(len(r.prompt) for r in group)
            toks = np.zeros((self.batch, plen), np.int64)
            for i, r in enumerate(group):
                toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(toks, self.max_seq, **self.extra)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            host = token.tolist()
            self.timings["prefill_s"].append(time.perf_counter() - t0)
            max_new = max(r.max_new for r in group)
            for step in range(max_new):
                t0 = time.perf_counter()
                for i, r in enumerate(group):
                    if not r.done and step < r.max_new:
                        r.out.append(host[i])
                token, cache = self.step_fn(cache, token, gen)
                if self.on_tick is not None:
                    self.on_tick(step)
                host = token.tolist()
                self.timings["decode_s"].append(time.perf_counter() - t0)
            for r in group:
                r.done = True
        return requests
