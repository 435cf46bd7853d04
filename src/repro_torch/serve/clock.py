"""Clocks for the asyncio serving tier — real and deterministic.

Port of ``repro.serve.clock``, unchanged in behaviour.

``AsyncDiscoveryEngine``'s pump task does exactly two time-dependent
things: read "now" (deadline checks) and sleep until "a submit arrives OR
the next group deadline".  Both are factored behind a clock object so the
entire serving tier runs under a fake clock in tests:

  * ``SystemClock`` — ``time.monotonic`` + ``asyncio.wait_for``; production.
  * ``ManualClock`` — VIRTUAL time that only moves when the test calls
    ``advance``/``advance_to``.  Waiters register a (deadline, event) pair;
    advancing past a deadline releases its waiter.  No real sleeping, no
    wall-clock flake: a test drives arrival order, deadline expiry and
    pump wake-ups cycle-by-cycle (``tests/test_torch_serving.py``).

Both expose ``now() -> float`` and ``async wait(event, timeout) -> bool``
(True iff the event fired before the timeout).  The plain synchronous
``DiscoveryEngine`` needs only ``now`` — pass ``ManualClock().now`` as its
``clock=``.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time


class SystemClock:
    """Wall clock: ``time.monotonic`` now, real asyncio sleeps."""

    def now(self) -> float:
        return time.monotonic()

    async def wait(self, event: asyncio.Event, timeout: float | None = None) -> bool:
        if timeout is None:
            await event.wait()
            return True
        if timeout <= 0:
            await asyncio.sleep(0)
            return event.is_set()
        try:
            await asyncio.wait_for(event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False


class ManualClock:
    """Deterministic virtual clock for serving-tier tests.

    ``now`` returns virtual time; ``wait`` parks the caller until the event
    fires or virtual time passes ``now + timeout`` — which only happens when
    the test calls ``advance``/``advance_to``.  Advancing releases every
    waiter whose virtual deadline passed (in deadline order), then returns;
    the released coroutines run on the next event-loop cycle, so tests
    interleave clock advances with ``asyncio.sleep(0)`` yields to step the
    pump deterministically.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._seq = itertools.count()  # tie-break so heap never compares Events
        self._sleepers: list[tuple[float, int, asyncio.Event]] = []

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self.advance_to(self._t + dt)

    def advance_to(self, t: float) -> None:
        if t < self._t:
            raise ValueError(f"virtual time cannot go backwards: {t} < {self._t}")
        self._t = float(t)
        while self._sleepers and self._sleepers[0][0] <= self._t:
            _, _, release = heapq.heappop(self._sleepers)
            release.set()

    async def wait(self, event: asyncio.Event, timeout: float | None = None) -> bool:
        if event.is_set():
            return True
        if timeout is None:
            await event.wait()
            return True
        if timeout <= 0:
            await asyncio.sleep(0)
            return event.is_set()
        release = asyncio.Event()
        heapq.heappush(self._sleepers, (self._t + timeout, next(self._seq), release))
        ev_task = asyncio.ensure_future(event.wait())
        rel_task = asyncio.ensure_future(release.wait())
        try:
            await asyncio.wait(
                {ev_task, rel_task}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            for task in (ev_task, rel_task):
                if not task.done():
                    task.cancel()
                    try:
                        await task
                    except asyncio.CancelledError:
                        pass
        return event.is_set()
