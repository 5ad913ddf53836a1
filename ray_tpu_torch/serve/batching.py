"""Token-level continuous batching inside a replica (port of the
ContinuousBatcher half of ray_tpu/serve/batching.py).

ContinuousBatcher is the Orca/vLLM iteration-level scheduling shape: one
loop thread owns an engine with `max_batch_size` decode slots, admits
queued requests into the RUNNING batch between decode steps and retires
finished sequences at token granularity. Emitted tokens stream to
per-request GenerationStreams.

`drain(deadline_s)` stops admissions, bounces queued-but-unadmitted work
with ReplicaDrainingError and lets in-flight work finish — a running
generation keeps decoding until done or the drain deadline, at which point
it is CUT (its stream ends, marked `cut`), never orphaned.

Not ported yet: the request-level `@serve.batch` queue, telemetry, and
`run_on_loop` (its callers, KV export and weight swap, are not ported).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .. import _config
from ..models.kv_paging import InsufficientBlocksError


class ReplicaDrainingError(RuntimeError):
    """Raised by a draining replica for NEW requests. No user code ran, so
    a caller may retry it on another replica."""

    def __init__(self, deployment_name: str = ""):
        super().__init__(
            f"replica of {deployment_name!r} is draining and accepts no new "
            "requests"
        )
        self.deployment_name = deployment_name


class GenerationStream:
    """Per-request token stream: the batcher pushes, one consumer pulls.

    Iterable in-process; `next_batch` is the long-poll pull (block up to
    wait_s for the first item, then drain whatever else is ready)."""

    _END = object()

    def __init__(self, request_id: int, request: Dict[str, Any]):
        self.request_id = request_id
        self.request = request
        self.cut = False        # drain deadline truncated this generation
        self.cancelled = False  # consumer went away
        self.preempted = False  # evicted under KV pressure, parked to resume
        self._q: "queue.Queue" = queue.Queue()
        self._finished = threading.Event()
        self._error: Optional[BaseException] = None
        self._drained = False   # END consumed; only the error (if any) left
        # finalize-once guard is a real lock: close() (caller thread) and
        # the batcher loop can race _finish on the same stream
        self._finalized = False
        self._final_lock = threading.Lock()

    # -- producer side (batcher loop thread)

    def _push(self, token) -> None:
        self._q.put(token)

    def _finish(self, error: Optional[BaseException] = None,
                cut: bool = False) -> None:
        # FIRST finish wins the terminal state: a racing close()/drain must
        # neither clear a recorded engine fault nor end the stream twice
        with self._final_lock:
            if self._finalized:
                return
            self._finalized = True
            self._error = error
            self.cut = cut or self.cut
        self._finished.set()
        self._q.put(self._END)

    # -- consumer side

    def cancel(self) -> None:
        """Consumer gone: the batcher retires the slot at the next step."""
        self.cancelled = True

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    def next_batch(self, max_items: int = 64,
                   wait_s: float = 0.25) -> Tuple[List[Any], bool]:
        """Pull up to max_items; returns (items, done). Blocks up to wait_s
        for the first item; raises the stream's error once all produced
        items have been delivered — when tokens and the END marker land in
        one pull the items go out with done=False and the NEXT pull
        raises, so a faulted stream never ends looking clean."""
        if self._drained:
            if self._error is not None:
                raise self._error
            return [], True
        items: List[Any] = []
        try:
            first = self._q.get(timeout=max(0.0, wait_s))
        except queue.Empty:
            return items, False
        ended = first is self._END
        if not ended:
            items.append(first)
            while len(items) < max_items:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._END:
                    ended = True
                    break
                items.append(nxt)
        if ended:
            self._drained = True
            if self._error is not None:
                if items:
                    return items, False  # error surfaces on the next pull
                raise self._error
        return items, ended

    def __iter__(self):
        while True:
            items, done = self.next_batch(max_items=64, wait_s=5.0)
            yield from items
            if done:
                return


class ContinuousBatcher:
    """Token-granularity continuous batching over a slot-based engine.

    engine contract (see ray_tpu_torch.models.kv_paging.PagedDecodeEngine):
      admit(slot, request) -> (token, done)
      step(slots)          -> {slot: (token, done)}
      release(slot)          optional

    Chunked prefill stretches the contract: admit() may return
    (None, False) — nothing is pushed — and subsequent steps return
    ([], False) for that slot while its prompt streams in chunk-per-step;
    the first sampled token arrives through step() as a one-item list.

    One loop thread owns the engine. Requests submitted while the batch is
    full wait in a queue and are admitted the moment a slot retires.

    Paging-aware engines are driven through two optional duck-typed hooks:

      can_admit(request) -> bool   block-budget admission: a request whose
        worst-case KV-block need exceeds the pool's current headroom waits
        at the head of the line (order preserved) — unless NOTHING is
        running, in which case it is admitted best-effort so a lone
        oversized request gets a clear error rather than queueing forever.
      take_preempted() -> [(slot, parked_request)]   generations the engine
        evicted under pool exhaustion: their stream stays OPEN and the
        parked request re-enters at the head of the admission line; on
        readmit the engine recomputes the cache and the stream resumes
        exactly where it stopped.
    """

    def __init__(
        self,
        engine,
        max_batch_size: Optional[int] = None,
        batch_wait_timeout_s: Optional[float] = None,
    ):
        self.engine = engine
        engine_cap = getattr(engine, "max_batch_size", None)
        self.max_batch_size = int(
            max_batch_size
            or engine_cap
            or _config.SERVE_GENERATION_MAX_BATCH_SIZE
        )
        if engine_cap is not None and self.max_batch_size > engine_cap:
            raise ValueError(
                f"max_batch_size {self.max_batch_size} exceeds the engine's "
                f"{engine_cap} slots"
            )
        self.batch_wait_timeout_s = float(
            _config.SERVE_GENERATION_BATCH_WAIT_TIMEOUT_S
            if batch_wait_timeout_s is None else batch_wait_timeout_s
        )
        self._pending: "queue.Queue[GenerationStream]" = queue.Queue()
        # head-of-line parking: preempted generations awaiting readmission
        # and requests the engine's block budget cannot cover yet — checked
        # before the pending queue so admission order is preserved
        self._holdback: "deque" = deque()
        # memoized verdict for the parked head-of-line request: pool
        # headroom only changes on retire/preempt/admit
        self._admission_verdict: Optional[Tuple[int, bool]] = None
        self._admission_dirty = True
        self._free = list(range(self.max_batch_size))
        self._active: Dict[int, GenerationStream] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._shutdown = False
        self._steps = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="continuous-batcher"
        )
        self._thread.start()

    # ------------------------------------------------------------ public API

    def submit(self, **request) -> GenerationStream:
        """Queue a generation request; returns its token stream. Raises
        ReplicaDrainingError while draining (nothing ran — retryable)."""
        with self._lock:
            if self._draining or self._shutdown:
                raise ReplicaDrainingError()
            stream = GenerationStream(next(self._ids), request)
            self._pending.put(stream)
        return stream

    def drain(self, deadline_s: Optional[float] = None) -> None:
        """Stop admissions; bounce queued-but-unadmitted requests; let
        running generations finish until `deadline_s` from now, then cut
        them."""
        with self._lock:
            self._draining = True
            # explicit None check: deadline_s=0 means cut NOW, not never
            self._drain_deadline = (
                None if deadline_s is None else time.monotonic() + deadline_s
            )
        self._bounce_pending()

    def close(self) -> None:
        """Terminal stop: bounce queued requests AND cut active streams so
        no consumer is left blocking on a loop thread that exited."""
        self._shutdown = True
        self._bounce_pending()
        self._cut_parked()
        with self._lock:
            active = list(self._active.values())
            self._active.clear()
        for stream in active:
            stream._finish(cut=True)
        self._thread.join(timeout=30.0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "active": len(self._active),
                "free_slots": len(self._free),
                "queued": self._pending.qsize() + len(self._holdback),
                "steps": self._steps,
                "draining": self._draining,
                "max_batch_size": self.max_batch_size,
            }
        get_stats = getattr(self.engine, "stats", None)
        if get_stats is not None:
            es = get_stats()
            for k in ("kv_blocks_total", "kv_blocks_free", "kv_blocks_cached",
                      "preemptions", "prefix_hits", "kv_block_bytes",
                      "kv_pool_bytes", "prefill_chunk_tokens",
                      "prefill_chunks", "chunked_prefills", "prefilling",
                      "prefill_tokens", "prefix_tokens_reused"):
                if k in es:
                    out[k] = es[k]
        return out

    # -------------------------------------------------------------- internals

    def _bounce_pending(self) -> None:
        """Fail queued-but-unadmitted requests with the retryable drain
        error. Preempted holdback streams already emitted tokens through
        THIS replica, so they stay parked for readmission until the drain
        deadline cuts them."""
        keep = []
        with self._lock:
            while self._holdback:
                item = self._holdback.popleft()
                if item[0].preempted:
                    keep.append(item)
                else:
                    item[0]._finish(error=ReplicaDrainingError())
            self._holdback.extend(keep)
        while True:
            try:
                stream = self._pending.get_nowait()
            except queue.Empty:
                return
            stream._finish(error=ReplicaDrainingError())

    def _cut_parked(self) -> None:
        """Terminal: cut preempted streams still parked (drain deadline or
        close — they can never resume here)."""
        with self._lock:
            parked = list(self._holdback)
            self._holdback.clear()
        for stream, _ in parked:
            stream._finish(cut=True)

    def _admissible(self, stream: GenerationStream,
                    request: Dict[str, Any]) -> bool:
        can = getattr(self.engine, "can_admit", None)
        if can is None:
            return True
        # the verdict for the parked head item is stable until a retire /
        # preemption / admission changes the pool
        rid = stream.request_id
        if (not self._admission_dirty
                and self._admission_verdict is not None
                and self._admission_verdict[0] == rid):
            return self._admission_verdict[1]
        try:
            verdict = bool(can(request))
        except Exception:  # noqa: BLE001
            return True  # a broken budget check must not wedge admission
        self._admission_verdict = (rid, verdict)
        self._admission_dirty = False
        return verdict

    def _admit_one(self, stream: GenerationStream,
                   request: Optional[Dict[str, Any]] = None) -> bool:
        """Admit into a free slot; returns False when the request was
        PARKED for lack of KV blocks (the caller must stop gathering this
        round or it would spin on the same head-of-line item)."""
        if request is None:
            request = stream.request
        if stream.cancelled or stream.finished:
            if not stream.finished:
                stream._finish()
            return True
        with self._lock:
            slot = self._free.pop()
            self._active[slot] = stream
        try:
            tok, done = self.engine.admit(slot, request)
        except InsufficientBlocksError:
            # pool can't cover the prompt right now: park for retry —
            # blocks free as running generations retire (a prompt that can
            # NEVER fit raises ValueError instead and fails below)
            with self._lock:
                self._active.pop(slot, None)
                self._free.append(slot)
                self._holdback.appendleft((stream, request))
            return False
        except Exception as e:  # noqa: BLE001 — a bad request must not kill the loop
            stream._finish(error=e)
            self._retire(slot)
            return True
        # a chunked-prefill admission returns no token yet
        if tok is not None:
            stream._push(tok)
        if done:
            stream._finish()
            self._retire(slot)
        return True

    def _retire(self, slot: int) -> None:
        with self._lock:
            self._active.pop(slot, None)
            self._free.append(slot)
            self._admission_dirty = True  # freed blocks: recheck parked head
        release = getattr(self.engine, "release", None)
        if release is not None:
            release(slot)

    def _gather(self, first_timeout: float) -> None:
        """Admit queued work into free slots: holdback (preempted /
        budget-parked, order preserved) first, then the pending queue —
        blocking up to first_timeout for the first pending item, then
        taking whatever else is ready."""
        block = first_timeout
        while self._free and not self._shutdown:
            with self._lock:
                item = self._holdback.popleft() if self._holdback else None
            if item is None:
                try:
                    stream = self._pending.get(timeout=block)
                except queue.Empty:
                    return
                item = (stream, stream.request)
            block = 0.0
            stream, request = item
            if not self._admissible(stream, request):
                with self._lock:
                    busy = bool(self._active)
                    if busy:
                        # head-of-line wait: blocks free as the running
                        # batch retires
                        self._holdback.appendleft(item)
                if busy:
                    return
                # nothing running to free blocks: admit best-effort so the
                # request either squeezes in or fails with the engine's
                # real error instead of parking forever
            if not self._admit_one(stream, request):
                return
            with self._lock:
                self._admission_dirty = True  # pool changed: recheck

    def _absorb_preempted(self) -> None:
        """Park engine-evicted generations (stream stays open) at the head
        of the admission line for recompute-on-readmit."""
        take = getattr(self.engine, "take_preempted", None)
        if take is None:
            return
        for slot, parked in reversed(list(take() or ())):
            with self._lock:
                stream = self._active.pop(slot, None)
                if slot not in self._free:
                    self._free.append(slot)
            if stream is None:
                continue
            if stream.cancelled:
                stream._finish()
                continue
            stream.preempted = True
            with self._lock:
                self._holdback.appendleft((stream, parked))
                self._admission_dirty = True  # blocks freed by the eviction

    def _loop(self) -> None:
        while not self._shutdown:
            if not self._active:
                if self._draining:
                    self._bounce_pending()
                    # preempted generations parked in holdback are
                    # in-flight work: keep readmitting them until done or
                    # the drain deadline cuts them
                    with self._lock:
                        has_parked = bool(self._holdback)
                    if has_parked:
                        self._gather(first_timeout=0.0)
                    if (self._drain_deadline is not None
                            and time.monotonic() >= self._drain_deadline):
                        self._cut_parked()
                    if not self._active:
                        time.sleep(0.01)
                        continue
                # idle: park on the queue; once the first request lands,
                # hold the batch open for the coalescing window so
                # near-simultaneous requests share the first step
                self._gather(first_timeout=0.05)
                if self._active and self.batch_wait_timeout_s > 0:
                    deadline = time.monotonic() + self.batch_wait_timeout_s
                    while self._free and time.monotonic() < deadline:
                        self._gather(
                            first_timeout=max(0.0, deadline - time.monotonic())
                        )
                if not self._active:
                    continue
            else:
                # running batch: admit whatever is queued, no waiting
                self._gather(first_timeout=0.0)

            with self._lock:
                slots = sorted(self._active)
            if not slots:
                continue
            try:
                results = self.engine.step(slots)
            except Exception as e:  # noqa: BLE001 — engine fault fails the batch
                # discard preemptions staged before the fault: their
                # streams are errored with everyone else's below
                take = getattr(self.engine, "take_preempted", None)
                if take is not None:
                    take()
                for slot in slots:
                    stream = self._active.get(slot)
                    if stream is not None:
                        stream._finish(error=e)
                    self._retire(slot)
                continue
            # slots the engine preempted mid-step are absent from results:
            # park their streams (still open) for recompute-on-readmit
            self._absorb_preempted()
            self._steps += 1
            for slot, (tok, done) in results.items():
                stream = self._active.get(slot)
                if stream is None:
                    continue
                if stream.cancelled:
                    stream._finish()
                    self._retire(slot)
                    continue
                # a chunked prefill's step result is a (possibly empty)
                # token list: push each one
                for t in (tok if isinstance(tok, list) else (tok,)):
                    stream._push(t)
                if done:
                    stream._finish()
                    self._retire(slot)
            # drain deadline: cut whatever is still running or parked
            if (self._draining and self._drain_deadline is not None
                    and time.monotonic() >= self._drain_deadline):
                with self._lock:
                    leftover = dict(self._active)
                for slot, stream in leftover.items():
                    stream._finish(cut=True)
                    self._retire(slot)
                self._cut_parked()
