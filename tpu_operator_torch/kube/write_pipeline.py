"""Bounded-concurrency apiserver write pipeline with per-key ordering.

The port's copy of ``tpu_operator/kube/write_pipeline.py``.

The convergence hot path used to be RTT-serialized: one reconcile worker
pushed every write (1000 node label patches, ~30 operand applies, the
kubelet simulator's pod fan-out) one-at-a-time through a single
synchronous connection. The reference operator overlaps independent
writes through client-go's pooled transport and per-object workqueues;
``WritePipeline`` is the same shape for this codebase:

* a thread-pool executor of configurable ``depth`` (default 16,
  ``WRITE_PIPELINE_DEPTH``) runs submitted write callables;
* **per-key serialization**: tasks submitted under the same key (by
  convention ``(kind, namespace, name)``) run strictly in submission
  order — two revisions of the same object can NEVER apply out of
  order, at any depth; tasks under different keys overlap freely;
* ``drain()`` is the flush barrier: it blocks until every outstanding
  task finished and returns (or raises, via ``PipelineError``) the
  errors collected since the last drain;
* error aggregation preserves the fault-tolerance semantics underneath
  (kube/retry.py): retries, Retry-After and the circuit breaker all
  live INSIDE the submitted client call — the pipeline only transports
  the outcome. Exceptions propagate unwrapped through
  ``WriteFuture.result()`` so per-task handlers (conflict recompute,
  vanished-object tolerance) behave exactly as they did inline.

``depth=1`` (or ``WRITE_PIPELINE_DEPTH=1``) is the escape hatch: every
submit executes inline on the caller's thread, byte-for-byte the old
serial behavior — no threads are ever created.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

from tpu_operator_torch.obs import trace

DEFAULT_DEPTH = 16

# installed by controllers/operator_metrics (the on_conflict_retry
# convention): observes each task's queue wait into the
# write_pipeline_queue_wait histogram without kube/ importing upward
on_queue_wait_ms: Optional[Callable[[float], None]] = None


def default_depth() -> int:
    """Resolve the depth at construction time (not import time) so a
    harness can set ``WRITE_PIPELINE_DEPTH`` before building its
    pipelines. 16 suits a real apiserver (network RTT to overlap, a
    multi-core server); an IN-PROCESS kubesim shares the client's GIL,
    where deep fan-out only adds thread-convoy latency (1000 label
    patches against an in-process KubeSim took 1.97 s at depth 1, 2.03 s
    at depth 4 and 1.84 s at depth 16 on the host of an NVIDIA H100 80GB
    HBM3 machine, ``chip_smoke.py`` phase 11), so harnesses over one run
    depth 4."""
    try:
        return int(os.environ.get("WRITE_PIPELINE_DEPTH", DEFAULT_DEPTH))
    except ValueError:
        return DEFAULT_DEPTH


class PipelineError(RuntimeError):
    """Aggregate of task exceptions surfaced by ``drain(raise_errors=True)``.

    Carries the original exceptions in ``errors`` (first one also chained
    as ``__cause__``) so a caller can still dispatch on concrete types."""

    def __init__(self, errors: List[BaseException]):
        self.errors = list(errors)
        super().__init__(
            f"{len(errors)} pipeline write(s) failed: "
            + "; ".join(f"{type(e).__name__}: {e}" for e in errors[:5])
        )
        if errors:
            self.__cause__ = errors[0]


class WriteFuture:
    """Outcome of one submitted write. ``result()`` blocks until the
    task ran and returns its value or re-raises its exception — the
    exact exception the client call raised, unwrapped."""

    __slots__ = ("key", "_done", "_value", "_error")

    def __init__(self, key: Hashable):
        self.key = key
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def _finish(self, value: Any, error: Optional[BaseException]) -> None:
        self._value = value
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"pipeline write {self.key!r} still pending")
        if self._error is not None:
            raise self._error
        return self._value


def _shutdown_executor(executor: ThreadPoolExecutor) -> None:
    executor.shutdown(wait=False)


# task tuple: (future, fn, args, kwargs, submit_monotonic)
_Task = Tuple[WriteFuture, Callable[..., Any], tuple, dict, float]


class WritePipeline:
    """Thread-safe; one instance per writer (the ClusterPolicyController
    owns one for the reconcile pass; the kubelet simulator builds its
    own). The executor is created lazily on the first parallel submit
    and reaped when the pipeline is garbage-collected, so unit tests
    that never fan out never spawn a thread."""

    def __init__(self, depth: Optional[int] = None, name: str = "write-pipeline"):
        self.depth = max(1, int(depth if depth is not None else default_depth()))
        self.name = name
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._executor: Optional[ThreadPoolExecutor] = None
        # key -> queued tasks behind the one currently running for that
        # key; key PRESENCE means a worker owns the key (per-key
        # serialization: the owner drains its deque in FIFO order)
        self._chains: Dict[Hashable, Deque[_Task]] = {}
        self._outstanding = 0
        # errors since the last drain() (bounded; full detail stays on
        # the individual futures)
        self._errors: List[BaseException] = []
        # observability counters (exported via stats())
        self.submitted_total = 0
        self.completed_total = 0
        self.errors_total = 0
        self.inline_total = 0
        self.queue_wait_s_total = 0.0
        self.busy_s_total = 0.0
        self.inflight = 0
        self.inflight_peak = 0

    # ------------------------------------------------------------------
    def _ensure_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self.depth, thread_name_prefix=self.name
            )
            # reap the worker threads when the owning controller goes
            # away (test fixtures create many controllers per process)
            weakref.finalize(self, _shutdown_executor, self._executor)
        return self._executor

    def submit(
        self, key: Hashable, fn: Callable[..., Any], *args: Any, **kwargs: Any
    ) -> WriteFuture:
        """Queue ``fn(*args, **kwargs)`` under ``key``. Same-key tasks
        run in submission order on one worker at a time; different keys
        overlap up to ``depth``. With ``depth=1`` the call runs inline
        immediately (serial escape hatch)."""
        fut = WriteFuture(key)
        if self.depth == 1:
            with self._lock:
                self.submitted_total += 1
                self.inline_total += 1
            self._run_one(fut, fn, args, kwargs, time.monotonic())
            return fut
        task: _Task = (fut, fn, args, kwargs, time.monotonic())
        with self._lock:
            self.submitted_total += 1
            self._outstanding += 1
            chain = self._chains.get(key)
            if chain is not None:
                chain.append(task)  # key busy: strictly ordered behind it
                return fut
            self._chains[key] = deque()
            executor = self._ensure_executor()
        executor.submit(self._work_key, key, task)
        return fut

    def _run_one(
        self, fut: WriteFuture, fn, args, kwargs, submitted: float
    ) -> None:
        t0 = time.monotonic()
        wait_s = max(0.0, t0 - submitted)
        observe = on_queue_wait_ms
        if observe is not None:
            try:
                observe(wait_s * 1000.0)
            except Exception:
                pass
        value, error = None, None
        with trace.span(
            "write.execute",
            key=str(fut.key),
            queue_wait_ms=round(wait_s * 1000.0, 3),
        ) as sp:
            try:
                value = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - transported, not handled
                error = e
                sp.set("error", type(e).__name__)
        elapsed = time.monotonic() - t0
        with self._lock:
            self.queue_wait_s_total += wait_s
            self.busy_s_total += elapsed
            self.completed_total += 1
            if error is not None:
                self.errors_total += 1
                if len(self._errors) < 256:
                    self._errors.append(error)
        fut._finish(value, error)

    def _work_key(self, key: Hashable, task: _Task) -> None:
        """Per-key worker: runs the task it was dispatched with, then
        drains everything queued behind the key in FIFO order. The key's
        chain entry exists for exactly the worker's lifetime — that
        invariant IS the ordering guarantee."""
        while True:
            fut, fn, args, kwargs, submitted = task
            with self._lock:
                self.inflight += 1
                self.inflight_peak = max(self.inflight_peak, self.inflight)
            try:
                self._run_one(fut, fn, args, kwargs, submitted)
            finally:
                with self._idle:
                    self.inflight -= 1
                    self._outstanding -= 1
                    chain = self._chains[key]
                    if chain:
                        task = chain.popleft()
                        next_task = True
                    else:
                        del self._chains[key]
                        next_task = False
                    if self._outstanding == 0:
                        self._idle.notify_all()
            if not next_task:
                return

    # ------------------------------------------------------------------
    def drain(
        self, timeout: Optional[float] = None, raise_errors: bool = False
    ) -> List[BaseException]:
        """Flush barrier: block until no task is queued or running, then
        return (and clear) the errors collected since the last drain.
        With ``raise_errors`` a non-empty error set raises
        ``PipelineError`` instead. Individual futures keep their own
        error regardless, so per-task handling and drain-level
        aggregation compose."""
        with self._idle:
            deadline = (
                time.monotonic() + timeout if timeout is not None else None
            )
            while self._outstanding:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"pipeline drain timed out with "
                            f"{self._outstanding} task(s) outstanding"
                        )
                self._idle.wait(remaining)
            errors, self._errors = self._errors, []
        if raise_errors and errors:
            raise PipelineError(errors)
        return errors

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Observability payload for /debug/vars and the metrics gauges:
        configured depth, live in-flight count, totals, and the average
        queue wait a task saw before a worker picked it up."""
        with self._lock:
            completed = self.completed_total
            return {
                "depth": self.depth,
                "inflight": self.inflight,
                "inflight_peak": self.inflight_peak,
                "outstanding": self._outstanding,
                "submitted_total": self.submitted_total,
                "completed_total": completed,
                "errors_total": self.errors_total,
                "inline_total": self.inline_total,
                "queue_wait_ms_avg": (
                    round(self.queue_wait_s_total * 1000.0 / completed, 3)
                    if completed
                    else 0.0
                ),
                "busy_s_total": round(self.busy_s_total, 6),
            }

    def utilization(self, wall_s: float) -> float:
        """Fraction of ``depth × wall_s`` worker capacity spent running
        tasks — the headline the fleet bench prints next to the render
        cache hit rate."""
        if wall_s <= 0:
            return 0.0
        with self._lock:
            return round(
                min(1.0, self.busy_s_total / (self.depth * wall_s)), 4
            )


# ---------------------------------------------------------------------------
# batch lane
# ---------------------------------------------------------------------------

DEFAULT_BATCH_MAX = 64


def default_batch_max() -> int:
    """Max objects per batched submission (``APPLY_BATCH_MAX``). 64
    keeps a 1000-node label fan-out at ~16 wire requests while one
    batch's service time stays small enough not to starve the lane's
    FIFO (a batch is one pipeline task; sibling lanes still overlap)."""
    try:
        return int(os.environ.get("APPLY_BATCH_MAX", DEFAULT_BATCH_MAX))
    except ValueError:
        return DEFAULT_BATCH_MAX


class BatchLane:
    """Group-commit batching over pipeline keys.

    Callers ``submit(item_key, payload)`` individual writes; the lane
    aggregates whatever queued while the previous batch was in flight
    into ONE ``flush_fn(payloads) -> [(value, error)]`` submission (the
    multi-object APPLY), resolving each item's ``WriteFuture`` from the
    per-item fan-back. Natural batching with zero added latency: an
    idle lane flushes a batch of one immediately; under load the queue
    fills while a batch runs and the next flush carries it all.

    At most ONE runner task per shard is ever scheduled on the
    pipeline; it drains batch after batch and reschedules itself only
    while items remain. (The naive one-task-per-submit shape paid the
    pipeline's per-task dispatch cost N times for N items, which at a
    fleet's pod fan-out outweighs the writes themselves.)

    ``shards`` (default 1) splits the lane into independent pipeline
    keys for overlap; an item's shard is chosen by a stable hash of its
    ``item_key``, so sharding cannot reorder two revisions of one key.

    Ordering guarantees, at ANY pipeline depth and shard count:

    * batches holding one ``item_key`` always run on the same shard, in
      strict FIFO — and a batch never contains two items with the same
      ``item_key`` (the cut rule below) — so two revisions of one
      (kind, ns, name) can NEVER apply out of order;
    * one failed item fails only its own future — the original
      exception, naming the object — and bumps the lane's
      ``items_failed_total``; siblings land, and the pipeline's
      drain-level aggregate stays clean (per-item churn like a
      vanished-node 404 is the submitter's to judge, not a pipeline
      failure).

    A batch is cut at ``max_batch`` items or at the first duplicate
    ``item_key`` — the duplicate waits for the next batch."""

    def __init__(
        self,
        pipeline: WritePipeline,
        flush_fn: Callable[[List[Any]], List[Tuple[Any, Optional[BaseException]]]],
        name: str = "batch",
        max_batch: Optional[int] = None,
        shards: int = 1,
    ):
        self.pipeline = pipeline
        self.flush_fn = flush_fn
        self.name = name
        self.max_batch = max(1, int(max_batch if max_batch is not None else default_batch_max()))
        self.shards = max(1, int(shards))
        self._lock = threading.Lock()
        self._queues: List[Deque[Tuple[Hashable, Any, WriteFuture]]] = [
            deque() for _ in range(self.shards)
        ]
        # shard -> a runner task is scheduled or running (guarded by
        # _lock); the submit/reschedule handoff below means queued items
        # ALWAYS have a runner coming — no lost wakeups
        self._scheduled = [False] * self.shards
        self.items_total = 0
        self.items_failed_total = 0
        self.batches_total = 0
        self.max_fill = 0

    def _shard_of(self, item_key: Hashable) -> int:
        # hash() is stable within one process, which is the lane's
        # lifetime; a given key always lands on one shard
        return hash(item_key) % self.shards if self.shards > 1 else 0

    def submit(self, item_key: Hashable, payload: Any) -> WriteFuture:
        fut = WriteFuture(item_key)
        shard = self._shard_of(item_key)
        with self._lock:
            self._queues[shard].append((item_key, payload, fut))
            self.items_total += 1
            need_runner = not self._scheduled[shard]
            self._scheduled[shard] = True
        if need_runner:
            self.pipeline.submit(
                ("batch-lane", self.name, shard), self._run_batch, shard
            )
        return fut

    def _cut_batch(self, shard: int) -> List[Tuple[Hashable, Any, WriteFuture]]:
        batch: List[Tuple[Hashable, Any, WriteFuture]] = []
        seen = set()
        with self._lock:
            queue = self._queues[shard]
            while queue and len(batch) < self.max_batch:
                item_key = queue[0][0]
                if item_key in seen:
                    break  # second revision of a key: next batch
                seen.add(item_key)
                batch.append(queue.popleft())
            if batch:
                self.batches_total += 1
                self.max_fill = max(self.max_fill, len(batch))
            else:
                # nothing left: the runner retires; the NEXT submit
                # schedules a fresh one (same lock as submit, so an
                # enqueue can't slip between the check and the clear)
                self._scheduled[shard] = False
        return batch

    def _reschedule(self, shard: int) -> None:
        """Hand the drain to a fresh runner task (the raise path only:
        a failed batch must surface through the pipeline's error
        aggregate, which means returning from this task — but it must
        never strand queued items behind a cleared-nowhere flag)."""
        with self._lock:
            if not self._queues[shard]:
                self._scheduled[shard] = False
                return
        self.pipeline.submit(
            ("batch-lane", self.name, shard), self._run_batch, shard
        )

    def _run_batch(self, shard: int = 0) -> None:
        """One runner drains its shard batch-after-batch IN PLACE —
        looping, not rescheduling: a continuation task per batch would
        go to the back of the pipeline queue and pay a worker-wakeup
        round-trip of latency per batch, serially (the dominant cost of
        a fleet's pod fan-out under GIL contention)."""
        while True:
            batch = self._cut_batch(shard)
            if not batch:
                return  # queue empty; flag cleared under the cut lock
            try:
                with trace.span(
                    "apply.batch_flush", lane=self.name, fill=len(batch)
                ):
                    results = self.flush_fn(
                        [payload for _, payload, _ in batch]
                    )
            except BaseException as e:  # noqa: BLE001 - fanned back per item
                for _, _, fut in batch:
                    fut._finish(None, e)
                self._reschedule(shard)
                raise  # the pipeline's error aggregate records the batch
            failed = 0
            for i, (_, _, fut) in enumerate(batch):
                if i < len(results):
                    value, error = results[i]
                    fut._finish(value, error)
                    if error is not None:
                        failed += 1
                else:
                    fut._finish(
                        None,
                        RuntimeError("batch flush returned too few results"),
                    )
                    failed += 1
            if failed:
                # per-item outcomes belong to their FUTURES, where the
                # caller decides: a 404 on a vanished node or the
                # designed pause-override 409 is normal churn the
                # submitter recovers in-line, and re-raising it here
                # would inflate write_pipeline_errors (and fail drain)
                # with phantom failures on every churny pass. The lane
                # keeps its own ledger instead; every call site resolves
                # every future, so nothing goes silent.
                with self._lock:
                    self.items_failed_total += failed

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "max_batch": self.max_batch,
                "shards": self.shards,
                "queued": sum(len(q) for q in self._queues),
                "items_total": self.items_total,
                "items_failed_total": self.items_failed_total,
                "batches_total": self.batches_total,
                "max_fill": self.max_fill,
                "fill_avg": (
                    round(self.items_total / self.batches_total, 2)
                    if self.batches_total
                    else 0.0
                ),
            }
