"""A run's world: one process a card, joined by ``torch.distributed``, from
set-up to the run's end.

A cell whose ``chips`` is n > 1 runs on n ranks. The harness's own process
is rank 0, on ``cuda:0``; one helper process a further card is rank r, on
``cuda:r`` (on the CPU, n gloo ranks, as the tests run them). The helpers
start with ``spawn`` and every rank meets the others through a ``file://``
rendezvous in the run's temporary directory. Each rank is set up as the
program sets up a rank of ``mesh.spawn_world`` (the device set, TF32 off,
``device_id`` given, a first barrier), so that the program's rank functions
run on it as they run there, given the run's ``rank``. Its start-up is
set-up time (``setup_parts["world"]``).

The harness drives the helpers over host pipes, never over the process
group. Each command goes to every helper while rank 0 does its own part,
and each helper answers it:

* ``prepare``: load and prepare the mix's components;
* ``call i``: component ``i``'s call (one pass runs each in turn on every
  rank, so that their collectives meet); the helper answers once its card
  has synchronised, with the verdict and the payload's numbers;
* ``check i``: component ``i``'s comparison and its entry held;
* ``trace_start``, ``trace_stop``: the helper's own profiler over the
  window; it answers the stop with its ``devtrace.Reduced`` trace;
* ``peak``: its card's allocator peak;
* ``stop``: leave the group, and answer with the forbidden modules loaded.

``begin`` and ``end`` mark a pass on the helpers and get no answer.

A helper that raises, dies, or does not answer within ``ANSWER_S`` fails
the run with ``WorldError``: each failing rank's number and traceback, the
first to fail first. Its traceback is also printed on standard error the
moment it arrives. A collective that a failed rank will never join holds the
others: gloo's ranks raise after ``ANSWER_S`` (the process group's timeout),
but on the card rank 0 can be held by its own part for good. There, once a
helper has failed for ``ESCAPE_S``, or a command's ``ANSWER_S`` has run out,
while rank 0 is still held, the world kills the helpers and ends this
process with exit code 5 and no result. ``stop`` sends ``stop``, gives the
helpers ``JOIN_S`` to end (a failed world ``FAILURE_GRACE_S``), and kills
what is left; a helper whose parent has gone ends itself.
"""

from __future__ import annotations

import datetime
import os
import queue
import sys
import threading
import time
import traceback
from contextlib import ExitStack
from multiprocessing import connection
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from benchmark import devtrace, harness
from tpu_operator_torch.workloads.mesh import Rank

# seconds a helper may take to start: import, CUDA context, kernel library
START_S = 180
# seconds a rank may take to answer a command, and to finish a collective
ANSWER_S = 120
# seconds the others may still answer once a rank has failed
FAILURE_GRACE_S = 2.0
# seconds rank 0 may stay held on the card once a helper has failed
ESCAPE_S = 10.0
# the exit code of a run that a held rank 0 ends (as run.py's for WorldError)
ESCAPE_CODE = 5
# seconds the helpers are given to end after ``stop``, before they are killed
JOIN_S = 10.0


class World:
    """Rank 0's end of the world: the helpers, their pipes, and what this
    process changed to be a rank."""

    def __init__(self, size: int, device: torch.device):
        self.size = size
        self.device = device
        self.answer_s = ANSWER_S
        self.procs, self.conns = [], []
        self.replies = queue.Queue()  # (rank, monotonic time, "ok" | "error" | "died", value)
        self.reader = threading.Thread(target=self._read, name="world-reader", daemon=True)
        self.closing = False
        self.held_until = None  # while rank 0 does its part: the command's deadline
        self.stopping = False  # from ``stop`` on, a helper's end is no failure
        self.broken = False
        self.closed = False
        self.joined = False
        self.saved = (torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)

    @classmethod
    def start(cls, bench, run, status_dir: str) -> "World":
        """Start the helpers, join the world as rank 0 and set ``run.rank``."""
        n = run.cell["chips"]
        if run.device.type == "cuda":
            run.device = torch.device("cuda", 0)
        world = cls(n, run.device)
        where = Path(status_dir) / "world"
        where.mkdir()
        init = "file://" + str(where / "rendezvous")
        ctx = mp.get_context("spawn")
        try:
            for r in range(1, n):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(
                    target=_helper, name=f"bench-rank-{r}", daemon=True,
                    args=(theirs, r, n, run.device.type, init, str(bench.root), run.cell["name"],
                          str(where / f"rank{r}"), run.annotate, world.answer_s, os.getpid()))
                proc.start()
                theirs.close()
                world.procs.append(proc)
                world.conns.append(mine)
            world.reader.start()
            world.command(None, seconds=START_S)  # each helper's card is open
            world.joined = True
            world.command(None, lambda: _join(0, n, run.device, init, world.answer_s))
            run.rank = Rank(0, n, run.device)
        except BaseException:
            world.broken = True  # no helper is asked to answer again
            world.stop()
            raise
        return world

    def post(self, message) -> None:
        """``message`` to every helper, with no answer to wait for."""
        for r in range(1, len(self.conns) + 1):
            self._send(r, message)

    def command(self, message, local=None, seconds: float = None) -> list:
        """``message`` to every helper (none where it is ``None``), and
        ``local()`` in this process, as rank 0, meanwhile; each rank's
        answer, by rank (rank 0's is what ``local`` returned). Raises
        ``WorldError`` where a rank raised, died or had not answered within
        ``seconds`` (``ANSWER_S``)."""
        if self.broken or self.closed:
            raise harness.WorldError("the world has already failed or stopped")
        what = "start" if message is None else " ".join(map(str, message))
        sent = time.monotonic()
        failures = {}
        if message is not None:
            for r in range(1, self.size):
                if not self._send(r, message):
                    failures[r] = (time.monotonic(), f"died before {what!r} ({self._exit(r)})")
        seconds = seconds or self.answer_s
        mine = None
        if local is not None:
            self.held_until = sent + seconds
            try:
                mine = local()
            except Exception:
                failures[0] = (time.monotonic(), "failed:\n" + traceback.format_exc())
            finally:
                self.held_until = None
        answers = self._gather(what, sent, failures, seconds)
        return [mine] + [answers[r] for r in range(1, self.size)]

    def one_pass(self, run, record: bool) -> None:
        """``harness.one_pass`` on every rank: each component called on
        every rank at once; a pass that any rank's verdict or
        ``ValidationError`` fails ends there, on every rank."""
        self.post(("begin",))
        try:
            for i, (name, _, _) in enumerate(run.components):
                with run.span(name):
                    answers = self.command(("call", i, record), lambda: _call(run, i, record))
                if record:
                    for _, numbers in answers:
                        harness.keep_largest(run.numbers, numbers)
                whys = [f"rank {r}: {why}" for r, (why, _) in enumerate(answers) if why is not None]
                if whys:
                    if record:
                        run.failed += 1
                        run.failures.append(f"{name}: {'; '.join(whys)}")
                    return
        finally:
            if not self.broken:
                self.post(("end",))

    def check_component(self, run, i: int, seed: int, control: bool) -> dict:
        """``harness.check_component`` on every rank; each number the
        largest over the ranks that gave it."""
        name, module, w = run.components[i]
        answers = self.command(("check", i, seed, control),
                               lambda: harness.check_component(run, name, module, w, seed, control))
        found = {}
        for numbers in answers:
            for key, value in numbers.items():
                if found.get(key) is None:
                    found[key] = value
                elif value is not None:
                    found[key] = max(value, found[key])
        return found

    def stop(self) -> dict:
        """Stop the world: ``stop`` to every helper, this process out of the
        group, ``JOIN_S`` for the helpers to end (``FAILURE_GRACE_S`` once
        the world has failed), then a kill. Returns the forbidden modules
        each helper had loaded, by rank; raises ``WorldError`` where a
        helper did not stop cleanly. Does nothing once stopped."""
        if self.closed:
            return {}
        try:
            if self.broken:
                self.post(("stop",))
                return {}
            self.stopping = True
            answers = self.command(("stop",), self._leave)
            return {r: mods for r, mods in enumerate(answers) if r and mods}
        finally:
            self._close(FAILURE_GRACE_S if self.broken else JOIN_S)

    def _send(self, rank: int, message) -> bool:
        try:
            self.conns[rank - 1].send(message)
            return True
        except (OSError, ValueError):  # its end is gone
            return False

    def _exit(self, rank: int) -> str:
        proc = self.procs[rank - 1]
        proc.join(1.0)
        return f"exit code {proc.exitcode}"

    def _read(self) -> None:
        """The helpers' answers into ``replies``, as they come; a failure on
        standard error at once, in case this process is held by a
        collective that will not end (``_escape``)."""
        rank_of = {conn: r for r, conn in enumerate(self.conns, start=1)}
        failed_at, erred = None, set()
        while rank_of and not self.closing:
            for conn in connection.wait(list(rank_of), timeout=0.2):
                r = rank_of[conn]
                try:
                    kind, value = conn.recv()
                except (EOFError, OSError):
                    del rank_of[conn]
                    kind, value = "died", None
                if kind == "error" or (kind == "died" and r not in erred and not self.stopping):
                    erred.add(r)
                    failed_at = failed_at or time.monotonic()
                    print(f"world: rank {r} of {self.size} " + (
                        f"failed:\n{value}" if kind == "error" else "died"), file=sys.stderr,
                        flush=True)
                self.replies.put((r, time.monotonic(), kind, value))
            held, now = self.held_until, time.monotonic()
            if self.device.type == "cuda" and held is not None and (
                    now > held or (failed_at is not None and now > failed_at + ESCAPE_S)):
                self._escape()

    def _escape(self) -> None:
        """End the run from another thread: rank 0 is held by a collective
        that a failed or silent rank will not join."""
        print(f"world: rank 0 of {self.size} is held by the world's collectives after a rank "
              f"failed or did not answer; every rank is ended", file=sys.stderr, flush=True)
        for proc in self.procs:
            proc.kill()
        for proc in self.procs:
            proc.join(JOIN_S)
        os._exit(ESCAPE_CODE)

    def _gather(self, what: str, sent: float, failures: dict, seconds: float) -> dict:
        """Each helper's answer to ``what``, by rank. Once a rank has failed
        the others have ``FAILURE_GRACE_S`` more; a rank silent at the end
        failed when its time ran out. Raises ``WorldError`` with every
        failure, the earliest first."""
        answers = {}
        waiting = set(range(1, self.size)) - set(failures)
        deadline = sent + seconds
        while waiting:
            limit = deadline
            if failures:  # the grace, cut to the deadline unless that had passed
                first = min(t for t, _ in failures.values())
                limit = first + FAILURE_GRACE_S
                if first <= deadline:
                    limit = min(deadline, limit)
            try:
                r, t, kind, value = self.replies.get(timeout=max(0.0, limit - time.monotonic()))
            except queue.Empty:
                break
            if r not in waiting:
                continue
            waiting.discard(r)
            if kind == "ok":
                answers[r] = value
            elif kind == "error":
                failures[r] = (t, f"failed:\n{value}")
            else:
                failures[r] = (t, f"died ({self._exit(r)}) with no answer to {what!r}")
        for r in waiting:
            failures[r] = (min(deadline, limit),
                           f"no answer to {what!r} within {min(deadline, limit) - sent:.1f} s")
        if failures:
            self.broken = True
            order = sorted(failures, key=lambda r: (failures[r][0], r))
            lines = [f"world of {self.size} on {self.device.type}: rank {order[0]} failed first"]
            lines += [f"rank {r} of {self.size} {failures[r][1]}" for r in order]
            raise harness.WorldError("\n".join(lines))
        return answers

    def _leave(self) -> None:
        """This process out of the world's process group. On the card a
        group that still waits for a failed rank may not let go: after
        ``JOIN_S`` the process ends (``_escape``)."""
        if self.joined and dist.is_initialized():
            self.joined = False
            timer = threading.Timer(JOIN_S, self._escape) if self.device.type == "cuda" else None
            if timer:
                timer.daemon = True
                timer.start()
            try:
                dist.destroy_process_group()
            finally:
                if timer:
                    timer.cancel()

    def _close(self, grace: float) -> None:
        """End every helper (a kill after ``grace`` seconds), leave the
        group, and give this process back the settings it had."""
        self.closed = True
        self.closing = True
        deadline = time.monotonic() + grace
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
            proc.join(JOIN_S)
        if self.reader.is_alive():
            self.reader.join()
        for conn in self.conns:
            conn.close()
        self._leave()
        threads, matmul_tf32, cudnn_tf32 = self.saved
        torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _join(rank: int, size: int, device: torch.device, init: str, answer_s: float) -> None:
    """Join the world as ``mesh._rank_main`` joins a program rank. A
    collective times out after ``answer_s`` on gloo, so that a held rank
    raises; NCCL's watchdog is given a minute more, so that on the card the
    world's own escape comes first and names the rank at fault."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # the probes' f32 products are the reference's full-precision dots
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))  # ranks share the cores
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=answer_s + (60 if device.type == "cuda" else 0)),
        device_id=device if device.type == "cuda" else None)
    dist.barrier()  # every rank in: NCCL wants all ranks in a group's first call


def _call(run, i: int, record: bool) -> tuple:
    """Component ``i`` called on this rank: ``(why, numbers)``."""
    _, module, w = run.components[i]
    payload, why = harness.call_component(run, module, w)
    return why, harness.payload_numbers(run, module, w, payload) if record else {}


def _watch_parent(pid: int) -> None:
    """End this process once its parent has gone, wherever it is held."""
    def watch():
        while os.getppid() == pid:
            time.sleep(1.0)
        os._exit(70)

    threading.Thread(target=watch, name="world-parent", daemon=True).start()


def _helper(conn, rank, size, device_type, init, root, cell_name, status_dir, annotate,
            answer_s, parent) -> None:
    """A helper rank's process: open its card, join the world, then answer
    rank 0's commands until ``stop``; on any error, send its traceback and
    leave."""
    _watch_parent(parent)
    joined = False
    try:
        device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        bench = harness.Bench(Path(root))
        run = harness.new_run(bench, cell_name, device, status_dir, annotate)
        harness.open_device(run, time.perf_counter())
        conn.send(("ok", None))
        _join(rank, size, device, init, answer_s)
        joined = True
        run.rank = Rank(rank, size, device)
        conn.send(("ok", None))
        _serve(conn, bench, run)
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise SystemExit(1) from None
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def _serve(conn, bench, run) -> None:
    """Answer rank 0's commands until ``stop``."""
    passes = ExitStack()
    profiler = None
    while True:
        command, *args = conn.recv()
        if command == "begin":
            passes.enter_context(run.span(harness.PASS_SPAN))
            continue
        if command == "end":
            passes.close()
            continue
        if command == "prepare":
            out = harness.prepare_components(bench, run)
        elif command == "call":
            i, record = args
            with run.span(run.components[i][0]):
                out = _call(run, i, record)
                harness._sync(run)  # the answer says this card is done
        elif command == "check":
            i, seed, control = args
            name, module, w = run.components[i]
            out = harness.check_component(run, name, module, w, seed, control)
        elif command == "trace_start":
            profiler = devtrace.DeviceTrace(run.device)
            out = profiler.start()
        elif command == "trace_stop":
            names = [harness.PASS_SPAN] + [c[0] for c in run.components]
            out = profiler.stop(harness.PASS_SPAN, names).reduce()
            profiler = None
        elif command == "peak":
            out = harness.memory_peak_bytes(run.device)
        elif command == "stop":
            if dist.is_initialized():
                dist.destroy_process_group()
            conn.send(("ok", harness.forbidden_modules()))
            return
        else:
            raise ValueError(f"no command {command!r}")
        conn.send(("ok", out))
