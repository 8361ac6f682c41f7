"""Cluster log plane: captured process output, task attribution, and
the GCS-side log store.

Port of ``ray_tpu/runtime/log_plane.py``: the same line stamps, epoch
headers, offset segments, parsers and store, so a capture file or a
``push_logs`` frame of either package reads the same. A line's trace id
comes from its task context alone (the tracing plane is not ported).

Reference analog: the per-worker log files under the session dir plus
``log_monitor.py`` tailing them into GCS pubsub and the dashboard, with
the driver echoing ``(actor pid=...)``-prefixed lines. Four cooperating
pieces live here; the transport glue lives in the runtime modules:

- **Capture** — :func:`install_capture` replaces ``sys.stdout``/
  ``sys.stderr`` with a line-buffered tee: every complete line is
  stamped ``(proc, pid, ts)`` plus the ambient task context and
  appended to a rotating ``<proc>.log`` under the node's log dir
  (bounds: ``RAY_TPU_LOG_MAX_BYTES`` / ``RAY_TPU_LOG_ROTATE_COUNT``).
  The raw Popen fd redirect to ``<proc>.out/.err`` stays in place
  underneath — interpreter-level crashes bypass Python streams, and
  their last words must land somewhere the monitor can find.
- **Attribution** — :func:`task_context` brackets each task/actor-method
  execution with begin/end byte offsets, producing a bounded
  ``task_id -> (file, start, end)`` segment registry published as an
  annex (``logs/segments/<proc>``, ``runtime/annex.py``) riding the
  process's MetricsPusher frames; ``get_log(task_id=...)`` resolves
  through it and serves exactly that segment.
- **Store** — :class:`LogStore` on the GCS keeps a bounded per-process
  ring plus a global error ring with deduplicated error GROUPS
  (signature-normalized, counts + first/last seen + linked trace ids).
  Ingest dedups by (file, offset) watermark so chaos-duplicated
  ``push_logs`` frames are idempotent.
- **Echo** — accepted lines fan out on CH_LOGS; the driver filters to
  its own job and prints ``(fn pid=N, node=M)``-prefixed lines under a
  per-source rate limit (``runtime/driver.py``).

Design invariant — STRICTLY BEST-EFFORT, same as the metrics plane:
capture is a few hundred nanoseconds of stamping on the emitting
process; all network IO happens on the raylet's monitor loop whose
pending queue is bounded (oldest entries dropped). A dropped, delayed,
duplicated, or partitioned log batch costs observability fidelity,
never throughput.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import sys
import threading
import time
from collections import OrderedDict, deque

# annex key prefix for the task -> log-offset segment registry
ANNEX_PREFIX = "logs/segments/"

# file line format (one header, tab, then the user text):
#   <ts> <o|e> <trace|-> <task|-> <name|-> <job|->\t<text>\n
# fields are single tokens (whitespace in name/job is folded) so the
# monitor parses with two splits and no regex on the hot path.
_HDR_FIELDS = 6


def _cfg_attr(name: str, default):
    """Config flag with an import-cycle-safe fallback."""
    try:
        from ray_tpu_torch.utils.config import get_config

        return getattr(get_config(), name, default)
    except Exception:  # pragma: no cover - early-import fallback
        return default


# ambient task context: (task_id, name, job, trace_id) of the currently
# executing task/actor method — stamped onto every captured line
_task_ctx: contextvars.ContextVar[tuple | None] = \
    contextvars.ContextVar("ray_tpu_torch_log_task", default=None)


def current_task_id() -> str | None:
    """Task id of the currently executing task/actor method (the log
    plane brackets every execution; ``runtime_context`` surfaces this)."""
    ctx = _task_ctx.get()
    return ctx[0] if ctx else None


def _tok(value) -> str:
    """One whitespace-free header token ('-' encodes None/empty)."""
    if not value:
        return "-"
    return "_".join(str(value).split()) or "-"


def _untok(token: str) -> str | None:
    return None if token == "-" else token


class _TeeStream:
    """File-like stand-in for sys.stdout/sys.stderr: complete lines go
    to the capture (stamped, rotated); everything else degrades to the
    original stream's behavior (fileno() still points at the Popen
    capture file, so C-level writes keep landing in <proc>.out/.err)."""

    def __init__(self, capture: "LogCapture", stream: str, orig):
        self._cap = capture
        self._stream = stream           # "o" | "e"
        self._orig = orig
        self._buf = ""
        self._lock = threading.Lock()

    def write(self, text) -> int:
        if not isinstance(text, str):
            text = str(text)
        with self._lock:
            self._buf += text
            if "\n" in self._buf:
                lines = self._buf.split("\n")
                self._buf = lines[-1]
                for line in lines[:-1]:
                    self._cap.emit(self._stream, line)
        return len(text)

    def writelines(self, lines):
        for line in lines:
            self.write(line)

    def flush(self):
        # line-buffered by design: a partial line flushes when its
        # newline arrives (or at close); emit() already hits the disk
        pass

    def close_partial(self):
        with self._lock:
            tail, self._buf = self._buf, ""
        if tail:
            self._cap.emit(self._stream, tail)

    def isatty(self) -> bool:
        return False

    def writable(self) -> bool:
        return True

    def fileno(self) -> int:
        return self._orig.fileno()

    @property
    def encoding(self):
        return getattr(self._orig, "encoding", "utf-8")

    @property
    def errors(self):
        return getattr(self._orig, "errors", "replace")

    @property
    def buffer(self):
        return getattr(self._orig, "buffer", self._orig)


class LogCapture:
    """Rotating, stamped capture file for one process.

    ``emit`` is the hot path: one time.time(), one contextvar read,
    one %-format, one os.write."""

    def __init__(self, proc: str, log_dir: str, *,
                 max_bytes: int | None = None,
                 rotate_count: int | None = None,
                 tail_lines: int | None = None):
        self.proc = proc
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{proc}.log")
        self.max_bytes = int(max_bytes if max_bytes is not None
                             else _cfg_attr("log_max_bytes", 16 << 20))
        self.rotate_count = int(rotate_count if rotate_count is not None
                                else _cfg_attr("log_rotate_count", 3))
        tail_n = int(tail_lines if tail_lines is not None
                     else _cfg_attr("log_tail_lines", 50))
        self._lock = threading.Lock()
        self.epoch = 0
        self._fd: int | None = None
        self._size = 0
        self._pid = os.getpid()     # capture is created post-fork
        self._file_token = ""       # cached; refreshed on (re)open
        self._open_locked(first=True)
        # recent parsed records for the flight recorder / stuck-call
        # tails (bounded; slightly larger than the dump tail so a
        # task-filtered query still finds its lines)
        self._tail: deque = deque(maxlen=max(tail_n, 256))
        self._tail_n = tail_n
        # shippable records for SELF-ingesting processes (the external
        # GCS has no monitor tailing its files; _metrics_self_loop
        # drains this instead) — bounded, oldest dropped
        self._drain: deque = deque(maxlen=4096)
        # task -> (file, start, end) offset segments, published as a
        # metric annex after every bracketed execution
        self._segments: deque = deque(
            maxlen=max(1, int(_cfg_attr("log_segments_max", 128))))
        self.lines = 0
        self.dropped = 0

    # -- file management -----------------------------------------------

    def _open_locked(self, first: bool = False):
        if not first:
            self.epoch += 1
        self._file_token = f"{os.path.basename(self.path)}@{self.epoch}"
        flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
        self._fd = os.open(self.path, flags, 0o644)
        try:
            self._size = os.fstat(self._fd).st_size
        except OSError:  # pragma: no cover - fs race
            self._size = 0
        if self._size == 0:
            # epoch header: the monitor and the offset annex must agree
            # on which GENERATION an offset belongs to, so the live file
            # declares its own epoch instead of both sides counting
            # rotations independently
            hdr = f"#epoch {self.epoch}\n".encode()
            try:
                os.write(self._fd, hdr)
                self._size = len(hdr)
            except OSError:  # pragma: no cover - disk full
                pass

    def _rotate_locked(self):
        try:
            os.close(self._fd)
        except OSError:  # pragma: no cover
            pass
        if self.rotate_count <= 0:
            try:
                os.unlink(self.path)
            except OSError:  # pragma: no cover
                pass
        else:
            for i in range(self.rotate_count - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    try:
                        os.replace(src, f"{self.path}.{i + 1}")
                    except OSError:  # pragma: no cover
                        pass
            try:
                os.replace(self.path, f"{self.path}.1")
            except OSError:  # pragma: no cover
                pass
        self._open_locked()

    def file_token(self) -> str:
        """``<basename>@<epoch>`` — the identity offsets are scoped to
        (dedup watermarks and task segments both key on it)."""
        return self._file_token

    def offset(self) -> int:
        with self._lock:
            return self._size

    # -- the hot path --------------------------------------------------

    def emit(self, stream: str, text: str):
        """Stamp + append one complete line."""
        ts = time.time()
        ctx = _task_ctx.get()
        task = name = job = trace = None
        if ctx is not None:
            task, name, job, trace = ctx
        data = "%f %s %s %s %s %s\t%s\n" % (
            ts, stream, _tok(trace), _tok(task), _tok(name), _tok(job),
            text)
        raw = data.encode("utf-8", "replace")
        with self._lock:
            if self._fd is None:
                self.dropped += 1
                return
            off = self._size
            try:
                os.write(self._fd, raw)
                self._size += len(raw)
            except OSError:  # pragma: no cover - disk full: drop
                self.dropped += 1
                return
            self.lines += 1
            # compact record tuple on the hot path; tail()/drain_records()
            # rebuild the dict shape on the (cold) read side
            rec = (ts, stream, text, trace, task, name, job,
                   self._file_token, off)
            self._tail.append(rec)
            self._drain.append(rec)
            if self._size >= self.max_bytes:
                self._rotate_locked()

    def _rec_dict(self, rec: tuple) -> dict:
        ts, stream, text, trace, task, name, job, file_token, off = rec
        return {"ts": ts, "stream": stream, "line": text,
                "trace": trace, "task": task, "name": name, "job": job,
                "file": file_token, "offset": off, "pid": self._pid}

    # -- task attribution ----------------------------------------------

    @contextlib.contextmanager
    def task_span(self, task_id: str, name: str, job: str | None,
                  trace_id: str | None):
        """Bracket one task/actor-method execution with begin/end
        offsets; the resulting segment rides the metric-annex registry
        so ``get_log(task_id=...)`` can serve exactly this slice."""
        with self._lock:
            start_file, start = self.file_token(), self._size
        token = _task_ctx.set((task_id, name, job, trace_id))
        try:
            yield
        finally:
            _task_ctx.reset(token)
            with self._lock:
                end_file, end = self.file_token(), self._size
            seg = {"task": task_id, "name": name, "proc": self.proc,
                   "file": start_file, "start": start,
                   "end_file": end_file, "end": end, "ts": time.time()}
            self._segments.append(seg)
            try:
                from ray_tpu_torch.runtime import annex as _annex

                _annex.set_annex(ANNEX_PREFIX + self.proc,
                                 list(self._segments))
            except Exception:  # pragma: no cover - teardown
                pass

    # -- reads ---------------------------------------------------------

    def tail(self, n: int | None = None, task_id: str | None = None
             ) -> list[dict]:
        n = self._tail_n if n is None else int(n)
        with self._lock:
            recs = list(self._tail)
        if task_id is not None:
            recs = [r for r in recs if r[4] == task_id]
        return [self._rec_dict(r) for r in recs[-n:]]

    def drain_records(self) -> list[dict]:
        """Pop records accumulated since the last drain (self-ingest
        path — the external GCS feeds its own LogStore from this)."""
        out = []
        with self._lock:
            while self._drain:
                out.append(self._drain.popleft())
        return [self._rec_dict(r) for r in out]

    def close(self):
        with self._lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:  # pragma: no cover
                pass


# ---------------------------------------------------------------------------
# process-wide install
# ---------------------------------------------------------------------------

_install_lock = threading.Lock()
_active: LogCapture | None = None
_tees: tuple | None = None


def install_capture(proc: str, log_dir: str | None = None,
                    **bounds) -> LogCapture | None:
    """Redirect this process's stdout/stderr through the stamped tee.
    Idempotent; returns the active capture (None when disabled)."""
    global _active, _tees
    with _install_lock:
        if _active is not None:
            return _active
        if not _cfg_attr("log_capture_enabled", True):
            return None
        if log_dir is None:
            log_dir = os.environ.get("RAY_TPU_TORCH_LOG_DIR")
        if not log_dir:
            return None
        try:
            cap = LogCapture(proc, log_dir, **bounds)
        except OSError:
            return None
        out = _TeeStream(cap, "o", sys.stdout)
        err = _TeeStream(cap, "e", sys.stderr)
        sys.stdout, sys.stderr = out, err
        _active, _tees = cap, (out, err)
        return cap


def uninstall_capture():
    global _active, _tees
    with _install_lock:
        cap, _active = _active, None
        tees, _tees = _tees, None
    if tees is not None:
        for tee in tees:
            tee.close_partial()
        sys.stdout, sys.stderr = tees[0]._orig, tees[1]._orig
    if cap is not None:
        cap.close()


def active_capture() -> LogCapture | None:
    return _active


@contextlib.contextmanager
def task_context(task_id: str | None, name: str | None,
                 job: str | None = None, trace_id: str | None = None):
    """Bracket one execution for log attribution. Without an installed
    capture this still binds the ambient task context (so
    ``runtime_context`` can answer ``get_task_id`` in local mode) but
    records no segment — near-zero cost."""
    cap = _active
    if cap is not None and task_id:
        with cap.task_span(task_id, name or "?", job, trace_id):
            yield
        return
    token = _task_ctx.set((task_id, name, job, trace_id))
    try:
        yield
    finally:
        _task_ctx.reset(token)


@contextlib.contextmanager
def label_context(name: str):
    """Re-label the ambient task context (serve replicas stamp their
    deployment/replica tag over the generic actor-method name so echoed
    lines read ``(App/replica-ab12 pid=N, node=M)``)."""
    ctx = _task_ctx.get()
    if ctx is None:
        token = _task_ctx.set((None, name, None, None))
    else:
        token = _task_ctx.set((ctx[0], name, ctx[2], ctx[3]))
    try:
        yield
    finally:
        _task_ctx.reset(token)


def log_tail(n: int | None = None) -> list[dict]:
    """Last captured lines of THIS process (flight-recorder payload)."""
    cap = _active
    if cap is None:
        return []
    return cap.tail(n)


def recent_lines(task_id: str, n: int = 5) -> list[str]:
    """Last ``n`` captured lines attributed to ``task_id`` (stuck-call
    reports append these so a hung task's report is actionable)."""
    cap = _active
    if cap is None:
        return []
    return [r["line"] for r in cap.tail(n=n, task_id=task_id)]


def chrome_instant_events(records: list[dict] | None = None) -> list[dict]:
    """Attributed log lines as chrome://tracing instant events on the
    emitting task's trace lane (tid = trace_id, matching span lanes in
    JAX's ``util.tracing.to_chrome_trace``)."""
    if records is None:
        records = log_tail(None)
    events = []
    for r in records:
        if not r.get("trace"):
            continue
        events.append({
            "name": r["line"][:120],
            "cat": "log",
            "ph": "i",
            "s": "t",
            "ts": r["ts"] * 1e6,
            "pid": r.get("pid", 0),
            "tid": r["trace"],
            "args": {"task": r.get("task"), "stream": r.get("stream")},
        })
    return events


# ---------------------------------------------------------------------------
# line parsing (monitor side)
# ---------------------------------------------------------------------------

def parse_line(line: str):
    """One stamped capture line -> (ts, stream, trace, task, name, job,
    text), or None for the ``#epoch`` header. Unstamped lines (raw
    .out/.err files, pre-tee startup output) fall through with stamp
    defaults."""
    if line.startswith("#epoch "):
        return None
    hdr, sep, text = line.partition("\t")
    if sep:
        fields = hdr.split(" ")
        if len(fields) == _HDR_FIELDS:
            try:
                ts = float(fields[0])
            except ValueError:
                ts = None
            if ts is not None and fields[1] in ("o", "e"):
                return (ts, fields[1], _untok(fields[2]),
                        _untok(fields[3]), _untok(fields[4]),
                        _untok(fields[5]), text)
    return (time.time(), "o", None, None, None, None, line)


def parse_epoch(line: str) -> int | None:
    if line.startswith("#epoch "):
        try:
            return int(line[len("#epoch "):].strip())
        except ValueError:
            return None
    return None


# ---------------------------------------------------------------------------
# error grouping
# ---------------------------------------------------------------------------

# an "error line": a leveled ERROR/CRITICAL/FATAL message, or the final
# line of a traceback ("SomeError: ..."). Traceback BODY lines are not
# errors themselves — one uncaught exception must become ONE group.
_ERR_RE = re.compile(
    r"\b(ERROR|CRITICAL|FATAL)\b"
    r"|^\s*[A-Za-z_][\w.]*(Error|Exception|Interrupt|Exit)\b\s*(:|$)")
_NORM_NUM = re.compile(r"0x[0-9a-fA-F]+|\b[0-9a-f]{8,}\b|\d+")

# Last words of a fault-injected process death. FaultPlane._die writes
# this marker straight to fd 2 before os._exit/SIGKILL, so it is the one
# record a killed process leaves behind (no flight-recorder dump, no
# atexit). Keep in sync with fault_injection.CRASH_MARKER.
_CRASH_MARKER = "RAY_TPU_CRASH"


def is_error_line(text: str) -> bool:
    return bool(_ERR_RE.search(text)) or _CRASH_MARKER in text


def crash_point(text: str) -> str | None:
    """Crash-point name from a ``RAY_TPU_CRASH point=... rule=...`` line
    (None when the line is not a crash marker)."""
    pos = text.find(_CRASH_MARKER)
    if pos < 0:
        return None
    for tok in text[pos:].split():
        if tok.startswith("point="):
            return tok[len("point="):]
    return "?"


def error_signature(text: str) -> str:
    """Stable dedup key: numbers/ids folded, whitespace collapsed."""
    return " ".join(_NORM_NUM.sub("#", text).split())[:160]


# ---------------------------------------------------------------------------
# GCS-side store
# ---------------------------------------------------------------------------

def _pos_key(file_token: str, off: int) -> tuple:
    """Orderable (base, epoch, offset) position from a file@epoch token
    (lexicographic file comparison would put epoch 10 before 9)."""
    base, _, epoch = (file_token or "@").rpartition("@")
    try:
        return (base, int(epoch), off)
    except ValueError:
        return (base, 0, off)


class LogStore:
    """Bounded cluster log rings on the GCS.

    Per-proc recent-line rings answer ``get_log``; the error ring +
    signature-grouped table answers ``summarize_errors``. Ingest is
    idempotent per (proc, file@epoch, offset) watermark, so duplicated
    push frames (chaos, monitor retry after a lost ack) neither
    double-store nor double-echo."""

    def __init__(self, lines_per_proc: int = 2000,
                 error_lines: int = 2000, error_groups: int = 256,
                 max_procs: int = 512):
        self._lock = threading.Lock()
        self._lines_per_proc = max(16, int(lines_per_proc))
        self._max_procs = max(1, int(max_procs))
        self._procs: "OrderedDict[str, dict]" = OrderedDict()
        self._errors: deque = deque(maxlen=max(16, int(error_lines)))
        self._groups: "OrderedDict[str, dict]" = OrderedDict()
        self._max_groups = max(8, int(error_groups))
        self.ingested = 0
        self.deduped = 0

    def _proc_locked(self, proc: str) -> dict:
        ent = self._procs.get(proc)
        if ent is None:
            ent = self._procs[proc] = {
                "ring": deque(maxlen=self._lines_per_proc),
                "watermarks": {},        # file@epoch -> max offset seen
                "node": None, "pid": 0, "last_ts": 0.0}
            while len(self._procs) > self._max_procs:
                self._procs.popitem(last=False)
        else:
            self._procs.move_to_end(proc)
        return ent

    def ingest(self, node_id: str, entries: list) -> list:
        """Store new lines; returns the accepted entries (same wire
        shape, duplicates stripped) for CH_LOGS fan-out."""
        accepted = []
        with self._lock:
            for entry in entries or []:
                proc = entry.get("proc") or "?"
                file_token = entry.get("file") or "?"
                ent = self._proc_locked(proc)
                ent["node"] = node_id
                if entry.get("pid"):
                    ent["pid"] = entry["pid"]
                wm = ent["watermarks"].get(file_token, -1)
                fresh = []
                for rec in entry.get("lines") or []:
                    # rec: (offset, ts, stream, text, trace, task,
                    #       name, job)
                    try:
                        off = int(rec[0])
                    except (TypeError, ValueError, IndexError):
                        continue
                    if off <= wm:
                        self.deduped += 1
                        continue
                    wm = off
                    fresh.append(rec)
                    stored = {"node": node_id, "proc": proc,
                              "pid": entry.get("pid", 0),
                              "file": file_token, "offset": off,
                              "ts": rec[1], "stream": rec[2],
                              "line": rec[3], "trace": rec[4],
                              "task": rec[5], "name": rec[6],
                              "job": rec[7]}
                    ent["ring"].append(stored)
                    ent["last_ts"] = max(ent["last_ts"], rec[1] or 0.0)
                    self.ingested += 1
                    if is_error_line(stored["line"]):
                        self._errors.append(stored)
                        self._group_locked(stored)
                ent["watermarks"][file_token] = wm
                if len(ent["watermarks"]) > 64:
                    # rotation churn: forget the oldest generations
                    for k in list(ent["watermarks"])[:-32]:
                        del ent["watermarks"][k]
                if fresh:
                    accepted.append({**entry, "lines": fresh})
        return accepted

    def _group_locked(self, rec: dict):
        line = rec["line"]
        point = crash_point(line)
        if point is not None:
            # group crash deaths by crash point, not by raw text — the
            # marker may ride the tail of an unterminated stdout line,
            # and pid/rule ids vary per death
            pos = line.find(_CRASH_MARKER)
            sig = error_signature(line[pos:])
            kind = "crash"
        else:
            sig = error_signature(line)
            kind = "error"
        g = self._groups.get(sig)
        if g is None:
            g = self._groups[sig] = {
                "signature": sig, "kind": kind, "sample": line,
                "count": 0,
                "first_ts": rec["ts"], "last_ts": rec["ts"],
                "procs": set(), "traces": set(), "tasks": set()}
            if point is not None:
                g["crash_point"] = point
            while len(self._groups) > self._max_groups:
                self._groups.popitem(last=False)
        else:
            self._groups.move_to_end(sig)
        g["count"] += 1
        g["first_ts"] = min(g["first_ts"], rec["ts"])
        g["last_ts"] = max(g["last_ts"], rec["ts"])
        g["procs"].add(rec["proc"])
        if rec.get("trace") and len(g["traces"]) < 8:
            g["traces"].add(rec["trace"])
        if rec.get("task") and len(g["tasks"]) < 8:
            g["tasks"].add(rec["task"])

    # -- queries -------------------------------------------------------

    def _resolve_proc_locked(self, proc: str) -> str | None:
        if proc in self._procs:
            return proc
        hits = [p for p in self._procs
                if p.startswith(proc) or p.endswith(proc)
                or p == f"worker-{proc}"]
        return hits[0] if len(hits) == 1 else None

    def tail(self, proc: str, n: int = 100,
             after: tuple | None = None) -> dict:
        with self._lock:
            name = self._resolve_proc_locked(proc)
            if name is None:
                return {"proc": proc, "lines": [],
                        "error": f"no logs for process {proc!r}"}
            ent = self._procs[name]
            recs = list(ent["ring"])
        if after:
            cursor = _pos_key(after[0], int(after[1]))
            recs = [r for r in recs
                    if _pos_key(r["file"], r["offset"]) > cursor]
        recs = recs[-max(0, int(n)):]
        return {"proc": name, "node": ent["node"], "pid": ent["pid"],
                "lines": recs}

    def segment(self, seg: dict) -> dict:
        """Exactly the lines inside one task's offset segment (epoch-
        aware: a rotation mid-task spans two generations)."""

        lo = _pos_key(seg.get("file"), int(seg.get("start", 0)))
        hi = _pos_key(seg.get("end_file") or seg.get("file"),
                      int(seg.get("end", 0)))
        with self._lock:
            name = self._resolve_proc_locked(seg.get("proc") or "")
            if name is None:
                return {"proc": seg.get("proc"), "lines": [],
                        "error": "segment's process has no stored logs"}
            recs = [r for r in self._procs[name]["ring"]
                    if lo <= _pos_key(r["file"], r["offset"]) < hi]
        return {"proc": name, "task": seg.get("task"),
                "name": seg.get("name"), "lines": recs,
                "segment": {k: seg.get(k) for k in
                            ("file", "start", "end_file", "end")}}

    def list(self) -> dict:
        with self._lock:
            procs = {
                proc: {"node": ent["node"], "pid": ent["pid"],
                       "lines": len(ent["ring"]),
                       "last_ts": ent["last_ts"],
                       "files": sorted(ent["watermarks"])}
                for proc, ent in self._procs.items()}
        return {"procs": procs, "ingested": self.ingested,
                "deduped": self.deduped}

    def summarize_errors(self, last_s: float | None = None) -> list[dict]:
        now = time.time()
        with self._lock:
            groups = [dict(g) for g in self._groups.values()
                      if last_s is None or now - g["last_ts"] <= last_s]
        for g in groups:
            g["procs"] = sorted(g["procs"])
            g["traces"] = sorted(g["traces"])
            g["tasks"] = sorted(g["tasks"])
        groups.sort(key=lambda g: (-g["count"], -g["last_ts"]))
        return groups
