"""Transports + request queue for the serving surface.

Counterpart of ``eeg2video_tpu/serving/transport.py``. Three ways requests
reach the batcher: the plain stdin loop (cli/serve.py), the stdin --coalesce
reader, and the --listen TCP acceptor — the latter two feed ONE shared queue
drained by ``_serve_queue`` (so coalescing spans clients).  ``_enqueue`` is
the reader-side admission control (--max_queue backpressure), ``_Stats`` the
{"cmd": "stats"} counters.  The protocol is documented in cli/serve.py.

One deliberate difference: a ``{"cmd": "shutdown"}`` replies ``bye`` and then
answers every line still queued behind it with the ``shutting_down`` refusal
before the loop returns (the JAX server drops those lines without a reply),
so every admitted line gets exactly one reply.
"""

import json
import os
import sys
import time

from ..utils import get_logger
from .batching import _process_group
from .runtimes import _knob_key

log = get_logger(__name__)

_SHUTTING_DOWN = "shutting_down: server is draining, request not accepted"


class _StdioClient:
    """The stdin-mode 'connection': replies print to stdout."""

    alive = True

    def send(self, resp):
        print(json.dumps(resp), flush=True)


class _SocketClient:
    """One accepted connection; ``send`` is thread-safe (reply callbacks
    fire on GIF-writer threads) and dead peers are dropped, never fatal."""

    def __init__(self, conn):
        import threading

        self._wfile = conn.makefile("w", encoding="utf-8")
        self._lock = threading.Lock()
        self.alive = True

    def send(self, resp):
        try:
            with self._lock:
                self._wfile.write(json.dumps(resp) + "\n")
                self._wfile.flush()
        except OSError:
            self.alive = False


class _Drain:
    """Drain state shared by reader threads and the queue loop.

    ``flag``: set by the SIGTERM handler (graceful preemption).  ``lock``:
    makes reader admission atomic against the loop's final emptiness
    check — a reader holding the lock either enqueues while the flag is
    still clear (the loop then sees a non-empty queue and keeps going) or
    observes the flag and refuses; the loop only exits after seeing
    flag-set AND queue-empty under the same lock, so no line is ever
    silently dropped into a dead queue (every request is either processed
    or refusal-replied)."""

    def __init__(self):
        import threading

        self.flag = threading.Event()
        self.lock = threading.Lock()


def _install_drain_handler(drain):
    """SIGTERM → graceful drain: the flag makes readers stop admitting new
    lines (``shutting_down`` error replies) and the queue loop exit once
    everything already queued has been processed and replied to.  A
    scheduler's preemption delivers exactly SIGTERM, and a serving process
    must not drop queued requests on the floor.  The handler sets the Event
    FIRST and then reports via os.write (async-signal-safe; a logging emit
    can raise a reentrant-call error inside a handler and would lose the
    signal).  SIGINT is left alone so an interactive Ctrl-C still
    hard-stops.  No-op off the main thread (in-process tests drive the
    loop directly and set the flag by hand).

    Returns a restore token for ``_restore_handler`` — serve can run
    embedded (tests run main() in-process), so the host process's SIGTERM
    disposition must come back when the loop returns."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return None

    def _h(signum, frame):
        drain.flag.set()
        os.write(2, b"serve: SIGTERM - draining queued requests, "
                    b"then exiting\n")

    try:
        prev = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _h)
    except ValueError:  # pragma: no cover - non-main interpreter state
        return None
    return (signal.SIGTERM, prev)


def _restore_handler(token):
    if token is None:
        return
    import signal

    try:
        signal.signal(token[0], token[1])
    except (ValueError, TypeError):  # pragma: no cover - defensive
        pass


def _init_drain(q, stats):
    """Wire the drain state for a queue-loop transport: install the
    SIGTERM handler and expose live refs on stats ({"cmd": "stats"}
    reports queue depth + drain state).  Returns (drain, restore_token)."""
    drain = _Drain()
    token = _install_drain_handler(drain)
    stats.queue, stats.draining = q, drain.flag
    return drain, token


def _serve_queue(pipe, args, q, _EOF, stats, drain=None):
    """Shared request loop for stdin --coalesce and --listen modes: readers
    feed ``q`` with (line, client); each iteration drains every
    already-queued knob-compatible request into one batched
    `_process_group` call (or, without --coalesce, a group of one).
    Draining stops at the first cmd or knob-mismatched request (kept FIFO
    via `pending`), so replies stay in arrival order.

    ``drain`` (a ``_Drain``, optional): once its flag is set — by the
    SIGTERM handler — the loop keeps processing whatever is already queued
    and returns when the queue runs dry; the final emptiness check happens
    under ``drain.lock`` so it cannot race a reader's admission (readers
    refuse new lines the same moment, so "dry" is reachable under load)."""
    import collections
    import queue as queue_mod

    def emit(resp, req, client):
        if isinstance(req, dict) and "id" in req:
            resp["id"] = req["id"]
        stats.reply(resp)
        client.send(resp)

    def parse(line, client):
        line = line.strip()
        if not line:
            return None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(req).__name__}")
            return req
        except (json.JSONDecodeError, ValueError) as e:
            client.send({"ok": False, "error": f"bad json: {e}"})
            return None

    pending = collections.deque()
    eof = False

    def refuse_queued():
        # after a shutdown cmd: readers stop admitting (the drain flag, set
        # under the lock their admission takes), then every line already
        # behind the shutdown gets the refusal a draining server gives
        if drain is not None:
            with drain.lock:
                drain.flag.set()
        queued = [(r, c) for r, _t0, c in pending]
        pending.clear()
        while True:
            try:
                line, c = q.get_nowait()
            except queue_mod.Empty:
                break
            if line is _EOF:
                continue
            r = parse(line, c)
            if r is not None:
                queued.append((r, c))
        for r, c in queued:
            emit({"ok": False, "error": _SHUTTING_DOWN}, r, c)

    while True:
        if pending:
            req, t0, client = pending.popleft()
        elif eof:
            return 0
        else:
            if drain is None:
                line, client = q.get()
            else:
                # bounded wait so a drain signal with an empty queue is
                # noticed; items already queued still process first
                try:
                    line, client = q.get(timeout=0.25)
                except queue_mod.Empty:
                    if drain.flag.is_set():
                        # under the lock: a reader past its own flag
                        # check has either put (queue non-empty, keep
                        # going) or will see the flag and refuse
                        with drain.lock:
                            if q.empty():
                                return 0
                    continue
            if line is _EOF:
                return 0
            req = parse(line, client)
            if req is None:
                continue
            t0 = time.time()
        if req.get("cmd") == "shutdown":
            emit({"ok": True, "bye": True}, req, client)
            refuse_queued()
            return 0
        if req.get("cmd") == "ping":
            emit({"ok": True, "pong": time.time()}, req, client)
            continue
        if req.get("cmd") == "stats":
            emit(stats.snapshot(), req, client)
            continue
        if req.get("cmd"):
            emit({"ok": False, "error": f"unknown cmd: {req['cmd']}"},
                 req, client)
            continue
        group = [(req, t0, client)]
        gkey = _knob_key(args, req)

        def _clip_count(r):
            # None = whole embedding file (size unknown here, but >= one
            # full dispatch in practice): don't hold it for company
            idx = r.get("indices")
            return len(idx) if idx is not None else None

        n_clips = _clip_count(req)
        while args.coalesce and not eof and not pending:
            try:
                # only delay dispatch while the batch is still short of one
                # full device dispatch of CLIPS (a single multi-clip request
                # can fill dispatches by itself); past that, take what is
                # instantly available
                if (args.coalesce_wait > 0 and n_clips is not None
                        and n_clips < max(1, args.max_batch)):
                    line, nclient = q.get(timeout=args.coalesce_wait)
                else:
                    line, nclient = q.get_nowait()
            except queue_mod.Empty:
                break
            if line is _EOF:
                eof = True
                break
            nreq = parse(line, nclient)
            if nreq is None:
                continue
            if nreq.get("cmd") or _knob_key(args, nreq) != gkey:
                pending.append((nreq, time.time(), nclient))
            else:
                group.append((nreq, time.time(), nclient))
                c = _clip_count(nreq)
                n_clips = (None if n_clips is None or c is None
                           else n_clips + c)
        # every slot is guaranteed exactly one reply (streamed in arrival
        # order; batch-level failures error-reply the unfinished slots)
        _process_group(pipe, args, group, emit)


def _enqueue(q, line, client, args, stats, drain=None):
    """Reader-side admission control.  Past --max_queue pending lines,
    work requests get an IMMEDIATE ``queue_full`` error reply instead of
    growing the queue without bound (an unbounded queue under overload
    means unbounded memory and minutes-stale replies); cmd lines
    (shutdown/ping/stats) are always admitted — they are cheap and an
    operator must never be locked out of shutdown by the very overload
    they are trying to stop.

    Once a SIGTERM drain began, EVERY line — cmds included — gets an
    immediate ``shutting_down`` refusal instead: admitting work would make
    the drain unreachable under load, and admitting a cmd could race the
    loop's final emptiness check and land in a dead queue with no reply
    (a shutdown/stats during a drain is answered by the refusal itself —
    the server is already stopping).  The flag check and the put happen
    under ``drain.lock`` so a line is never enqueued after the loop's
    exit decision (see ``_Drain``)."""
    if not line.strip():
        return  # keep-alive/trailing blank: the parse path ignores these
    if drain is not None:
        with drain.lock:
            if not drain.flag.is_set():
                if not (args.max_queue and q.qsize() >= args.max_queue):
                    q.put((line, client))
                    return
                admit_cmds = True  # fall through: queue_full refusal
            else:
                admit_cmds = False  # drain refusal: nothing is admitted
        err = ("queue_full: {} requests already pending".format(
                   args.max_queue) if admit_cmds
               else _SHUTTING_DOWN)
    elif args.max_queue and q.qsize() >= args.max_queue:
        admit_cmds = True
        err = f"queue_full: {args.max_queue} requests already pending"
    else:
        q.put((line, client))
        return
    try:
        req = json.loads(line)
    except ValueError:
        req = None
    if admit_cmds and isinstance(req, dict) and req.get("cmd"):
        if drain is not None:
            with drain.lock:
                if not drain.flag.is_set():
                    q.put((line, client))
                    return
            # drain began between the checks: refuse like everything else
            err = _SHUTTING_DOWN
        else:
            q.put((line, client))
            return
    resp = {"ok": False, "error": err}
    if isinstance(req, dict) and "id" in req:
        resp["id"] = req["id"]
    stats.reply(resp)
    client.send(resp)


def _serve_coalesced(pipe, args, stats):
    """stdin --coalesce mode: one reader thread feeds the shared queue."""
    import queue as queue_mod
    import threading

    q = queue_mod.Queue()
    _EOF = object()
    client = _StdioClient()
    drain, token = _init_drain(q, stats)

    def reader():
        for line in sys.stdin:
            _enqueue(q, line, client, args, stats, drain)
        q.put((_EOF, client))

    threading.Thread(target=reader, daemon=True).start()
    try:
        return _serve_queue(pipe, args, q, _EOF, stats, drain)
    finally:
        _restore_handler(token)


def _serve_socket(pipe, args, stats, on_ready=None):
    """--listen HOST:PORT mode: concurrent clients over TCP, one JSONL
    protocol line per request.  Every connection's requests
    feed ONE shared queue, so --coalesce batches clips ACROSS clients;
    replies route back to the connection that asked.  A "shutdown" cmd
    from any client stops the server; client disconnects don't."""
    import queue as queue_mod
    import socket
    import threading

    host, _, port = args.listen.rpartition(":")
    srv = socket.create_server((host or "127.0.0.1", int(port)))
    bound = srv.getsockname()[1]
    # operator console: the actual port (0 = ephemeral for tests);
    # ``on_ready`` hands the same line to an in-process caller
    ready = {"ok": True, "ready": True, "port": bound}
    print(json.dumps(ready), flush=True)
    if on_ready is not None:
        on_ready(ready)

    q = queue_mod.Queue()
    _EOF = object()
    stop = threading.Event()
    drain, token = _init_drain(q, stats)

    def reader(conn, addr):
        client = _SocketClient(conn)
        client.send({"ok": True, "ready": True})
        try:
            with conn:
                # errors="replace": a stray non-UTF8 byte becomes a bad-json
                # reply instead of killing this reader thread
                rfile = conn.makefile("r", encoding="utf-8",
                                      errors="replace")
                for line in rfile:
                    _enqueue(q, line, client, args, stats, drain)
                    if stop.is_set():
                        break
        except OSError:
            pass
        client.alive = False
        log.info("client %s disconnected", addr)

    def acceptor():
        while not stop.is_set():
            try:
                conn, addr = srv.accept()
            except OSError:  # listener shut down
                return
            log.info("client %s connected", addr)
            threading.Thread(target=reader, args=(conn, addr),
                             daemon=True).start()

    acceptor_t = threading.Thread(target=acceptor, name="serve-acceptor",
                                  daemon=True)
    acceptor_t.start()
    try:
        return _serve_queue(pipe, args, q, _EOF, stats, drain)
    finally:
        _restore_handler(token)
        stop.set()
        # close() alone does NOT wake a thread blocked in accept() on
        # Linux — shutdown(SHUT_RDWR) does (accept returns EINVAL), so the
        # acceptor exits instead of wedging forever holding a dead fd
        try:
            srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        srv.close()
        acceptor_t.join(timeout=5.0)
        if acceptor_t.is_alive():  # pragma: no cover - defensive
            log.warning("acceptor thread did not exit within 5 s")


class _Stats:
    """Served-request counters behind the {"cmd": "stats"} reply."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._t0 = time.time()
        self.requests = self.clips = self.errors = 0
        self.latency_sum = 0.0
        # live-state refs, set by the queue-loop transports: snapshot then
        # reports backlog + drain state (operator visibility under load)
        self.queue = None
        self.draining = None

    def reply(self, resp):
        if "pong" in resp or "bye" in resp or "uptime_s" in resp:
            return
        with self._lock:
            self.requests += 1
            if resp.get("ok"):
                self.clips += resp.get("clips", 0)
                self.latency_sum += resp.get("latency_s", 0.0)
            else:
                self.errors += 1

    def snapshot(self):
        with self._lock:
            done = self.requests - self.errors
            snap = {"ok": True, "requests": self.requests,
                    "clips": self.clips, "errors": self.errors,
                    "mean_latency_s": round(
                        self.latency_sum / done, 3) if done else None,
                    "uptime_s": round(time.time() - self._t0, 1)}
        if self.queue is not None:
            snap["queued"] = self.queue.qsize()
        if self.draining is not None:
            snap["draining"] = self.draining.is_set()
        return snap

