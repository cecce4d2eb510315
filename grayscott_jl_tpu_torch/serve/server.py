"""The HTTP front door: submit / status / cancel / result / SSE
(counterpart of ``grayscott_jl_tpu/serve/server.py``).

Stdlib ``http.server`` (threading). Endpoints, as the reference's:

* ``POST /v1/jobs`` — submit a JSON job spec. 200 -> the queued job
  record; 400 -> the ``SettingsError`` text naming the spec problem;
  429 -> admission refused (full queue, tenant quota), the body names
  the reason.
* ``GET /v1/jobs/<id>`` — the lifecycle record (state, batch, slot,
  timestamps, request-to-first-step latency once known).
* ``POST /v1/jobs/<id>/cancel`` — cancel a QUEUED job (409 once it is
  committed to a launch).
* ``GET /v1/jobs/<id>/result`` — terminal record + member store path
  (409 until terminal).
* ``GET /v1/jobs/<id>/field?field=u&z=8`` — one z-plane of a field from
  the job's member store at its latest durable output step.
* ``GET /v1/jobs/<id>/events`` — server-sent events: the job's lifecycle
  and its batch's run events, fanned out live from the ``GS_EVENTS``
  stream (``obs/events.subscribe``), a compact field slice with each
  output boundary, and a terminal frame.
* ``GET /v1/healthz`` — liveness + scheduler counters.

:class:`ServeService` arms the event stream, builds the scheduler and
the worker fleet, and tears them down in order on ``close()``. A service
with local workers on the card (``backend = "CUDA"``, the default)
checks at construction that the card is there, and raises when it is
not; ``--backend CPU`` runs batches on the host.

    python -m grayscott_jl_tpu_torch.serve [--backend CUDA|CPU]
        [--role frontdoor|worker]
"""

from __future__ import annotations

import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..models.base import SettingsError
from ..utils.log import Logger
from .scheduler import AdmissionError, Scheduler, ServeConfig
from .worker import WorkerFleet

__all__ = ["ServeService", "main"]


def _ensure_events(state_dir: str):
    """The service REQUIRES a live event stream (SSE fan-out, progress
    tracking, the job_* audit trail). Honor an operator-armed
    ``GS_EVENTS``; otherwise arm the stream at the state dir's
    ``events.jsonl`` before the process-wide singleton resolves."""
    from ..obs import events as obs_events

    stream = obs_events.get_events()
    if stream.enabled:
        return stream
    os.makedirs(state_dir, exist_ok=True)
    os.environ["GS_EVENTS"] = os.path.join(state_dir, "events.jsonl")
    obs_events.reset_events()
    return obs_events.get_events()


def _field_slice(job, *, field: Optional[str] = None,
                 z: Optional[int] = None, stride: int = 1) -> dict:
    """One z-plane of one field from the job's member OUTPUT store at
    its latest durable step, through ``io.open_reader`` (a BP-lite store
    under its durability rules, so a torn tail is invisible, or a real
    ADIOS2 store with its rollback sidecar merged)."""
    from ..io import open_reader

    if job.store is None or not os.path.exists(job.store):
        raise FileNotFoundError("no output store yet")
    L = job.spec.L
    z = L // 2 if z is None else max(0, min(int(z), L - 1))
    stride = max(1, int(stride))
    reader = open_reader(job.store)
    try:
        n = reader.num_steps()
        if n == 0:
            raise FileNotFoundError("no durable output step yet")
        names = [
            v for v in reader.available_variables() if v != "step"
        ]
        name = (field or names[0]).upper()
        if name not in names:
            raise KeyError(
                f"field {field!r} not in store (have "
                f"{sorted(v.lower() for v in names)})"
            )
        plane = reader.get(
            name, step=n - 1, start=[0, 0, z], count=[L, L, 1]
        )[:, :, 0]
        step_arr = reader.get("step", step=n - 1)
    finally:
        reader.close()
    data = plane[::stride, ::stride]
    return {
        "job": job.id,
        "field": name.lower(),
        "z": z,
        "stride": stride,
        "sim_step": int(step_arr),
        "shape": list(data.shape),
        "data": [[round(float(v), 6) for v in row] for row in data],
    }


class _Server(ThreadingHTTPServer):
    """One thread per connection; the listen backlog must absorb a
    whole synthetic-client burst (the load harness opens hundreds of
    sockets in one instant — the stdlib default of 5 resets them)."""

    daemon_threads = True
    request_queue_size = 512


class ServeService:
    """The assembled service: scheduler + worker fleet + HTTP server."""

    def __init__(self, cfg: ServeConfig, *, log: Optional[Logger] = None):
        self.cfg = cfg
        self.log = log or Logger(verbose=True)
        if cfg.workers:
            check_backend(cfg.backend)
        os.makedirs(cfg.state_dir, exist_ok=True)
        if cfg.fleet_dir:
            # Fleet replica: per-member .rank<N> event file + the
            # shared-KV scheduler — any replica can answer for any job.
            from .cluster import ClusterScheduler, arm_fleet_events

            self.events = arm_fleet_events(cfg)
            self.scheduler = ClusterScheduler(
                cfg, role="frontdoor", events=self.events, log=self.log,
            )
        else:
            self.events = _ensure_events(cfg.state_dir)
            self.scheduler = Scheduler(cfg, events=self.events)
        self.scheduler.attach_events()
        self.fleet = WorkerFleet(self.scheduler, cfg, log=self.log)
        from .elastic import ElasticController

        # Off unless GS_SERVE_ELASTIC=1 (start() is then a no-op): the
        # control loop turning queue depth + worker utilization into
        # live mesh reshapes on running batches.
        self.elastic = ElasticController(
            self.scheduler, self.fleet if cfg.workers else None,
            log=self.log,
        )
        handler = _make_handler(self)
        self.httpd = _Server((cfg.host, cfg.port), handler)
        if cfg.fleet_dir:
            self.scheduler.announce_endpoint(cfg.host, self.port)
        self._http_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """The BOUND port (``GS_SERVE_PORT=0`` = ephemeral, tests)."""
        return self.httpd.server_address[1]

    def start(self) -> "ServeService":
        self.fleet.start()
        self.elastic.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="gs-serve-http",
            daemon=True,
        )
        self._http_thread.start()
        self.log.info(
            f"gs-serve: listening on {self.cfg.host}:{self.port} "
            f"({self.cfg.workers} worker(s), pack_max="
            f"{self.cfg.pack_max}, events={self.events.describe()})"
        )
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Drain: stop admitting, let workers finish in-flight batches,
        then stop the HTTP loop."""
        self.scheduler.drain()
        self.elastic.close()
        self.fleet.stop(timeout)
        self.scheduler.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(5.0)

    def __enter__(self) -> "ServeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _make_handler(service: ServeService):
    scheduler = service.scheduler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "gs-serve/1"

        # Quiet the default stderr-per-request logging.
        def log_message(self, fmt, *args):  # noqa: ARG002
            pass

        # ------------------------------------------------------- helpers

        def _json(self, code: int, payload: dict) -> None:
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str, **extra) -> None:
            self._json(code, {"error": message, **extra})

        def _job(self, job_id: str):
            return scheduler.jobs.get(job_id)

        # --------------------------------------------------------- POST

        def do_POST(self) -> None:  # noqa: N802 — http.server API
            path = urlparse(self.path).path
            parts = [p for p in path.split("/") if p]
            if parts == ["v1", "jobs"]:
                return self._submit()
            if (len(parts) == 4 and parts[:2] == ["v1", "jobs"]
                    and parts[3] == "cancel"):
                return self._cancel(parts[2])
            self._error(404, f"no such endpoint: POST {path}")

        def _submit(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(
                    self.rfile.read(length).decode() or "null"
                )
            except (ValueError, UnicodeDecodeError) as e:
                return self._error(400, f"invalid JSON body: {e}")
            try:
                job = scheduler.submit(payload)
            except AdmissionError as e:
                # Valid spec, refused admission: the client's cue to
                # back off (quota) or retry later (queue_full).
                return self._error(
                    429, f"admission refused: {e.reason}",
                    job=e.job.id, reason=e.reason,
                )
            except SettingsError as e:
                # The loud spec-validation contract: the framework's
                # own error text goes straight back to the client.
                return self._error(400, str(e))
            self._json(200, job.describe())

        def _cancel(self, job_id: str) -> None:
            job = self._job(job_id)
            if job is None:
                return self._error(404, f"no such job: {job_id}")
            if scheduler.cancel(job_id):
                return self._json(200, job.describe())
            self._error(
                409,
                f"job {job_id} is {job.state} — only queued jobs "
                "cancel",
            )

        # ---------------------------------------------------------- GET

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if parts == ["v1", "healthz"]:
                return self._json(200, {
                    "ok": True, **scheduler.describe(),
                    "launches": service.fleet.launches,
                    "warm_hits": service.fleet.warm_hits,
                })
            if len(parts) >= 3 and parts[:2] == ["v1", "jobs"]:
                job = self._job(parts[2])
                if job is None:
                    return self._error(404, f"no such job: {parts[2]}")
                if len(parts) == 3:
                    return self._json(200, job.describe())
                tail = parts[3]
                if tail == "result":
                    return self._result(job)
                if tail == "field":
                    return self._field(job, parse_qs(url.query))
                if tail == "events":
                    return self._sse(job)
            self._error(404, f"no such endpoint: GET {url.path}")

        def _result(self, job) -> None:
            if job.state not in ("complete", "failed", "cancelled",
                                 "rejected"):
                return self._error(
                    409, f"job {job.id} is {job.state}; result is "
                    "available once terminal",
                )
            self._json(200, job.describe())

        def _field(self, job, qs) -> None:
            try:
                payload = _field_slice(
                    job,
                    field=(qs.get("field") or [None])[0],
                    z=(
                        int(qs["z"][0]) if "z" in qs else None
                    ),
                    stride=int((qs.get("stride") or ["1"])[0]),
                )
            except (FileNotFoundError, KeyError, ValueError,
                    OSError) as e:
                return self._error(404, f"no field slice: {e}")
            self._json(200, payload)

        # ---------------------------------------------------------- SSE

        def _sse(self, job) -> None:
            """Live progress: replay the job's current state, then
            stream its lifecycle + batch run events until terminal.
            Frames are ``event: <kind>`` + JSON data lines; output
            boundaries additionally carry a coarse field slice.

            The per-subscriber queue is BOUNDED (GS_SERVE_SSE_QUEUE):
            a slow client drops frames, it never grows an unbounded
            buffer inside the serving process or blocks the emitting
            run. The idle poll doubles as the disconnect detector —
            the keepalive write to a dead socket raises, the handler
            returns, and ``finally`` unsubscribes the fan-out — and,
            in fleet mode, as the terminal detector: another process's
            ``job_complete`` never flows through THIS process's stream,
            so the refreshed job document is what ends the session."""
            q: "queue.Queue" = queue.Queue(
                maxsize=service.cfg.sse_queue
            )
            ref = {"job": job}

            def fan_out(record: dict) -> None:
                # This job's own lifecycle records, plus its batch's
                # run events (the job snapshot is refreshed on idle —
                # the job may still be queued when the client
                # connects).
                j = ref["job"]
                attrs = record.get("attrs") or {}
                if attrs.get("job") == j.id or (
                    j.batch_id is not None
                    and attrs.get("batch") == j.batch_id
                ):
                    try:
                        q.put_nowait(record)
                    except queue.Full:
                        pass  # slow client: drop, never block the run

            unsubscribe = service.events.subscribe(fan_out)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                self._sse_frame("state", job.describe())
                terminal = ("complete", "failed", "cancelled",
                            "rejected")
                if job.state in terminal:
                    self._sse_frame("done", job.describe())
                    return
                while True:
                    try:
                        record = q.get(timeout=5.0)
                    except queue.Empty:
                        latest = scheduler.jobs.get(job.id)
                        if latest is not None:
                            ref["job"] = latest
                            if latest.state in terminal:
                                self._sse_frame(
                                    "done", latest.describe()
                                )
                                return
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    kind = record.get("kind")
                    self._sse_frame(kind, record)
                    if kind == "output":
                        try:
                            self._sse_frame(
                                "field_slice",
                                _field_slice(job, stride=max(
                                    1, job.spec.L // 16
                                )),
                            )
                        except (FileNotFoundError, KeyError,
                                ValueError, OSError):
                            pass  # not durable yet: next boundary
                    if kind == "job_complete" and (
                        record.get("attrs", {}).get("job") == job.id
                    ):
                        self._sse_frame("done", job.describe())
                        return
            except OSError:
                pass  # client went away — normal SSE teardown
            finally:
                unsubscribe()

        def _sse_frame(self, event: str, payload: dict) -> None:
            self.wfile.write(
                f"event: {event}\ndata: {json.dumps(payload)}\n\n"
                .encode()
            )
            self.wfile.flush()

    return Handler


def check_backend(backend: str) -> None:
    """Raise unless ``backend`` (``protocol.BACKENDS``) can run here: the
    card must be there for ``"CUDA"`` (``config/settings.resolve_device``);
    nothing falls back to the host."""
    from ..config.settings import Settings, resolve_device
    from .protocol import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"serve backend must be one of {sorted(BACKENDS)}, "
                         f"got {backend!r}")
    resolve_device(Settings(backend=BACKENDS[backend][0]))


def parse_args(argv):
    """``--role frontdoor|worker`` and ``--backend CUDA|CPU``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="gs-serve-torch",
        description="The simulation service (the GS_SERVE_* variables "
                    "configure the rest).")
    p.add_argument("--role", default="frontdoor",
                   choices=("frontdoor", "worker"))
    p.add_argument("--backend", default="CUDA", choices=("CUDA", "CPU"),
                   help="CUDA (the default) runs batches on the card; CPU "
                        "on the host")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """CLI entry (``python -m grayscott_jl_tpu_torch.serve``,
    ``gs-serve-torch``): resolve the GS_SERVE_* knobs, start the service,
    serve until SIGINT/SIGTERM, drain.

    ``--role frontdoor`` (default) runs the HTTP front door — standalone,
    or as a fleet replica when ``GS_SERVE_FLEET_DIR`` is set. ``--role
    worker`` runs a headless fleet worker process
    (``serve/cluster.worker_main``). ``--backend`` picks where batches
    run: the card (``CUDA``, the default) or the host (``CPU``)."""
    import signal
    import sys

    from .scheduler import resolve_serve_config

    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.role == "worker":
        from .cluster import worker_main

        return worker_main(backend=args.backend)
    cfg = resolve_serve_config()
    cfg.backend = args.backend
    service = ServeService(cfg)
    stop = threading.Event()

    def _request_stop(signum, frame):  # noqa: ARG001
        stop.set()

    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)
    service.start()
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        service.log.info("gs-serve: draining...")
        service.close()
        service.log.info("gs-serve: bye")
    return 0
