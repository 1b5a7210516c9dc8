"""Build, supervise, and drive the native canary router (native/router.cc;
the port's copy of the JAX package's ``clients/router.py``).

The reference splits canary traffic with Istio weights written into a
SeldonDeployment and reads latency histograms from the Seldon *executor*
(``mlflow_operator.py:205,:220,:322-324`` / ``:367-415``).  Outside a
service mesh — a bare GPU node, a dev box, the benchmark harness —
this framework carries its own executor: ``tpumlops-router``, a C++ epoll
reverse proxy that does the weighted split and exports the same
``seldon_api_executor_*`` histogram families the gate queries.

This module is the Python face of that binary:

- :func:`build_router` — compile this package's ``native/router.cc`` with
  the system ``g++`` into ``build/native/`` at the repository root, named
  by the source's hash (no pip/cmake involvement; the toolchain is a
  baseline environment guarantee);
- :class:`RouterProcess` — spawn/supervise one router instance;
- :class:`RouterAdmin` — typed admin API (weights, config, metrics) used by
  tests and by operators running in local/router mode.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import time
import urllib.error
import urllib.request

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "router.cc"


def _cache_dir() -> pathlib.Path:
    # ``build/native/`` at the repository root, mode 0700: the binary is
    # exec'd, so no other local user may plant one at its predictable
    # source-hash name.
    path = _SRC.parent.parent.parent / "build" / "native"
    path.mkdir(parents=True, exist_ok=True, mode=0o700)
    return path


def build_router(src: pathlib.Path | None = None) -> pathlib.Path:
    """Compile the router (cached by source hash). Returns the binary path."""
    src = src or _SRC
    text = src.read_bytes()
    tag = hashlib.sha256(text).hexdigest()[:16]
    cache = _cache_dir()
    out = cache / f"tpumlops-router-{tag}"
    # Trust the cached binary only if this user owns it.
    if out.exists() and out.stat().st_uid == os.getuid():
        return out
    tmp = out.with_suffix(f".build{os.getpid()}")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-o", str(tmp), str(src)],
        check=True,
        capture_output=True,
    )
    tmp.replace(out)
    return out


class RouterAdmin:
    """Admin-API client for a running router (stdlib urllib; no deps)."""

    def __init__(self, port: int, host: str = "127.0.0.1", timeout: float = 5.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _req(self, path: str, method: str = "GET", body: dict | None = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def healthy(self) -> bool:
        try:
            return self._req("/router/healthz") == b"ok\n"
        except (urllib.error.URLError, ConnectionError, OSError):
            return False

    def get_weights(self) -> dict[str, int]:
        return json.loads(self._req("/router/weights"))

    def _req_retry(
        self,
        path: str,
        method: str,
        body: dict | None,
        retries: int,
        backoff_s: float,
        sleep=time.sleep,
    ):
        """Bounded retry on TRANSIENT transport errors only.

        An HTTPError means the router is up and answered (a real 4xx/5xx
        the caller must see); connection refused/reset/timeout means it
        is restarting — exactly the window a scale event's weight flip
        used to race and lose, leaving the split stale until the next
        reconcile.  Exponential backoff, ``retries`` re-attempts, then
        the last error propagates."""
        for attempt in range(retries + 1):
            try:
                return self._req(path, method, body)
            except urllib.error.HTTPError:
                raise  # the router answered; not a transient
            except (urllib.error.URLError, ConnectionError, OSError):
                if attempt == retries:
                    raise
                sleep(backoff_s * (2 ** attempt))

    def set_weights(
        self,
        weights: dict[str, int],
        retries: int = 3,
        backoff_s: float = 0.05,
        sleep=time.sleep,
    ) -> None:
        """Idempotent (PUT of an absolute weight map), so retrying a
        flip against a mid-restart router is always safe."""
        self._req_retry(
            "/router/weights", "PUT", weights, retries, backoff_s, sleep
        )

    def get_config(self) -> dict:
        return json.loads(self._req("/router/config"))

    def drain_latencies(self) -> list[float]:
        """Exact router-internal per-request latencies (SECONDS) since
        the last drain — read-and-clear.  Precise where the Prometheus
        histogram's buckets are decades wide; used to attribute tail
        latency to inside-the-proxy vs kernel/client scheduling."""
        payload = json.loads(self._req("/router/latencies"))
        return [us / 1e6 for us in payload.get("recent_us", [])]

    def set_config(
        self,
        backends: list[dict],
        namespace: str | None = None,
        deployment: str | None = None,
        journey_ring: int | None = None,
        mux_models: int | None = None,
        timeseries_ring: int | None = None,
    ) -> dict:
        body: dict = {"backends": backends}
        if namespace:
            body["namespace"] = namespace
        if deployment:
            body["deployment"] = deployment
        if journey_ring is not None:
            # Fleet trace plane sizing (0 disables; omitted = keep the
            # router's running ring).
            body["journeyRing"] = int(journey_ring)
        if timeseries_ring is not None:
            # Per-backend 1 s history sizing (0 disables; omitted = keep
            # the router's running ring).
            body["timeseriesRing"] = int(timeseries_ring)
        if mux_models is not None:
            # Multi-model multiplexing toggle (0 disables; omitted =
            # keep the router's running mode).  Backend entries may then
            # carry a "model" key — the attached-model table the
            # model-aware pick and per-model park release consult.
            body["muxModels"] = int(mux_models)
        return json.loads(self._req("/router/config", "PUT", body))

    def metrics_text(self) -> str:
        return self._req("/router/metrics").decode()

    def parked(self) -> dict:
        """Park-buffer state (``GET /router/parked``): ``parked`` count,
        ``capacity``, ``oldest_wait_s``, and the released/overflow/
        timeout counters — the operator's wake signal for a CR whose
        replicas are at zero.  With multiplexing on the body also
        carries ``models`` — a per-model parked breakdown, so the
        bin-packer attaches the RIGHT model instead of inferring from
        the fleet-wide count."""
        return json.loads(self._req("/router/parked"))

    def fleet(self) -> dict:
        """Disaggregated-fleet state (``GET /router/fleet``): affinity
        hit/miss tallies, KV handoff counts/bytes/failures, ring size,
        and per-backend role + known-prefix counts."""
        return json.loads(self._req("/router/fleet"))

    def journeys(self) -> dict:
        """The journey ring (``GET /router/debug/requests``): per-request
        JourneyRecords — identity, affinity decision, per-leg backend/
        bytes/wall, park hold spans, failover attempts, final outcome —
        plus the ``started_unix`` clock anchor the fleet-trace stitcher
        uses.  404 (HTTPError) while ``--journey-ring`` is 0."""
        return json.loads(self._req("/router/debug/requests"))

    def journey_trace(self, fmt: str = "chrome") -> dict:
        """The journey ring as Chrome trace-event JSON
        (``GET /router/debug/trace?format=chrome``): one track per
        backend, async request spans keyed by request id."""
        return json.loads(self._req(f"/router/debug/trace?format={fmt}"))

    def timeseries(self) -> dict:
        """The timeseries ring (``GET /router/debug/timeseries``):
        per-backend 1 s buckets of leg wall p50/p99, leg/error/failover
        counts, plus a router-level park series — the proxy-side
        per-replica history the operator's anomaly detector compares
        across peers.  404 (HTTPError) while ``--timeseries-ring`` is
        0."""
        return json.loads(self._req("/router/debug/timeseries"))


def parse_prometheus_text(text: str) -> dict[tuple[str, frozenset], float]:
    """Parse Prometheus exposition text into {(name, labelset): value}."""
    out: dict[tuple[str, frozenset], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
        except ValueError:
            continue
        if "{" in series:
            name, rest = series.split("{", 1)
            labels = frozenset(
                tuple(pair.split("=", 1)) for pair in _split_labels(rest.rstrip("}"))
            )
        else:
            name, labels = series, frozenset()
        try:
            out[(name, labels)] = float(value)
        except ValueError:
            continue
    return out


def _split_labels(raw: str) -> list[str]:
    """Split 'a="x",b="y,z"' respecting quoted commas; strips quotes."""
    parts, cur, in_q = [], "", False
    for ch in raw:
        if ch == '"':
            in_q = not in_q
            continue
        if ch == "," and not in_q:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts


def _histogram_quantile(q: float, buckets: list[tuple[float, float]]) -> float | None:
    """PromQL histogram_quantile over cumulative (le, count) buckets.

    ``buckets`` must be sorted by le and include the +Inf bucket last.
    Returns None when the histogram is empty.
    """
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if le == float("inf"):
                return prev_le  # PromQL returns the highest finite bound
            if count == prev_count:
                return le
            return prev_le + (le - prev_le) * (rank - prev_count) / (count - prev_count)
        prev_le, prev_count = le, count
    return buckets[-1][0]


class RouterMetricsSource:
    """``MetricsSource`` over the router's ``/router/metrics`` endpoint.

    In-cluster, Prometheus scrapes the router and the gate runs PromQL
    (reference ``mlflow_operator.py:363-417``).  In local/router mode there
    is no Prometheus; this class keeps a short history of scrapes and
    computes the same six quantities over the requested window from
    histogram deltas — ``rate()``/``increase()`` semantics, including the
    reference's "None means no traffic in the window" convention.
    """

    _CLIENT = "seldon_api_executor_client_requests_seconds"
    _SERVER = "seldon_api_executor_server_requests_seconds"

    def __init__(self, admin: "RouterAdmin"):
        self.admin = admin
        self._snapshots: list[tuple[float, dict]] = []  # (monotonic_t, parsed)
        self._max_window_s = 60.0  # grows to the largest window requested

    def _scrape(self) -> dict:
        now = time.monotonic()
        parsed = parse_prometheus_text(self.admin.metrics_text())
        self._snapshots.append((now, parsed))
        # Keep only what any requested window can reach (plus slack) — the
        # reconciler scrapes several times per second during a canary, and
        # ten minutes of full parsed snapshots would be thousands of dicts.
        cutoff = now - (2.0 * self._max_window_s + 10.0)
        while len(self._snapshots) > 2 and self._snapshots[1][0] < cutoff:
            self._snapshots.pop(0)
        return parsed

    def _baseline(self, window_s: float) -> dict:
        """Newest snapshot at least ``window_s`` old (or empty = since start)."""
        now = time.monotonic()
        base: dict = {}
        for t, snap in self._snapshots[:-1]:
            if now - t >= window_s:
                base = snap
            else:
                break
        return base

    def model_metrics(
        self,
        deployment_name: str,
        predictor_name: str,
        namespace: str,
        window_s: int = 60,
    ):
        from .base import ModelMetrics

        self._max_window_s = max(self._max_window_s, float(window_s))
        current = self._scrape()
        base = self._baseline(window_s)
        ident = {
            ("deployment_name", deployment_name),
            ("predictor_name", predictor_name),
            ("namespace", namespace),
        }

        def delta(name: str, key: str = "code"):
            """(current - base) per label value over series matching identity.

            Clamped at 0 per series: a counter that went BACKWARD means the
            series was reset (predictor removed and re-added, router
            restart) — PromQL's increase() treats that as a reset, and a
            negative count fed to the gate would make error_rate garbage.
            """
            out: dict[str, float] = {}
            for (n, labels), v in current.items():
                if n != name or not ident <= labels:
                    continue
                ld = dict(labels)
                k = ld.get(key, "")
                out[k] = out.get(k, 0.0) + max(0.0, v - base.get((n, labels), 0.0))
            return out

        bucket_deltas = delta(self._CLIENT + "_bucket", key="le")
        buckets = sorted(
            ((float(le), c) for le, c in bucket_deltas.items()),
            key=lambda x: x[0],
        )
        count = delta(self._CLIENT + "_count").get("", 0.0)
        total_sum = delta(self._CLIENT + "_sum").get("", 0.0)

        by_code = delta(self._SERVER + "_count")
        server_total = sum(by_code.values())
        errors = sum(v for code, v in by_code.items() if code != "200")
        # service="feedback" series from the router's own histograms —
        # the count the reference reads at mlflow_operator.py:410-415.
        feedback = delta(self._SERVER + "_count", key="service").get(
            "feedback", 0.0
        )

        return ModelMetrics(
            latency_p95=_histogram_quantile(0.95, buckets),
            error_responses=errors,
            error_rate=(errors / server_total) if server_total > 0 else None,
            latency_avg=(total_sum / count) if count > 0 else None,
            request_count=count,
            feedback_request_count=feedback,
        )


class RouterSync:
    """Push a SeldonDeployment manifest's traffic split into the router.

    In-cluster the manifest's ``traffic`` weights become Istio
    VirtualService weights via Seldon's controller; in local/router mode
    this class is that controller: it maps each predictor to a backend
    address via ``resolve(predictor_name) -> (host, port)`` and PUTs the
    router config.  Weights change on every promotion step; addresses and
    the predictor set change when versions roll.
    """

    def __init__(self, admin: "RouterAdmin", resolve):
        self.admin = admin
        self.resolve = resolve

    def sync_manifest(self, manifest: dict) -> None:
        spec = manifest.get("spec") or {}
        meta = manifest.get("metadata") or {}
        # Fleet trace plane: the builder stamps spec.fleet.observability.
        # journeyRing as a manifest annotation; the sync ALWAYS sends it
        # (absent = 0) so the manifest stays the source of truth — the
        # same keep-survivor trap the role field had (an omitted value
        # would pin a previously-enabled ring on forever after the CR
        # disables it).
        annotations = meta.get("annotations") or {}
        journey_ring = int(
            annotations.get("tpumlops.dev/fleet-journey-ring") or 0
        )
        # Multi-model multiplexing: same always-sent contract as the
        # journey ring (absent = 0) — an omitted toggle would pin a
        # previously-enabled mux mode on forever after the CR disables
        # it.  Per-backend attachments ride tpumlops.dev/mux-model-<name>
        # annotations (the multiplexer stamps them as it executes its
        # attach plan).
        mux_models = int(annotations.get("tpumlops.dev/mux-models") or 0)
        # Router timeseries ring: same always-sent contract (absent = 0)
        # — an omitted size would pin a previously-enabled ring on
        # forever after the CR disables it.
        timeseries_ring = int(
            annotations.get("tpumlops.dev/fleet-timeseries-ring") or 0
        )
        backends = []
        for pred in spec.get("predictors") or []:
            name = pred.get("name")
            weight = int(pred.get("traffic", 0))
            replicas = pred.get("replicas")
            if replicas is not None and int(replicas) == 0:
                # Scale-to-zero: the predictor holds NO capacity, so its
                # traffic share drops to 0 regardless of the split — with
                # every backend at weight 0 the router PARKS incoming
                # requests (or sheds typed 503s past the buffer) instead
                # of dialing a dead address.
                weight = 0
            try:
                host, port = self.resolve(name)
            except Exception:
                if weight > 0:
                    raise
                # Parked predictor with no resolvable replica: keep a
                # placeholder address (never dialed at weight 0) so the
                # backend — and its histograms — survive the park.
                host, port = "127.0.0.1", 9
            entry = {
                "name": name,
                "host": host,
                "port": port,
                "weight": weight,
            }
            # Disaggregated pools: whoever materializes the fleet
            # (tests / a local plane today — an in-cluster controller
            # reading the builder's tpumlops.dev/fleet-* annotations is
            # ROADMAP item 2's open end) stamps the pool role on the
            # predictor entry; the router needs it for ring membership
            # and relay targeting.  ALWAYS sent — to the router an
            # omitted role means "keep the survivor's role", which would
            # pin a backend once tagged prefill out of client traffic
            # forever after disaggregation is turned off.
            entry["role"] = str(pred.get("tpumlopsFleetRole") or "unified")
            if mux_models:
                # Attached-model table (explicit "" = detached): sent
                # ONLY with mux on so the config body — and the router's
                # survivor-keeping "model" semantics — stay byte-for-
                # byte for single-model fleets.
                entry["model"] = str(
                    pred.get("tpumlopsMuxModel")
                    or annotations.get(f"tpumlops.dev/mux-model-{name}")
                    or ""
                )
            backends.append(entry)
        if backends:
            self.admin.set_config(
                backends,
                namespace=meta.get("namespace"),
                deployment=meta.get("name"),
                journey_ring=journey_ring,
                mux_models=mux_models,
                timeseries_ring=timeseries_ring,
            )


class RouterProcess:
    """One supervised router instance.

    >>> with RouterProcess(port=9000, namespace="ns", deployment="bert",
    ...                    backends={"v1": ("127.0.0.1", 8001, 90),
    ...                              "v2": ("127.0.0.1", 8002, 10)}) as r:
    ...     r.admin.set_weights({"v1": 80, "v2": 20})
    """

    def __init__(
        self,
        port: int,
        backends: dict[str, tuple],
        namespace: str = "default",
        deployment: str = "router",
        binary: pathlib.Path | None = None,
        park_buffer: int = 0,
        park_timeout_s: float = 30.0,
        affinity_tokens: int = 0,
        kv_handoff: bool = True,
        handoff_retries: int = 1,
        health_probes: bool = False,
        health_threshold: int = 3,
        probe_interval_s: float = 0.5,
        failover_retries: int = 0,
        journey_ring: int = 0,
        access_log: bool = False,
        mux_models: int = 0,
        timeseries_ring: int = 0,
    ):
        self.port = port
        # Values are (host, port, weight) or (host, port, weight, role)
        # — role in {"unified", "prefill", "decode"} for disaggregated
        # fleets (prefill backends serve KV exports, not client traffic;
        # decode backends join the prefix-affinity ring).
        self.backends = backends
        self.namespace = namespace
        self.deployment = deployment
        self.binary = binary or build_router()
        # Scale-to-zero request parking: hold up to park_buffer requests
        # while no backend has positive weight (0 = old behavior, an
        # immediate 503), releasing them in arrival order when capacity
        # returns; each parked request waits at most park_timeout_s.
        self.park_buffer = int(park_buffer)
        self.park_timeout_s = float(park_timeout_s)
        # Prefix affinity + KV handoff relay: hash the first
        # affinity_tokens prompt ids onto a consistent-hash ring over
        # decode-role backends; cold prompts relay prefill→import→
        # forward, retrying on up to handoff_retries ADDITIONAL prefill
        # replicas after the first export fails before the unified
        # fallback.  0 (default) = old routing byte-for-byte.
        self.affinity_tokens = int(affinity_tokens)
        self.kv_handoff = bool(kv_handoff)
        self.handoff_retries = int(handoff_retries)
        # Failure containment (both default off = old router byte-for-
        # byte).  health_probes: consecutive connect/5xx failures trip a
        # per-backend circuit (ejected from SWRR + the affinity ring)
        # and half-open GET /healthz probes at a capped exponential
        # interval re-admit it.  failover_retries: a request whose
        # upstream dies before any response byte retries on up to N
        # other healthy backends, then sheds a TYPED 503
        # {reason: upstream_failed} — never a bare 502.
        self.health_probes = bool(health_probes)
        self.health_threshold = int(health_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.failover_retries = int(failover_retries)
        # Fleet trace plane (both default off = old router byte-for-
        # byte).  journey_ring: adopt-or-mint X-Request-Id/traceparent,
        # propagate on every leg, keep a bounded JourneyRecord ring
        # served at /router/debug/requests + /router/debug/trace.
        # access_log: one JSON line per completed/shed request on
        # stderr (the server's tpumlops.request contract).  With the log
        # on, stderr goes to a FILE (access_log_path) — a supervised
        # PIPE nobody drains would fill and block the router's event
        # loop mid-request under sustained traffic.
        self.journey_ring = int(journey_ring)
        self.access_log = bool(access_log)
        # Per-backend 1 s history (default off = old router byte-for-
        # byte): leg wall p50/p99 + error/failover/park buckets served
        # at /router/debug/timeseries for the fleet anomaly observatory.
        self.timeseries_ring = int(timeseries_ring)
        # Multi-model multiplexing (default off = old router byte-for-
        # byte): the model id of a POST's /v2/models/<m>/ path joins the
        # routing decision — requests reach only replicas whose attached
        # model (per-backend "model" config key) matches, park per-model
        # otherwise, and the park release awaits the model's attach.
        self.mux_models = int(mux_models)
        self.access_log_path: pathlib.Path | None = None
        self._stderr_file = None
        self.proc: subprocess.Popen | None = None
        self.admin = RouterAdmin(port)

    def start(self, wait_s: float = 5.0) -> "RouterProcess":
        argv = [
            str(self.binary),
            "--port", str(self.port),
            "--namespace", self.namespace,
            "--deployment", self.deployment,
        ]
        if self.park_buffer > 0:
            argv += [
                "--park-buffer", str(self.park_buffer),
                "--park-timeout-s", str(self.park_timeout_s),
            ]
        if self.affinity_tokens > 0:
            argv += [
                "--affinity-tokens", str(self.affinity_tokens),
                "--kv-handoff", "1" if self.kv_handoff else "0",
                "--handoff-retries", str(self.handoff_retries),
            ]
        if self.health_probes:
            argv += [
                "--health-probes", "1",
                "--health-threshold", str(self.health_threshold),
                "--probe-interval-s", str(self.probe_interval_s),
            ]
        if self.failover_retries > 0:
            argv += ["--failover-retries", str(self.failover_retries)]
        if self.journey_ring > 0:
            argv += ["--journey-ring", str(self.journey_ring)]
        if self.timeseries_ring > 0:
            argv += ["--timeseries-ring", str(self.timeseries_ring)]
        if self.access_log:
            argv += ["--access-log", "1"]
        if self.mux_models:
            argv += ["--mux-models", "1"]
        for name, spec in self.backends.items():
            host, port, weight = spec[0], spec[1], spec[2]
            role = spec[3] if len(spec) > 3 else None
            arg = f"{name}={host}:{port}:{weight}"
            if role:
                arg += f":{role}"
            argv += ["--backend", arg]
        if self.access_log:
            import tempfile

            fd, path = tempfile.mkstemp(
                prefix="tpumlops-router-access-", suffix=".log"
            )
            self.access_log_path = pathlib.Path(path)
            self._stderr_file = os.fdopen(fd, "wb")
            stderr_target = self._stderr_file
        else:
            stderr_target = subprocess.PIPE
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=stderr_target
        )
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if self.admin.healthy():
                return self
            if self.proc.poll() is not None:
                if self.proc.stderr is not None:
                    err = self.proc.stderr.read().decode()
                elif self.access_log_path is not None:
                    err = self.access_log_path.read_text()
                else:
                    err = ""
                raise RuntimeError(f"router exited at startup: {err}")
            time.sleep(0.02)
        self.stop()
        raise TimeoutError("router did not become healthy")

    def access_log_lines(self) -> list[dict]:
        """Parsed ``tpumlops.router.access`` JSON lines written so far
        (requires ``access_log=True``)."""
        if self.access_log_path is None or not self.access_log_path.exists():
            return []
        out = []
        for line in self.access_log_path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # startup banner / circuit logs ride stderr too
            if rec.get("logger") == "tpumlops.router.access":
                out.append(rec)
        return out

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            if self.proc.stderr:
                self.proc.stderr.close()
            self.proc = None
        if self._stderr_file is not None:
            self._stderr_file.close()
            self._stderr_file = None
        if self.access_log_path is not None:
            # Temp-file hygiene: repeated test/bench runs must not
            # litter the temp dir (read access_log_lines BEFORE stop).
            import contextlib

            with contextlib.suppress(OSError):
                self.access_log_path.unlink()
            self.access_log_path = None

    def __enter__(self) -> "RouterProcess":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
