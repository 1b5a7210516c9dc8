"""Fleet anomaly observatory: peer straggler detection + baseline drift
(the port's copy of the JAX package's ``operator/anomaly.py``; the ring
fetch is ``urllib``).

The rings (``server/timeseries.py``, the router's ``--timeseries-ring``)
give every replica a short-horizon per-second history; this module is
the pure logic that turns a FLEET of those histories into verdicts:

- **Straggler** — one replica's window statistic (mean ITL p99, mean
  router leg wall, queue-depth slope, …) is a robust outlier against its
  same-pool peers.  Outliers are scored with the median/MAD modified
  z-score (Iglewicz & Hoaglin): ``z = 0.6745 · (x − median) / MAD``,
  falling back to the mean absolute deviation (scale 1.2533) when MAD
  collapses to zero (e.g. two identical healthy peers + one outlier).
  A series is only compared when **at least** ``spec.anomaly.minPeers``
  replicas report it — the MAD of a pair is degenerate, so small fleets
  produce NO verdict rather than a noisy one.
- **Drift** — a replica's current window has moved more than
  ``spec.anomaly.driftPct`` percent away from its own post-warmup /
  post-attach baseline (the ring's lifecycle marks anchor the baseline
  window), catching a slow degradation every peer shares — which peer
  comparison is structurally blind to.

:func:`detect` is a pure function of (windows, spec, baselines) — same
division of labor as ``autoscaler.decide`` and ``multiplexer.plan``; the
reconciler's ``_anomaly_step`` owns the I/O (ring snapshots in, journal
records + status out).  The window/baseline extraction helpers
(:func:`replica_series`, :func:`router_series`, :func:`baseline_of`)
keep detect() generic over NAMED series: server-side ITL and router-side
leg latency are just two series names, so proxy-visible slowness (a
``ChaosProxy inject_slow`` replica whose own server-side ITL looks
healthy) is caught by exactly the same code path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from .rollout_recorder import _iso

# Modified z-score scale factors: 0.6745 ≈ Φ⁻¹(0.75) makes the MAD a
# consistent σ estimator for normal data; 1.2533 ≈ √(π/2) does the same
# for the mean absolute deviation (the MAD-zero fallback).
MAD_SCALE = 0.6745
MEANAD_SCALE = 1.253314

# Named series (replica_series emits them from a server ring snapshot).
# Kept as a tuple so the catalog in docs/OBSERVABILITY.md and the tests
# can pin the vocabulary.
SERVER_SERIES = (
    "itl_p50_ms",
    "itl_p99_ms",
    "mfu",
    "hbm_bw_util",
    "queue_depth",
    "queue_depth_slope",
    "active_slots",
    "shed",
    "poison",
)
ROUTER_SERIES = (
    "router_leg_p50_ms",
    "router_leg_p99_ms",
    "router_errors",
    "router_failovers",
)


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    if n % 2:
        return float(s[mid])
    return (s[mid - 1] + s[mid]) / 2.0


def robust_z(x: float, peers: Sequence[float]) -> "float | None":
    """Modified z-score of ``x`` against ``peers`` (x included).

    MAD-based; falls back to the mean absolute deviation when MAD is 0
    (a single outlier among otherwise-identical peers would otherwise
    be unscorable).  None when every deviation is zero — identical
    values have no outlier."""
    med = _median(peers)
    devs = [abs(v - med) for v in peers]
    mad = _median(devs)
    if mad > 0:
        return MAD_SCALE * (x - med) / mad
    mean_ad = sum(devs) / len(devs)
    if mean_ad > 0:
        return (x - med) / (MEANAD_SCALE * mean_ad)
    return None


def slope(samples: Sequence[float]) -> float:
    """Least-squares slope per sample step (the queue-growth signal:
    a replica whose queue RISES while its peers' hold flat is falling
    behind even if its absolute depth still looks ordinary)."""
    n = len(samples)
    if n < 2:
        return 0.0
    mean_x = (n - 1) / 2.0
    mean_y = sum(samples) / n
    num = sum((i - mean_x) * (y - mean_y) for i, y in enumerate(samples))
    den = sum((i - mean_x) ** 2 for i in range(n))
    return num / den if den else 0.0


@dataclass(frozen=True)
class AnomalyVerdict:
    """One replica flagged on one series."""

    replica: str
    kind: str  # "straggler" | "drift"
    series: str
    value: float  # the replica's window statistic
    direction: str  # "high" | "low" (relative to peers / baseline)
    z: "float | None" = None  # straggler: modified z-score
    peer_median: "float | None" = None  # straggler: the fleet's median
    peers: int = 0  # straggler: replicas compared (incl. this one)
    baseline: "float | None" = None  # drift: the anchored baseline
    drift_pct: "float | None" = None  # drift: observed deviation (%)

    @property
    def shape(self) -> tuple:
        """Dedupe key: WHICH replica is anomalous on WHICH series in
        WHICH direction — never the live statistics, which jitter every
        poll and would defeat the dedupe exactly when it matters (same
        contract as the PromotionHold rate limiter)."""
        return (self.replica, self.kind, self.series, self.direction)

    def as_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "replica": self.replica,
            "kind": self.kind,
            "series": self.series,
            "value": round(self.value, 4),
            "direction": self.direction,
        }
        if self.z is not None:
            out["z"] = round(self.z, 2)
        if self.peer_median is not None:
            out["peerMedian"] = round(self.peer_median, 4)
        if self.peers:
            out["peers"] = self.peers
        if self.baseline is not None:
            out["baseline"] = round(self.baseline, 4)
        if self.drift_pct is not None:
            out["driftPct"] = round(self.drift_pct, 1)
        return out


@dataclass(frozen=True)
class AnomalyRecord:
    """One verdict-set transition, journaled beside gate/scale/mux
    records (``kind: "anomaly"``)."""

    wall: float
    action: str  # "detected" | "cleared"
    verdicts: tuple = ()  # AnomalyVerdicts active after this transition
    replicas: int = 0  # fleet size the detector saw

    def as_dict(self) -> dict[str, Any]:
        return {
            "kind": "anomaly",
            "ts": self.wall,
            "time": _iso(self.wall),
            "action": self.action,
            "replicas": self.replicas,
            "verdicts": [v.as_dict() for v in self.verdicts],
        }


def detect(
    windows: Mapping[str, Mapping[str, Sequence[float]]],
    spec,
    baselines: "Mapping[str, Mapping[str, float]] | None" = None,
) -> tuple:
    """Pure detection pass over one fleet observation.

    ``windows`` maps replica → series name → window samples (what the
    extraction helpers below produce from ring snapshots).  ``spec`` is
    an ``AnomalySpec``; ``baselines`` maps replica → series → anchored
    baseline mean (drift is skipped for replicas/series without one, and
    entirely when ``spec.drift_pct`` is 0).

    Returns a deterministically-ordered tuple of verdicts: straggler
    verdicts first (by replica, series), then drift."""
    stats: dict[str, dict[str, float]] = {}
    for replica, series_map in windows.items():
        for series, samples in series_map.items():
            vals = [float(v) for v in samples if v is not None]
            if not vals:
                continue
            stats.setdefault(series, {})[replica] = sum(vals) / len(vals)

    verdicts: list[AnomalyVerdict] = []
    for series in sorted(stats):
        by_replica = stats[series]
        if len(by_replica) < spec.min_peers:
            continue  # hard no-verdict: a tiny peer set cannot vote
        peers = list(by_replica.values())
        med = _median(peers)
        for replica in sorted(by_replica):
            x = by_replica[replica]
            z = robust_z(x, peers)
            if z is None or abs(z) <= spec.mad_threshold:
                continue
            verdicts.append(
                AnomalyVerdict(
                    replica=replica,
                    kind="straggler",
                    series=series,
                    value=x,
                    direction="high" if x > med else "low",
                    z=z,
                    peer_median=med,
                    peers=len(peers),
                )
            )

    if spec.drift_pct > 0 and baselines:
        for replica in sorted(windows):
            base_map = baselines.get(replica) or {}
            for series in sorted(windows[replica]):
                base = base_map.get(series)
                cur = stats.get(series, {}).get(replica)
                if base is None or cur is None or base == 0:
                    continue
                pct = (cur - base) / abs(base) * 100.0
                if abs(pct) <= spec.drift_pct:
                    continue
                verdicts.append(
                    AnomalyVerdict(
                        replica=replica,
                        kind="drift",
                        series=series,
                        value=cur,
                        direction="high" if pct > 0 else "low",
                        baseline=base,
                        drift_pct=pct,
                    )
                )
    return tuple(verdicts)


# -- window / baseline extraction from ring snapshots -----------------------


def _window(samples: Sequence[Mapping], window_s: int) -> list:
    """Trailing ``window_s`` FINALIZED buckets (the open bucket is a
    partial second — including it would bias every rate downward)."""
    closed = [s for s in samples if not s.get("open")]
    return closed[-window_s:]


def replica_series(
    snapshot: Mapping, window_s: int
) -> dict[str, list]:
    """Named series from one server ``/debug/timeseries`` snapshot.

    Missing facets (no ITL this second, device telemetry off) are simply
    absent from that second's contribution — detect() works on what the
    fleet actually reports."""
    out: dict[str, list] = {}

    def push(series: str, value) -> None:
        if value is not None:
            out.setdefault(series, []).append(float(value))

    for s in _window(list(snapshot.get("samples") or ()), window_s):
        itl = s.get("itl") or {}
        if itl.get("n"):
            push("itl_p50_ms", itl.get("p50_ms"))
            push("itl_p99_ms", itl.get("p99_ms"))
        push("mfu", s.get("mfu"))
        push("hbm_bw_util", s.get("hbm_bw_util"))
        push("queue_depth", s.get("queue_depth"))
        push("active_slots", s.get("active_slots"))
        push("shed", s.get("shed"))
        push("poison", s.get("poison"))
    if "queue_depth" in out:
        out["queue_depth_slope"] = [slope(out["queue_depth"])]
    return out


def router_series(
    snapshot: Mapping, window_s: int
) -> dict[str, dict[str, list]]:
    """Per-backend named series from one ``/router/debug/timeseries``
    snapshot — keyed by backend (= replica/predictor) name, so they
    merge straight into the same fleet window map as the server series."""
    out: dict[str, dict[str, list]] = {}
    for name, ring in (snapshot.get("backends") or {}).items():
        series: dict[str, list] = {}
        for s in _window(list(ring.get("samples") or ()), window_s):
            if s.get("n"):
                series.setdefault("router_leg_p50_ms", []).append(
                    float(s.get("p50_ms") or 0.0)
                )
                series.setdefault("router_leg_p99_ms", []).append(
                    float(s.get("p99_ms") or 0.0)
                )
            series.setdefault("router_errors", []).append(
                float(s.get("errors") or 0)
            )
            series.setdefault("router_failovers", []).append(
                float(s.get("failovers") or 0)
            )
        if series:
            out[name] = series
    return out


def ring_sources_from(sources, timeout_s: float = 5.0):
    """Adapt a fleet trace-source list — or a zero-arg callable
    returning one (``[{"name", "base_url", "kind":
    "router"|"replica"}, ...]``, the ``--fleet-trace-sources`` shape) —
    into the reconciler's ``ring_sources`` seam: fetch every replica's
    ``/debug/timeseries`` and the router's ``/router/debug/timeseries``.
    A source with its ring disabled (404) or unreachable is simply
    absent from the observation; detect()'s min-peers gate handles the
    thinned fleet.  The ONLY I/O in this module — everything above
    stays pure."""
    import json as _json
    import urllib.request

    def _get(url: str):
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return _json.loads(resp.read().decode())

    def fetch() -> dict:
        specs = sources() if callable(sources) else sources
        out: dict = {"replicas": {}, "router": None}
        for spec in specs:
            base = str(spec.get("base_url") or "").rstrip("/")
            kind = spec.get("kind") or "replica"
            name = spec.get("name") or base
            try:
                if kind == "router":
                    out["router"] = _get(base + "/router/debug/timeseries")
                else:
                    out["replicas"][name] = _get(base + "/debug/timeseries")
            except Exception:
                continue
        return out

    return fetch


def baseline_of(snapshot: Mapping, baseline_s: int) -> dict[str, float]:
    """Anchored baseline from one server ring snapshot: the mean of each
    series over the ``baseline_s`` buckets FOLLOWING the newest
    lifecycle mark ("warmup" / "attach").  Empty when the ring carries
    no mark (nothing to anchor on) or no post-mark samples yet."""
    samples = [
        s for s in (snapshot.get("samples") or ()) if not s.get("open")
    ]
    mark_idx = None
    for i, s in enumerate(samples):
        if s.get("marks"):
            mark_idx = i
    if mark_idx is None:
        return {}
    window = samples[mark_idx : mark_idx + baseline_s]
    fake = {"samples": window}
    series = replica_series(fake, baseline_s)
    return {
        name: sum(vals) / len(vals)
        for name, vals in series.items()
        if vals and name != "queue_depth_slope"
    }
