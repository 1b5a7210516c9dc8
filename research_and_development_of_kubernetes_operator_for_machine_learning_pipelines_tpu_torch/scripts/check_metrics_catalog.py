"""Metrics-catalog lint for the port's three planes.

The counterpart of the JAX repository's ``scripts/check_metrics_catalog.py``.
``docs/OBSERVABILITY.md`` carries a "Prometheus series catalog": three
tables (Server / Operator / Router) that enumerate every exported family.
The port exports the same families, so the same catalog holds it.  This
gate collects the port's real family inventory from each plane and diffs
it against the parsed tables, failing on EITHER direction
(exported-but-undocumented or documented-but-gone):

- Server: the ``# TYPE`` lines of ``ServerMetrics(device_telemetry=True)``'s
  exposition (``server/metrics.py``; a counter's family is named with its
  ``_total``, as the catalog names it).
- Operator: the same, of ``OperatorTelemetry().exposition()``.
- Router: the ``# TYPE <family> <type>`` exposition lines of the port's
  ``native/router.cc``.

Table cells may name several families (comma- or slash-separated) and use
brace expansion (``tpumlops_prefix_cache_{hits,evictions}_total``); a
trailing ``{label}`` annotation (no comma inside) is stripped.  It reads
files and builds the metric objects only (no card)::

    python -m <port>.scripts.check_metrics_catalog
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
DOC = _PKG_DIR.parent / "docs" / "OBSERVABILITY.md"
ROUTER_CC = _PKG_DIR / "native" / "router.cc"
PLANES = ("server", "operator", "router")

_BRACES = re.compile(r"\{([^{}]*)\}")
_TYPE = re.compile(r"^# TYPE (\S+) \w+$", re.M)


def expand_cell(cell: str) -> set[str]:
    """``cell`` is one backtick-quoted family token from a table row."""
    # Trailing {label} annotation (no comma) is documentation, not a
    # name component; {a,b,c} anywhere is brace expansion.
    names = {cell}
    while True:
        expanded = set()
        again = False
        for name in names:
            m = _BRACES.search(name)
            if m is None:
                expanded.add(name)
            elif "," in m.group(1):
                again = True
                for alt in m.group(1).split(","):
                    expanded.add(name[: m.start()] + alt.strip() + name[m.end():])
            else:
                again = True
                expanded.add(name[: m.start()] + name[m.end():])
        names = expanded
        if not again:
            return names


def doc_families(doc: Path = DOC) -> dict[str, set[str]]:
    """Parse the three catalog tables -> {"server"|"operator"|"router": names}."""
    text = Path(doc).read_text()
    try:
        catalog = text.split("## Prometheus series catalog", 1)[1]
    except IndexError:
        raise SystemExit("metrics-catalog: catalog heading missing from doc")
    out: dict[str, set[str]] = {}
    for plane in PLANES:
        title = plane.capitalize()
        m = re.search(rf"### {title}\b.*?\n(.*?)(?=\n### |\n## |\Z)", catalog, re.S)
        if m is None:
            raise SystemExit(f"metrics-catalog: '### {title}' table missing")
        names: set[str] = set()
        for line in m.group(1).splitlines():
            if not line.startswith("|") or line.startswith("|---"):
                continue
            first = line.split("|")[1]
            if first.strip() == "family":
                continue
            for token in re.findall(r"`([^`]+)`", first):
                names |= expand_cell(token.strip())
        out[plane] = names
    return out


def exposition_families(text: str) -> set[str]:
    """The families an exposition's ``# TYPE`` lines name."""
    return set(_TYPE.findall(text))


def exported_families(router_cc: Path = ROUTER_CC) -> dict[str, set[str]]:
    """Each plane's exported families."""
    from ..operator.telemetry import OperatorTelemetry
    from ..server.metrics import ServerMetrics

    return {
        "server": exposition_families(
            ServerMetrics("d", "p", "ns", device_telemetry=True).render().decode()),
        "operator": exposition_families(OperatorTelemetry().exposition().decode()),
        "router": set(re.findall(r"# TYPE (tpumlops_router_\w+) \w+",
                                 Path(router_cc).read_text())),
    }


def check(doc: Path = DOC, router_cc: Path = ROUTER_CC) -> tuple[list[str], int]:
    """``(problems, families exported)``: each family exported but not in
    ``doc``'s catalog, or in it but not exported."""
    exported = exported_families(router_cc)
    documented = doc_families(doc)
    problems: list[str] = []
    for plane in PLANES:
        for name in sorted(exported[plane] - documented[plane]):
            problems.append(f"{plane}: `{name}` exported but not in the catalog")
        for name in sorted(documented[plane] - exported[plane]):
            problems.append(f"{plane}: `{name}` in the catalog but not exported")
    return problems, sum(len(v) for v in exported.values())


def main(argv=None) -> int:
    problems, total = check()
    if problems:
        print(f"metrics-catalog: OUT OF SYNC with {DOC.name}:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"metrics-catalog: OK ({total} families across 3 planes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
