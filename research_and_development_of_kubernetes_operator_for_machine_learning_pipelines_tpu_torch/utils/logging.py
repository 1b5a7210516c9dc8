"""Logging helpers (port of the JAX package's ``utils/logging.py``;
standard library only).

One child logger per model resource, named ``tpumlops.<namespace>.<name>``,
prefixes its messages with ``[namespace/name]`` (``model_logger``).

``configure(json_format=True)`` (the server's ``--log-format json``)
switches every line to one JSON object: ``ts`` (UTC, milliseconds),
``level``, ``logger``, ``message``, and ``request_id`` when the record
carries one (``extra={"request_id": ...}``), so the per-request completion
lines parse without a regex.
"""

from __future__ import annotations

import json
import logging


class _PrefixAdapter(logging.LoggerAdapter):
    """Per-resource adapter: the ``[ns/name]`` prefix (with the observed
    ``metadata.generation`` once set), and namespace / name / generation
    as record attributes, which :class:`JsonFormatter` renders as fields."""

    def process(self, msg, kwargs):
        # cr_-prefixed on the record: "name" is a reserved LogRecord
        # attribute (logging refuses it in extra).
        extra = dict(kwargs.get("extra") or {})
        extra.setdefault("cr_namespace", self.extra["namespace"])
        extra.setdefault("cr_name", self.extra["name"])
        generation = self.extra.get("generation")
        prefix = self.extra["resource"]
        if generation is not None:
            extra.setdefault("cr_generation", generation)
            prefix = f"[{self.extra['namespace']}/{self.extra['name']} gen={generation}]"
        kwargs["extra"] = extra
        return f"{prefix} {msg}", kwargs

    def set_generation(self, generation) -> None:
        """Stamp the resource generation the current step observed."""
        self.extra["generation"] = generation


def model_logger(name: str, namespace: str) -> logging.LoggerAdapter:
    """Per-resource logger with the ``[ns/name]`` message prefix."""
    base = logging.getLogger(f"tpumlops.{namespace}.{name}")
    return _PrefixAdapter(base, {"resource": f"[{namespace}/{name}]", "namespace": namespace,
                                 "name": name, "generation": None})


class JsonFormatter(logging.Formatter):
    """One JSON object a line; ``request_id`` rides along when present."""

    def format(self, record: logging.LogRecord) -> str:
        from datetime import datetime, timezone

        # UTC with milliseconds and an explicit offset: whole local seconds
        # cannot order two lines of one burst, and offset-less stamps from
        # hosts in different zones do not merge.
        ts = datetime.fromtimestamp(record.created, timezone.utc).isoformat(
            timespec="milliseconds")
        out = {
            "ts": ts,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        request_id = getattr(record, "request_id", None)
        if request_id:
            out["request_id"] = str(request_id)
        for attr, key in (("cr_namespace", "namespace"), ("cr_name", "name"),
                          ("cr_generation", "generation")):
            value = getattr(record, attr, None)
            if value is not None:
                out[key] = value
        if record.exc_info:
            out["exc_info"] = self.formatException(record.exc_info)
        # default=str: an extra that JSON cannot encode degrades to its
        # repr, never raises inside logging.
        return json.dumps(out, default=str)


def configure(level: int = logging.INFO, json_format: bool = False) -> None:
    if json_format:
        handler = logging.StreamHandler()
        handler.setFormatter(JsonFormatter())
        logging.basicConfig(level=level, handlers=[handler], force=True)
        return
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
