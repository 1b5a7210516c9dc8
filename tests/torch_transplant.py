"""Run a JAX-package test file's tests against the port.

``transplant(name)`` loads ``tests/<name>.py`` with every import of the JAX
package pointed at the port and, with ``vocabulary=True``, the control
plane's vocabulary mapped as ``torch_operator_map`` maps it (``backend:
tpu`` on ``v5e-N`` is ``backend: cuda`` on ``h100-N``, ``spec.tpu`` is
``spec.cuda``, ``TpuSpec`` is ``CudaSpec``).  ``export`` puts the chosen
tests, and the fixtures they need, into a port test module's namespace,
where pytest collects them with their marks: each such test then holds the
port to the same assertions the JAX package's module is held to.
"""

from __future__ import annotations

import re
import types
from pathlib import Path

PORT = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"
JAX_PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu"
TESTS = Path(__file__).resolve().parent

# The control plane's vocabulary, reference -> port, applied in order.
VOCABULARY = [
    (r'"backend": "tpu"', '"backend": "cuda"'),
    (r"backend=\"tpu\"", 'backend="cuda"'),
    (r"backend: tpu\b", "backend: cuda"),
    (r'"tpu":', '"cuda":'),
    (r"\bTpuSpec\b", "CudaSpec"),
    (r"\bTPU_TOPOLOGIES\b", "GPU_TOPOLOGIES"),
    (r"\btpuTopology\b", "gpuTopology"),
    (r"\bv5e-(\d+)\b", r"h100-\1"),
    (r"\.tpu\b", ".cuda"),
    (r"\btpu=", "cuda="),
    (r"spec\.tpu\b", "spec.cuda"),
]


def transplant(name: str, vocabulary: bool = False, subs=()) -> types.ModuleType:
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\b" + JAX_PKG + r"\.", PORT + ".", src)
    # ``tpumlops`` (the JAX package's alias) only where it is imported: the
    # same word names loggers and annotation keys.
    src = re.sub(r"^(\s*)(from|import) tpumlops\.", rf"\1\2 {PORT}.", src, flags=re.M)
    for a, b in (VOCABULARY if vocabulary else []) + list(subs):
        src = re.sub(a, b, src, flags=re.M)
    mod = types.ModuleType(f"ported_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(src, f"<{name} on the port>", "exec"), mod.__dict__)
    return mod


def _is_fixture(obj) -> bool:
    return any(hasattr(obj, a) for a in ("_pytestfixturefunction", "_fixture_function_marker")) \
        or type(obj).__name__ == "FixtureFunctionDefinition"


def export(mod: types.ModuleType, namespace: dict, names, tag: str = "") -> list[str]:
    """Put ``names`` (tests of ``mod``) and every fixture ``mod`` defines
    into ``namespace``, each test as ``test_<tag>_<rest>`` when ``tag`` is
    given; a name that is not a test of ``mod`` fails."""
    for key, obj in vars(mod).items():
        if _is_fixture(obj):
            namespace[key] = obj
    out = []
    for n in names:
        fn = vars(mod).get(n)
        if not (n.startswith("test_") and callable(fn)):
            raise AssertionError(f"{mod.__name__} has no test {n}")
        key = f"test_{tag}_{n[5:]}" if tag else n
        namespace[key] = fn
        out.append(key)
    return out


def httpx_seam(handler):
    """An ``httpx.MockTransport`` handler as the port clients' transport:
    the request it sees is the one an ``httpx`` client would have built
    from the same method, URL, headers and body."""
    import httpx

    def transport(method, url, headers, body):
        resp = handler(httpx.Request(method, url, headers=dict(headers), content=body))
        resp.read()
        return resp.status_code, dict(resp.headers), resp.content

    return transport


# Reference REST-client tests build ``client._http = httpx.Client(base_url=...,
# transport=httpx.MockTransport(handler))``: the port's client is built with
# that URL and the same handler behind its transport seam instead.
REST_SUBS = [
    (r'(\w+)\._http = httpx\.Client\(\s*base_url="([^"]+)",\s*'
     r'transport=httpx\.MockTransport\((\w+)\)\s*\)',
     r'\1.__init__("\2", transport=_seam(\3))'),
    (r"\._http\.headers\b", ".headers"),
    (r"^import httpx$", "import httpx\nfrom torch_transplant import httpx_seam as _seam"),
]
