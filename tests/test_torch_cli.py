"""The port's repo-root CLIs and their helpers against the JAX package's.

- ``quantized_bytes``, ``count_params`` and ``cost_from_analysis`` give the
  reference's integers on the reference tests' own inputs (the last on a
  JAX compiled object's ``cost_analysis()``).
- ``scripts/gen_7b_checkpoint``: at a tiny geometry its ``params.npz`` is
  the reference generator's (its code run here, where ``ml_dtypes``
  exists) byte for byte, and the JAX package's loader reads it.
- ``scripts/rehearse_7b_load`` on that artifact on the CPU: int8 leaves
  equal to the JAX loader's (a scale may sit one f32 ulp away, ROADMAP C,
  and then a code one step), greedy tokens equal to the JAX ``prefill`` +
  ``decode_ragged`` chain in f32 on the same int8 tree.
- ``scripts/rehearse_tp8_dryrun`` as a gloo world of 8 at 8 heads: each
  rank's blocks (checked in the ranks), its logits against the JAX
  script's path on the 8 CPU devices of ``tests/conftest.py``.
- ``scripts/plan``: ``--expect tests/fixtures/journey_plan_h100.json``
  exits 0, and with v5e peaks its output is the reference CLI's.
- ``scripts/check_metrics_catalog`` passes, and fails on a doctored copy
  of the doc in each direction.
- ``scripts/stitch_trace`` on two in-process sources writes what the
  reference tool writes.
"""

from __future__ import annotations

import http.server
import importlib.util
import json
import re
import sys
import threading
import time
from importlib import import_module
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_transplant as TT
from tpumlops.models import common as JCOMMON
from tpumlops.models import llama as J
from tpumlops.models import quantization as JQ
from tpumlops.models import resnet as JRESNET
from tpumlops.server import device_telemetry as JDT
from tpumlops.server import loader as JLOADER

ROOT = Path(__file__).resolve().parents[1]
PORT = TT.PORT
PQ = import_module(f"{PORT}.models.quantization")
PCOMMON = import_module(f"{PORT}.models.common")
PCONVERT = import_module(f"{PORT}.convert")
PRESNET = import_module(f"{PORT}.models.resnet")
PDT = import_module(f"{PORT}.server.device_telemetry")
PLLAMA = import_module(f"{PORT}.models.llama")
GEN = import_module(f"{PORT}.scripts.gen_7b_checkpoint")
REHEARSE = import_module(f"{PORT}.scripts.rehearse_7b_load")
DRY = import_module(f"{PORT}.scripts.rehearse_tp8_dryrun")
PLAN = import_module(f"{PORT}.scripts.plan")
CATALOG = import_module(f"{PORT}.scripts.check_metrics_catalog")
STITCH = import_module(f"{PORT}.scripts.stitch_trace")

# A tiny geometry of the 7B artifact's leaves (8 heads, so tp 8 splits it).
TINY = dict(hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=8, intermediate_size=128,
            vocab_size=256, max_seq=64)
TINY_WINDOW = 32  # the rehearsal's decode window at TINY's max_seq
# tp 8 against the JAX script's path, f32 logits: the same int8 tree up to
# a scale one f32 ulp apart (ROADMAP C) and sums in another order.
TP8_TOL = dict(rtol=1e-4, atol=1e-5)


def _numpy(tree):
    """A port tree as numpy, for the JAX side (bfloat16 leaves as f32)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()


def _script(name: str):
    """The reference repository's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the helpers -----------------------------------------------------------------


def test_quantized_bytes_is_the_references_on_its_inputs():
    w = jax.random.normal(jax.random.key(0), (4, 64, 128), jnp.float32) * 0.02
    jq = JQ.quantize_tensor(w)
    pq = PQ.quantize_tensor(torch.from_numpy(np.array(w)))
    assert PQ.quantized_bytes(pq) == JQ.quantized_bytes(jq) == 4 * 64 * 128 + 4 * 128 * 4
    jp = J.init(jax.random.key(0), J.LlamaConfig.tiny(max_seq=32), dtype=jnp.float32)
    tree = PCONVERT.from_jax_numpy(jax.device_get(jp))
    assert PQ.quantized_bytes(PQ.quantize_llama(tree)) == JQ.quantized_bytes(JQ.quantize_llama(jp))
    assert PQ.quantized_bytes(tree) == JQ.quantized_bytes(jp)


def test_quantize_stacked_is_quantize_tensor_bit_for_bit():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 16, 8), np.float32))
    a, b = PQ.quantize_tensor(w), PQ.quantize_stacked(w)
    assert torch.equal(a["q8"], b["q8"]) and torch.equal(a["scale"], b["scale"])


def test_count_params_is_the_references_on_resnet50():
    jp = JRESNET.init(jax.random.key(0), JRESNET.ResNetConfig.resnet50())
    pp = PRESNET.init(torch.Generator().manual_seed(0), PRESNET.ResNetConfig.resnet50())
    n = PCOMMON.count_params(pp)
    assert n == JCOMMON.count_params(jp)
    assert 25_000_000 < n < 26_000_000


@pytest.mark.parametrize("payload", [
    {"flops": 123.0, "bytes accessed": 456.0, "utilization0{}": 1.0},
    [{"flops": 123.0, "bytes accessed": 456.0}],
    {}, None, [], {"flops": 0.0}, ({"bytes accessed": 8.0},),
], ids=["dict", "one-item list", "empty dict", "none", "empty list", "zero", "tuple"])
def test_cost_from_analysis_parses_what_the_reference_parses(payload):
    assert PDT.cost_from_analysis(payload) == JDT.cost_from_analysis(payload)


def test_cost_from_analysis_reads_a_compiled_programs_analysis():
    x = jnp.ones((4, 64), jnp.float32)
    w = jnp.ones((64, 256), jnp.float32)
    analysis = jax.jit(lambda a, b: a @ b).lower(x, w).compile().cost_analysis()
    got = PDT.cost_from_analysis(analysis)
    assert got is not None and got == JDT.cost_from_analysis(analysis)
    assert got[0] == pytest.approx(2 * 4 * 64 * 256, rel=0.01)


# -- the 7B artifact and its rehearsal ------------------------------------------------


def _reference_generator(out: Path) -> None:
    """The reference ``scripts/gen_7b_checkpoint.py`` run here at TINY: its
    source with the geometry line and the output path replaced."""
    src = (ROOT / "scripts" / "gen_7b_checkpoint.py").read_text()
    geometry = re.compile(r"^H, L, NH, NKV, INTER, VOCAB, SEQ = .*$", re.M)
    assert geometry.search(src) and src.count('"/root/ckpt7b"') == 2
    g = TINY
    src = geometry.sub(f"H, L, NH, NKV, INTER, VOCAB, SEQ = {g['hidden_size']}, "
                       f"{g['num_layers']}, {g['num_heads']}, {g['num_kv_heads']}, "
                       f"{g['intermediate_size']}, {g['vocab_size']}, 4096", src)
    src = src.replace('"/root/ckpt7b"', repr(str(out))).replace('"max_seq": 1024',
                                                                 f'"max_seq": {g["max_seq"]}')
    exec(compile(src, "gen_7b_checkpoint.py", "exec"), {"__name__": "ref_gen"})


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The port's and the reference's tiny artifacts, each written under one
    frozen clock (a zip member's header carries its write time)."""
    tmp = tmp_path_factory.mktemp("gen")
    frozen = time.localtime(0)
    real = time.localtime
    time.localtime = lambda *a: frozen
    try:
        nbytes = GEN.write_checkpoint(tmp / "port", GEN.synthetic_params(TINY), TINY)
        _reference_generator(tmp / "ref")
    finally:
        time.localtime = real
    return tmp / "port", tmp / "ref", nbytes


def test_the_generator_writes_the_references_artifact_byte_for_byte(artifacts):
    port, ref, nbytes = artifacts
    data = (port / "params.npz").read_bytes()
    assert data == (ref / "params.npz").read_bytes() and len(data) == nbytes
    assert (json.loads((port / "config.json").read_text())
            == json.loads((ref / "config.json").read_text()))
    assert (port / "MLmodel").read_text() == (ref / "MLmodel").read_text()


def test_the_generators_bf16_rounding_is_ml_dtypes():
    import ml_dtypes

    x = np.random.default_rng(3).standard_normal(1 << 16, np.float32) * 0.02
    x[:4] = [1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 2**-130]  # ties to even, a subnormal
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(got, x.astype(ml_dtypes.bfloat16).view(np.int16))


@pytest.fixture(scope="module")
def jax_loaded(artifacts):
    """The JAX package's int8 load of the port's artifact, as the
    reference's rehearsal loads it."""
    pred = JLOADER.load_predictor(str(artifacts[0]), quantize="int8")
    return jax.device_get(pred.causal_lm["params"]), pred.causal_lm["cfg"]


def test_the_rehearsal_loads_the_jax_loaders_int8_tree(artifacts, jax_loaded):
    # bf16, the rehearsal's serving type: the JAX loader keeps the stored bf16.
    out = REHEARSE.rehearse(artifacts[0], "cpu", window=TINY_WINDOW, log=lambda m: None)
    got = _numpy(out["predictor"].causal_lm["params"])
    want, _ = jax_loaded
    assert out["stored_bytes"] == JQ.quantized_bytes(want)
    for name in (*PQ._LLAMA_LAYER_MATS, "lm_head"):
        g = got[name] if name == "lm_head" else got["layers"][name]
        w = want[name] if name == "lm_head" else want["layers"][name]
        scale_w = np.asarray(w["scale"], np.float32)
        np.testing.assert_array_max_ulp(g["scale"], scale_w, maxulp=1)
        assert np.abs(g["q8"].astype(int) - np.asarray(w["q8"]).astype(int)).max() <= 1, name
    assert {"disk_s", "transfer_s", "quantize_s", "read_gib"} <= set(out["load_stats"])
    assert out["loaded"]["peak"] is None  # no card: "not measured"


def test_the_rehearsals_tokens_are_the_jax_chains(artifacts, jax_loaded):
    out = REHEARSE.rehearse(artifacts[0], "cpu", dtype=torch.float32, window=TINY_WINDOW,
                            log=lambda m: None)
    params = jax.tree.map(jnp.asarray, _numpy(out["predictor"].causal_lm["params"]))
    _, cfg = jax_loaded
    cache = J.RaggedKVCache.create(cfg, 1, jnp.float32)
    ids = jnp.ones((1, REHEARSE.PROMPT), jnp.int32)
    logits, seq = J.prefill(params, ids, cfg, dtype=jnp.float32)
    cache = J.insert_sequence(cache, seq, jnp.int32(0), jnp.int32(REHEARSE.PROMPT))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    tokens = [int(tok[0, 0])]
    for _ in range(REHEARSE.STEPS):
        logits, cache = J.decode_ragged(params, tok, cache, cfg, window=TINY_WINDOW,
                                        dtype=jnp.float32)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tokens.append(int(tok[0, 0]))
    assert out["tokens"] == tokens
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(logits), rtol=2e-5, atol=2e-6)


# -- the tp-8 dry run ---------------------------------------------------------------


def test_the_tp8_dry_run_holds_blocks_and_the_jax_scripts_logits(tmp_path):
    cfg = J.LlamaConfig(**{**TINY, "max_seq": 32})
    art = JLOADER.save_native_model(
        tmp_path / "llm2l", "llama-generate", J.init(jax.random.key(0), cfg, dtype=jnp.float32),
        config={**TINY, "max_seq": 32})
    res = DRY.dryrun(art, "cpu", torch.float32, timeout=120)
    assert [r["rank"] for r in res["ranks"]] == list(range(8))
    for r in res["ranks"]:
        assert r["backend"] == "gloo" and len(r["blocks"]) == 8
        assert r["blocks"][0] == "layers|q (2, 64, 8) of (2, 64, 64)"
        assert r["blocks"][3] == "layers|o (2, 8, 64) of (2, 64, 64)"
    # The JAX script's path: the sharded int8 load on the 8 CPU devices.
    pred = JLOADER.load_predictor(str(art), mesh_shape={"tp": 8}, quantize="int8")
    p = pred.causal_lm["params"]
    assert not p["layers"]["q"]["q8"].sharding.is_fully_replicated
    want, _ = J.prefill(p, jnp.ones((1, DRY.PROMPT), jnp.int32), pred.causal_lm["cfg"],
                        dtype=jnp.float32)
    np.testing.assert_allclose(res["logits"].numpy(), np.asarray(want), **TP8_TOL)


def test_the_tp8_dry_run_fails_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match="tp-8 dry run: rank"):
        DRY.dryrun(tmp_path / "missing", "cpu", torch.float32, timeout=120)


# -- plan ---------------------------------------------------------------------------


def test_plan_meets_its_h100_contract(capsys):
    assert PLAN.main(["--dry-run", "--expect", "tests/fixtures/journey_plan_h100.json"]) == 0
    assert "plan-contract OK" in capsys.readouterr().err


def test_plan_with_v5e_peaks_prints_the_reference_clis_plan(monkeypatch, capsys):
    from test_torch_planner import V5E

    monkeypatch.setattr(import_module(f"{PORT}.operator.planner"), "detect_peaks", lambda: V5E)
    assert PLAN.main(["--dry-run", "--objective-ttft-p99-ms", "250"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["plan.py", "--dry-run", "--expect",
                                      "tests/fixtures/journey_plan.json"])
    assert _script("plan").main() == 0
    assert port == capsys.readouterr().out


def test_plan_refuses_a_bad_trace_typed(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"requests": [{"no": "arrival"}]}))
    assert PLAN.main(["--trace", str(bad)]) == 2
    assert capsys.readouterr().err.startswith("plan: ")


# -- the metrics catalog -------------------------------------------------------------


def test_the_catalog_holds_the_ports_three_planes(capsys):
    assert CATALOG.main() == 0
    assert "OK (88 families across 3 planes)" in capsys.readouterr().out


@pytest.mark.parametrize("edit", ["dropped", "added"])
def test_a_doctored_catalog_fails_in_each_direction(tmp_path, edit):
    text = CATALOG.DOC.read_text()
    row = next(line for line in text.splitlines()
               if line.startswith("| `tpumlops_model_ready`"))
    if edit == "dropped":
        doc, want = text.replace(row + "\n", ""), ("exported but not in the catalog",
                                                  "tpumlops_model_ready")
    else:
        doc, want = (text.replace(row, row + "\n| `tpumlops_not_exported_total` | x |"),
                     ("in the catalog but not exported", "tpumlops_not_exported_total"))
    (tmp_path / "OBSERVABILITY.md").write_text(doc)
    problems, _ = CATALOG.check(tmp_path / "OBSERVABILITY.md")
    assert len(problems) == 1 and all(w in problems[0] for w in want), problems
    assert problems[0].startswith("server: ")


# -- stitch_trace -------------------------------------------------------------------


def _source(kind: str, anchor: float, rid: str):
    """An in-process component serving a Chrome trace with its anchor."""
    path = "/router/debug/trace" if kind == "router" else "/debug/trace"
    doc = {"started_unix": anchor, "traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 7, "tid": 0, "args": {"name": kind}},
        {"name": "request", "ph": "b", "ts": 100, "pid": 7, "tid": 1, "id": rid,
         "cat": "request"},
        {"name": "request", "ph": "e", "ts": 900, "pid": 7, "tid": 1, "id": rid,
         "cat": "request"},
        {"name": "tick", "ph": "X", "ts": 300, "dur": 50, "pid": 7, "tid": 2,
         "args": {"request_id": "other"}}]}
    body = json.dumps(doc).encode()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            ok = self.path.split("?")[0] == path
            self.send_response(200 if ok else 404)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body if ok else b"{}")

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.mark.parametrize("request_id", [None, "r-1"])
def test_stitch_trace_writes_the_reference_tools_trace(tmp_path, monkeypatch, request_id):
    router, rurl = _source("router", 1000.0, "r-1")
    replica, purl = _source("replica", 1000.25, "r-1")
    try:
        args = ["--router", rurl, "--replica", purl]
        if request_id:
            args += ["--request-id", request_id]
        assert STITCH.main(args + ["-o", str(tmp_path / "port.json")]) == 0
        assert _script("stitch_trace").main(args + ["-o", str(tmp_path / "ref.json")]) == 0
    finally:
        router.shutdown()
        replica.shutdown()
    got = (tmp_path / "port.json").read_text()
    assert got == (tmp_path / "ref.json").read_text()
    events = json.loads(got)["traceEvents"]
    assert {e["pid"] for e in events} == {1, 2}
    assert [e["ts"] for e in events if e.get("id") == "r-1" and e["pid"] == 2] == [250100,
                                                                                   250900]
