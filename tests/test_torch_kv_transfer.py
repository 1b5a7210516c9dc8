"""The port's KV handoff against the JAX package, on the CPU (tiny Llama,
f64 unless a test says otherwise).  Counterpart: ``tests/test_kv_transfer.py``.

- The wire format's cases of the reference (round trip, corruption,
  truncation, aliased offsets, a shape that the byte count does not fit,
  mismatched geometry, bfloat16) against the port's ``kv_transfer``; the
  reference's and the port's ``serialize_chunks`` give the same bytes for
  the same chunks (f32, f64, bf16), and each package reads the other's blob;
  the port never imports ``ml_dtypes`` (hidden from ``sys.modules``).
- Engine to engine: a port engine prefills, exports, and a second port
  engine imports and decodes exactly the JAX ``generate_greedy`` tokens,
  recomputing only the suffix; the int8kv round trip; the L2 re-seed; a JAX
  engine exporting to a port engine and the reverse, each equal to the
  exporter's own greedy tokens; an import the cache cannot hold whole stops
  at the chunk it drops; an import that evicts a preempted sequence's
  chunks while it waits, whose restore then seeds from its own copies (no
  token recomputed, none changed).
- Served: an export and an import between a prefill and a decode port
  server, the relayed request's handoff stamp and the ``kv-import`` tick on
  ``/debug/engine``; 400 on a corrupt blob and a short prompt, 409 on a
  mismatched geometry or dtype and without the prefix cache; the
  ``--fleet-role`` flag.
"""

import http.client
import json
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    kv_transfer as tkv,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    snapshot as tsnap,
)
from tpumlops.models import llama as J
from tpumlops.server import generation as JG
from tpumlops.server import kv_transfer as jkv
from tpumlops.server import prefix_cache as jpc

JCFG = J.LlamaConfig.tiny(max_seq=64)
TCFG = T.LlamaConfig.tiny(max_seq=64)
PROMPT = list(range(2, 22))  # 20 tokens; C = 8 -> a handoff covers 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the wire format -----------------------------------------------------------


def _chunk_pair(seed: int, shape=(2, 1, 4, 2, 3), dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=torch.float64).to(dtype),
            torch.randn(shape, generator=g, dtype=torch.float64).to(dtype))


def _blob(n_chunks=2, C=4):
    prompt = np.arange(1, n_chunks * C + 2, dtype=np.int32)
    chunks = [_chunk_pair(i) for i in range(n_chunks)]
    return prompt, chunks, tkv.serialize_chunks(C, prompt, chunks)


def _reheader(blob: bytes, edit) -> bytes:
    head_len = int.from_bytes(blob[6:14], "little")
    header = json.loads(blob[14:14 + head_len])
    edit(header)
    head2 = json.dumps(header).encode()
    return tkv.MAGIC + len(head2).to_bytes(8, "little") + head2 + blob[14 + head_len:]


def test_wire_round_trip_is_exact():
    prompt, chunks, blob = _blob()
    header, out = tkv.deserialize_chunks(blob)
    assert header["total_tokens"] == 8 and header["chunk_tokens"] == 4
    assert len(out) == 2
    for (k0, v0), (k1, v1) in zip(chunks, out):
        assert torch.equal(k0, k1) and k1.dtype == torch.float64
        assert torch.equal(v0, v1)
    assert tkv.chunk_token_ids(header).tolist() == prompt[:8].tolist()


def test_wire_rejects_corruption_and_truncation(monkeypatch):
    _, _, blob = _blob()
    with pytest.raises(tkv.KvTransferError, match="magic"):
        tkv.deserialize_chunks(b"NOPE" + blob[4:])
    with pytest.raises(tkv.KvTransferError, match="truncated"):
        tkv.deserialize_chunks(blob[:-10])
    corrupt = bytearray(blob)
    corrupt[-1] ^= 0xFF
    with pytest.raises(tkv.KvTransferError, match="CRC"):
        tkv.deserialize_chunks(bytes(corrupt))

    def bump(h):
        h["format_version"] = 999

    with pytest.raises(tkv.KvTransferError, match="format"):
        tkv.deserialize_chunks(_reheader(blob, bump))
    monkeypatch.setattr(tkv, "MAX_BLOB_BYTES", len(blob) - 1)
    with pytest.raises(tkv.KvTransferError, match="cap"):
        tkv.deserialize_chunks(blob)


def test_wire_rejects_aliased_payload_offsets():
    _, _, blob = _blob(n_chunks=2)

    def alias(h):  # chunk 1 points back at chunk 0's bytes, CRCs consistent
        h["chunks"][1] = dict(h["chunks"][0], tokens=h["chunks"][1]["tokens"])

    with pytest.raises(tkv.KvTransferError, match="overlap"):
        tkv.deserialize_chunks(_reheader(blob, alias))


def test_wire_rejects_shape_byte_count_mismatch():
    _, _, blob = _blob()

    def reshape(h):
        h["kv_shape"] = [3, 1, 4, 2, 3]  # the payload holds [2, 1, 4, 2, 3]

    with pytest.raises(tkv.KvTransferError, match="does not fit"):
        tkv.deserialize_chunks(_reheader(blob, reshape))


def test_serialize_rejects_mismatched_geometry():
    prompt = np.arange(1, 10, dtype=np.int32)
    good = _chunk_pair(0)
    bad = _chunk_pair(1, shape=(2, 1, 4, 2, 5))
    with pytest.raises(tkv.KvTransferError, match="geometry"):
        tkv.serialize_chunks(4, prompt, [good, bad])
    with pytest.raises(tkv.KvTransferError, match="geometry"):
        tkv.serialize_chunks(4, prompt, [good, _chunk_pair(1, dtype=torch.float32)])
    with pytest.raises(tkv.KvTransferError, match="no chunks"):
        tkv.serialize_chunks(4, prompt, [])
    with pytest.raises(tkv.KvTransferError, match="exceed"):
        tkv.serialize_chunks(4, np.arange(4, dtype=np.int32), [good, good])


def test_bfloat16_payload_round_trips():
    prompt = np.arange(1, 6, dtype=np.int32)
    k, v = _chunk_pair(7, dtype=torch.bfloat16)
    blob = tkv.serialize_chunks(4, prompt, [(k, v)])
    header, [(k2, v2)] = tkv.deserialize_chunks(blob)
    assert header["dtype"] == "bfloat16" and k2.dtype == torch.bfloat16
    assert torch.equal(k.view(torch.int16), k2.view(torch.int16))
    assert torch.equal(v.view(torch.int16), v2.view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_blobs_are_byte_identical_to_the_reference_both_ways(dtype):
    rng = np.random.default_rng(5)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    shape = (2, 1, 8, 2, 4)
    ref_chunks = [(rng.standard_normal(shape).astype(np_dtype),
                   rng.standard_normal(shape).astype(np_dtype)) for _ in range(3)]
    port_chunks = [(convert.to_tensor(k), convert.to_tensor(v)) for k, v in ref_chunks]
    prompt = np.arange(3, 30, dtype=np.int32)
    ref_blob = jkv.serialize_chunks(8, prompt, ref_chunks)
    port_blob = tkv.serialize_chunks(8, prompt, port_chunks)
    assert port_blob == ref_blob
    # Numpy chunks through the port's serializer: the same bytes again.
    assert tkv.serialize_chunks(8, prompt, ref_chunks) == ref_blob
    # Each package reads the other's blob.
    header, got = tkv.deserialize_chunks(ref_blob)
    assert header == jkv.deserialize_chunks(ref_blob)[0]
    for (k, v), (tk, tv) in zip(ref_chunks, got):
        assert np.array_equal(convert.to_numpy(tk).view(np.uint8), k.view(np.uint8))
        assert np.array_equal(convert.to_numpy(tv).view(np.uint8), v.view(np.uint8))
    _, back = jkv.deserialize_chunks(port_blob)
    for (k, v), (jk, jv) in zip(ref_chunks, back):
        assert jk.dtype == k.dtype
        assert np.array_equal(jk.view(np.uint8), k.view(np.uint8))
        assert np.array_equal(jv.view(np.uint8), v.view(np.uint8))
    assert np.array_equal(tkv.chunk_token_ids(header), jkv.chunk_token_ids(header))


def test_the_port_reads_and_writes_bfloat16_without_ml_dtypes(monkeypatch, tmp_path):
    """With ``ml_dtypes`` unimportable (``sys.modules`` entry None), bf16
    blobs and snapshots still round-trip in the port, and its modules never
    import it."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes as _  # noqa: F401
    k, v = _chunk_pair(3, dtype=torch.bfloat16)
    header, [(k2, v2)] = tkv.deserialize_chunks(
        tkv.serialize_chunks(4, np.arange(1, 6, dtype=np.int32), [(k, v)]))
    assert header["dtype"] == "bfloat16"
    assert torch.equal(k.view(torch.int16), k2.view(torch.int16))
    tree = {"w": k, "q": {"q8": torch.ones(3, dtype=torch.int8), "scale": torch.ones(1)}}
    ident = tsnap.snapshot_identity("uri", "int8", {"tp": 1})
    path = tsnap.write_snapshot(tmp_path, tree, identity=ident, flavor="llama-generate")
    back, manifest = tsnap.load_snapshot(path, identity=ident, device="cpu")
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == ["int8", "float32", "bfloat16"]
    assert torch.equal(back["w"].view(torch.int16), k.view(torch.int16))


# -- engine to engine ------------------------------------------------------------


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def tiny(x64):
    jp = J.init(jax.random.key(0), JCFG, dtype=jnp.float64)
    tp = convert.from_jax_numpy(jax.device_get(jp))
    return jp, tp


@pytest.fixture(scope="module")
def ref_tokens(tiny):
    jp, _ = tiny
    cache = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            out = J.generate_greedy(jp, jnp.asarray([prompt], jnp.int32), n, JCFG,
                                    dtype=jnp.float64)
            cache[key] = np.asarray(out)[0].tolist()
        return cache[key]

    return ref


def _pc(budget_bytes=1 << 22, mod=tpc, **kw):
    return mod.PrefixCacheConfig(enabled=True, budget_bytes=budget_bytes, chunk_tokens=8, **kw)


def _engine(tp, **kw):
    kw.setdefault("prefix_cache", _pc())
    return TG.GenerationEngine(tp, TCFG, max_slots=2, dtype=torch.float64, device="cpu", **kw)


def _handoff(src, dst, prompt, src_kv=tkv, dst_kv=tkv):
    """Prefill ``prompt`` on ``src``, export, serialize with ``src_kv``,
    deserialize with ``dst_kv``, import on ``dst``; returns the tokens the
    import covers."""
    prompt = np.asarray(prompt, np.int32)
    covered = src.exportable_prefix_tokens(prompt)
    matched, chunks = src.export_prefix_kv(prompt)
    if matched < covered:
        src.generate(prompt, 1)  # the write-backs land the chunks
        matched, chunks = src.export_prefix_kv(prompt)
    assert matched == covered and chunks
    blob = src_kv.serialize_chunks(src._prefill_chunk_size, prompt, chunks)
    header, wire = dst_kv.deserialize_chunks(blob)
    return dst.import_prefix_kv(dst_kv.chunk_token_ids(header), wire)


def _chunk_bytes(itemsize=8):
    return TCFG.num_layers * 8 * TCFG.num_kv_heads * TCFG.head_dim * itemsize * 2


def test_handoff_tokens_bit_identical_to_local_serving(tiny, ref_tokens):
    _, tp = tiny
    a, b = _engine(tp), _engine(tp)
    a.start()
    b.start()
    try:
        assert _handoff(a, b, PROMPT) == 16
        before = b.prefill_forwards
        out = b.generate(PROMPT, 5).tolist()
        spent = b.prefill_forwards - before
        # The export's chunks are the exporter's cache entries, as stored.
        _, mine = a.export_prefix_kv(np.asarray(PROMPT, np.int32))
        _, theirs = b.export_prefix_kv(np.asarray(PROMPT, np.int32))
    finally:
        a.shutdown()
        b.shutdown()
    assert out == ref_tokens(PROMPT, 5)
    assert spent == 1  # only the uncovered suffix chunk (3 locally)
    assert b.prefix_hits == 1 and b.prefix_cached_tokens == 16
    assert b.dispatches_total["kv-import"] == 1
    for (k0, v0), (k1, v1) in zip(mine, theirs):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)


def test_handoff_parity_through_int8kv_round_trip(tiny):
    _, tp = tiny
    prompt = list(range(3, 21))  # 18 tokens -> 16 covered
    a, b, local = (_engine(tp, kv_quant=True) for _ in range(3))
    for e in (a, b, local):
        e.start()
    try:
        local.generate(prompt, 1)
        ref_warm = local.generate(prompt, 6).tolist()
        assert _handoff(a, b, prompt) == 16
        out = b.generate(prompt, 6).tolist()
    finally:
        for e in (a, b, local):
            e.shutdown()
    assert out == ref_warm


def test_handoff_parity_through_l2_reseed(tiny, ref_tokens):
    _, tp = tiny
    other = list(range(40, 60))  # a disjoint two-chunk prefix (L1 pressure)
    cb = _chunk_bytes()
    a = _engine(tp)
    b = _engine(tp, prefix_cache=_pc(2 * cb + cb // 2, l2_budget_bytes=1 << 22))
    a.start()
    b.start()
    try:
        assert _handoff(a, b, PROMPT) == 16
        cache = b._prefix_cache
        b.generate(other, 2)  # its write-backs spill the import to the L2
        assert cache.l2_spills >= 1
        out = b.generate(PROMPT, 5).tolist()
        assert cache.l2_hits >= 1
    finally:
        a.shutdown()
        b.shutdown()
    assert out == ref_tokens(PROMPT, 5)


def test_export_requires_prefix_cache(tiny):
    _, tp = tiny
    engine = TG.GenerationEngine(tp, TCFG, max_slots=2, dtype=torch.float64, device="cpu")
    with pytest.raises(RuntimeError, match="prefix cache"):
        engine.export_prefix_kv(np.arange(1, 20, dtype=np.int32))
    with pytest.raises(RuntimeError, match="prefix cache"):
        engine.import_prefix_kv(np.arange(1, 20, dtype=np.int32), [])
    with pytest.raises(RuntimeError, match="prefix cache"):
        engine.exportable_prefix_tokens(np.arange(1, 20, dtype=np.int32))


def test_control_ops_run_on_the_scheduler_and_fail_typed_at_shutdown(tiny):
    _, tp = tiny
    engine = _engine(tp, slo_class="batch")  # classes armed: the deque path
    engine.start()
    try:
        names = [engine.run_control(lambda: threading.current_thread().name)
                 .result(timeout=30) for _ in range(3)]
        boom = engine.run_control(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            boom.result(timeout=30)
        # A wake never reaches admission: the next request serves as usual.
        assert len(engine.generate(PROMPT[:5], 3)) == 3
    finally:
        engine.shutdown()
    assert names == ["generation-scheduler"] * 3
    late = engine.run_control(lambda: 1)
    with pytest.raises(TG.EngineShutdown):
        late.result(timeout=1)
    # An op queued on a never-started engine fails typed at its shutdown.
    idle = _engine(tp)
    fut = idle.run_control(lambda: 1)
    idle.shutdown()
    with pytest.raises(TG.EngineShutdown):
        fut.result(timeout=1)


@pytest.fixture(scope="module")
def jax_engine(tiny):
    jp, _ = tiny
    engine = JG.GenerationEngine(jp, JCFG, max_slots=2, dtype=jnp.float64,
                                 prefix_cache=_pc(mod=jpc))
    engine.start(warmup=False)
    yield engine
    engine.shutdown()


def test_a_jax_replica_hands_off_to_a_port_replica(tiny, jax_engine):
    _, tp = tiny
    prompt = list(range(5, 27))  # 22 tokens -> 16 covered
    want = np.asarray(jax_engine.generate(prompt, 6)).tolist()
    port = _engine(tp)
    port.start()
    try:
        assert _handoff(jax_engine, port, prompt, src_kv=jkv, dst_kv=tkv) == 16
        before = port.prefill_forwards
        out = port.generate(prompt, 6).tolist()
        assert port.prefill_forwards - before == 1
    finally:
        port.shutdown()
    assert out == want and port.prefix_cached_tokens == 16


def test_a_port_replica_hands_off_to_a_jax_replica(tiny, jax_engine):
    _, tp = tiny
    prompt = list(range(31, 50))  # 19 tokens -> 16 covered
    port = _engine(tp)
    port.start()
    try:
        want = port.generate(prompt, 6).tolist()
        assert _handoff(port, jax_engine, prompt, src_kv=tkv, dst_kv=jkv) == 16
    finally:
        port.shutdown()
    hits = jax_engine.prefix_hits
    out = np.asarray(jax_engine.generate(prompt, 6)).tolist()
    assert out == want and jax_engine.prefix_hits == hits + 1


def test_an_import_the_cache_cannot_hold_stops_at_the_chunk_it_drops(tiny, ref_tokens):
    """A budget of 1.5 chunks: inserting chunk 1 evicts it at once (chunk 0
    is its parent, so the only leaf), ``insert_chunk`` returns False and the
    import stops with one chunk installed.  Serving then prefills the rest."""
    _, tp = tiny
    cb = _chunk_bytes()
    a = _engine(tp)
    b = _engine(tp, prefix_cache=_pc(cb + cb // 2))
    a.start()
    b.start()
    try:
        assert _handoff(a, b, PROMPT) == 8
        out = b.generate(PROMPT, 5).tolist()
    finally:
        a.shutdown()
        b.shutdown()
    assert out == ref_tokens(PROMPT, 5)
    assert b.prefix_cached_tokens == 8 and b.prefix_evictions >= 1


def test_an_import_that_evicts_a_parked_sequence_keeps_its_tokens(tiny, ref_tokens):
    """A best-effort stream is preempted; while its record waits, an import
    fills the radix cache and evicts the stream's chunks.  Its restore finds
    none of them (no prefix hit) and seeds from the record's own host
    copies, as the reference's restore does: no token is recomputed
    (``preempt_recomputed_tokens`` 0) and none changes."""
    _, tp = tiny
    be_prompt, ia_prompt, other = list(range(2, 14)), list(range(30, 40)), list(range(40, 66))
    cb = _chunk_bytes()
    src = _engine(tp)
    src.start()
    try:
        other_tokens = np.asarray(other, np.int32)
        src.generate(other_tokens, 1)
        _, other_chunks = src.export_prefix_kv(other_tokens)
    finally:
        src.shutdown()
    assert len(other_chunks) == 3
    engine = TG.GenerationEngine(tp, TCFG, max_slots=1, dtype=torch.float64, device="cpu",
                                 prefix_cache=_pc(3 * cb), preemption=True)
    state = {}

    def on_ia(_t, seen=[0]):
        seen[0] += 1
        if seen[0] == 1:
            # The import's control op is queued before the next admission
            # phase, which runs it: the stream's record is still parked.
            t = threading.Thread(target=lambda: state.setdefault(
                "imported", engine.import_prefix_kv(other_tokens[:24], other_chunks)))
            t.start()
            while engine._control_ops.empty():
                pass
            state["thread"] = t

    def on_be(_t, seen=[0]):
        seen[0] += 1
        if seen[0] == 10:
            state["ia"] = engine.submit(ia_prompt, 5, slo_class="interactive", on_token=on_ia)

    f_be = engine.submit(be_prompt, 20, on_token=on_be, slo_class="best-effort")
    engine.start()
    try:
        out_be = f_be.result(timeout=120).tolist()
        out_ia = state["ia"].result(timeout=120).tolist()
        state["thread"].join(timeout=30)
    finally:
        engine.shutdown()
    assert state["imported"] == 24
    assert engine.preemptions == engine.preempt_restores == 1
    assert engine.preempt_recomputed_tokens == 0
    assert engine.prefix_hits == 0  # the restore found no chunk of its own
    assert engine.prefix_evictions >= 2
    assert out_be == ref_tokens(be_prompt, 20)
    assert out_ia == ref_tokens(ia_prompt, 5)


# -- served ----------------------------------------------------------------------


class _Handle:
    def __init__(self, srv):
        self.srv = srv
        self.port = srv.server_address[1]
        self.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        if self.srv.lifecycle != "shutdown":
            self.srv.shutdown_all()
        self.thread.join(timeout=10)


def _request(h, method, path, body=None, headers=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=120)
    data = raw if raw is not None else (None if body is None else json.dumps(body))
    conn.request(method, path, data, {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    payload = resp.read()
    conn.close()
    if resp.getheader("Content-Type") == "application/json":
        payload = json.loads(payload)
    return resp.status, payload, resp


@pytest.fixture(scope="module")
def f32_tiny():
    params = T.init(torch.Generator().manual_seed(3), TCFG, dtype=torch.float32)
    return TR._build_llama(params, TCFG, dtype=torch.float32)


def _serve(pred, **conf):
    return _Handle(tapp.build_server(pred, tapp.ServerConfig(
        model_name="llm", host="127.0.0.1", port=0, dtype="float32", max_slots=2,
        device="cpu", **conf)))


@pytest.fixture(scope="module")
def kv_servers(f32_tiny):
    handles = [_serve(f32_tiny, prefix_cache=True, prefix_cache_chunk=8, trace_ring=256,
                      fleet_role=role) for role in ("prefill", "decode")]
    yield handles
    for h in handles:
        h.stop()


GEN = "/v2/models/llm/generate"


def test_http_export_import_relay_round_trip(kv_servers):
    prefill, decode = kv_servers
    code, ref, _ = _request(decode, "POST", GEN, {"prompt_ids": PROMPT, "max_new_tokens": 5})
    assert code == 200, ref
    assert _request(prefill, "GET", "/readyz")[1]["fleetRole"] == "prefill"
    assert _request(decode, "GET", "/readyz")[1]["fleetRole"] == "decode"
    code, blob, resp = _request(prefill, "POST", "/admin/kv/export", {"prompt_ids": [PROMPT]})
    assert code == 200, blob
    assert resp.getheader("X-Tpumlops-Kv-Tokens") == "16"
    assert resp.getheader("Content-Type") == "application/octet-stream"
    # The blob is the exporter's radix entries, as the reference writes them.
    header, chunks = tkv.deserialize_chunks(blob)
    assert header["dtype"] == "float32" and header["kv_shape"] == [
        TCFG.num_layers, 1, 8, TCFG.num_kv_heads, TCFG.head_dim]
    code, body, _ = _request(decode, "POST", "/admin/kv/import", raw=blob,
                             headers={"Content-Type": "application/octet-stream"})
    assert code == 200, body
    assert body == {"imported_tokens": 16, "chunks": 2}
    code, out, _ = _request(decode, "POST", GEN,
                            {"prompt_ids": PROMPT, "max_new_tokens": 5, "debug": True},
                            headers={"X-Tpumlops-Handoff": "12.5",
                                     "X-Request-Id": "relay-req-1"})
    assert code == 200, out
    assert out["outputs"][0]["data"] == ref["outputs"][0]["data"]
    assert out["timing"]["rows"][0]["handoff_ms"] == 12.5
    assert out["timing"]["cached_tokens"] == 16
    eng = _request(decode, "GET", "/debug/engine")[1]
    assert "kv-import" in {t["kind"] for t in eng["ticks"]}
    relayed = [r for r in eng["requests"] if r["request_id"] == "relay-req-1"]
    assert relayed and relayed[0]["handoff_ms"] == 12.5
    trace = _request(decode, "GET", "/debug/trace")[1]
    assert any(e.get("name") == "kv-handoff" for e in trace["traceEvents"])
    # A warm export reads the cache again: the same bytes, no new prefill.
    forwards = prefill.srv.engine.prefill_forwards
    assert _request(prefill, "POST", "/admin/kv/export", {"prompt_ids": PROMPT})[1] == blob
    assert prefill.srv.engine.prefill_forwards == forwards
    metrics = _request(decode, "GET", "/metrics")[1].decode()
    assert 'service="kv-import"' in metrics
    assert 'service="kv-export"' in _request(prefill, "GET", "/metrics")[1].decode()


def test_http_import_rejects_corrupt_and_mismatched_blobs(kv_servers, f32_tiny):
    prefill, decode = kv_servers
    prompt = list(range(30, 48))
    code, blob, _ = _request(prefill, "POST", "/admin/kv/export", {"prompt_ids": prompt})
    assert code == 200
    corrupt = bytearray(blob)
    corrupt[-1] ^= 0xFF
    code, body, _ = _request(decode, "POST", "/admin/kv/import", raw=bytes(corrupt))
    assert code == 400 and body["reason"] == "bad_blob"
    code, body, _ = _request(prefill, "POST", "/admin/kv/export", {"prompt_ids": [1, 2, 3]})
    assert code == 400 and body["reason"] == "prompt_too_short"
    header, chunks = tkv.deserialize_chunks(blob)
    ids = tkv.chunk_token_ids(header)
    half = [(k[:, :, :4], v[:, :, :4]) for k, v in chunks]  # chunks of 4 tokens
    code, body, _ = _request(decode, "POST", "/admin/kv/import",
                             raw=tkv.serialize_chunks(4, ids, half))
    assert code == 409 and body["reason"] == "geometry_mismatch"
    wide = [(k.double(), v.double()) for k, v in chunks]
    code, body, _ = _request(decode, "POST", "/admin/kv/import",
                             raw=tkv.serialize_chunks(8, ids, wide))
    assert code == 409 and body["reason"] == "dtype_mismatch"
    plain = _serve(f32_tiny)
    try:
        code, body, _ = _request(plain, "POST", "/admin/kv/import", raw=blob)
        assert code == 409 and body["reason"] == "prefix_cache_disabled"
        assert "fleetRole" not in _request(plain, "GET", "/readyz")[1]
    finally:
        plain.stop()


def test_fleet_role_flag_needs_the_prefix_cache():
    ap = tapp.build_arg_parser()
    args = ap.parse_args(["--model-uri", "x", "--fleet-role", "decode"])
    with pytest.raises(ValueError, match="requires --prefix-cache 1"):
        tapp.config_from_args(args)
    conf = tapp.config_from_args(ap.parse_args(["--model-uri", "x", "--fleet-role", "prefill",
                                                "--prefix-cache", "1"]))
    assert conf.fleet_role == "prefill"
    with pytest.raises(SystemExit):
        ap.parse_args(["--model-uri", "x", "--fleet-role", "router"])
