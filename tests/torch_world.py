"""Spawned gloo worlds for the port's parallel tests (torch and numpy only:
the ranks never import JAX, so each starts in about a second).

:func:`run` starts ``world`` processes with the ``spawn`` method, each on
one torch thread, forms their gloo group through the port's
``parallel.distributed.maybe_initialize_distributed`` on a free port of
its own, and calls ``fn(rank, world, *args)`` in every rank.  It returns
each rank's result in rank order.  A rank that raises, or a world that
does not finish within ``timeout`` seconds, fails the test with every
rank's traceback: never a hang.  The workers below are the ranks' bodies
of the ``test_torch_*`` parallel tests; the JAX references run in the
test process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np

PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn_name: str, rank: int, world: int, port: int, args: tuple, env: dict,
               timeout_s: float, q) -> None:
    import datetime

    import torch

    torch.set_num_threads(1)
    os.environ.update(env)
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel import (  # noqa: E501
        distributed,
    )

    try:
        distributed.maybe_initialize_distributed(
            f"127.0.0.1:{port}", world, rank, device_type="cpu",
            timeout=datetime.timedelta(seconds=timeout_s))
        out = globals()[fn_name](rank, world, *args)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        try:
            distributed.shutdown_distributed()
        except Exception:
            pass


def run(fn, world: int, *args, timeout: float = 120.0, env: dict | None = None,
        group_timeout: float | None = None) -> list:
    """``fn(rank, world, *args)`` in each of ``world`` spawned ranks; their
    results in rank order.  ``group_timeout`` bounds the model groups'
    collectives (``timeout`` by default)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn.__name__, r, world, port, args, env or {},
                               group_timeout or timeout, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, tuple] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and time.monotonic() < deadline:
            try:
                rank, ok, out = q.get(timeout=0.5)
            except queue.Empty:
                # A rank that died before reporting (an import error, a
                # crash) fails the world now, not at the deadline.
                if any(p.exitcode is not None and r not in got for r, p in enumerate(procs)):
                    break
                continue
            got[rank] = (ok, out)
            if not ok:
                break  # one failure fails the world: do not wait for the rest
    finally:
        for p in procs:
            p.join(timeout=max(0.5, min(10.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}:\n{out}" for r, (ok, out) in sorted(got.items()) if not ok]
    if errors:
        raise AssertionError("a rank failed:\n" + "\n".join(errors))
    if len(got) < world:
        raise AssertionError(f"world of {world} timed out after {timeout} s: "
                             f"ranks {sorted(got)} answered")
    return [got[r][1] for r in range(world)]


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------


# The tiny Llama and the traffic the engine tests share: six greedy
# prompts (more than four slots: slot churn), two seeded sampled ones, and
# the composition's run, whose last prompt shares two whole chunks of 8
# with its first (a prefix-cache seed).
CFG_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
              intermediate_size=128, max_seq=64)
GREEDY = [([5, 9, 2], 6, {}), ([7, 1, 4, 8, 3], 9, {}), (list(range(2, 23)), 7, {}),
          ([11, 3], 4, {}), ([9, 8], 10, {}), ([3, 3, 3, 4, 5, 3, 3, 3, 4], 8, {})]
SAMPLED = [([5, 9, 2], 8, dict(temperature=0.9, top_k=20, top_p=0.95, seed=7)),
           ([7, 1, 4, 8, 3], 6, dict(temperature=1.3, top_p=0.8, seed=11))]
SHARED = list(range(40, 57))  # two whole chunks of 8 and one token
COMPOSITION = [(SHARED + [1, 2], 6, {})] + GREEDY + [(SHARED + [3], 5, {})]


def composition_kw() -> dict:
    """Prefix cache, speculation, packed prefill and K 4 multistep."""
    m = _port()
    return dict(prefill_chunk=8, prefill_batch=2, decode_steps=4,
                prefix_cache=m["server.prefix_cache"].PrefixCacheConfig(
                    enabled=True, budget_bytes=1 << 22, chunk_tokens=8),
                speculative=m["server.speculative"].SpeculativeConfig(
                    enabled=True, draft_tokens=2))


def request_key(p, n, kw) -> tuple:
    return (tuple(p), n, tuple(sorted(kw.items())))


def _port():
    import importlib

    return {name: importlib.import_module(f"{PKG}.{name}") for name in (
        "convert", "models.llama", "models.partition", "parallel", "parallel.collectives",
        "parallel.distributed", "server.generation", "server.multihost",
        "server.prefix_cache", "server.speculative")}


def collectives_case(rank: int, world: int, n: int) -> dict:
    """Every collective helper on this rank's block of one array; the
    parent checks each against numpy."""
    import torch

    m = _port()
    C = m["parallel.collectives"]
    mesh_flat = m["parallel"].build_mesh({"tp": world})
    g = mesh_flat.group("tp")
    x = torch.arange(n * 4, dtype=torch.float64).reshape(n, 4) + 100.0 * rank
    out = {
        "axis_index": C.axis_index(g),
        "psum": C.psum(x, g).numpy(),
        "pmean": C.pmean(x, g).numpy(),
        "gather0": C.all_gather_concat(x, g, 0).numpy(),
        "gather1": C.all_gather_concat(x, g, 1).numpy(),
        "reduce_scatter": C.reduce_scatter(x, g, 0).numpy(),
        "ring1": C.ring_shift(x, g, 1).numpy(),
        "ring_m1": C.ring_shift(x, g, -1).numpy(),
        "ring2": C.ring_shift(x, g, 2).numpy(),
        "bidir": C.ring_shift_bidirectional(x, g, 0).numpy(),
        "swap": C.all_to_all_swap(x, g, 0, 1).numpy(),
        "psum_none": C.psum(x, None).numpy(),
    }
    if world == 4:
        two = m["parallel"].build_mesh({"dp": 2, "tp": 2})
        out["hier"] = C.hierarchical_psum(x, two.group("tp"), two.group("dp"), 0).numpy()
        out["coords"] = dict(two.coords)
    # An unused input is left as it was (every helper is functional).
    assert torch.equal(x, torch.arange(n * 4, dtype=torch.float64).reshape(n, 4) + 100.0 * rank)
    return out


def _ids(n: int, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


def forward_case(rank: int, world: int, mesh_shape: dict, cfg_kw: dict, trees: dict) -> dict:
    """The sharded forward on each tree of ``trees`` (name -> numpy tree,
    ``kv`` flag): prefill and a chunk on the scratch cache, two decode
    steps and a verify on a 3-row ragged cache (slots 0 and 2 prefilled,
    row 1 inactive).  Returns each case's logits and this rank's cache
    blocks."""
    import torch

    m = _port()
    L = m["models.llama"]
    cfg = L.LlamaConfig(**cfg_kw)
    mesh = m["parallel"].build_mesh(mesh_shape)
    out = {}
    for name, (tree, kv) in trees.items():
        params = m["models.partition"].shard_llama_params(
            m["convert"].from_jax_numpy(tree), mesh)
        res: dict = {}
        ids = torch.from_numpy(_ids(11, 1, cfg.vocab_size)).long()
        lg, seq = L.prefill(params, ids, cfg, torch.float64, mesh)
        res["prefill"] = lg.numpy()
        res["seq_k"] = seq.k.numpy().copy()  # the chunk below writes it in place
        ids2 = torch.from_numpy(_ids(5, 2, cfg.vocab_size)).long()
        lg2, seq = L.forward(params, ids2, seq, cfg, torch.float64, mesh)
        res["chunk"] = lg2.numpy()
        if kv:
            cache = L.QuantRaggedKVCache.create(cfg, 3, mesh=mesh)
        else:
            cache = L.RaggedKVCache.create(cfg, 3, torch.float64, mesh=mesh)
        for slot, n in ((0, 7), (2, 16)):
            pid = np.zeros((1, 16), np.int32)
            pid[0, :n] = _ids(n, 10 + slot, cfg.vocab_size)[0]
            _, s1 = L.prefill(params, torch.from_numpy(pid).long(), cfg, torch.float64, mesh)
            cache = L.insert_sequence(cache, s1, slot, n, mesh)
        active = torch.tensor([True, False, True])
        toks = torch.tensor([[3], [5], [7]])
        res["decode"] = []
        for window in (24, 32):
            lg, cache = L.decode_ragged(params, toks, cache, cfg, active, torch.float64,
                                        window, mesh)
            res["decode"].append(lg.numpy())
            toks = torch.argmax(lg[:, -1], dim=-1)[:, None]
        vt = torch.from_numpy(np.array([[3, 9, 4], [5, 1, 2], [7, 7, 8]]))
        lg, cache = L.verify_ragged(params, vt, cache, cfg, torch.float64, 40, active, mesh)
        res["verify"] = lg.numpy()
        res["cache"] = [t.numpy() for t in cache]
        out[name] = res
    return out


def _engine_state(engine) -> dict:
    """What a rank's engine holds after a run: the replicated sampling state
    and its own block of the cache."""
    return {
        "tokens": engine._tokens.numpy().copy(),
        "lengths": engine._cache.lengths.numpy().copy(),
        "keys": engine._keys.numpy().copy(),
        "temps": engine._temps.numpy().copy(),
        "topk": engine._topk.numpy().copy(),
        "topp": engine._topp.numpy().copy(),
        "cache": [t.numpy().copy() for t in engine._cache[:-1]],
    }


def engine_case(rank: int, world: int, mesh_shape: dict, cfg_kw: dict, tree: dict,
                runs: list) -> list:
    """One served unit a run: rank 0's engine (``mesh_shape``, a
    ``UnitChannel`` over the control group) schedules ``requests`` (prompt,
    new tokens, submit kwargs), all submitted before ``start()``; every
    other rank's engine repeats its ops in ``follower_loop``.  Returns per
    run the leader's tokens and counters (rank 0) or the follower's op
    count, and each rank's engine state."""
    import torch

    m = _port()
    G, MH = m["server.generation"], m["server.multihost"]
    cfg = m["models.llama"].LlamaConfig(**cfg_kw)
    params = m["convert"].from_jax_numpy(tree)
    transport = MH.TorchDistTransport() if world > 1 else None
    out = []
    for engine_kw, requests in runs:
        kw = dict(max_slots=4, dtype=torch.float64, device="cpu", mesh_shape=mesh_shape)
        kw.update(engine_kw)
        if rank == 0:
            channel = MH.UnitChannel(transport) if transport is not None else None
            engine = G.GenerationEngine(params, cfg, channel=channel, **kw)
            futs = [engine.submit(p, n, **skw) for p, n, skw in requests]
            engine.start(warmup=False)
            try:
                toks = [f.result(timeout=120).tolist() for f in futs]
            finally:
                engine.shutdown()
                if channel is not None:
                    channel.close_with(MH.encode_message(MH.OP_SHUTDOWN))
            res = {"tokens": toks, "decode_forwards": engine.decode_forwards,
                   "spec_verify_ticks": engine.spec_verify_ticks,
                   "prefix_hits": engine.prefix_hits,
                   "prefill_chunks_dispatched": engine.prefill_chunks_dispatched,
                   "dispatches": dict(engine.dispatches_total)}
        else:
            engine = G.GenerationEngine(params, cfg, **kw)
            res = {"steps": MH.follower_loop(None, transport, gen_engine=engine)}
        res["state"] = _engine_state(engine)
        out.append(res)
    return out


def transport_case(rank: int, world: int, idle_s: float) -> dict:
    """``TorchDistTransport`` over the control group: payloads of 0 B,
    a few bytes and 1 MiB from the leader; then the leader idles for
    ``idle_s`` (past the model groups' timeout) before the next op, which
    every follower still takes; then a model-group broadcast that the
    leader never joins, which must time out on the followers."""
    import torch
    import torch.distributed as dist

    m = _port()
    MH = m["server.multihost"]
    t = MH.TorchDistTransport()
    payloads = [b"", b"gen_step", bytes(range(256)) * 4096]
    got = [t.broadcast(p if rank == 0 else None) for p in payloads]
    out = {"equal": got == payloads, "leader": t.is_leader}
    if rank == 0:
        time.sleep(idle_s)
        msg = MH.encode_message(MH.OP_GEN_STEP, {"window": 16})
        out["late"] = MH.decode_message(t.broadcast(msg))
        time.sleep(idle_s)  # never joins the broadcast below, which times out first
    else:
        t0 = time.perf_counter()
        out["late"] = MH.decode_message(t.broadcast(None))
        out["waited_s"] = time.perf_counter() - t0
        try:
            dist.broadcast(torch.zeros(1), src=0)
            out["model_group_timed_out"] = False
        except RuntimeError:
            out["model_group_timed_out"] = True
    return out


def forward_and_engine_case(rank: int, world: int, mesh_shape: dict, cfg_kw: dict,
                            trees: dict, tree: dict, runs: list) -> dict:
    """:func:`forward_case` then :func:`engine_case` in one world (one spawn)."""
    return {"forward": forward_case(rank, world, mesh_shape, cfg_kw, trees),
            "engine": engine_case(rank, world, mesh_shape, cfg_kw, tree, runs)}


def ring_case(rank: int, world: int, cases: list) -> list:
    """Ring attention on an ``{"sp": world}`` mesh, each case ``(q, k, v,
    causal)`` of global numpy arrays: the plain ring and the ring through
    the (plain) flash with its log-sum-exp, each cut to this rank's shard
    and gathered back (``ring_attention_sharded``)."""
    import importlib

    import torch

    R = importlib.import_module(f"{PKG}.ops.ring_attention")
    mesh = _port()["parallel"].build_mesh({"sp": world})
    out = []
    for q, k, v, causal in cases:
        q, k, v = (torch.from_numpy(x) for x in (q, k, v))
        out.append({name: R.ring_attention_sharded(q, k, v, mesh, causal=causal, fn=fn).numpy()
                    for name, fn in (("plain", R.ring_attention_reference),
                                     ("flash", R.ring_attention_flash))})
    return out


def prefill_ring_case(rank: int, world: int, mesh_shape: dict, cfg_kw: dict, tree: dict,
                      ids: np.ndarray, last_idx: int) -> dict:
    """``llama.prefill_ring`` on ``mesh_shape``: the logits and this rank's
    K/V (every position, its tp heads)."""
    import torch

    m = _port()
    L = m["models.llama"]
    cfg = L.LlamaConfig(**cfg_kw)
    mesh = m["parallel"].build_mesh(mesh_shape)
    params = m["convert"].from_jax_numpy(tree)
    if mesh.tp > 1:
        params = m["models.partition"].shard_llama_params(params, mesh)
    lg, k_all, v_all = L.prefill_ring(params, torch.from_numpy(ids).long(), cfg, mesh=mesh,
                                      last_idx=last_idx, dtype=torch.float64)
    return {"logits": lg.numpy(), "k": k_all.numpy(), "v": v_all.numpy(),
            "coords": dict(mesh.coords)}


def sharded_snapshot_case(rank: int, world: int, art: str, mesh_shape: dict,
                          loads: list) -> list:
    """``load_predictor`` on ``mesh_shape`` once for each ``(snapshot dir,
    quantize)`` of ``loads``, in order: each load's tree (flattened, as
    bits with the dtype's name), its load stats, the snapshot records this
    rank read (key, file, offset, nbytes) and the loader's warnings."""
    import importlib
    import logging

    import torch

    loader = importlib.import_module(f"{PKG}.server.loader")
    snap = importlib.import_module(f"{PKG}.server.snapshot")
    reads: list = []
    real = snap.read_plan

    def plan(manifest, mesh=None):
        recs = real(manifest, mesh)
        reads.extend((r["key"], r["file"], r["offset"], r["nbytes"]) for r in recs)
        return recs

    snap.read_plan = plan
    warnings: list = []

    class Catch(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    logging.getLogger("tpumlops_torch.loader").addHandler(Catch())
    out = []
    for snapdir, quantize in loads:
        reads.clear()
        warnings.clear()
        stats: dict = {}
        pred = loader.load_predictor(art, quantize=quantize, device="cpu",
                                     dtype=torch.bfloat16, load_stats=stats,
                                     snapshot_dir=snapdir, mesh_shape=mesh_shape)
        flat = {}
        for k, v in loader._flatten(pred.causal_lm["params"]).items():
            bits = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            flat[k] = (str(v.dtype), bits.numpy().copy())
        out.append({"params": flat, "stats": stats, "reads": list(reads),
                    "warnings": list(warnings)})
    return out


def bert_forward_case(rank: int, world: int, mesh_shape: dict, cfg_kw: dict, trees: dict,
                      inputs: tuple) -> dict:
    """BERT's sharded forward on ``mesh_shape``: for each tree of ``trees``
    (name -> (numpy tree, torch dtype name)) this rank's cut of it
    (``partition.shard_bert_params``), then ``classify`` and ``encode`` on
    ``inputs`` (ids, mask, token types); and a tp ``pmax``."""
    import importlib

    import torch

    m = _port()
    B = importlib.import_module(f"{PKG}.models.bert")
    C = m["parallel.collectives"]
    cfg = B.BertConfig(**cfg_kw)
    mesh = m["parallel"].build_mesh(mesh_shape)
    ids, mask, tt = (None if x is None else torch.from_numpy(x) for x in inputs)
    out: dict = {"coords": dict(mesh.coords)}
    for name, (tree, dtype) in trees.items():
        params = m["models.partition"].shard_bert_params(
            m["convert"].from_jax_numpy(tree), mesh)
        dt = getattr(torch, dtype)
        seq, pooled = B.encode(params, ids, mask, tt, cfg, dt, mesh)
        out[name] = {"logits": B.classify(params, ids, mask, tt, cfg, dt, mesh).numpy(),
                     "seq": seq.numpy(), "pooled": pooled.numpy()}
    x = torch.tensor([float(rank), -float(rank), 3.0], dtype=torch.float64)
    out["pmax"] = C.pmax(x, mesh.group("tp")).numpy()
    out["pmax_calls"] = C.calls.get("all_reduce_max", 0)
    return out


def _tree_bits(tree) -> dict:
    """A tree of tensors flattened as the loader flattens it, each leaf as
    (dtype name, numpy bits)."""
    import importlib

    import torch

    loader = importlib.import_module(f"{PKG}.server.loader")
    flat = {}
    for k, v in loader._flatten(tree).items():
        bits = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
        flat[k] = (str(v.dtype), bits.numpy().copy())
    return flat


def load_case(rank: int, world: int, mesh_shape: dict, loads: list) -> list:
    """``load_predictor`` on ``mesh_shape`` for each ``(uri, quantize, dtype
    name, snapshot dir, inputs)`` of ``loads``, in order: the prediction on
    ``inputs`` (kwargs, or the one positional input), the served tree as
    bits, the load stats, the loader's warnings and how many leaves were
    read from an npz; a typed refusal's message in place of the rest."""
    import importlib
    import logging

    import torch

    loader = importlib.import_module(f"{PKG}.server.loader")
    reads = [0]
    real = loader.to_tensor

    def counted(*a, **kw):
        reads[0] += 1
        return real(*a, **kw)

    loader.to_tensor = counted
    warnings: list = []

    class Catch(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    logging.getLogger("tpumlops_torch.loader").addHandler(Catch())
    out = []
    for uri, quantize, dtype, snapdir, inputs in loads:
        reads[0] = 0
        warnings.clear()
        stats: dict = {}
        try:
            pred = loader.load_predictor(uri, quantize=quantize, device="cpu",
                                         dtype=getattr(torch, dtype), load_stats=stats,
                                         snapshot_dir=snapdir, mesh_shape=mesh_shape)
        except loader.ModelLoadError as e:
            out.append({"refused": str(e), "reads": reads[0]})
            continue
        y = pred.predict(**inputs) if len(inputs) > 1 else pred.predict(*inputs.values())
        tree = pred.tree or pred.causal_lm
        out.append({"y": y.detach().cpu().numpy(), "flavor": pred.name,
                    "params": _tree_bits(tree["params"]) if tree else None,
                    "hidden_act": getattr(tree["cfg"], "hidden_act", None) if tree else None,
                    "stats": stats, "warnings": list(warnings), "reads": reads[0]})
    return out


def _http(port: int, method: str, path: str, body=None, timeout: float = 120.0):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def unit_case(rank: int, world: int, units: list) -> list:
    """Served units, one after another in this world, each as the app runs
    them: ``argv`` parsed into the server's config, ``form_unit``, then the
    leader's ``build_server`` (after ``load_predictor`` unless
    ``--warm-pool``) serving on a thread, the followers in ``run_follower``.
    The leader sends each ``(method, path, body)`` of ``plan`` and returns
    the answers; ``fail_rank`` makes that rank's first sharded block read
    raise (an attach that fails on one rank).  A follower returns its ops
    run."""
    import importlib
    import threading

    app = importlib.import_module(f"{PKG}.server.app")
    loader = importlib.import_module(f"{PKG}.server.loader")
    out = []
    for argv, plan, fail_rank in units:
        config = app.config_from_args(app.build_arg_parser().parse_args(argv))
        transport, device, local_rank = app.form_unit(config)
        config.device = device
        if rank == fail_rank:
            real, failed = loader._blocks, [False]

            def once(*a, **kw):
                if not failed[0]:
                    failed[0] = True
                    raise RuntimeError("injected block read failure")
                return real(*a, **kw)

            loader._blocks = once
        try:
            if rank != 0:
                out.append({"steps": app.run_follower(config, transport, local_rank=1)})
                continue
            pred = None
            if not config.warm_pool:
                pred = loader.load_predictor(config.model_uri, quantize=config.quantize,
                                             device=config.device,
                                             dtype=app._DTYPES[config.dtype],
                                             mesh_shape=config.mesh_shape)
            srv = app.build_server(pred, config, transport=transport)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                answers = [_http(srv.server_address[1], *step) for step in plan]
            finally:
                srv.shutdown_all()
                thread.join(timeout=30)
            out.append({"answers": answers})
        finally:
            if rank == fail_rank:
                loader._blocks = real
    return out


def calls_case(rank: int, world: int, calls: list) -> list:
    """Several rank bodies of this file in one world, in order: each
    ``(name, args)`` called as ``name(rank, world, *args)``."""
    return [globals()[name](rank, world, *args) for name, args in calls]
