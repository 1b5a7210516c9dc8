"""The unit launcher (``server/launch.py``) on the CPU.

- The rank plan of every topology of several cards, from the operator's own
  manifest (h100-2/4/8 one pod, h100-16 the StatefulSet's two): each rank
  once, its local rank and ``LOCAL_WORLD_SIZE``, the coordinator; with
  ``torch.cuda.device_count`` patched to the host's cards every rank
  chooses nccl.  A rank that finds fewer cards than ranks on its host fails
  before the rendezvous, naming both counts, unless the ranks share the
  cards by the launcher's option.
- A tiny Llama (the JAX package's weights, f64) served through the
  manifest's own command with ``--device cpu`` as a ``{"tp": 2}`` unit on
  one host (one launcher, two ranks), and across two hosts (two launchers
  of one rank each, from the StatefulSet's pod of a two-host topology of
  one card a host, added to the table for this test): greedy tokens equal
  the JAX package's ``generate_greedy``; SIGTERM to the launcher of host 0
  ends every process with 0.
- A follower killed with SIGKILL: the launcher exits non-zero and no rank
  is left alive within its grace.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (  # noqa: E501
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator import (  # noqa: E501
    builder as PB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel import (  # noqa: E501
    distributed as TDIST,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    launch as L,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (  # noqa: E501
    config as PC,
)
from tpumlops.models import llama as J

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [list(range(2, 20)), [5, 9, 2]]
NEW = 6


def _cr(topology: str, mesh: dict, **cuda) -> PC.OperatorConfig:
    return PC.OperatorConfig.from_spec({
        "modelName": "model", "modelAlias": "champion", "backend": "cuda",
        "cuda": {"gpuTopology": topology, "meshShape": mesh, "compileCacheDir": "", **cuda}})


def _pods(cfg: PC.OperatorConfig, uri: str = "s3://mlflow/1") -> list[dict]:
    """The container of every pod of the unit, its env resolved as the
    cluster would for each pod index."""
    info = PC.GPU_TOPOLOGIES[cfg.cuda.topology]
    if info.hosts == 1:
        sd = PB.build_deployment("m", "ns", "uid", cfg, "1", uri, 100)
        (c,) = sd["spec"]["predictors"][0]["componentSpecs"][0]["spec"]["containers"]
        return [dict(c, env_values={e["name"]: e["value"] for e in c["env"]})]
    _, _, sts = PB.build_worker_unit_manifests("m", "ns", "uid", cfg, "1", uri)
    (c,) = sts["spec"]["template"]["spec"]["containers"]
    pods = []
    for host in range(sts["spec"]["replicas"]):
        env = {}
        for e in c["env"]:
            if "valueFrom" in e:
                assert e["valueFrom"]["fieldRef"]["fieldPath"] == \
                    "metadata.labels['apps.kubernetes.io/pod-index']"
                env[e["name"]] = str(host)
            else:
                env[e["name"]] = e["value"]
        pods.append(dict(c, env_values=env))
    return pods


@pytest.mark.parametrize("topology", ["h100-2", "h100-4", "h100-8", "h100-16"])
def test_every_rank_once_with_its_local_rank_and_nccl(topology, monkeypatch):
    info = PC.GPU_TOPOLOGIES[topology]
    mesh = {"dp": 1, "tp": info.cards}
    pods = _pods(_cr(topology, mesh))
    assert len(pods) == info.hosts
    seen = []
    for host, c in enumerate(pods):
        assert c["command"] == ["python", "-m", PB.LAUNCH_MODULE]
        world = L.mesh_world(c["args"])
        assert world == info.cards
        plans = L.rank_plan(world, c["env_values"])
        assert [int(p["LOCAL_RANK"]) for p in plans] == list(range(info.cards_per_host))
        assert {p["LOCAL_WORLD_SIZE"] for p in plans} == {str(info.cards_per_host)}
        assert {p["JAX_NUM_PROCESSES"] for p in plans} == {str(world)}
        coord = {p["JAX_COORDINATOR_ADDRESS"] for p in plans}
        if info.hosts == 1:
            assert len(coord) == 1 and re.fullmatch(r"127\.0\.0\.1:\d+", coord.pop())
        else:
            assert coord == {f"m-v1-workers-0.m-v1-workers.ns.svc.cluster.local:"
                             f"{PB.COORDINATOR_PORT}"}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: info.cards_per_host)
        for p in plans:
            seen.append(int(p["JAX_PROCESS_ID"]))
            assert int(p["JAX_PROCESS_ID"]) == host * info.cards_per_host + int(p["LOCAL_RANK"])
            for k, v in p.items():
                monkeypatch.setenv(k, v)
            assert TDIST.choose_backend(TDIST.local_world_size(world), "cuda") == "nccl"
            rank = int(p["JAX_PROCESS_ID"])
            assert str(TDIST.rank_device("cuda", TDIST.local_rank(rank, world))) == \
                f"cuda:{p['LOCAL_RANK']}"
    assert sorted(seen) == list(range(info.cards))


def test_the_launcher_option_stands_among_the_server_arguments():
    args, rest = L.build_arg_parser().parse_known_args(
        ["--model-uri", "m", "--mesh-shape", '{"sp": 2, "tp": 2}', "--ranks-share-card",
         "--port", "0"])
    assert args.ranks_share_card
    assert rest == ["--model-uri", "m", "--mesh-shape", '{"sp": 2, "tp": 2}', "--port", "0"]
    assert not L.build_arg_parser().parse_known_args(["--model-uri", "m"])[0].ranks_share_card
    assert L.mesh_world(rest) == 4 and L.mesh_world(["--model-uri", "m"]) == 1
    with pytest.raises(ValueError, match="does not split over 2 hosts"):
        L.rank_plan(3, {L.HOSTS_ENV: "2", L.COORDINATOR_ENV: "a:1"})
    with pytest.raises(ValueError, match=L.COORDINATOR_ENV):
        L.rank_plan(4, {L.HOSTS_ENV: "2", L.HOST_INDEX_ENV: "1"})


def test_ranks_that_outnumber_the_cards_fail_before_the_rendezvous(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.delenv(L.SHARE_CARD_ENV, raising=False)
    conf = tapp.ServerConfig(mesh_shape={"dp": 2, "tp": 2}, device="cuda")
    with pytest.raises(ValueError, match=r"4 ranks on this host .* but 1 cards"):
        tapp.form_unit(conf)
    # With the launcher's option the check passes and the rank goes on to
    # its rendezvous (here: none configured).
    monkeypatch.setenv(L.SHARE_CARD_ENV, "1")
    monkeypatch.setattr(TDIST, "maybe_initialize_distributed", lambda **kw: False)
    with pytest.raises(ValueError, match="set JAX_COORDINATOR_ADDRESS"):
        tapp.form_unit(conf)


# -- served units ---------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The artifact (the JAX package's tiny Llama in f64, as the port's
    native layout) and the JAX package's greedy tokens for PROMPTS."""
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = J.LlamaConfig(**W.CFG_KW)
        jp = J.init(jax.random.key(5), jcfg, dtype=jnp.float64)
        want = [np.asarray(J.generate_greedy(jp, jnp.asarray([p], jnp.int32), NEW, jcfg,
                                             dtype=jnp.float64))[0, -NEW:].tolist()
                for p in PROMPTS]
        params = convert.from_jax_numpy(jax.device_get(jp), dtype=torch.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    art = tloader.save_native_model(tmp_path_factory.mktemp("launch") / "tiny",
                                    "llama-generate", params,
                                    config=dataclasses.asdict(T.LlamaConfig(**W.CFG_KW)))
    return art, want


LOCAL = ["--host", "127.0.0.1", "--port", "0", "--metrics-port", "0", "--drain-s", "0",
         "--device", "cpu"]


def _start(c: dict, log: Path) -> subprocess.Popen:
    """The pod's command (``python`` is this interpreter), its arguments and
    the local flags a CR cannot state, with the pod's env."""
    env = dict(os.environ, **c["env_values"], PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore")
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", L.SHARE_CARD_ENV):
        env.pop(k, None)
    with open(log, "wb") as f:
        return subprocess.Popen([sys.executable] + c["command"][1:] + c["args"] + LOCAL,
                                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)


def _leader_port(procs, log: Path, timeout: float = 120) -> int:
    serving = re.compile(r"\[rank 0\] .*serving model \(llama-generate\) on 127\.0\.0\.1:(\d+)")
    deadline = time.time() + timeout
    while True:
        m = serving.search(log.read_text(errors="replace"))
        if m:
            return int(m.group(1))
        if any(p.poll() is not None for p in procs) or time.time() > deadline:
            for p in procs:
                p.kill()
            raise AssertionError(log.read_text(errors="replace")[-3000:])
        time.sleep(0.1)


def _generate(port: int) -> list[list[int]]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v2/models/model/generate",
                 json.dumps({"prompt_ids": PROMPTS, "max_new_tokens": NEW}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, body
    return [o["data"] for o in body["outputs"]]


def _children(pid: int) -> list[int]:
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(x) for x in path.read_text().split()] if path.exists() else []


def _alive(pid: int) -> bool:
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except OSError:
        return False


def _stop(procs, logs) -> list[int]:
    procs[0].send_signal(signal.SIGTERM)
    try:
        return [p.wait(timeout=90) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            sys.stdout.write(log.read_text(errors="replace")[-1500:])


def test_a_one_host_unit_serves_the_jax_tokens_and_stops_on_sigterm(served, tmp_path):
    art, want = served
    (c,) = _pods(_cr("h100-2", {"tp": 2}, dtype="float64", prefillChunk=8), uri=str(art))
    assert c["command"] == ["python", "-m", PB.LAUNCH_MODULE]
    log = tmp_path / "unit.log"
    proc = _start(c, log)
    port = _leader_port([proc], log)
    ranks = _children(proc.pid)
    assert len(ranks) == 2
    try:
        assert _generate(port) == want
    finally:
        codes = _stop([proc], [log])
    assert codes == [0]
    text = log.read_text()
    assert "model collectives over gloo" in text and "[rank 1] " in text
    assert "launch: every rank exited 0 ([0, 1])" in text
    assert not any(_alive(pid) for pid in ranks)


def test_a_unit_across_two_hosts_serves_the_jax_tokens_and_stops_on_sigterm(
        served, tmp_path, monkeypatch):
    """Two hosts of one card each: a topology added to the table for this
    test (the real ones are eight cards a host, sixteen processes)."""
    art, want = served
    monkeypatch.setitem(PC.GPU_TOPOLOGIES, "h100-2x1",
                        PC.GpuTopologyInfo(PC.H100_PRODUCT, 2, hosts=2))
    pods = _pods(_cr("h100-2x1", {"tp": 2}, dtype="float64", prefillChunk=8), uri=str(art))
    assert [c["env_values"][L.HOST_INDEX_ENV] for c in pods] == ["0", "1"]
    coord = f"127.0.0.1:{L.free_port()}"  # pod 0's address, on this machine
    for c in pods:
        c["env_values"][L.COORDINATOR_ENV] = coord
    logs = [tmp_path / f"host{h}.log" for h in range(2)]
    procs = [_start(c, log) for c, log in zip(pods, logs)]
    port = _leader_port(procs, logs[0])
    try:
        assert _generate(port) == want
    finally:
        codes = _stop(procs, logs)
    assert codes == [0, 0]
    assert "[rank 1] " in logs[1].read_text() and "[rank 0] " not in logs[1].read_text()


def test_a_killed_follower_ends_the_unit(served, tmp_path):
    art, _ = served
    (c,) = _pods(_cr("h100-2", {"tp": 2}, dtype="float64", prefillChunk=8), uri=str(art))
    log = tmp_path / "unit.log"
    proc = _start(c, log)
    try:
        _leader_port([proc], log)
        leader, follower = _children(proc.pid)
        os.kill(follower, signal.SIGKILL)
        t0 = time.monotonic()
        code = proc.wait(timeout=60)
        waited = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert code != 0
    assert waited < L.KILL_GRACE_S + 5, waited
    assert not _alive(leader) and not _alive(follower)
    assert "launch: rank 1 exited with signal 9" in log.read_text()
