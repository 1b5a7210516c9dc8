"""The port's operator on a shared warm pool, end to end on the CPU: the
counterpart of ``tests/test_e2e_localplane.py``'s multiplexing and anomaly
observatory cases, run as ``chip_smoke.py``'s phase 9b runs it on the card,
at ``LlamaConfig.tiny`` widths.

Four tiny Llama artifacts share three ``--warm-pool 1`` server processes
(the operator's warm-pool manifest's command) behind the port's router in
model-multiplexing mode, replica r1's leg through a ``ChaosProxy``; four
``MlflowModel`` CRs with ``spec.multiplex``, ``spec.slo`` and
``spec.anomaly`` run in the port's ``OperatorRuntime``.  Parked requests
for three models are attached and answered with a direct f32 engine's
tokens; the observatory flags r1 from the router's legs and the packer
avoids it; the fourth model replaces an attachment (journaled); the SLO
records agree with a recomputation; the planner's suggestion on the
router's journey export equals a re-plan; the operator process takes its
Lease and stops on SIGTERM.
"""

from __future__ import annotations

import pytest

import chip_smoke
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    llama,
)


def test_four_models_share_the_warm_pool_and_the_operator_judges_them(monkeypatch):
    # On a loaded CPU the healthy replicas' legs spread over hundreds of
    # ms: r1's injected hold is a second here, so its leg stands out of
    # that spread as the card's 0.35 s stands out of ~30 ms legs.
    monkeypatch.setattr(chip_smoke, "JUDGE_SLOW_S", 1.0)
    res = chip_smoke.phase_control_plane_judgment(
        "cpu", device="cpu", cfg=llama.LlamaConfig.tiny(max_seq=64))
    assert set(res["park_to_200_s"]) == {"mux0", "mux1", "mux2", "mux3"}
    assert res["verdict"] and all(v["replica"] == "r1" for v in res["verdict"])
    assert res["anomaly_z"] > 3.5
    assert res["replace"]["replica"] in ("r0", "r2")
    assert res["replace"]["displaced"]
    assert [a for a in res["attach"] if a["replace"]]
    assert res["mux_moves"] == 4
    assert all(n["ttft_p99"] >= 1 and n["itl_p99"] >= 1 for n in res["slo"].values())
    assert res["plan"]["requests"] >= 5
    assert res["operator_exit_s"] < 10.0
    assert set(res["launches"]) == {"r0", "r1", "r2"}


@pytest.mark.parametrize("replica", ["r0", "r1", "r2"])
def test_the_pool_command_is_the_warm_pool_manifest(replica, tmp_path):
    from importlib import import_module

    builder = import_module(f"{chip_smoke.PKG}.operator.builder")
    config = import_module(f"{chip_smoke.PKG}.utils.config")
    cfg = config.OperatorConfig.from_spec(chip_smoke._judge_pool_spec(tmp_path))
    argv = chip_smoke._pool_argv(builder, cfg, str(tmp_path / "m"), 9000, "cpu")
    assert argv[1:3] == ["-m", f"{chip_smoke.PKG}.server"]
    for flag, value in (("--warm-pool", "1"), ("--snapshot-dir", str(tmp_path)),
                        ("--dtype", "float32"), ("--timeseries-ring", "64")):
        assert argv[argv.index(flag) + 1] == value, flag
    assert argv[-2:] == ["--device", "cpu"]
