"""Units of several cards in the port's control plane: the JAX package's own
tests of the worker unit and of its multi-host rejections, run against the
port (``tests/torch_transplant.py``).

From ``tests/test_multihost.py``: the routing-only predictor across hosts,
the headless Service, the routed Service and the ``Parallel`` StatefulSet,
replicas refused across hosts, no unit block on one host, the topology
table, and the reconciler materializing and collecting the units of a
canary.  From ``tests/test_config.py``: autoscaling, scale-to-zero and
disaggregation refused across hosts.

The vocabulary is ``torch_operator_map``'s (``v5e-16`` is ``h100-16``), plus
what the two units differ in: v5e-16 is four hosts of four chips, h100-16
two hosts of eight cards; the JAX package's pods carry the rank variables
(``JAX_*``) where the port's carry the launcher's pod-level ones
(``TPUMLOPS_UNIT_*``, ``server/launch.py``), and its worker-unit block is
``gpuWorkerUnit`` with ``cardsPerHost``.
"""

from torch_transplant import export, transplant

UNIT_SUBS = [
    (r'"tpuWorkerUnit"', '"gpuWorkerUnit"'),
    (r'unit\["hosts"\] == 4', 'unit["hosts"] == 2'),
    (r'unit\["chipsPerHost"\] == 4', 'unit["cardsPerHost"] == 8'),
    (r'sts\["spec"\]\["replicas"\] == 4', 'sts["spec"]["replicas"] == 2'),
    (r'env\["JAX_NUM_PROCESSES"\]\["value"\] == "4"', 'env["TPUMLOPS_UNIT_HOSTS"]["value"] == "2"'),
    (r'env\["JAX_COORDINATOR_ADDRESS"\]', 'env["TPUMLOPS_UNIT_COORDINATOR"]'),
    (r'env\["JAX_PROCESS_ID"\]', 'env["TPUMLOPS_UNIT_HOST_INDEX"]'),
    (r'\["google\.com/tpu"\] == "4"', '["nvidia.com/gpu"] == "8"'),
    (r'\["google\.com/tpu"\] == "8"', '["nvidia.com/gpu"] == "8"'),
    (r'startswith\("JAX_COORDINATOR"\)', 'startswith("TPUMLOPS_UNIT_")'),
    # GpuTopologyInfo has no tuple form: its product and card count instead.
    (r"info\.chips % info\.hosts", "info.cards % info.hosts"),
    (r"assert info\[0\] == info\.accelerator", "assert info.product"),
    (r"assert info\[2\] == info\.chips", "assert info.cards_per_host * info.hosts == info.cards"),
    # The JAX package's process transport; these tests use none.
    (r"^    JaxProcessTransport,\n", ""),
]

MULTIHOST = transplant("test_multihost", vocabulary=True, subs=UNIT_SUBS)
export(MULTIHOST, globals(), [
    "test_builder_multihost_unit_wiring",
    "test_builder_worker_unit_manifests",
    "test_multihost_replicas_rejected",
    "test_builder_single_host_has_no_unit_block",
    "test_topology_table_consistency",
    "test_reconciler_materializes_and_gcs_worker_units",
], tag="unit")

CONFIG = transplant("test_config", vocabulary=True, subs=[
    (r"base_tpu\.update\(tpu or \{\}\)", "base_tpu.update(cuda or {})"),
])
export(CONFIG, globals(), [
    "test_autoscaling_multihost_rejected_like_replicas",
    "test_scale_to_zero_multihost_rejected",
    "test_fleet_disaggregation_rejected_on_multihost",
], tag="config")


def test_the_unit_block_states_cards_and_ranks_per_host():
    """The port's worker-unit block carries the cards and the rank
    processes of each host, and the StatefulSet's pods run the launcher
    with the pod-level variables the launcher reads."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator import (  # noqa: E501
        builder,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        launch,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils.config import (  # noqa: E501
        OperatorConfig,
    )

    cfg = OperatorConfig.from_spec({"modelName": "m", "modelAlias": "c", "backend": "cuda",
                                    "cuda": {"gpuTopology": "h100-16",
                                             "meshShape": {"sp": 4, "tp": 4}}})
    sd = builder.build_deployment("m", "ns", "uid", cfg, "7", "s3://mlflow/7", 100)
    unit = sd["spec"]["predictors"][0]["gpuWorkerUnit"]
    assert (unit["hosts"], unit["cardsPerHost"], unit["ranksPerHost"]) == (2, 8, 8)
    assert unit["coordinatorPort"] == builder.COORDINATOR_PORT
    _, _, sts = builder.build_worker_unit_manifests("m", "ns", "uid", cfg, "7", "s3://mlflow/7")
    pod = sts["spec"]["template"]["spec"]
    (c,) = pod["containers"]
    assert c["command"] == ["python", "-m", builder.LAUNCH_MODULE]
    names = [e["name"] for e in c["env"]]
    assert {launch.HOSTS_ENV, launch.HOST_INDEX_ENV, launch.COORDINATOR_ENV} <= set(names)
    assert not any(n.startswith("JAX_") and n != "JAX_COMPILATION_CACHE_DIR" for n in names)
    assert {"name": "dshm", "emptyDir": {"medium": "Memory"}} in pod["volumes"]
