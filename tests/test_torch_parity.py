"""What holds each of the JAX package's test suites on the port.

``PARITY`` maps every reference test file (``tests/test_*.py`` that is not
``test_torch_*``) to the port's test files that hold it (``held_by``) and
to the reference cases nothing holds, each with its reason
(``not_held``). A reason is one of ``REASONS``:

* the bench and its gates, which wait for the port's benchmark;
* a wall-clock ratio, which tier-1 does not assert;
* a check of JAX's own CPU mesh, with the port's counterpart named;
* a deliberate adaptation to the card (ROADMAP queue 3 item 4).

The files in ``BY_NAME`` keep the reference's case names: every case of
theirs that is not excused is a test of the same name in a ``held_by``
file. The others are held under the port's own names (their files'
docstrings say how).

The checks read source files only, with ``ast``; nothing here imports a
test module. A reference suite added later fails
``test_every_reference_suite_has_an_entry`` until it has an entry.
"""

import ast
import glob
import os

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

BENCH = "bench, waits for the benchmark PR"
WALL = "wall-clock ratio"
JAX_MESH = "JAX CPU mesh only, counterpart"
ADAPTED = "deliberate adaptation, ROADMAP queue 3 item 4"
REASONS = (BENCH, WALL, JAX_MESH, ADAPTED)


def held(*files, **not_held):
    return {"held_by": list(files), "not_held": not_held}


PARITY = {
    "test_alloc_bench.py": held(test_alloc_churn_gate=BENCH),
    "test_analysis.py": held("test_torch_analysis.py"),
    "test_apply.py": held("test_torch_apply.py", "test_torch_warm.py", "test_torch_shard_replica.py"),
    "test_bench_gate.py": held(
        "test_torch_timing.py", "test_torch_fa_gate.py",
        test_fleet_pass_gate_trips_on_regression_and_missing=BENCH,
        test_fleet_pass_gate_ceiling_env_override=BENCH),
    "test_cache.py": held("test_torch_cache.py", "test_torch_cache_wire.py"),
    "test_cfg.py": held("test_torch_cfg.py", "test_torch_api.py"),
    "test_chaos_flight.py": held("test_torch_chaos_flight.py"),
    "test_chaos_kubesim.py": held("test_torch_chaos_kubesim.py"),
    "test_chaos_soak.py": held(
        "test_torch_chaos_soak.py", "test_torch_chaos_rollback.py", "test_torch_chaos_schedule.py",
        test_soak_1000_nodes=f"{BENCH}: a 1000-node soak the repo marks slow (a fleet-scale benchmark); "
                             "ROADMAP queue 1 item 1 puts it in the churn cell"),
    "test_churn_bench.py": held(test_churn_storm_per_event_cost_scales_with_events_not_fleet=BENCH),
    "test_clusterpolicy_types.py": held("test_torch_clusterpolicy_types.py"),
    "test_concurrent_writers.py": held("test_torch_lockwatch.py"),
    "test_converge_bench.py": held(test_fleet_converge_time_to_ready_under_ceiling=BENCH),
    "test_daemonset_common.py": held("test_torch_daemonset_common.py"),
    "test_debug_vars_schema.py": held("test_torch_manager.py"),
    "test_delta_reconcile.py": held("test_torch_delta.py", "test_torch_manager.py"),
    "test_devchar.py": held("test_torch_host_components.py"),
    "test_device_plugin.py": held("test_torch_device_plugin.py"),
    "test_discovery_exporter_sliceman.py": held(
        "test_torch_tfd.py", "test_torch_cdi.py", "test_torch_exporter.py", "test_torch_sliceman.py"),
    "test_disruption.py": held("test_torch_disruption.py", "test_torch_kube.py"),
    "test_events_and_status.py": held("test_torch_write_pipeline.py", "test_torch_reconciler.py"),
    "test_fake_client.py": held("test_torch_fake_client.py", "test_torch_kube.py"),
    "test_fake_e2e.py": held("test_torch_e2e.py"),
    "test_fault_matrix.py": held("test_torch_fault_matrix.py"),
    "test_flashattn.py": held("test_torch_flashattn.py", "test_torch_flash_variants.py"),
    "test_http_e2e.py": held("test_torch_e2e.py"),
    "test_jax_cpu_mesh.py": held(
        test_cpu_devices=f"{JAX_MESH} tests/test_torch_mesh.py: the port's multi-rank tests run gloo worlds "
                         "of processes on the CPU, and the port imports no JAX"),
    "test_kubelet_plugin_loop.py": held(
        "test_torch_kubelet_sim.py", "test_torch_device_plugin.py", "test_torch_upgrade_kubesim.py"),
    "test_kubesim.py": held("test_torch_kubesim.py", "test_torch_kubesim_cases.py"),
    "test_lifecycle.py": held("test_torch_lifecycle.py", "test_torch_schedsim.py"),
    "test_lockwatch.py": held("test_torch_lockwatch.py"),
    "test_logonce.py": held("test_torch_logonce.py", "test_torch_write_pipeline.py"),
    "test_maintenance.py": held("test_torch_maintenance.py"),
    "test_manager.py": held("test_torch_manager.py", "test_torch_workqueue.py"),
    "test_manager_http.py": held("test_torch_manager.py"),
    "test_manager_kubesim.py": held("test_torch_manager_kubesim.py"),
    "test_metrics_noprom.py": held("test_torch_manager.py"),
    "test_metricsd.py": held("test_torch_metricsd.py"),
    "test_multihost_slice_loop.py": held("test_torch_multihost_slice_loop.py"),
    "test_must_gather.py": held("test_torch_must_gather.py"),
    "test_native.py": held("test_torch_native.py", "test_torch_gpuinfo.py"),
    "test_native_metricsd.py": held(
        "test_torch_native_metricsd.py", "test_torch_metricsd.py", "test_torch_exporter.py",
        "test_torch_object_controls.py"),
    "test_node_metrics.py": held("test_torch_node_metrics.py"),
    "test_obs.py": held("test_torch_obs.py", test_tracing_overhead_smoke=WALL),
    "test_operands.py": held("test_torch_operands.py", "test_torch_cdi.py", "test_torch_device_plugin.py"),
    "test_patch_labels.py": held("test_torch_patch_labels.py", "test_torch_kube.py"),
    "test_pipeline_moe.py": held("test_torch_pipeline_moe.py", "test_torch_validator.py"),
    "test_prometheus_rules.py": held("test_torch_prometheus_rules.py"),
    "test_reconcile_pass_bench.py": held(test_reconcile_pass_under_ceiling_at_1000_nodes=BENCH),
    "test_reconciler.py": held("test_torch_reconciler.py"),
    "test_remediation.py": held("test_torch_remediation.py"),
    "test_remediation_matrix.py": held("test_torch_remediation_matrix.py"),
    "test_render_cache.py": held(
        "test_torch_controllers_leaf.py", "test_torch_reconciler.py", "test_torch_state_machine.py"),
    "test_repartition.py": held("test_torch_repartition.py"),
    "test_resource_manager.py": held("test_torch_resource_manager.py", "test_torch_controllers_leaf.py"),
    "test_rest_client.py": held("test_torch_rest_client.py", "test_torch_incluster.py", "test_torch_kubesim.py"),
    "test_retry.py": held("test_torch_retry.py", "test_torch_kube.py"),
    "test_ring.py": held("test_torch_ring.py", "test_torch_validator.py"),
    "test_ringattn.py": held("test_torch_ringattn.py", "test_torch_validator.py"),
    "test_rollout.py": held("test_torch_rollout.py", "test_torch_assets.py"),
    "test_schedsim.py": held("test_torch_schedsim.py"),
    "test_schema_validate.py": held("test_torch_schema_validate.py", "test_torch_api.py"),
    "test_shard_bench.py": held(test_sharded_replicas_converge_balance_and_failover=BENCH),
    "test_shard_splitbrain.py": held("test_torch_shard.py"),
    "test_sharding.py": held("test_torch_shard.py", "test_torch_workqueue.py"),
    "test_slice_status.py": held(
        "test_torch_slice_status.py", "test_torch_reconciler.py", "test_torch_tfd.py",
        "test_torch_host_components.py",
        test_expected_hosts_derived_from_topology_when_tfd_absent=(
            f"{ADAPTED}: a GPU node carries no TPU topology labels to derive a host count from; without the "
            "slice-hosts label it is a single-host slice "
            "(tests/test_torch_slice_status.py::test_no_slice_hosts_label_means_single_host)")),
    "test_sliceman_kubesim.py": held("test_torch_sliceman.py"),
    "test_state_machine.py": held("test_torch_state_machine.py"),
    "test_taints.py": held("test_torch_taints.py"),
    "test_topology.py": held(
        "test_torch_topology.py",
        test_wraparound=f"{ADAPTED}: NVSwitch joins every pair of an NVLink domain in one hop; the fabric has "
                        "no torus and so no wraparound axis (tests/test_torch_topology.py holds the domains)"),
    "test_topology_properties.py": held("test_torch_topology_properties.py"),
    "test_upgrade.py": held("test_torch_upgrade.py"),
    "test_upgrade_kubesim.py": held("test_torch_upgrade_kubesim.py", "test_torch_upgrade_wire.py"),
    "test_upgrade_slices.py": held("test_torch_upgrade.py", "test_torch_upgrade_wire.py"),
    "test_validator.py": held(
        "test_torch_host_components.py", "test_torch_validator.py", "test_torch_workload_pods.py",
        "test_torch_dryrun.py", "test_torch_operands.py"),
    "test_warm_bench.py": held(test_warm_restart_first_pass_is_zero_write=BENCH),
    "test_workloads.py": held(
        "test_torch_matmul.py", "test_torch_membw.py", "test_torch_burnin.py", "test_torch_validator.py",
        "test_torch_dryrun.py"),
    "test_workqueue.py": held("test_torch_workqueue.py"),
    "test_write_pipeline.py": held("test_torch_write_pipeline.py"),
}

# reference suites whose every case that is not excused keeps its name
BY_NAME = {
    "test_alloc_bench.py", "test_analysis.py", "test_bench_gate.py", "test_chaos_flight.py",
    "test_chaos_kubesim.py", "test_churn_bench.py", "test_clusterpolicy_types.py", "test_concurrent_writers.py",
    "test_converge_bench.py", "test_daemonset_common.py", "test_debug_vars_schema.py", "test_delta_reconcile.py",
    "test_disruption.py", "test_fake_client.py", "test_fault_matrix.py", "test_http_e2e.py",
    "test_jax_cpu_mesh.py", "test_lifecycle.py", "test_lockwatch.py", "test_logonce.py", "test_maintenance.py",
    "test_manager.py", "test_manager_http.py", "test_manager_kubesim.py", "test_metrics_noprom.py",
    "test_multihost_slice_loop.py", "test_must_gather.py", "test_obs.py", "test_patch_labels.py",
    "test_prometheus_rules.py", "test_reconcile_pass_bench.py", "test_reconciler.py", "test_remediation.py",
    "test_remediation_matrix.py", "test_render_cache.py", "test_repartition.py", "test_resource_manager.py",
    "test_rest_client.py", "test_retry.py", "test_rollout.py", "test_schedsim.py", "test_schema_validate.py",
    "test_shard_bench.py", "test_shard_splitbrain.py", "test_sharding.py", "test_taints.py",
    "test_topology_properties.py", "test_upgrade.py", "test_upgrade_kubesim.py", "test_upgrade_slices.py",
    "test_warm_bench.py", "test_workqueue.py",
}


def reference_suites():
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(TESTS, "test_*.py"))
                  if not os.path.basename(p).startswith("test_torch_"))


def case_names(filename):
    """The ``def test_…`` names of a test file, read with ``ast``."""
    with open(os.path.join(TESTS, filename)) as f:
        tree = ast.parse(f.read(), filename)
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name.startswith("test_")}


def test_every_reference_suite_has_an_entry():
    suites = reference_suites()
    assert len(suites) >= 79, suites
    assert sorted(PARITY) == suites, {"no entry": sorted(set(suites) - set(PARITY)),
                                      "no such suite": sorted(set(PARITY) - set(suites))}
    assert BY_NAME <= set(PARITY), sorted(BY_NAME - set(PARITY))


@pytest.mark.parametrize("suite", sorted(PARITY))
def test_entry_is_sound(suite):
    """Each ``held_by`` file is a port test file that defines a test; each
    excused name is a case of the suite, with a reason of ``REASONS``; a
    suite that no port file holds has every case excused; a ``BY_NAME``
    suite's other cases are tests of the same name in its holders."""
    entry = PARITY[suite]
    cases = case_names(suite)
    holders = set()
    for port_file in entry["held_by"]:
        assert port_file.startswith("test_torch_"), port_file
        assert os.path.exists(os.path.join(TESTS, port_file)), port_file
        names = case_names(port_file)
        assert names, f"{port_file} defines no test"
        holders |= names
    for name, reason in entry["not_held"].items():
        assert name in cases, f"{suite} has no def {name}"
        assert reason.startswith(REASONS), (name, reason)
    if not entry["held_by"]:
        assert set(entry["not_held"]) == cases, sorted(cases - set(entry["not_held"]))
    if suite in BY_NAME:
        assert cases - set(entry["not_held"]) <= holders, sorted(cases - set(entry["not_held"]) - holders)
