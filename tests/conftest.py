"""Test configuration: run on CPU with 8 virtual devices.

This is the analog of the reference's ``mpirun -np {1,2,4}`` CTest harness
(SURVEY.md §4): XLA's host-platform device-count flag stands in for MPI ranks,
so distributed code paths (shard_map collectives) execute for real on one box.

The platform is pinned through jax.config as well as the environment, after
import and before any backend use, so the suite stays on the CPU on a machine
with a GPU.  Tests that need the card are marked ``chip`` and run the smoke
in a child process (tests/test_chip.py).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert len(jax.devices()) == 8, (
    f"tests need 8 virtual CPU devices, got {jax.devices()}"
)


# ---------------------------------------------------------------------------
# quick tier: `pytest -m quick` runs an inner-loop smoke subset (~2 min)
# covering every subsystem — the light modules whole, plus fast
# representatives of the heavy ones.  The full suite (~10-20 min depending
# on the box) stays the merge gate.
# ---------------------------------------------------------------------------

QUICK_FILES = {
    "test_geometry.py", "test_comm.py", "test_io.py", "test_timing.py",
    "test_mesh.py",
}
QUICK_TESTS = {
    # search: one per walk flavor + robustness
    "test_search_2d_rectangle", "test_search_3d_box",
    "test_search_2d_exit_domain", "test_search_2d_accel_matches_plain",
    "test_trace_dispatch", "test_check_initial_parents_delete_mode",
    "test_recover_project_accepts_adjacent_strand_rejects_far",
    # particle structures: build/rebuild/migrate basics per layout
    "test_build_counts_and_identity", "test_layout_invariants",
    "test_rebuild_variants", "test_migrate_single_rank",
    "test_metrics_padding", "test_count_per_key_matches_bincount",
    # models + distributed smoke
    "test_search2d_driver", "test_pseudo_xgcm_runs_and_conserves",
    "test_migrate_roundtrip", "test_reduce_comm_array_sum",
    "test_repartition_reduces_imbalance",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if item.path.name in QUICK_FILES or base in QUICK_TESTS:
            item.add_marker(pytest.mark.quick)
