"""The port's asset loader (``controllers/resource_manager.py``) against
the JAX package's, on the 4 cases of ``tests/test_resource_manager.py``:
the sorted walk with the OpenShift skip, controls in file order across
multi-document files, and the refusal of an unknown kind and of a
document without a kind.

Each case runs on each package (``two_sided.hold``) over the same state
directory, written once a case under ``tmp_path``, with the reference's
assertions made on each side; the file names, control names, objects and
error messages must be equal. Tolerance: exact equality.
``tests/test_torch_controllers_leaf.py`` runs both loaders over every
asset directory; these cases keep the reference's names and fixtures.
"""

from types import SimpleNamespace

import pytest

from tests.two_sided import BY_SIDE, hold
from tpu_operator.controllers import resource_manager as ref_rm
from tpu_operator_torch.controllers import resource_manager as rm

SIDES = {"reference": SimpleNamespace(name="reference", rm=ref_rm), "port": SimpleNamespace(name="port", rm=rm)}


@pytest.fixture()
def state_dir(tmp_path):
    (tmp_path / "0100_sa.yaml").write_text("apiVersion: v1\nkind: ServiceAccount\nmetadata: {name: sa}\n")
    (tmp_path / "0500_ds.yaml").write_text(
        "apiVersion: apps/v1\nkind: DaemonSet\nmetadata: {name: ds}\n"
        "---\n"
        "apiVersion: v1\nkind: ConfigMap\nmetadata: {name: cm}\n")
    (tmp_path / "0300_openshift_scc.yaml").write_text("kind: SecurityContextConstraints\nmetadata: {name: scc}\n")
    (tmp_path / "notes.txt").write_text("not yaml")
    (tmp_path / "subdir").mkdir()
    return tmp_path


@BY_SIDE
def test_sorted_walk_and_openshift_skip(side, state_dir):
    def script(side):
        walks = [[f.rsplit("/", 1)[1] for f in side.rm.get_assets_from(str(state_dir), openshift=o)]
                 for o in (False, True)]
        assert walks[0] == ["0100_sa.yaml", "0500_ds.yaml"]  # sorted, the SCC skipped
        assert walks[1] == ["0100_sa.yaml", "0300_openshift_scc.yaml", "0500_ds.yaml"]
        return walks

    hold(SIDES, side, script)


@BY_SIDE
def test_controls_in_file_order_with_multidoc(side, state_dir):
    def script(side):
        res, controls = side.rm.add_resources_controls(str(state_dir))
        names = [c for c, _ in controls]
        assert names == ["service_account", "daemonset", "config_map"]
        assert res.first("DaemonSet")["metadata"]["name"] == "ds"
        assert res.of("ConfigMap")[0]["metadata"]["name"] == "cm"
        assert res.of("Service") == []
        with pytest.raises(KeyError):
            res.first("Service")
        return names, [o for _, o in controls], res.first("DaemonSet"), res.of("ConfigMap")

    hold(SIDES, side, script)


def refusal(side, path, match):
    with pytest.raises(ValueError, match=match) as err:
        side.rm.add_resources_controls(str(path))
    return str(err.value).replace(str(path), "<dir>")


@BY_SIDE
def test_unknown_kind_rejected(side, tmp_path):
    (tmp_path / "0100_x.yaml").write_text("kind: FancyNewKind\nmetadata: {name: x}\n")
    hold(SIDES, side, refusal, tmp_path, "unhandled kind")


@BY_SIDE
def test_document_without_kind_rejected(side, tmp_path):
    (tmp_path / "0100_x.yaml").write_text("metadata: {name: x}\n")
    hold(SIDES, side, refusal, tmp_path, "without kind")
