"""The port's server-side apply (``kube/apply.py``, the APPLY verb, the
batch flush and lane, the apply-set) against the JAX package's, on the
cases of ``tests/test_apply.py`` past its warm journal: the merge math
(ownership, conflicts, force, prune, null deletes, no-op detection,
``reown``, JSON pointers), the verb on ``FakeClient`` (no-op, the human
write that conflicts a stale apply, update-only and create-only, the
pruned manifest field), the base ``Client``'s fallback, the batch flush's
fan-back and per-item failures, the lane's per-key ordering at every
depth, and the apply-set's commit, abort, retain and journal round trip
with the reconciler pruning an abandoned DaemonSet.

Each case runs on each package (``two_sided.hold``) with the same objects
and the reference's assertions made on each side; merged objects, owned
paths, conflicts, flags, error class names and abandoned keys must be
equal. The reconciler case renders each side's own assets from its own
sample CR; DaemonSet names cross through ``convert.operand_app_from_reference``.
Tolerance: exact equality. The journal's cases are held in
``tests/test_torch_warm.py``, which ages a journal by rewriting its stamp
instead of sleeping.
"""

import os
import threading
import time
from types import SimpleNamespace

import pytest
import yaml

from tests.two_sided import BY_SIDE, hold
from tpu_operator.controllers import clusterpolicy_controller as ref_cpc
from tpu_operator.kube import apply as ref_ssa
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube import write_pipeline as ref_wp
from tpu_operator_torch import consts, convert
from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
from tpu_operator_torch.kube import apply as ssa
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import testing
from tpu_operator_torch.kube import write_pipeline as wp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"

SIDES = {
    "reference": SimpleNamespace(
        name="reference", ssa=ref_ssa, k=ref_kclient, wp=ref_wp, cpc=ref_cpc, testing=ref_testing,
        node=ref_testing.make_tpu_node, assets=os.path.join(REPO, "assets"),
        app=convert.operand_app_from_reference, ref_app=lambda a: a),
    "port": SimpleNamespace(
        name="port", ssa=ssa, k=kclient, wp=wp, cpc=cpc, testing=testing, node=testing.make_gpu_node,
        assets=os.path.join(REPO, "tpu_operator_torch", "assets"), app=lambda a: a,
        ref_app=convert.operand_app_from_reference),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def node(name, labels=None):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": dict(labels or {})}}


def ds(name, ns=NS, image="img:1"):
    return {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": {"containers": [{"name": "c", "image": image}]}}}}


def manager_name(side, name):
    """A field manager in the port's names: each side's default manager
    is its process's own (``tpu-operator``, ``gpu-operator``)."""
    return ssa.DEFAULT_FIELD_MANAGER if name == side.ssa.DEFAULT_FIELD_MANAGER else name


def owned(side, obj):
    """The managed fields as sorted paths by manager."""
    return {manager_name(side, m): sorted(paths) for m, paths in side.ssa.decode_managed(obj).items()}


# --- the merge math ------------------------------------------------------------

@BY_SIDE
def test_create_records_ownership(side):
    def script(side):
        s = side.ssa
        created = s.create_from_applied(node("n1", {"a": "1"}))
        mine = s.decode_managed(created)[s.DEFAULT_FIELD_MANAGER]
        assert ("metadata", "labels", "a") in mine
        assert ("metadata", "name") not in mine  # identity fields are never owned
        return side.ssa.strip_managed(created), owned(side, created)

    hold(SIDES, side, script)


@BY_SIDE
def test_noop_apply_reports_unchanged(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"a": "1"}))
        merged, changed, conflicts = s.apply_merge(stored, node("n1", {"a": "1"}))
        assert not changed and not conflicts
        assert s.strip_managed(merged) == s.strip_managed(stored)
        return changed, conflicts

    hold(SIDES, side, script)


@BY_SIDE
def test_conflict_names_field_and_owner(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"pause": "false"}), manager="human")
        merged, changed, conflicts = s.apply_merge(stored, node("n1", {"pause": "true"}), force=False)
        assert merged is stored and not changed
        assert conflicts == [("/metadata/labels/pause", "human")]
        return conflicts

    hold(SIDES, side, script)


@BY_SIDE
def test_force_transfers_ownership(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"pause": "false"}), manager="human")
        merged, changed, _ = s.apply_merge(stored, node("n1", {"pause": "true"}), force=True)
        assert changed and merged["metadata"]["labels"]["pause"] == "true"
        got = owned(side, merged)
        assert ("metadata", "labels", "pause") in got[ssa.DEFAULT_FIELD_MANAGER]
        assert "human" not in got
        return merged["metadata"]["labels"], got

    hold(SIDES, side, script)


@BY_SIDE
def test_equal_value_co_set_never_conflicts(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"a": "1"}), manager="human")
        _, changed, conflicts = s.apply_merge(stored, node("n1", {"a": "1"}), force=False)
        assert not conflicts
        return changed, conflicts

    hold(SIDES, side, script)


@BY_SIDE
def test_prune_removes_omitted_owned_fields(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"a": "1", "b": "2"}))
        merged, changed, _ = s.apply_merge(stored, node("n1", {"a": "1"}), prune=True)
        assert changed and "b" not in merged["metadata"]["labels"]
        return merged["metadata"]["labels"], owned(side, merged)

    hold(SIDES, side, script)


@BY_SIDE
def test_prune_never_touches_other_managers_fields(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"mine": "1"}))
        other, _, _ = s.apply_merge(stored, node("n1", {"theirs": "x"}), manager="tfd", prune=False)
        merged, _, _ = s.apply_merge(other, node("n1", {"mine": "2"}))
        assert merged["metadata"]["labels"] == {"mine": "2", "theirs": "x"}
        return merged["metadata"]["labels"], owned(side, merged)

    hold(SIDES, side, script)


@BY_SIDE
def test_delta_apply_accrues_ownership_without_prune(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"a": "1"}))
        step1, _, _ = s.apply_merge(stored, node("n1", {"b": "2"}), prune=False)
        assert step1["metadata"]["labels"] == {"a": "1", "b": "2"}
        mine = s.decode_managed(step1)[s.DEFAULT_FIELD_MANAGER]
        assert ("metadata", "labels", "a") in mine and ("metadata", "labels", "b") in mine
        return owned(side, step1)

    hold(SIDES, side, script)


@BY_SIDE
def test_null_deletes_foreign_leaf_without_conflict(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"stale": "x"}), manager="tfd")
        merged, changed, conflicts = s.apply_merge(stored, node("n1", {"stale": None}), force=False, prune=False)
        assert changed and not conflicts
        assert "labels" not in merged["metadata"]  # the emptied map is pruned
        assert s.decode_managed(merged) == {}
        return merged

    hold(SIDES, side, script)


@BY_SIDE
def test_reown_moves_changed_leaves_to_unmanaged(side):
    def script(side):
        s = side.ssa
        stored = s.create_from_applied(node("n1", {"a": "1", "b": "2"}))
        new = node("n1", {"a": "1", "b": "HUMAN"})
        s.reown(stored, new)
        got = owned(side, new)
        assert ("metadata", "labels", "b") in got[s.UNMANAGED]
        assert ("metadata", "labels", "a") in got[ssa.DEFAULT_FIELD_MANAGER]
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_json_pointer_roundtrip_escapes(side):
    def script(side):
        path = ("metadata", "labels", f"{consts.GROUP}/tpu.present")
        encoded = side.ssa.encode_path(path)
        assert side.ssa.decode_path(encoded) == path
        return encoded

    hold(SIDES, side, script)


# --- the APPLY verb --------------------------------------------------------------

@BY_SIDE
def test_noop_apply_does_not_bump_rv(side):
    def script(side):
        c = side.k.FakeClient()
        rv = c.apply_ssa(ds("d1"))["metadata"]["resourceVersion"]
        again = c.apply_ssa(ds("d1"))["metadata"]["resourceVersion"]
        assert again == rv
        return rv, again

    hold(SIDES, side, script)


@BY_SIDE
def test_human_write_conflicts_stale_apply(side):
    def script(side):
        c = side.k.FakeClient()
        c.apply_ssa(node("n1", {"deploy": "true"}), prune=False)
        c.patch_labels("v1", "Node", "n1", labels={"deploy": "false"})  # re-owned as unmanaged
        with pytest.raises(side.ssa.ApplyConflictError) as ei:
            c.apply_ssa(node("n1", {"deploy": "true"}), force=False, prune=False)
        assert "/metadata/labels/deploy" in str(ei.value)
        kept = c.get("v1", "Node", "n1")["metadata"]["labels"]["deploy"]
        assert kept == "false"  # the pause stands
        return str(ei.value), kept

    hold(SIDES, side, script)


@BY_SIDE
def test_update_only_refuses_creation(side):
    def script(side):
        with pytest.raises(side.k.NotFoundError) as err:
            side.k.FakeClient().apply_ssa(node("ghost", {"a": "1"}), update_only=True)
        return type(err.value).__name__

    hold(SIDES, side, script)


@BY_SIDE
def test_create_only_refuses_existing(side):
    def script(side):
        c = side.k.FakeClient()
        c.apply_ssa(ds("d1"))
        with pytest.raises(side.k.ConflictError) as err:
            c.apply_ssa(ds("d1"), create_only=True)
        return type(err.value).__name__

    hold(SIDES, side, script)


@BY_SIDE
def test_prune_collapses_dropped_manifest_field(side):
    def script(side):
        c = side.k.FakeClient()
        first = ds("d1")
        first["spec"]["template"]["spec"]["nodeSelector"] = {"old": "true"}
        c.apply_ssa(first)
        c.apply_ssa(ds("d1"))
        stored = c.get("apps/v1", "DaemonSet", "d1", NS)
        assert "nodeSelector" not in stored["spec"]["template"]["spec"]
        return stored["spec"]

    hold(SIDES, side, script)


# --- the base Client's fallback --------------------------------------------------

def wrapper(side, inner):
    """A ``Client`` of the side whose storage is ``inner`` and whose
    ``apply_ssa`` is the base class's read-merge-update."""

    class Wrapper(side.k.Client):
        def get(self, *a, **k):
            return inner.get(*a, **k)

        def get_or_none(self, *a, **k):
            return inner.get_or_none(*a, **k)

        def list(self, *a, **k):
            return inner.list(*a, **k)

        def create(self, obj):
            return inner.create(obj)

        def update(self, obj):
            return inner.update(obj)

        def delete_if_exists(self, *a, **k):
            return inner.delete_if_exists(*a, **k)

    return Wrapper()


@BY_SIDE
def test_same_manager_never_conflicts_with_itself(side):
    def script(side):
        c = wrapper(side, side.k.FakeClient())
        c.apply_ssa(node("n1", {"a": "1"}), force=False, prune=False)
        out = c.apply_ssa(node("n1", {"a": "2"}), force=False, prune=False)
        assert out["metadata"]["labels"]["a"] == "2"
        return out["metadata"]["labels"]

    hold(SIDES, side, script)


@BY_SIDE
def test_foreign_write_still_conflicts(side):
    def script(side):
        inner = side.k.FakeClient()
        c = wrapper(side, inner)
        c.apply_ssa(node("n1", {"a": "1"}), force=False, prune=False)
        human = inner.get("v1", "Node", "n1", copy=True)
        human["metadata"]["labels"]["a"] = "paused"
        inner.update(human)
        with pytest.raises(side.ssa.ApplyConflictError) as err:
            c.apply_ssa(node("n1", {"a": "2"}), force=False, prune=False)
        kept = inner.get("v1", "Node", "n1")["metadata"]["labels"]["a"]
        assert kept == "paused"
        return str(err.value), kept

    hold(SIDES, side, script)


# --- batched submission ------------------------------------------------------------

@BY_SIDE
def test_mixed_collections_fan_back_in_caller_order(side):
    def script(side):
        c = side.k.FakeClient()
        payloads = [ds("d1"), node("n1", {"a": "1"}), ds("d2"), node("n2", {"a": "1"})]
        results = side.ssa.batch_flush(c, payloads)
        assert len(results) == 4
        got = []
        for payload, (obj, err) in zip(payloads, results):
            assert err is None
            assert (obj["kind"], obj["metadata"]["name"]) == (payload["kind"], payload["metadata"]["name"])
            got.append((obj["kind"], obj["metadata"]["name"], obj["metadata"]["resourceVersion"]))
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_failed_item_fails_only_itself(side):
    def script(side):
        c = side.k.FakeClient()
        c.apply_ssa(node("exists", {}))
        (ok, err0), (bad, err1) = side.ssa.batch_flush(
            c, [node("exists", {"a": "1"}), node("ghost", {"a": "1"})], update_only=True)
        assert err0 is None and ok["metadata"]["labels"]["a"] == "1"
        assert bad is None and isinstance(err1, side.k.NotFoundError)
        return ok["metadata"]["labels"], type(err1).__name__

    hold(SIDES, side, script)


@BY_SIDE
@pytest.mark.parametrize("depth", [2, 8, 64])
def test_same_key_revisions_never_apply_out_of_order(side, depth):
    """Interleaved revision streams of ten keys through one lane: every
    key's revisions are flushed strictly in order, at any depth."""

    def script(side, depth):
        applied = []
        lock = threading.Lock()

        def flush(payloads):
            time.sleep(0.001 * (len(payloads) % 3))  # uneven service times
            with lock:
                applied.extend(payloads)
            return [(p, None) for p in payloads]

        pipe = side.wp.WritePipeline(depth=depth, name=f"order-{depth}")
        lane = side.wp.BatchLane(pipe, flush, name="prop")
        keys = [f"node-{i}" for i in range(10)]
        futs = [lane.submit(k, (k, rev)) for rev in range(25) for k in keys]
        pipe.drain()
        results = [f.result() for f in futs]
        seen = {}
        for k, rev in applied:
            assert rev == seen.get(k, -1) + 1, f"{k} applied revision {rev} after {seen.get(k)}"
            seen[k] = rev
        assert all(seen[k] == 24 for k in keys)
        return seen, sorted(results)

    hold(SIDES, side, script, depth)


@BY_SIDE
def test_one_failed_item_fails_only_its_future_and_names_it(side):
    def script(side):
        c = side.k.FakeClient()
        c.apply_ssa(node("good-1", {}))
        c.apply_ssa(node("good-2", {}))
        pipe = side.wp.WritePipeline(depth=4, name="err-agg")
        lane = side.wp.BatchLane(
            pipe, lambda payloads: side.ssa.batch_flush(c, payloads, force=False, prune=False, update_only=True),
            name="labels")
        f1 = lane.submit("good-1", node("good-1", {"a": "1"}))
        f2 = lane.submit("vanished", node("vanished", {"a": "1"}))
        f3 = lane.submit("good-2", node("good-2", {"a": "1"}))
        pipe.drain(raise_errors=True)  # per-item failures stay at their futures
        assert f1.result()["metadata"]["labels"]["a"] == "1"
        assert f3.result()["metadata"]["labels"]["a"] == "1"
        with pytest.raises(side.k.NotFoundError) as ei:
            f2.result()
        assert "vanished" in str(ei.value)
        assert lane.stats()["items_failed_total"] == 1
        assert pipe.errors_total == 0
        return type(ei.value).__name__, lane.stats()["items_failed_total"], pipe.errors_total

    hold(SIDES, side, script)


# --- the apply-set -----------------------------------------------------------------

KEY = ("apps/v1", "DaemonSet", NS)


@BY_SIDE
def test_commit_returns_only_abandoned_seen_keys(side):
    def script(side):
        s = side.ssa.ApplySet()
        s.begin_pass()
        s.seen(*KEY, "a")
        s.seen(*KEY, "b")
        first = s.commit()
        s.begin_pass()
        s.seen(*KEY, "b")
        second = s.commit()
        assert first == [] and second == [KEY + ("a",)]
        return first, second

    hold(SIDES, side, script)


@BY_SIDE
def test_abort_keeps_last_complete_membership(side):
    def script(side):
        s = side.ssa.ApplySet()
        s.begin_pass()
        s.seen(*KEY, "a")
        s.commit()
        s.begin_pass()  # this pass dies before registering anything
        s.abort()
        s.begin_pass()
        s.seen(*KEY, "a")
        out = s.commit()
        assert out == []  # "a" was never abandoned
        return out, sorted(map(tuple, s.members()))

    hold(SIDES, side, script)


@BY_SIDE
def test_retain_resurfaces_failed_prune(side):
    def script(side):
        s = side.ssa.ApplySet()
        s.begin_pass()
        s.seen(*KEY, "old")
        s.commit()
        s.begin_pass()
        abandoned = s.commit()
        assert abandoned == [KEY + ("old",)]
        s.retain(abandoned[0])  # its delete failed: it stays a member
        s.begin_pass()
        again = s.commit()
        assert again == abandoned  # the next pass retries
        return abandoned, again

    hold(SIDES, side, script)


@BY_SIDE
def test_journal_roundtrip_preserves_membership(side):
    def script(side):
        s = side.ssa.ApplySet()
        s.begin_pass()
        s.seen(*KEY, "a")
        s.commit()
        restored = side.ssa.ApplySet(s.members())
        restored.begin_pass()
        out = restored.commit()
        assert out == [KEY + ("a",)]
        return out

    hold(SIDES, side, script)


@BY_SIDE
def test_reconciler_prunes_abandoned_daemonset(side):
    """A DaemonSet a previous pass applied under a name the render no
    longer produces is deleted by the apply-set's prune on the next
    completed pass; the current operands stay."""

    def script(side):
        client = side.k.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                                    side.node("gpu-node-1")])
        with open(side.testing.sample_clusterpolicy_path()) as f:
            client.create(yaml.safe_load(f))
        r = side.cpc.ClusterPolicyReconciler(client, assets_dir=side.assets)
        retired = side.ref_app("tpu-device-plugin") + "-v1-legacy"
        client.apply_ssa(ds(retired))
        r.ctrl.applyset = side.ssa.ApplySet([KEY + (retired,)])
        r.reconcile()
        assert client.get_or_none("apps/v1", "DaemonSet", retired, NS) is None, \
            "abandoned DaemonSet survived the apply-set prune"
        names = sorted(side.app(d["metadata"]["name"]) for d in client.list("apps/v1", "DaemonSet", NS))
        assert side.ref_app("tpu-feature-discovery") in {d["metadata"]["name"]
                                                         for d in client.list("apps/v1", "DaemonSet", NS)}
        return names

    hold(SIDES, side, script)
