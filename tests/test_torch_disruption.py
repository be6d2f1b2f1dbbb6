"""The port's PodDisruptionBudget selectors and veto arithmetic
(``kube/disruption.py``) against the JAX package's, on the 8 cases of
``tests/test_disruption.py``: the ``matchExpressions`` operators (``In``,
``NotIn``, ``Exists``, ``DoesNotExist``, an unknown one failing closed),
``matchLabels`` and expressions together, and evictions vetoed or allowed
through budgets that select by expression.

Each case runs on each package (``two_sided.hold``) with the same pods and
budgets and the reference's assertions made on each side; every verdict
must be equal. Tolerance: exact equality. ``tests/test_torch_kube.py``
compares ``eviction_blocked_by`` over a table of budgets; these cases keep
the reference's names and assertions.
"""

from types import SimpleNamespace

from tests.two_sided import BY_SIDE, hold
from tpu_operator.kube import disruption as ref_disruption
from tpu_operator_torch.kube import disruption

SIDES = {"reference": SimpleNamespace(name="reference", d=ref_disruption),
         "port": SimpleNamespace(name="port", d=disruption)}


def pod(name, labels=None, healthy=True, namespace="default"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": namespace, "labels": labels or {}},
            "status": {"phase": "Running" if healthy else "Pending"}}


def pdb(name, selector, min_available=None, max_unavailable=None):
    spec = {"selector": selector}
    if min_available is not None:
        spec["minAvailable"] = min_available
    if max_unavailable is not None:
        spec["maxUnavailable"] = max_unavailable
    return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": {"name": name, "namespace": "default"}, "spec": spec}


def matches(side, sel, cases):
    """``_selector_matches`` on each ``(labels, want)``."""
    got = [side.d._selector_matches(sel, pod(f"p{i}", labels)) for i, (labels, _) in enumerate(cases)]
    assert got == [want for _, want in cases], got
    return got


def expr(op, values=None):
    e = {"key": "tier", "operator": op}
    if values is not None:
        e["values"] = values
    return {"matchExpressions": [e]}


@BY_SIDE
def test_match_expressions_in(side):
    hold(SIDES, side, matches, expr("In", ["train", "batch"]),
         [({"tier": "train"}, True), ({"tier": "batch"}, True), ({"tier": "serve"}, False), ({}, False)])


@BY_SIDE
def test_match_expressions_notin(side):
    # NotIn: a pod without the key matches
    hold(SIDES, side, matches, expr("NotIn", ["serve"]),
         [({"tier": "train"}, True), ({}, True), ({"tier": "serve"}, False)])


@BY_SIDE
def test_match_expressions_exists(side):
    hold(SIDES, side, matches, expr("Exists"),
         [({"tier": "anything"}, True), ({"tier": ""}, True), ({"other": "x"}, False)])


@BY_SIDE
def test_match_expressions_does_not_exist(side):
    hold(SIDES, side, matches, expr("DoesNotExist"), [({"other": "x"}, True), ({"tier": "train"}, False)])


@BY_SIDE
def test_match_expressions_unknown_operator_fails_closed(side):
    hold(SIDES, side, matches, expr("Bogus"), [({"tier": "train"}, False)])


@BY_SIDE
def test_match_labels_and_expressions_combine(side):
    sel = {"matchLabels": {"app": "train"}, "matchExpressions": [{"key": "gen", "operator": "Exists"}]}
    hold(SIDES, side, matches, sel,
         [({"app": "train", "gen": "v5e"}, True), ({"app": "train"}, False), ({"gen": "v5e"}, False)])


@BY_SIDE
def test_eviction_vetoed_via_exists_selector(side):
    """A budget selecting by Exists vetoes exactly its own pods."""

    def script(side):
        budget = pdb("gang", {"matchExpressions": [{"key": "gang", "operator": "Exists"}]}, min_available=2)
        gang = [pod("g1", {"gang": "a"}), pod("g2", {"gang": "a"})]
        loner = pod("solo", {"other": "x"})
        blocked = side.d.eviction_blocked_by(gang[0], gang + [loner], [budget])
        assert blocked is not None and blocked[0] == "gang"  # 1 < 2 healthy would remain
        free = side.d.eviction_blocked_by(loner, gang + [loner], [budget])
        assert free is None
        return blocked, free

    hold(SIDES, side, script)


@BY_SIDE
def test_eviction_allowed_via_does_not_exist_selector(side):
    """A DoesNotExist budget: pods carrying the key are outside it."""

    def script(side):
        budget = pdb("non-gang", {"matchExpressions": [{"key": "gang", "operator": "DoesNotExist"}]},
                     max_unavailable=0)
        gang_pod, plain = pod("g1", {"gang": "a"}), pod("p1", {})
        verdicts = [side.d.eviction_blocked_by(p, [gang_pod, plain], [budget]) for p in (gang_pod, plain)]
        assert verdicts[0] is None and verdicts[1] is not None
        return verdicts

    hold(SIDES, side, script)
