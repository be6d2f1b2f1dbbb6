"""The port's log-once registry (``obs/logonce.py``) against the JAX
package's, on the 5 cases of ``tests/test_logonce.py``: one line at INFO a
key and its repeats at DEBUG, a cleared key logging again, pruning dead
subjects only, the set surface, and the three registries that use it (the
no-card DaemonSet skip, remediation's and re-partition's).

Each case runs on each package (``two_sided.hold``) with the same keys and
the reference's assertions made on each side; the verdicts, the log lines
(level and message), the members and counts must be equal. Tolerance:
exact equality. ``tests/test_torch_write_pipeline.py`` drives one script
through both registries; these cases keep the reference's names.
"""

import logging
from types import SimpleNamespace

import pytest

from tests.two_sided import BY_SIDE, hold
from tpu_operator.controllers import remediation as ref_rem
from tpu_operator.controllers import repartition as ref_rp
from tpu_operator.controllers import state_manager as ref_sm
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.obs import logonce as ref_logonce
from tpu_operator_torch import consts
from tpu_operator_torch.controllers import remediation as rem
from tpu_operator_torch.controllers import repartition as rp
from tpu_operator_torch.controllers import state_manager as sm
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.obs import logonce

SIDES = {
    "reference": SimpleNamespace(name="reference", lo=ref_logonce, rem=ref_rem, rp=ref_rp, sm=ref_sm,
                                 FakeClient=RefFakeClient),
    "port": SimpleNamespace(name="port", lo=logonce, rem=rem, rp=rp, sm=sm, FakeClient=FakeClient),
}
LOGGER = "logonce-test"
log = logging.getLogger(LOGGER)


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, "tpu-operator")
    monkeypatch.setenv("UNIT_TEST", "true")


def lines(caplog, needle):
    return [(r.levelname, r.getMessage()) for r in caplog.records if r.name == LOGGER and needle in r.getMessage()]


@BY_SIDE
def test_log_once_then_debug(side, caplog):
    def script(side):
        caplog.clear()
        reg = side.lo.LogOnce()
        with caplog.at_level(logging.DEBUG, logger=LOGGER):
            firsts = [reg.log(log, ("n1", "budget"), "deferred %s", "n1"),
                      reg.log(log, ("n1", "budget"), "deferred %s", "n1"),
                      reg.log(log, ("n2", "budget"), "deferred %s", "n2")]
        assert firsts == [True, False, True]
        got = lines(caplog, "deferred")
        assert [lvl for lvl, _ in got].count("INFO") == 2  # one a key, repeats at DEBUG
        assert [lvl for lvl, _ in got].count("DEBUG") == 1
        return firsts, got

    hold(SIDES, side, script)


@BY_SIDE
def test_clear_makes_a_new_stretch_log_again(side, caplog):
    def script(side):
        caplog.clear()
        reg = side.lo.LogOnce()
        with caplog.at_level(logging.INFO, logger=LOGGER):
            reg.log(log, "ds-a", "skip %s", "ds-a")
            reg.clear("ds-a")  # the condition cleared
            reg.log(log, "ds-a", "skip %s", "ds-a")
        got = [line for line in lines(caplog, "skip") if line[0] == "INFO"]
        assert len(got) == 2
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_prune_retires_dead_subjects_only(side):
    def script(side):
        reg = side.lo.LogOnce()
        for key in (("alive", "budget"), ("dead", "budget"), ("dead", "interlock"), "plain-alive", "plain-dead"):
            reg.add(key)
        dropped = reg.prune({"alive", "plain-alive"})
        assert dropped == 3
        members = [k in reg for k in (("alive", "budget"), ("dead", "budget"), ("dead", "interlock"),
                                      "plain-alive", "plain-dead")]
        assert members == [True, False, False, True, False]
        assert len(reg) == 2
        return dropped, members, len(reg)

    hold(SIDES, side, script)


@BY_SIDE
def test_set_surface_compat(side):
    def script(side):
        reg = side.lo.LogOnce()
        reg.add("x")
        seen = ["x" in reg, len(reg)]
        reg.discard("x")
        seen.append("x" in reg)
        reg.add("y")
        reg.clear()  # no argument: a full reset
        seen.append(len(reg))
        assert seen == [True, 1, False, 0]
        return seen

    hold(SIDES, side, script)


@BY_SIDE
def test_all_three_registries_are_logonce(side):
    def script(side):
        client = side.FakeClient()
        regs = [side.sm.ClusterPolicyController(client).no_tpu_skip_logged,
                side.rem.NodeRemediationController(client)._logged,
                side.rp.SliceRepartitionController(client)._logged]
        kinds = [isinstance(r, side.lo.LogOnce) for r in regs]
        assert kinds == [True, True, True]
        return kinds

    hold(SIDES, side, script)
