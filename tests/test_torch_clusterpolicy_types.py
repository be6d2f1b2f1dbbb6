"""The port's ClusterPolicy types (``api/v1/clusterpolicy_types.py``)
against the JAX package's, on the 5 cases of
``tests/test_clusterpolicy_types.py``: the sample CR's round trip, image
path resolution, the ``is_enabled`` defaults, the state enum and the
upgrade policy's defaults.

Each case runs on each package (``two_sided.hold``) with the reference's
assertions made on each side. The port gets the reference's CR through
``convert.clusterpolicy_from_reference``; its driver section, image names
and image environment variables are the rename table's
(``KEY_RENAMES``, ``VALUE_RENAMES``, ``ENV_VAR_RENAMES``), never a literal.
The outcomes (the encoded CR, the resolved image paths, the defaults) are
compared in the port's names. Tolerance: exact equality.
"""

import os
from types import SimpleNamespace

from tests.two_sided import BY_SIDE, hold
from tpu_operator.api.v1 import clusterpolicy_types as ref_cpt
from tpu_operator_torch import convert
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt

REF_DRIVER, REF_IMAGE = "libtpu", "libtpu-installer"


def port_text(text):
    """A reference string in the port's words, by ``VALUE_RENAMES``."""
    for old in sorted(cpt.VALUE_RENAMES, key=len, reverse=True):
        text = text.replace(old, cpt.VALUE_RENAMES[old])
    return text


SIDES = {
    "reference": SimpleNamespace(
        name="reference", cpt=ref_cpt, driver_spec=ref_cpt.LibtpuSpec, driver=REF_DRIVER, image=REF_IMAGE,
        env=ref_cpt.LibtpuSpec.ENV_VAR, cr=lambda o: o, to_port=convert.clusterpolicy_from_reference, text=port_text),
    "port": SimpleNamespace(
        name="port", cpt=cpt, driver_spec=cpt.DriverSpec, driver=cpt.KEY_RENAMES[("spec", REF_DRIVER)],
        image=cpt.VALUE_RENAMES[REF_IMAGE], env=cpt.ENV_VAR_RENAMES[ref_cpt.LibtpuSpec.ENV_VAR],
        cr=convert.clusterpolicy_from_reference, to_port=lambda o: o, text=lambda t: t),
}

SAMPLE = {
    "apiVersion": "tpu.k8s.io/v1",
    "kind": "ClusterPolicy",
    "metadata": {"name": "cluster-policy"},
    "spec": {
        "operator": {"defaultRuntime": "containerd", "runtimeClass": "tpu"},
        "daemonsets": {"tolerations": [{"key": "google.com/tpu", "operator": "Exists", "effect": "NoSchedule"}]},
        "libtpu": {
            "enabled": True,
            "repository": "gcr.io/tpu-operator",
            "image": "libtpu-installer",
            "version": "1.2.3",
            "generationConfigs": {"v5p": "1.2.3-v5p"},
            "upgradePolicy": {"autoUpgrade": True, "maxUnavailable": "25%"},
        },
        "devicePlugin": {"enabled": True, "repository": "gcr.io/tpu-operator", "image": "tpu-device-plugin",
                         "version": "0.9"},
        "validator": {"repository": "gcr.io/tpu-operator", "image": "tpu-operator-validator", "version": "0.9"},
        "sandboxWorkloads": {"enabled": False},
    },
}


def driver_of(side, spec):
    return getattr(spec, side.driver)


@BY_SIDE
def test_round_trip(side):
    def script(side):
        t = side.cpt
        cp = t.clusterpolicy_from_obj(side.cr(SAMPLE))
        drv = driver_of(side, cp.spec)
        assert cp.name == "cluster-policy"
        assert drv.repository == "gcr.io/tpu-operator"
        assert drv.generation_configs == {"v5p": "1.2.3-v5p"}
        assert drv.upgrade_policy.is_auto_upgrade_enabled()
        obj = t.clusterpolicy_to_obj(cp)
        assert obj["spec"][side.driver]["generationConfigs"] == {"v5p": "1.2.3-v5p"}
        assert obj["spec"][side.driver]["upgradePolicy"]["autoUpgrade"] is True
        assert t.clusterpolicy_to_obj(t.clusterpolicy_from_obj(obj)) == obj  # stable
        return side.to_port(obj)

    hold(SIDES, side, script)


@BY_SIDE
def test_image_path_resolution(side):
    def script(side):
        spec = side.driver_spec(repository="gcr.io/x", image=side.image, version="9.9")
        paths = [spec.image_path()]
        assert paths[-1] == f"gcr.io/x/{side.image}:9.9"
        spec.version = "sha256:" + "a" * 64  # the digest form
        paths.append(spec.image_path())
        assert paths[-1] == f"gcr.io/x/{side.image}@sha256:" + "a" * 64
        os.environ[side.env] = f"gcr.io/env/{side.image}:7"  # the environment's fallback
        try:
            paths.append(side.driver_spec().image_path())
        finally:
            del os.environ[side.env]
        assert paths[-1] == f"gcr.io/env/{side.image}:7"
        return [side.text(p) for p in paths]

    hold(SIDES, side, script)


@BY_SIDE
def test_is_enabled_defaults(side):
    def script(side):
        spec = side.cpt.ClusterPolicySpec()
        got = {"driver": driver_of(side, spec).is_enabled(), "devicePlugin": spec.device_plugin.is_enabled(),
               "sandboxWorkloads": spec.sandbox_workloads.is_enabled(), "psp": spec.psp.is_enabled(),
               "cdi": (spec.cdi.is_enabled(), spec.cdi.is_default())}
        # unset means enabled; the sandbox gates default off; CDI defaults on
        assert got == {"driver": True, "devicePlugin": True, "sandboxWorkloads": False, "psp": False,
                       "cdi": (True, True)}
        driver_of(side, spec).enabled = False
        assert not driver_of(side, spec).is_enabled()
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_state_enum(side):
    def script(side):
        s = side.cpt.State
        got = (s.READY, s.NOT_READY, s.IGNORED, s.DISABLED)
        assert got == ("ready", "notReady", "ignored", "disabled")
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_upgrade_policy_defaults(side):
    def script(side):
        up = side.cpt.UpgradePolicySpec.from_dict({})
        got = (up.is_auto_upgrade_enabled(), up.max_parallel_upgrades, up.max_unavailable)
        assert got == (False, 1, "25%")
        return got

    hold(SIDES, side, script)
