"""The port's ClusterPolicy types, schema validation, CRD generation and
``gpuop-cfg`` (``api/v1/``, ``cfg/``) against the JAX package's, on the
same CRs carried across by ``convert.clusterpolicy_from_reference``.

The corpus is every CR of the reference's tests and its sample: the
sample, the types test's CR, the CLI's invalid CR, and the admission
cases (typo, enum, int-or-string, bounds, typed map, unknown field,
defaulting). For each, the port's problems and defaults must be the
reference's through the rename table (``reference_problem_as_port``
renames the paths and the quoted values in a problem)."""

import copy
import os
import re
import subprocess
import sys

import pytest
import yaml

from tpu_operator.api.v1 import clusterpolicy_types as ref_cpt
from tpu_operator.cfg import crdgen as ref_crdgen
from tpu_operator.cfg import main as ref_main
from tpu_operator.cfg import schema_validate as ref_sv
from tpu_operator_torch import convert
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt
from tpu_operator_torch.cfg import crdgen
from tpu_operator_torch.cfg import main as cfg_main
from tpu_operator_torch.cfg import schema_validate as sv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SAMPLE = os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")
PORT_SAMPLE = os.path.join(REPO, "tpu_operator_torch", "api", "v1", "sample_clusterpolicy.yaml")


def _sample():
    with open(REF_SAMPLE) as f:
        return yaml.safe_load(f)


def _cp(spec):
    return {"apiVersion": "tpu.k8s.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": "cluster-policy"}, "spec": spec}


def _edit(fn):
    cr = _sample()
    fn(cr["spec"])
    return cr


def _cfg_invalid(spec):
    spec["devicePlugin"]["version"] = ""
    spec["slice"]["strategy"] = "bogus"
    spec["libtpu"]["upgradePolicy"] = {"maxUnavailable": "x%"}


TYPES_SAMPLE = _cp({
    "operator": {"defaultRuntime": "containerd", "runtimeClass": "tpu"},
    "daemonsets": {"tolerations": [{"key": "google.com/tpu", "operator": "Exists", "effect": "NoSchedule"}]},
    "libtpu": {"enabled": True, "repository": "gcr.io/tpu-operator", "image": "libtpu-installer",
               "version": "1.2.3", "generationConfigs": {"v5p": "1.2.3-v5p"},
               "upgradePolicy": {"autoUpgrade": True, "maxUnavailable": "25%"}},
    "devicePlugin": {"enabled": True, "repository": "gcr.io/tpu-operator", "image": "tpu-device-plugin",
                     "version": "0.9"},
    "validator": {"repository": "gcr.io/tpu-operator", "image": "tpu-operator-validator", "version": "0.9"},
    "sandboxWorkloads": {"enabled": False},
})

# every CR of the reference's tests and samples, as the reference writes it
CORPUS = {
    "sample": _sample(),
    "types-sample": TYPES_SAMPLE,
    "cfg-invalid": _edit(_cfg_invalid),
    "typo": _edit(lambda s: s["devicePlugin"].update(verison="oops")),
    "enum-runtime": _edit(lambda s: s["operator"].update(defaultRuntime="rkt")),
    "int-or-string": _edit(lambda s: s["libtpu"].update(upgradePolicy={"maxUnavailable": "lots"})),
    "int-or-string-float": _edit(lambda s: s["libtpu"].update(upgradePolicy={"maxUnavailable": 2.5})),
    "enum-update-strategy": _cp({"daemonsets": {"updateStrategy": "Recreate"}}),
    "typed-map": _cp({"daemonsets": {"labels": {"a": 3}}}),
    "unknown-field": _cp({"operator": {"useOcpDriverToolkit": True, "runtimeClass": "tpu"}}),
    "defaulting": _cp({"libtpu": {"enabled": True, "upgradePolicy": {"autoUpgrade": True}}}),
    "bounds": _cp({"metricsd": {"hostPort": 70000}, "rollout": {"tflopsDegradedPct": 101},
                   "remediation": {"maxAttempts": -1}, "libtpu": {"upgradePolicy": {"maxParallelUpgrades": -2}}}),
    "validator-subspecs": _cp({"validator": {"jax": {"env": [{"name": "A", "value": "1"}]},
                                             "libtpu": {"enabled": True}, "runtime": {"x": 1},
                                             "version": "1"}}),
    "resources": _cp({"devicePlugin": {"resources": {"limits": {"google.com/tpu": 1, "cpu": "2"}},
                                       "version": "1.0"},
                      "daemonsets": {"tolerations": [{"key": "google.com/tpu-2x2", "effect": "Never"}]}}),
    "wrong-kind": {"apiVersion": "v1", "kind": "Wrong", "metadata": {"name": "x"}},
}
CASES = sorted(CORPUS)


def _rename_literal(lit: str, value) -> str:
    """A quoted value of a problem through the value renames: an image
    reference renames only its image name."""
    head, slash, last = lit.rpartition("/")
    if not slash:
        return value((), lit)
    name, tag = re.match(r"([^:@]*)(.*)", last).groups()
    return f"{head}/{value((), name)}{tag}"


def reference_problem_as_port(problem: str) -> str:
    """A reference problem as the port words it: the CR path's renamed keys
    and the renamed quoted values."""
    keys, value = convert._renamer(True)
    path, sep, rest = problem.partition(":")
    if sep and " " not in path:
        parts, renamed = path.split("."), []
        for i, part in enumerate(parts):
            base = re.sub(r"\[\d+\]$", "", part)
            key = tuple(re.sub(r"\[\d+\]$", "", p) for p in parts[: i + 1])
            renamed.append(keys[key] + part[len(base):] if key in keys else part)
        path = ".".join(renamed)
    else:
        path, rest = "", problem
        for (old_path, new) in keys.items():
            rest = rest.replace(".".join(old_path) + ".", ".".join(old_path[:-1] + (new,)) + ".")
            rest = re.sub(r"\b" + re.escape(".".join(old_path)) + r"\b", ".".join(old_path[:-1] + (new,)), rest)
    rest = re.sub(r"'([^']*)'", lambda m: "'" + _rename_literal(m.group(1), value) + "'", rest)
    return f"{path}{sep}{rest}" if path else rest


def test_crd_equals_the_reference_under_the_rename_table():
    assert crdgen.build_crd() == convert.crd_from_reference(ref_crdgen.build_crd())


def _spec_props(crd):
    return crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]["properties"]


def _rules(schema, keys, path, out):
    """{(CR path, rule): value} of a schema's enums, bounds, patterns and
    int-or-string marks, property names renamed through ``keys``."""
    for k in ("enum", "minimum", "maximum", "pattern", "x-kubernetes-int-or-string", "type"):
        if k in schema:
            out[(tuple(keys.get(path[: i + 1], p) for i, p in enumerate(path)), k)] = schema[k]
    for name, sub in schema.get("properties", {}).items():
        _rules(sub, keys, path + (name,), out)
    for k in ("items", "additionalProperties"):
        if isinstance(schema.get(k), dict):
            _rules(schema[k], keys, path + (k,), out)
    return out


@pytest.mark.parametrize("name", sorted(_spec_props(ref_crdgen.build_crd())))
def test_each_sub_spec_schema_equals_the_reference(name):
    """Property by property: the enums, bounds, patterns and typed maps are
    the reference's exactly; names and defaults go through the table."""
    keys, _ = convert._renamer(True)
    new = keys.get(("spec", name), name)
    port = _spec_props(crdgen.build_crd())[new]
    assert port == _spec_props(convert.crd_from_reference(ref_crdgen.build_crd()))[new]
    raw = _spec_props(ref_crdgen.build_crd())[name]
    assert _rules(port, {}, ("spec", new), {}) == _rules(raw, keys, ("spec", name), {})


@pytest.mark.parametrize("case", CASES)
def test_admission_problems_are_the_reference_s(case):
    cr = CORPUS[case]
    want = sorted(reference_problem_as_port(p) for p in ref_sv.validate_cr(ref_crdgen.build_crd(), cr))
    got = sorted(sv.validate_cr(crdgen.build_crd(), convert.clusterpolicy_from_reference(cr)))
    assert got == want


@pytest.mark.parametrize("case", CASES)
def test_defaults_are_the_reference_s(case):
    ref = copy.deepcopy(CORPUS[case])
    ref_sv.default_cr(ref_crdgen.build_crd(), ref)
    port = convert.clusterpolicy_from_reference(CORPUS[case])
    sv.default_cr(crdgen.build_crd(), port)
    assert port == convert.clusterpolicy_from_reference(ref)
    assert convert.clusterpolicy_to_reference(port) == ref


@pytest.mark.parametrize("case", CASES)
def test_cli_problems_are_the_reference_s(case):
    want = sorted(reference_problem_as_port(p) for p in ref_main.validate_clusterpolicy_obj(CORPUS[case]))
    got = sorted(cfg_main.validate_clusterpolicy_obj(convert.clusterpolicy_from_reference(CORPUS[case])))
    assert got == want


@pytest.mark.parametrize("case", [c for c in CASES if c != "wrong-kind"])
def test_decode_encode_round_trips(case):
    port = convert.clusterpolicy_from_reference(CORPUS[case])
    sv.default_cr(crdgen.build_crd(), port)
    problems = [p for p in sv.validate_cr(crdgen.build_crd(), port) if p.endswith("unknown field")]
    for p in problems:  # what admission prunes never reaches the decoder
        path = p.rsplit(":", 1)[0].split(".")
        parent = port
        for part in path[:-1]:
            parent = parent[part]
        del parent[path[-1]]
    encoded = cpt.clusterpolicy_to_obj(cpt.clusterpolicy_from_obj(port))
    assert cpt.clusterpolicy_to_obj(cpt.clusterpolicy_from_obj(encoded)) == encoded
    ref = copy.deepcopy(CORPUS[case])
    ref_sv.default_cr(ref_crdgen.build_crd(), ref)
    for p in problems:
        path = p.rsplit(":", 1)[0].split(".")
        parent = ref
        for part in path[:-1]:
            parent = parent[{"driver": "libtpu", "toolkit": "runtime"}.get(part, part)]
        del parent[path[-1]]
    ref_encoded = ref_cpt.clusterpolicy_to_obj(ref_cpt.clusterpolicy_from_obj(ref))
    assert encoded == convert.clusterpolicy_from_reference(ref_encoded)


def test_round_trip_of_the_types_sample():
    cp = cpt.clusterpolicy_from_obj(convert.clusterpolicy_from_reference(TYPES_SAMPLE))
    assert cp.name == "cluster-policy"
    assert cp.spec.driver.repository == "gcr.io/tpu-operator"
    assert cp.spec.driver.image == "gpu-driver-installer"
    assert cp.spec.driver.generation_configs == {"v5p": "1.2.3-v5p"}
    assert cp.spec.driver.upgrade_policy.is_auto_upgrade_enabled()
    assert cp.spec.operator.runtime_class == "nvidia"
    assert cp.spec.daemonsets.tolerations[0]["key"] == "nvidia.com/gpu"


SPEC_PAIRS = [
    (ref_cls, getattr(cpt, {"LibtpuSpec": "DriverSpec", "RuntimeSpec": "ToolkitSpec"}.get(name, name)))
    for name, ref_cls in sorted(vars(ref_cpt).items())
    if isinstance(ref_cls, type) and issubclass(ref_cls, ref_cpt._ImageSpec) and ref_cls is not ref_cpt._ImageSpec
]


@pytest.mark.parametrize("ref_cls,cls", SPEC_PAIRS, ids=[c.__name__ for _, c in SPEC_PAIRS])
def test_image_specs_resolve_as_the_reference_s(ref_cls, cls, monkeypatch):
    """Defaults, environment fallback, tag and digest forms: the reference's
    through the value and environment-variable tables."""
    ref, port = ref_cls(), cls()
    assert port.image == cpt.VALUE_RENAMES.get(ref.image, ref.image)
    assert cls.ENV_VAR == cpt.ENV_VAR_RENAMES[ref_cls.ENV_VAR]
    assert port.is_enabled() == ref.is_enabled()
    monkeypatch.setenv(ref_cls.ENV_VAR, "gcr.io/env/x:7")
    monkeypatch.setenv(cls.ENV_VAR, "gcr.io/env/x:7")
    if hasattr(ref, "version"):
        ref.version = port.version = ""
        ref.image = port.image = ""
        assert port.image_path() == ref.image_path() == "gcr.io/env/x:7"
        for version in ("9.9", "sha256:" + "a" * 64):
            ref.repository = port.repository = "gcr.io/x"
            ref.image, port.image = ref_cls().image, cls().image
            ref.version = port.version = version
            assert port.image_path() == _rename_literal(ref.image_path(), convert._renamer(True)[1])


def test_is_enabled_defaults_match():
    ref, port = ref_cpt.ClusterPolicySpec(), cpt.ClusterPolicySpec()
    keys, _ = convert._renamer(True)
    for name in ref_cpt.ClusterPolicySpec.__dataclass_fields__:
        new = {"libtpu": "driver", "runtime": "toolkit"}.get(name, name)
        sub_ref, sub = getattr(ref, name), getattr(port, new)
        if hasattr(sub_ref, "is_enabled"):
            assert sub.is_enabled() == sub_ref.is_enabled(), name
    assert port.cdi.is_enabled() and port.cdi.is_default() and not port.sandbox_enabled()
    assert cpt.State.READY == ref_cpt.State.READY == "ready"


def test_sample_is_the_reference_sample_through_the_table():
    with open(PORT_SAMPLE) as f:
        assert yaml.safe_load(f) == convert.clusterpolicy_from_reference(_sample())


@pytest.mark.parametrize("case", CASES)
def test_conversion_inverts(case):
    assert convert.clusterpolicy_to_reference(convert.clusterpolicy_from_reference(CORPUS[case])) == CORPUS[case]


@pytest.mark.parametrize("case", ["sample", "cfg-invalid", "enum-runtime", "typo", "wrong-kind"])
def test_cli_rc_and_output_are_tpuop_cfg_s(case, tmp_path, capsys):
    ref_file, port_file = tmp_path / "ref.yaml", tmp_path / "port.yaml"
    ref_file.write_text(yaml.safe_dump(CORPUS[case]))
    port_file.write_text(yaml.safe_dump(convert.clusterpolicy_from_reference(CORPUS[case])))
    ref_rc = ref_main.main(["validate", "clusterpolicy", "--input", str(ref_file)])
    ref_out = capsys.readouterr()
    rc = cfg_main.main(["validate", "clusterpolicy", "--input", str(port_file)])
    out = capsys.readouterr()
    assert rc == ref_rc == (0 if case == "sample" else 1)
    assert out.out == ref_out.out
    want = sorted(reference_problem_as_port(line[len("INVALID: "):]) for line in ref_out.err.splitlines())
    assert sorted(line[len("INVALID: "):] for line in out.err.splitlines()) == want


def test_gpuop_cfg_runs_as_a_program(tmp_path):
    gen = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cfg", "generate", "crd"],
                         capture_output=True, text=True, timeout=60, cwd=REPO)
    assert gen.returncode == 0, gen.stderr
    assert yaml.safe_load(gen.stdout) == crdgen.build_crd()
    ok = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cfg", "validate", "clusterpolicy",
                         "--input", PORT_SAMPLE], capture_output=True, text=True, timeout=60, cwd=REPO)
    assert ok.returncode == 0 and ok.stdout.strip() == "OK", ok.stderr
    bad = yaml.safe_load(open(PORT_SAMPLE))
    bad["spec"]["operator"]["defaultRuntime"] = "rkt"
    (tmp_path / "bad.yaml").write_text(yaml.safe_dump(bad))
    no = subprocess.run([sys.executable, "-m", "tpu_operator_torch.cfg", "validate", "clusterpolicy",
                         "--input", str(tmp_path / "bad.yaml")], capture_output=True, text=True, timeout=60,
                        cwd=REPO)
    assert no.returncode == 1 and "spec.operator.defaultRuntime" in no.stderr


@pytest.mark.parametrize("mod", [ref_sv, sv], ids=["reference", "port"])
def test_schema_rules(mod):
    """The validator's rules, each module on the reference's unit cases."""
    def bad(schema, obj, fragment):
        assert any(fragment in p for p in mod.validate(schema, obj)), (schema, obj)

    assert mod.validate({"type": "string"}, "x") == []
    bad({"type": "string"}, 3, "expected string")
    bad({"type": "integer"}, True, "expected integer")
    bad({"type": "number"}, False, "expected number")
    s = {"x-kubernetes-int-or-string": True, "pattern": r"^\d+%?$"}
    assert mod.validate(s, 3) == mod.validate(s, "25%") == []
    bad(s, 3.5, "int-or-string")
    bad(s, "abc", "does not match")
    assert mod.validate({"type": "string", "pattern": "b+"}, "abc") == []
    bad({"type": "integer", "minimum": 1}, 0, "below minimum")
    bad({"type": "integer", "maximum": 65535}, 70000, "above maximum")
    bad({"type": "object", "properties": {"name": {"type": "string"}}, "required": ["name"]}, {}, "missing required")
    bad({"type": "object", "additionalProperties": {"type": "string"}}, {"a": 1}, "expected string")
    problems = mod.validate({"type": "array", "items": {"type": "object", "properties": {"key": {"type": "string"}}}},
                            [{"key": "a"}, {"key": 2}], path="spec.tolerations")
    assert problems and "spec.tolerations[1].key" in problems[0]
    with pytest.raises(KeyError):
        mod.crd_schema({"spec": {"versions": [{"name": "v2"}]}})
