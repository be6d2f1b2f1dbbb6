"""The reference's ``tests/test_cfg.py`` held on the port: each of its cases
runs on both packages under the same name, parametrised by side. The
reference side reads ``config/``, ``deployments/tpu-operator/`` and
``bundle/``; the port side reads ``tpu_operator_torch/deploy/``.

Three of the reference's cases are held in ``tests/test_torch_api.py``
on the whole corpus of CRs and are not repeated here: the schema
hardening, the malformed CR and the int-or-string quantities.

The graph cases cut their tree in ``tmp_path`` with each side's own
``cut_release`` (0.1.0, then 0.2.0 replacing it): the port ships one
release and no graph. The cases at the end hold the port against the
reference under the rename: the chart's values and CRD, the CSV, the
ClusterRole, and the problems and CLI output on the same tampered inputs.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from dataclasses import dataclass
from types import ModuleType

import pytest
import yaml

from tpu_operator import consts as ref_consts
from tpu_operator.cfg import crdgen as ref_crdgen
from tpu_operator.cfg import csvgen as ref_csvgen
from tpu_operator.cfg import main as ref_main
from tpu_operator.cfg import release as ref_release
from tpu_operator_torch import consts, convert
from tpu_operator_torch.cfg import crdgen, csvgen, release
from tpu_operator_torch.cfg import main as cfg_main
from tpu_operator_torch.kube.rest import KIND_TABLE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "tpu_operator_torch", "deploy")
CRD_FILE = "tpu.k8s.io_clusterpolicies.yaml"


@dataclass(frozen=True)
class Side:
    name: str
    main: ModuleType
    crdgen: ModuleType
    csvgen: ModuleType
    release: ModuleType
    consts: ModuleType
    config: str
    chart: str
    bundle: str
    csv_prefix: str
    driver: str  # the ClusterPolicy's driver key
    runtime: str  # and its runtime key
    installer: str  # the driver installer's default image

    @property
    def sample(self) -> str:
        return os.path.join(self.config, "samples", "v1_clusterpolicy.yaml")

    @property
    def bundle_csv(self) -> str:
        return os.path.join(self.bundle, "manifests", self.release.CSV_NAME)


REFERENCE = Side("reference", ref_main, ref_crdgen, ref_csvgen, ref_release, ref_consts,
                 os.path.join(REPO, "config"), os.path.join(REPO, "deployments", "tpu-operator"),
                 os.path.join(REPO, "bundle"), "tpu-operator.v", "libtpu", "runtime", "libtpu-installer")
PORT = Side("port", cfg_main, crdgen, csvgen, release, consts,
            os.path.join(DEPLOY, "config"), os.path.join(DEPLOY, "gpu-operator"),
            os.path.join(DEPLOY, "bundle"), "gpu-operator.v", "driver", "toolkit", "gpu-driver-installer")
SIDES = [REFERENCE, PORT]
BY_SIDE = pytest.mark.parametrize("side", SIDES, ids=[s.name for s in SIDES])

# the reference's words in a problem or CLI line, as the port words them
PROBLEM_RENAMES = (
    ("'make bundle' (tpuop-cfg release bundle keeps the replaces edge)",
     "'gpuop-cfg release bundle' (it keeps the replaces edge)"),
    ("run 'make bundle'", "run 'gpuop-cfg release bundle'"),
    ("tpuop-cfg generate crd", "gpuop-cfg generate crd"),
    ("tpu-operator.v", "gpu-operator.v"),
    ("tpu-operator.clusterserviceversion.yaml", "gpu-operator.clusterserviceversion.yaml"),
    ("relatedImage tpu-operator:", "relatedImage gpu-operator:"),
    ("deployment container tpu-operator:", "deployment container gpu-operator:"),
    ("gcr.io/tpu-operator/tpu-operator", "gcr.io/tpu-operator/gpu-operator"),
)


def problem_as_port(problem: str) -> str:
    for old, new in PROBLEM_RENAMES:
        problem = problem.replace(old, new)
    return problem


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _dump(path, obj):
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)


# --- the reference's cases on both sides ----------------------------------


@BY_SIDE
def test_sample_cr_valid(side):
    assert side.main.validate_clusterpolicy(side.sample) == []


@BY_SIDE
def test_invalid_cr_detected(side, tmp_path):
    obj = _load(side.sample)
    obj["spec"]["devicePlugin"]["version"] = ""
    obj["spec"]["slice"]["strategy"] = "bogus"
    obj["spec"][side.driver]["upgradePolicy"] = {"maxUnavailable": "x%"}
    bad = tmp_path / "bad.yaml"
    bad.write_text(yaml.safe_dump(obj))
    problems = side.main.validate_clusterpolicy(str(bad))
    assert any("devicePlugin" in p for p in problems)
    assert any("slice.strategy" in p for p in problems)
    assert any("maxUnavailable" in p for p in problems)


@BY_SIDE
def test_chart_valid(side):
    assert side.main.validate_chart(side.chart) == []


@BY_SIDE
def test_chart_stale_crd_detected(side, tmp_path):
    dst = tmp_path / "chart"
    shutil.copytree(side.chart, dst)
    crd = dst / "crds" / CRD_FILE
    obj = yaml.safe_load(crd.read_text())
    obj["spec"]["group"] = "other.io"
    crd.write_text(yaml.safe_dump(obj))
    problems = side.main.validate_chart(str(dst))
    assert any("stale" in p for p in problems)


@BY_SIDE
def test_cli_exit_codes(side, tmp_path, capsys):
    assert side.main.main(["validate", "clusterpolicy", "--input", side.sample]) == 0
    bad = tmp_path / "bad.yaml"
    bad.write_text("kind: Wrong\napiVersion: v1\nmetadata: {name: x}\n")
    assert side.main.main(["validate", "clusterpolicy", "--input", str(bad)]) == 1
    capsys.readouterr()
    assert side.main.main(["generate", "crd"]) == 0
    crd = yaml.safe_load(capsys.readouterr().out)
    assert crd["metadata"]["name"] == "clusterpolicies.tpu.k8s.io"


@BY_SIDE
def test_crd_schema_covers_spec_fields(side):
    crd = side.crdgen.build_crd()
    schema = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
    spec_props = schema["properties"]["spec"]["properties"]
    for key in (side.driver, side.runtime, "devicePlugin", "metricsd", "metricsExporter", "tfd",
                "sliceManager", "validator", "sandboxWorkloads", "cdi", "kataManager"):
        assert key in spec_props, key
    assert spec_props[side.driver]["properties"]["version"]["type"] == "string"
    up = spec_props[side.driver]["properties"]["upgradePolicy"]["properties"]
    assert up["maxParallelUpgrades"]["type"] == "integer"
    assert crd["spec"]["versions"][0]["subresources"] == {"status": {}}


@BY_SIDE
def test_sample_cr_decodes_under_chart_values_shape(side):
    values = _load(os.path.join(side.chart, "values.yaml"))
    spec_cls = side.main.ClusterPolicySpec
    spec = spec_cls.from_dict(values)
    assert getattr(spec, side.driver).image == side.installer
    assert spec.metricsd.host_port == 5555


@BY_SIDE
def test_bundle_csv_valid(side):
    assert side.csvgen.validate_csv(side.bundle_csv, config_dir=side.config) == []


@BY_SIDE
def test_bundle_csv_stale_or_broken_detected(side, tmp_path):
    csv = _load(side.bundle_csv)
    csv["spec"]["relatedImages"][0]["image"] = csv["spec"]["relatedImages"][0]["image"].rsplit(":", 1)[0]
    csv["spec"]["customresourcedefinitions"]["owned"][0]["version"] = "v2"
    bad = tmp_path / "csv.yaml"
    bad.write_text(yaml.safe_dump(csv))
    problems = side.csvgen.validate_csv(str(bad), config_dir=side.config)
    assert any("unpinned" in p for p in problems)
    assert any("owned" in p for p in problems)
    assert any("stale" in p for p in problems)


@BY_SIDE
def test_bundle_csv_alm_examples_match_sample(side):
    csv = _load(side.bundle_csv)
    examples = json.loads(csv["metadata"]["annotations"]["alm-examples"])
    assert examples[0] == _load(side.sample)


@BY_SIDE
def test_bundle_crd_matches_generated(side):
    assert _load(os.path.join(side.bundle, "manifests", CRD_FILE)) == side.crdgen.build_crd()


@BY_SIDE
def test_cli_csv_commands(side, capsys):
    assert side.main.main(["validate", "csv", "--input", side.bundle_csv, "--config-dir", side.config]) == 0
    capsys.readouterr()
    assert side.main.main(["generate", "csv", "--config-dir", side.config]) == 0
    out = capsys.readouterr().out
    assert yaml.safe_load(out)["kind"] == "ClusterServiceVersion"


# --- the graph cases: each side cuts its own tree -------------------------

GRAPH = (("0.1.0", ""), ("0.2.0", "0.1.0"))


def cut_graph(side: Side, root, releases=GRAPH) -> str:
    """A bundle tree in ``root`` holding ``releases`` ((version, replaces)
    in order), each cut by the side's own ``cut_release``."""
    bundle = os.path.join(str(root), f"{side.name}-bundle")
    os.makedirs(os.path.join(bundle, "metadata"))
    os.makedirs(os.path.join(bundle, "manifests"))
    shutil.copy(os.path.join(side.bundle, "metadata", "annotations.yaml"),
                os.path.join(bundle, "metadata", "annotations.yaml"))
    for version, replaces in releases:
        side.release.cut_release(version, replaces=replaces, bundle_dir=bundle, config_dir=side.config)
    return bundle


def _csv_of(side: Side, bundle: str, version: str) -> str:
    return os.path.join(bundle, f"v{version}", "manifests", side.release.CSV_NAME)


def _edit_csv(path: str, fn) -> None:
    csv = _load(path)
    fn(csv)
    _dump(path, csv)


@BY_SIDE
def test_release_bundles_and_upgrade_graph(side, tmp_path):
    """The shipped tree validates and its graph is the side's (the
    reference's 0.2.0 replaces 0.1.0; the port ships 0.2.0 alone); a tree
    cut 0.1.0 then 0.2.0 validates with the head's replaces edge."""
    assert side.release.validate_bundle_tree(side.bundle, config_dir=side.config) == []
    shipped = sorted(e for e in os.listdir(side.bundle) if re.match(r"^v\d+\.\d+\.\d+$", e))
    edges = {v: _load(_csv_of(side, side.bundle, v[1:]))["spec"].get("replaces") for v in shipped}
    want = ({"v0.1.0": None, "v0.2.0": "tpu-operator.v0.1.0"} if side is REFERENCE else
            {f"v{side.consts.VERSION}": None})
    assert edges == want
    bundle = cut_graph(side, tmp_path)
    assert side.release.validate_bundle_tree(bundle, config_dir=side.config) == []
    assert _load(_csv_of(side, bundle, "0.2.0"))["spec"]["replaces"] == f"{side.csv_prefix}0.1.0"
    assert "replaces" not in _load(_csv_of(side, bundle, "0.1.0"))["spec"]


def _dangling(side, bundle):
    _edit_csv(_csv_of(side, bundle, "0.1.0"), lambda c: c["spec"].update(replaces=f"{side.csv_prefix}0.0.9"))


def _cycle(side, bundle):
    _edit_csv(_csv_of(side, bundle, "0.1.0"), lambda c: c["spec"].update(replaces=f"{side.csv_prefix}0.1.0"))


def _second_head(side, bundle):
    _edit_csv(_csv_of(side, bundle, "0.2.0"), lambda c: c["spec"].pop("replaces"))


def _stale_mirror(side, bundle):
    _edit_csv(os.path.join(bundle, "manifests", side.release.CSV_NAME),
              lambda c: c["spec"].update(maturity="beta"))


def _bogus_skips(side, bundle):
    _edit_csv(_csv_of(side, bundle, "0.2.0"), lambda c: c["spec"].update(skips=[f"{side.csv_prefix}9.9.9"]))


GRAPH_PROBLEMS = {
    "dangling-replaces": (GRAPH, _dangling, "not a shipped bundle"),
    "cycle": (GRAPH, _cycle, "replaces cycle"),
    "second-head": (GRAPH, _second_head, "exactly one head"),
    "stale-head-mirror": (GRAPH, _stale_mirror, "is not the graph head"),
    "head-behind-version": (GRAPH[:1], lambda side, bundle: None, "!= current version"),
    "bogus-skips": (GRAPH, _bogus_skips, "skips"),
}


def graph_problems(side: Side, root, problem: str) -> list:
    releases, tamper, _ = GRAPH_PROBLEMS[problem]
    bundle = cut_graph(side, root, releases)
    tamper(side, bundle)
    return [p.replace(bundle, "<bundle>") for p in side.release.validate_bundle_tree(bundle, side.config)]


@pytest.mark.parametrize("problem", [p for p in GRAPH_PROBLEMS if p != "bogus-skips"])
@BY_SIDE
def test_release_graph_problems_detected(side, problem, tmp_path):
    """A broken upgrade graph is flagged by the bundle linter."""
    fragment = GRAPH_PROBLEMS[problem][2]
    assert any(fragment in p for p in graph_problems(side, tmp_path, problem))


@BY_SIDE
def test_cut_release_writes_versioned_bundle(side, tmp_path):
    bundle = tmp_path / "bundle"
    shutil.copytree(side.bundle, bundle)
    prev = "v0.1.0" if side is REFERENCE else ""
    rel = side.release.cut_release(f"v{side.consts.VERSION}", replaces=prev, bundle_dir=str(bundle),
                                   config_dir=side.config)
    assert os.path.isdir(rel)
    assert side.release.validate_bundle_tree(str(bundle), config_dir=side.config) == []
    if side is REFERENCE:
        return  # its shipped v0.2.0 CRD predates the generator's current output
    # re-cutting the shipped release leaves the shipped tree as it is
    for dirpath, _, files in os.walk(side.bundle):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as a, open(os.path.join(bundle, os.path.relpath(path, side.bundle)), "rb") as b:
                assert a.read() == b.read(), path


@BY_SIDE
def test_version_pin_single_source(side):
    """versions.mk is the version pin: consts reads it, csvgen follows
    consts, the installed-package fallback literal matches, and the
    workload image and the e2e pod follow; on the port also the chart and
    the operator's image."""
    mk = open(os.path.join(REPO, "versions.mk")).read()
    pinned = re.search(r"^VERSION \?=\s*(\S+)", mk, re.M).group(1)
    assert side.consts.VERSION == pinned
    assert side.csvgen.OPERATOR_VERSION == pinned
    src = open(side.consts.__file__).read()
    assert re.search(r'return "(\d+\.\d+\.\d+)"', src).group(1) == pinned
    if side is REFERENCE:
        assert pinned in ref_consts.DEFAULT_JAX_WORKLOAD_IMAGE
        pod = open(os.path.join(REPO, "tests", "tpu-pod.yaml")).read()
        assert f"tpu-operator-jax-validator:{pinned}" in pod
        return
    assert consts.DEFAULT_CUDA_WORKLOAD_IMAGE == f"{consts.DEFAULT_REGISTRY}/tpu-operator-cuda-validator:{pinned}"
    pod = _load(os.path.join(DEPLOY, "gpu-pod.yaml"))
    assert pod["spec"]["containers"][0]["image"] == consts.DEFAULT_CUDA_WORKLOAD_IMAGE
    chart = _load(os.path.join(PORT.chart, "Chart.yaml"))
    assert chart["version"] == chart["appVersion"] == pinned
    assert str(_load(os.path.join(PORT.chart, "values.yaml"))["operatorDeployment"]["version"]) == pinned
    manager = _load(os.path.join(PORT.config, "manager", "manager.yaml"))
    assert manager["spec"]["template"]["spec"]["containers"][0]["image"] == (
        f"{consts.DEFAULT_REGISTRY}/gpu-operator:{pinned}")


@BY_SIDE
def test_bogus_skips_edge_detected(side, tmp_path):
    assert any("skips" in x and "not a shipped bundle" in x for x in graph_problems(side, tmp_path, "bogus-skips"))


# --- the port against the reference ---------------------------------------


@pytest.mark.parametrize("problem", list(GRAPH_PROBLEMS))
def test_graph_problems_are_the_reference_s(problem, tmp_path):
    ref = graph_problems(REFERENCE, tmp_path, problem)
    assert ref
    assert graph_problems(PORT, tmp_path, problem) == [problem_as_port(p) for p in ref]


def test_chart_values_are_the_reference_s_through_the_table():
    """The port's values are the reference's through the CR rename table;
    the operator's own image follows VERSION (the reference's chart still
    pins 0.1.0, a release the port never shipped)."""
    ref = _load(os.path.join(REFERENCE.chart, "values.yaml"))
    want = convert.clusterpolicy_from_reference({"spec": ref})["spec"]
    want["operatorDeployment"]["version"] = consts.VERSION
    assert _load(os.path.join(PORT.chart, "values.yaml")) == want


def test_chart_crd_is_the_reference_s_through_the_table():
    crd = _load(os.path.join(PORT.chart, "crds", CRD_FILE))
    assert crd == convert.crd_from_reference(ref_crdgen.build_crd()) == crdgen.build_crd()
    assert _load(os.path.join(PORT.config, "crd", CRD_FILE)) == crd


def test_kustomize_sample_is_the_port_s_sample():
    with open(os.path.join(REPO, "tpu_operator_torch", "api", "v1", "sample_clusterpolicy.yaml"), "rb") as f:
        want = f.read()
    with open(PORT.sample, "rb") as f:
        assert f.read() == want


def _container(csv):
    dep = csv["spec"]["install"]["spec"]["deployments"][0]
    return dep, dep["spec"]["template"]["spec"]["containers"][0]


def test_csv_matches_the_reference_s_under_the_rename():
    ref, port = _load(REFERENCE.bundle_csv), _load(PORT.bundle_csv)
    for key in ("installModes", "minKubeVersion", "customresourcedefinitions", "maturity"):
        if key == "customresourcedefinitions":
            strip = lambda c: [{k: v for k, v in o.items() if k != "description"} for o in c[key]["owned"]]  # noqa: E731
            assert strip(port["spec"]) == strip(ref["spec"])
        else:
            assert port["spec"][key] == ref["spec"][key], key
    (ref_dep, ref_ctr), (dep, ctr) = _container(ref), _container(port)
    for key in ("ports", "livenessProbe", "readinessProbe", "resources", "args", "imagePullPolicy"):
        assert ctr[key] == ref_ctr[key], key
    assert dep["name"] == ctr["name"] == csvgen.PACKAGE
    assert ctr["command"] == ["python", "-m", "tpu_operator_torch.main"]
    names = [convert._renamer(True)[1]((), e["name"]) for e in ref["spec"]["relatedImages"]]
    assert sorted(e["name"] for e in port["spec"]["relatedImages"]) == sorted(names)
    assert port["metadata"]["name"] == f"gpu-operator.v{consts.VERSION}"
    assert port["metadata"]["annotations"]["operators.operatorframework.io/builder"] == "gpuop-cfg"
    text = json.dumps({k: port["spec"][k] for k in ("description", "displayName", "keywords")})
    assert not re.search(r"TPU|JAX|libtpu|\btpu\b|\bjax\b", text), text


def _rules(path):
    rules = set()
    for doc in yaml.safe_load_all(open(path)):
        if doc and doc["kind"] == "ClusterRole":
            for rule in doc["rules"]:
                for group in rule["apiGroups"]:
                    for res in rule["resources"]:
                        rules.update((group, res, verb) for verb in rule["verbs"])
    return rules


def _covered(rules, group, resource):
    return any((group, resource, v) in rules for v in ("*", "create", "patch"))


def test_cluster_role_covers_the_reference_s_and_the_assets():
    """Every rule of the reference's ClusterRole, every kind the port's
    assets create and every kind the port's code names to the API server
    is granted to the port's operator, in the kustomize base and in the
    chart alike."""
    port = _rules(os.path.join(PORT.config, "rbac", "role.yaml"))
    assert port >= _rules(os.path.join(REFERENCE.config, "rbac", "role.yaml"))
    chart_text = open(os.path.join(PORT.chart, "templates", "rbac.yaml")).read()
    chart_doc = yaml.safe_load(chart_text.split("---")[0])
    assert chart_doc["rules"] == next(yaml.safe_load_all(open(os.path.join(PORT.config, "rbac", "role.yaml"))))["rules"]
    kinds = set()
    assets = os.path.join(REPO, "tpu_operator_torch", "assets")
    for state in os.listdir(assets):
        for name in os.listdir(os.path.join(assets, state)):
            if name.endswith(".yaml"):
                kinds |= {(d["apiVersion"], d["kind"]) for d in yaml.safe_load_all(open(os.path.join(assets, state, name)))
                          if d}
    pattern = re.compile(r'"(v1|[a-z0-9.]+/v\w+)",\s*"([A-Z]\w+)"')
    for root, _, files in os.walk(os.path.join(REPO, "tpu_operator_torch")):
        for name in files:
            if name.endswith(".py"):
                kinds |= set(pattern.findall(open(os.path.join(root, name)).read()))
    # the ClusterPolicy under its own group (a bare "v1" beside its name is
    # the CSV's owned-CRD version); CRDs are the upgrade hook's, not the operator's
    kinds = {(av, k) for av, k in kinds if k in KIND_TABLE and k not in ("ClusterPolicy", "CustomResourceDefinition")}
    kinds.add((consts.API_VERSION, consts.CLUSTER_POLICY_KIND))
    assert ("apps/v1", "DaemonSet") in kinds and ("coordination.k8s.io/v1", "Lease") in kinds
    missing = [(av, k) for av, k in sorted(kinds)
               if not _covered(port, av.rpartition("/")[0], KIND_TABLE[k][0])]
    assert missing == []


TAMPERS = ("stale-crd", "unpinned-image", "alm-not-json", "missing-owned-crd")


def tampered(side: Side, root, tamper: str) -> dict:
    """Copies of the side's chart and bundle with ``tamper`` applied, and
    the problems of ``validate_chart``, ``validate_csv`` on the head CSV and
    ``validate_bundle_tree``, each side's tree paths as placeholders."""
    chart = os.path.join(str(root), f"{side.name}-chart")
    bundle = os.path.join(str(root), f"{side.name}-bundle")
    shutil.copytree(side.chart, chart)
    shutil.copytree(side.bundle, bundle)
    head = os.path.join(bundle, f"v{side.consts.VERSION}", "manifests", side.release.CSV_NAME)
    csvs = [head, os.path.join(bundle, "manifests", side.release.CSV_NAME)]
    if tamper == "stale-crd":
        crd_path = os.path.join(chart, "crds", CRD_FILE)
        crd = _load(crd_path)
        crd["spec"]["versions"][0]["served"] = False
        _dump(crd_path, crd)
    for path in csvs:
        if tamper == "unpinned-image":
            def fn(c):
                c["spec"]["relatedImages"][0]["image"] = c["spec"]["relatedImages"][0]["image"].rsplit(":", 1)[0]
                _container(c)[1]["image"] = c["spec"]["relatedImages"][0]["image"]
            _edit_csv(path, fn)
        elif tamper == "alm-not-json":
            _edit_csv(path, lambda c: c["metadata"]["annotations"].update({"alm-examples": "[{not json"}))
        elif tamper == "missing-owned-crd":
            _edit_csv(path, lambda c: c["spec"]["customresourcedefinitions"].update(owned=[]))

    def scrub(problems):
        return [p.replace(chart, "<chart>").replace(bundle, "<bundle>") for p in problems]

    return {
        "chart": scrub(side.main.validate_chart(chart)),
        "csv": scrub(side.csvgen.validate_csv(head, config_dir=side.config)),
        "bundle": scrub(side.release.validate_bundle_tree(bundle, config_dir=side.config)),
    }


@pytest.mark.parametrize("tamper", TAMPERS)
def test_tampered_inputs_give_the_reference_s_problems(tamper, tmp_path):
    ref = tampered(REFERENCE, tmp_path, tamper)
    port = tampered(PORT, tmp_path, tamper)
    assert any(ref.values())
    assert port["chart"] == [problem_as_port(p) for p in ref["chart"]]
    assert port["csv"] == [problem_as_port(p) for p in ref["csv"]]
    assert port["bundle"] == [problem_as_port(p) for p in ref["bundle"]]


CLI_CASES = {
    "chart-ok": ("", ["validate", "chart", "--dir", "{chart}"]),
    "chart-stale": ("stale-crd", ["validate", "chart", "--dir", "{chart}"]),
    "csv-unpinned": ("unpinned-image", ["validate", "csv", "--input", "{head}", "--config-dir", "{config}"]),
    "csv-alm": ("alm-not-json", ["validate", "csv", "--input", "{head}", "--config-dir", "{config}"]),
    "bundle-owned": ("missing-owned-crd", ["validate", "bundle", "--dir", "{bundle}", "--config-dir", "{config}"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_rc_and_output_are_tpuop_cfg_s(case, tmp_path, capsys):
    tamper, argv = CLI_CASES[case]
    got = {}
    for side in SIDES:
        if tamper:
            tampered(side, tmp_path, tamper)
        chart = os.path.join(str(tmp_path), f"{side.name}-chart") if tamper else side.chart
        bundle = os.path.join(str(tmp_path), f"{side.name}-bundle") if tamper else side.bundle
        head = os.path.join(bundle, f"v{side.consts.VERSION}", "manifests", side.release.CSV_NAME)
        args = [a.format(chart=chart, bundle=bundle, head=head, config=side.config) for a in argv]
        capsys.readouterr()
        rc = side.main.main(args)
        out = capsys.readouterr()
        err = out.err.replace(chart, "<chart>").replace(bundle, "<bundle>").splitlines()
        got[side.name] = (rc, out.out, err)
    ref_rc, ref_out, ref_err = got["reference"]
    rc, out, err = got["port"]
    assert rc == ref_rc == (0 if not tamper else 1)
    assert out == ref_out
    assert err == [problem_as_port(line) for line in ref_err]


def test_gpuop_cfg_reads_the_port_s_tree_from_the_repo_root():
    """Run from the repo root with no directory flags, every subcommand
    reads the port's tree (never the reference's ``config/``, chart or
    bundle) and ``generate csv`` prints the shipped head CSV."""
    run = lambda *a: subprocess.run([sys.executable, "-m", "tpu_operator_torch.cfg", *a],  # noqa: E731
                                    capture_output=True, text=True, timeout=120, cwd=REPO)
    for args in (["validate", "clusterpolicy", "--input", os.path.relpath(PORT.sample, REPO)],
                 ["validate", "chart"], ["validate", "csv"], ["validate", "bundle"]):
        proc = run(*args)
        assert (proc.returncode, proc.stdout) == (0, "OK\n"), (args, proc.stderr)
    gen = run("generate", "csv")
    assert gen.returncode == 0, gen.stderr
    with open(PORT.bundle_csv) as f:
        assert gen.stdout == f.read()
