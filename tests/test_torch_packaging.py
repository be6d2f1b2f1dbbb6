"""The port's install tree (``tpu_operator_torch/deploy/``) is the port's:
every module it runs resolves inside ``tpu_operator_torch``, no file names
the JAX package or the TPU's names, the chart's templates read only values
it has, the NodeFeatureRule emits the port's labels, the hooks' Python
bodies run against a KubeSim, and the operator-side modules import with
``jax`` and ``tpu_operator`` refused.

The chart is rendered here by a small renderer of the Helm subset its
templates use (``if``/``with``/``end`` blocks on lines of their own,
``.Values`` paths, ``include``, ``toYaml | nindent``, ``default``)."""

import importlib
import os
import re
import subprocess
import sys
import tomllib

import pytest
import yaml

from tpu_operator_torch import consts
from tpu_operator_torch.cfg import main as cfg_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "tpu_operator_torch", "deploy")
CHART = os.path.join(DEPLOY, "gpu-operator")
TEMPLATES = os.path.join(CHART, "templates")
TIMEOUT_S = 120
VFIO_LABEL = f"{consts.GROUP}/vfio.capable"


def deploy_files():
    for root, _, files in os.walk(DEPLOY):
        for name in sorted(files):
            yield os.path.join(root, name)


def values():
    with open(os.path.join(CHART, "values.yaml")) as f:
        return yaml.safe_load(f)


# --- the Helm subset ------------------------------------------------------

BLOCK = re.compile(r"^\s*\{\{-?\s*(if|with|end)\b\s*(.*?)\s*-?\}\}\s*$")
EXPR = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}")


def lookup(path: str, ctx: dict, dot):
    if path == ".":
        return dot
    node = ctx
    for part in path.lstrip(".").split("."):
        node = node.get(part) if isinstance(node, dict) else None
    return node


def evaluate(expr: str, ctx: dict, dot):
    pipeline = [p.strip() for p in expr.split("|")]
    head = pipeline[0]
    if head.startswith("include "):
        name = head.split('"')[1]
        assert name == "gpu-operator.operator-image", name
        od = ctx["Values"]["operatorDeployment"]
        value = f"{od['repository']}/{od['image']}:{od['version']}"
    elif head.startswith("toYaml "):
        value = lookup(head.split(None, 1)[1], ctx, dot)
    else:
        value = lookup(head, ctx, dot)
    for stage in pipeline[1:]:
        fn, _, arg = stage.partition(" ")
        if fn == "default":
            value = value or arg.strip('"')
        else:
            assert fn == "nindent", stage
            text = yaml.safe_dump(value, sort_keys=False).rstrip("\n")
            value = "\n" + "\n".join(" " * int(arg) + line for line in text.splitlines())
    return value


def render(name: str, vals=None, namespace: str = "gpu-ns") -> list:
    """The documents ``templates/<name>`` renders to."""
    ctx = {"Values": values() if vals is None else vals, "Release": {"Namespace": namespace},
           "Chart": {"AppVersion": consts.VERSION}}
    out, stack = [], []  # stack of (active, dot)
    with open(os.path.join(TEMPLATES, name)) as f:
        lines = f.read().splitlines()
    for line in lines:
        active = all(a for a, _ in stack)
        dot = next((d for _, d in reversed(stack) if d is not None), None)
        m = BLOCK.match(line)
        if m:
            kind, arg = m.groups()
            if kind == "end":
                stack.pop()
            else:
                value = evaluate(arg, ctx, dot) if active else None
                stack.append((bool(value), value if kind == "with" else dot))
            continue
        if not active:
            continue
        if re.match(r"^\s*\{\{-", line):  # a trimmed expression: joins the previous line
            out[-1] += evaluate(EXPR.match(line.strip()).group(1), ctx, dot)
            continue
        out.append(EXPR.sub(lambda e: str(evaluate(e.group(1), ctx, dot)), line))
    assert not stack, name
    return [d for d in yaml.safe_load_all("\n".join(out)) if d]


def template_reads(name: str) -> list:
    """(path, guard) of each ``.Values`` path the template reads, with the
    ``if``/``with`` paths that enclose it."""
    reads, guards = [], []
    with open(os.path.join(TEMPLATES, name)) as f:
        for line in f:
            m = BLOCK.match(line)
            if m and m.group(1) == "end":
                guards.pop()
                continue
            paths = [p.lstrip(".") for p in re.findall(r"\.Values((?:\.\w+)+)", line)]
            if m:  # the guard's own read is guarded by itself
                guards.append(paths[0] if paths else "")
            reads += [(p, tuple(guards)) for p in paths]
    return reads


# --- the cases ------------------------------------------------------------


def _modules_run(text: str):
    mods = set(re.findall(r"python3?\s*,?\s+-m\s*,?\s+([\w.]+)", text))
    imports = set(re.findall(r"from\s+([\w.]+)\s+import\s+(\w+)", text))
    return mods, imports


def test_every_module_the_tree_runs_resolves_inside_the_port():
    """Every ``python -m X`` and ``from X import Y`` in the chart's
    templates, the kustomize base and the bundle's CSVs names a module of
    the port that imports, and ``Y`` exists in it."""
    mods, imports = set(), set()
    for path in deploy_files():
        if path.endswith((".yaml", ".tpl", ".txt")):
            m, i = _modules_run(open(path).read())
            mods |= m
            imports |= i
    assert {"tpu_operator_torch.main", "tpu_operator_torch.cfg"} <= mods
    assert ("tpu_operator_torch.kube.rest", "RestClient") in imports
    for mod in mods:
        assert mod.startswith("tpu_operator_torch."), mod
        spec = importlib.util.find_spec(mod)
        assert spec is not None, mod
        if spec.submodule_search_locations:  # a package run with -m needs its __main__
            assert importlib.util.find_spec(f"{mod}.__main__") is not None, mod
    for mod, name in imports:
        assert mod.startswith("tpu_operator_torch.") or mod in ("yaml",), mod
        assert hasattr(importlib.import_module(mod), name), (mod, name)


@pytest.mark.parametrize("word", [r"\btpu_operator\.", r"(?i)jax", r"libtpu", r"google\.com/tpu",
                                  r"TPU_OPERATOR_ASSETS", r"1ae0"])
def test_no_file_of_the_tree_names_the_reference(word):
    hits = [os.path.relpath(p, DEPLOY) for p in deploy_files() if re.search(word, open(p).read())]
    assert hits == []


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(TEMPLATES) if n != "_helpers.tpl"))
def test_every_value_a_template_reads_exists(name):
    """Each ``.Values`` path a template reads is in values.yaml, or lies
    under an ``if``/``with`` guard on a path whose parent is there (an
    optional block such as ``devicePlugin.config``); the template renders."""
    vals = values()

    def exists(path):
        node = vals
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return False
            node = node[part]
        return True

    for path, guards in template_reads(name):
        guarded = any(g and (path == g or path.startswith(g + ".")) and exists(g.rpartition(".")[0] or g)
                      for g in guards)
        assert exists(path) or guarded, (name, path)
    if name.endswith(".yaml"):
        render(name)


def test_chart_renders_the_port_s_operator_and_cr():
    """The chart's Deployment runs what the kustomize base's runs, and its
    ClusterPolicy is the chart's values under driver/toolkit and passes the
    port's validation."""
    (dep,) = render("operator.yaml")
    with open(os.path.join(DEPLOY, "config", "manager", "manager.yaml")) as f:
        base = yaml.safe_load(f)
    ctr, base_ctr = (d["spec"]["template"]["spec"]["containers"][0] for d in (dep, base))
    assert ctr == base_ctr
    assert dep["metadata"]["name"] == base["metadata"]["name"] == "gpu-operator"
    env = {e["name"]: e.get("value") for e in ctr["env"]}
    assert env[consts.ASSETS_ENV] == consts.DEFAULT_ASSETS_DIR
    assert {"POD_NAME", "POD_UID", consts.OPERATOR_NAMESPACE_ENV} <= set(env)
    (cr,) = render("clusterpolicy.yaml")
    assert {"driver", "toolkit"} <= set(cr["spec"]) and not {"libtpu", "runtime"} & set(cr["spec"])
    assert cr["spec"]["driver"] == values()["driver"]
    assert cfg_main.validate_clusterpolicy_obj(cr) == []
    assert render("clusterpolicy.yaml", dict(values(), platform={"deployCR": False})) == []


def test_node_feature_rule_emits_the_port_s_labels():
    (rule,) = render("nodefeaturerules.yaml", dict(values(), nfd={"enabled": True, "nodefeaturerules": True}))
    labels = [label for r in rule["spec"]["rules"] for label in r["labels"]]
    assert labels == [consts.NFD_RULE_GPU_PCI_LABEL, VFIO_LABEL]
    for r in rule["spec"]["rules"]:
        pci = next(f for f in r["matchFeatures"] if f["feature"] == "pci.device")["matchExpressions"]
        assert pci == {"vendor": {"op": "In", "value": ["10de"]}, "class": {"op": "In", "value": ["0302"]}}
    assert consts.NFD_GPU_PCI_LABEL == "feature.node.kubernetes.io/pci-10de.present"
    assert render("nodefeaturerules.yaml") == []


def test_plugin_config_map_is_the_one_the_operator_mounts():
    vals = values()
    vals["devicePlugin"] = dict(vals["devicePlugin"], config={"create": True, "data": {"a": "b"}})
    (cm,) = render("plugin_config.yaml", vals)
    assert cm["metadata"]["name"] == "gpu-device-plugin-config" and cm["data"] == {"a": "b"}
    vals["devicePlugin"]["config"]["name"] = "mine"
    (cm,) = render("plugin_config.yaml", vals)
    assert cm["metadata"]["name"] == "mine"
    assert render("plugin_config.yaml") == []


def test_notes_name_the_port_s_resource_and_validator():
    text = open(os.path.join(TEMPLATES, "NOTES.txt")).read()
    assert consts.GPU_RESOURCE.replace(".", "\\.") in text and consts.VALIDATOR_APP in text


def hook_command(name: str) -> str:
    (job,) = [d for d in render(name) if d["kind"] == "Job"]
    (ctr,) = job["spec"]["template"]["spec"]["containers"]
    assert ctr["command"] == ["sh", "-c"]
    (cmd,) = ctr["args"]
    return cmd


def test_hook_bodies_run_against_kubesim(tmp_path):
    """The upgrade hook applies the generated CRD and the cleanup hook
    deletes the CR, each body run by ``sh -c`` as the Job runs it, with
    ``RestClient()`` aimed at a KubeSim (it needs the service account's CA
    bundle otherwise). Each Python program starts right after its quote:
    the folded YAML line must not give it an IndentationError."""
    from tpu_operator_torch.cfg.crdgen import build_crd
    from tpu_operator_torch.kube import kubesim

    server = kubesim.KubeSimServer(kubesim.KubeSim()).start()
    try:
        client = kubesim.make_client(server.port)
        crd = build_crd()
        stale = yaml.safe_load(yaml.safe_dump(crd))
        stale["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]["description"] = "stale"
        client.create(stale)
        with open(os.path.join(DEPLOY, "config", "samples", "v1_clusterpolicy.yaml")) as f:
            client.create(yaml.safe_load(f))
        aim = ("from tpu_operator_torch.kube.rest import RestClient;",
               f"from tpu_operator_torch.kube.kubesim import make_client; RestClient = lambda: make_client({server.port});")
        for name, want in (("upgrade_crd.yaml", "CRD applied"), ("cleanup_crd.yaml", "ClusterPolicy removed")):
            cmd = hook_command(name)
            assert re.search(r'python -c "\S', cmd), cmd
            assert aim[0] in cmd, cmd
            cmd = cmd.replace(aim[0], aim[1]).replace("/tmp/crd.yaml", str(tmp_path / "crd.yaml"))
            proc = subprocess.run(["sh", "-c", cmd], capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
            assert proc.returncode == 0 and proc.stdout.strip().endswith(want), proc.stderr
            if name == "upgrade_crd.yaml":
                got = client.get("apiextensions.k8s.io/v1", "CustomResourceDefinition", consts.CRD_NAME)
                assert got["spec"]["versions"] == crd["spec"]["versions"]
        assert client.get_or_none(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy") is None
    finally:
        server.stop()


GUARD = """
import importlib.abc, runpy, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_operator"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
"""


@pytest.mark.parametrize("module", ["tpu_operator_torch.main", "tpu_operator_torch.cfg"])
def test_operator_side_runs_without_jax_or_the_reference(module):
    """The manager's command and the hooks' program, with ``jax`` and
    ``tpu_operator`` refused at import: the operator-side modules import and
    ``--help`` exits 0."""
    code = GUARD + f"""
import tpu_operator_torch.main, tpu_operator_torch.manager, tpu_operator_torch.kube.rest
import tpu_operator_torch.cfg.main, tpu_operator_torch.cfg.csvgen, tpu_operator_torch.cfg.release
import tpu_operator_torch.controllers.clusterpolicy_controller, tpu_operator_torch.upgrade.upgrade_controller
sys.argv = [{module!r}, "--help"]
runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "usage:" in proc.stdout


def test_gpu_pod_runs_a_bf16_matmul_on_one_card():
    with open(os.path.join(DEPLOY, "gpu-pod.yaml")) as f:
        pod = yaml.safe_load(f)
    (ctr,) = pod["spec"]["containers"]
    assert ctr["image"] == consts.DEFAULT_CUDA_WORKLOAD_IMAGE
    assert ctr["resources"]["limits"] == {consts.GPU_RESOURCE: "1"}
    assert [t["key"] for t in pod["spec"]["tolerations"]] == [consts.GPU_RESOURCE]
    program = ctr["command"][-1]
    compile(program, "gpu-pod", "exec")
    for needle in ("torch.cuda.is_available()", "torch.bfloat16", "torch.matmul"):
        assert needle in program, needle


def test_package_data_carries_the_tree():
    """An installed ``tpu_operator_torch`` carries every file of deploy/."""
    import fnmatch

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"]["tpu_operator_torch"]
    pkg = os.path.join(REPO, "tpu_operator_torch")
    for path in deploy_files():
        rel = os.path.relpath(path, pkg)
        assert any(fnmatch.fnmatch(rel, p) and rel.count("/") == p.count("/") for p in patterns), rel
