"""The port's images (``tpu_operator_torch/deploy/docker/`` and the image
table ``tpu_operator_torch/deploy/Makefile``) against the reference's
``docker/`` and root ``Makefile``, with no ``docker``.

The four Dockerfiles parse to known instructions; what they copy lies in
the port (or is the root ``versions.mk``/``pyproject.toml``) and nothing of
the JAX package is copied or installed. ``install.sh --prefix tmp`` writes
a command for everything the port's containers exec (``cfg/images``), each
Python shim answers ``--help``, ``gpu_smoke`` is built here with ``g++``,
and a kernel library that is not prebuilt fails for want of ``nvcc``. The
command table maps one to one onto the reference image's under the rename;
``make -n`` names the four Dockerfiles with the tags the chart and the
workload pods pull; the bundle image's labels are the bundle's annotations;
the chart images no Dockerfile builds are the reference's under the rename.
Tolerance: exact equality.
"""

import os
import re
import subprocess
import sys
import tomllib

import pytest
import yaml

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import VALUE_RENAMES
from tpu_operator_torch.cfg import images
from tpu_operator_torch.metricsd import daemon
from tpu_operator_torch.native import gpuinfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCKER = os.path.join(REPO, "tpu_operator_torch", "deploy", "docker")
PORT_MAKEFILE = os.path.join("tpu_operator_torch", "deploy", "Makefile")
DOCKERFILES = ("Dockerfile", "Dockerfile.cuda-validator", "bundle.Dockerfile", "must-gather.Dockerfile")
INSTRUCTIONS = {"FROM", "ARG", "RUN", "COPY", "ENV", "LABEL", "WORKDIR", "ENTRYPOINT"}
REFERENCE_TREES = ("tpu_operator/", "assets/", "native/", "hack/", "bundle/")
TIMEOUT_S = 120

# the reference image's command names as the port's
NAME_RENAMES = {"tpuop-cfg": "gpuop-cfg", "tpu-libtpu-installer": "gpu-driver-installer",
                "tpu-libtpu-manager": "gpu-driver-manager", "tpu-smoke": "gpu_smoke",
                "libtpuinfo.so": "libgpuinfo.so"}


def as_port_name(name: str) -> str:
    return NAME_RENAMES.get(name, re.sub(r"^tpu-", "gpu-", name))


def as_port_entry(entry: str) -> str:
    entry = entry.replace("tpu_operator.", "tpu_operator_torch.")
    return entry.replace("libtpu_installer", "driver_installer").replace("libtpu_manager", "driver_manager")


def instructions(path: str) -> list:
    """(instruction, argument text) of a Dockerfile: continuations joined,
    comments and blank lines dropped."""
    out, pending = [], ""
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            if not pending and (not stripped or stripped.startswith("#")):
                continue
            if pending and stripped.startswith("#"):
                continue
            pending += line.rstrip("\n")
            if pending.endswith("\\"):
                pending = pending[:-1] + " "
                continue
            word, _, rest = pending.strip().partition(" ")
            out.append((word, " ".join(rest.split())))
            pending = ""
    assert not pending, path
    return out


def port_instructions(name: str) -> list:
    return instructions(os.path.join(DOCKER, name))


def copies(name: str) -> list:
    """(sources, destination, from-stage) of each COPY."""
    out = []
    for word, rest in port_instructions(name):
        if word == "COPY":
            args = rest.split()
            stage = args.pop(0).split("=", 1)[1] if args[0].startswith("--from=") else None
            out.append((args[:-1], args[-1], stage))
    return out


def arg_defaults(name: str) -> dict:
    defaults = {}
    for word, rest in port_instructions(name):
        if word == "ARG":
            for m in re.finditer(r'(\w+)(?:=("[^"]*"|\S*))?', rest):
                if m.group(2) is not None:
                    defaults[m.group(1)] = m.group(2).strip('"')
    return defaults


def labels(name: str) -> dict:
    defaults = arg_defaults(name)
    out = {}
    for word, rest in port_instructions(name):
        if word == "LABEL":
            for key, value in re.findall(r'([\w.\-]+)=("[^"]*"|\S+)', rest):
                value = re.sub(r"\$\{(\w+)\}", lambda m: defaults[m.group(1)], value.strip('"'))
                out[key] = value
    return out


def pyproject_scripts() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def native_table() -> dict:
    """``install.sh``'s ``NATIVE``: built name -> installed path under the prefix."""
    with open(images.INSTALL_SCRIPT) as f:
        body = re.search(r"^NATIVE=\(\n(.*?)^\)", f.read(), re.M | re.S).group(1)
    return dict(line.strip().split(":") for line in body.splitlines())


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    """``install.sh --prefix`` into a temporary directory, as the image's
    final stage runs it but with this interpreter (no ``--kernels``: there
    is no nvcc here)."""
    root = tmp_path_factory.mktemp("image")
    out = root / "prefix"
    proc = subprocess.run(["bash", str(images.INSTALL_SCRIPT), "--prefix", str(out), "--python", sys.executable],
                          capture_output=True, text=True, timeout=TIMEOUT_S, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "native build: built=True" in proc.stderr, proc.stderr
    return out


@pytest.mark.parametrize("name", DOCKERFILES)
def test_dockerfiles_parse_to_known_instructions(name):
    parsed = port_instructions(name)
    assert parsed and parsed[0][0] in ("FROM", "ARG"), parsed[:1]
    assert {word for word, _ in parsed} <= INSTRUCTIONS, parsed
    assert any(word == "FROM" for word, _ in parsed)


@pytest.mark.parametrize("name", DOCKERFILES)
def test_copy_sources_lie_in_the_port(name):
    for sources, _, stage in copies(name):
        if stage is not None:
            continue
        for src in sources:
            assert os.path.exists(os.path.join(REPO, src)), (name, src)
            assert src.startswith("tpu_operator_torch/") or src in ("versions.mk", "pyproject.toml"), (name, src)


@pytest.mark.parametrize("name", DOCKERFILES)
def test_nothing_of_the_reference_is_copied_or_installed(name):
    for sources, _, stage in copies(name):
        for src in sources:
            assert not src.startswith(REFERENCE_TREES), (name, src)
    for word, rest in port_instructions(name):
        if word == "RUN":
            assert not re.search(r"(?i)jax", rest), (name, rest)
            assert not re.search(r"pip install[^&;]*\s\.(\s|$)", rest), (name, rest)


def test_operator_image_prebuilds_the_kernels_and_carries_no_nvcc():
    parsed = port_instructions("Dockerfile")
    froms = [rest for word, rest in parsed if word == "FROM"]
    assert len(froms) == 2 and "devel" in froms[0] and froms[0].endswith(" AS build"), froms
    assert "cuda" not in froms[1] and "devel" not in froms[1], froms
    runs = [rest for word, rest in parsed if word == "RUN"]
    installs = [r for r in runs if "deploy/docker/install.sh" in r]
    assert len(installs) == 2, runs
    for run in installs:  # both stages: the build stage compiles, the final one finds the builds
        assert run.startswith('CUDA_VISIBLE_DEVICES=""') and "--prefix /usr/local" in run and "--kernels" in run, run
    stage_copies = [(src, dst) for srcs, dst, stage in copies("Dockerfile") if stage == "build" for src in srcs]
    assert ("/usr/local/lib/gpu-operator/build/", "/usr/local/lib/gpu-operator/build/") in stage_copies
    assert ("tpu_operator_torch/assets/", consts.DEFAULT_ASSETS_DIR + "/") in [
        (srcs[0], dst) for srcs, dst, stage in copies("Dockerfile") if stage is None]
    env = dict(re.findall(r"(\w+)=(\S+)", " ".join(rest for word, rest in parsed if word == "ENV")))
    assert env[consts.ASSETS_ENV] == consts.DEFAULT_ASSETS_DIR
    assert env["PYTHONPATH"] == "/usr/local/lib/gpu-operator"
    assert env["PATH"].startswith("/usr/local/bin:")
    assert parsed[-1] == ("ENTRYPOINT", '["gpu-operator"]')
    defaults = arg_defaults("Dockerfile")
    assert defaults["PYTHON_VERSION"] == "3.12" and defaults["TORCH_INDEX_URL"].endswith("/cu128")


def test_workload_image_is_torch_with_cuda_and_python3():
    parsed = port_instructions("Dockerfile.cuda-validator")
    runs = " ".join(rest for word, rest in parsed if word == "RUN")
    assert '"torch==${TORCH_VERSION}"' in runs and "${TORCH_INDEX_URL}" in runs
    assert arg_defaults("Dockerfile.cuda-validator")["TORCH_INDEX_URL"] == \
        arg_defaults("Dockerfile")["TORCH_INDEX_URL"]
    assert parsed[-1] == ("ENTRYPOINT", '["python3"]')


def test_must_gather_image_runs_the_port_s_script():
    assert copies("must-gather.Dockerfile") == [(["tpu_operator_torch/deploy/must-gather.sh"], "/usr/bin/gather",
                                                 None)]
    got = labels("must-gather.Dockerfile")
    assert got["org.opencontainers.image.title"] == "gpu-operator-must-gather"
    assert {"VERSION", "GIT_COMMIT"} <= set(arg_defaults("must-gather.Dockerfile"))


def test_bundle_image_labels_equal_the_bundle_s_annotations():
    with open(os.path.join(REPO, "tpu_operator_torch", "deploy", "bundle", "metadata", "annotations.yaml")) as f:
        annotations = yaml.safe_load(f)["annotations"]
    got = labels("bundle.Dockerfile")
    assert {k: v for k, v in got.items() if k.startswith("operators.operatorframework.io.")} == annotations
    assert {"VERSION", "GIT_COMMIT"} <= set(arg_defaults("bundle.Dockerfile"))
    assert [(srcs[0], dst) for srcs, dst, _ in copies("bundle.Dockerfile")] == [
        ("tpu_operator_torch/deploy/bundle/manifests", "/manifests/"),
        ("tpu_operator_torch/deploy/bundle/metadata", "/metadata/"),
        ("tpu_operator_torch/deploy/bundle/tests/scorecard", "/tests/scorecard/")]


def test_command_table_is_the_port_s_scripts():
    scripts = {name: ep for name, ep in pyproject_scripts().items() if name.startswith("gpu")}
    assert images.install_table() == scripts


def reference_image_table() -> tuple:
    """The reference image's commands: ``docker/Dockerfile:23-43``'s shims
    with its ``tpu-*`` scripts (``pip install .`` writes them all), and its
    native programs with where they land."""
    with open(os.path.join(REPO, "docker", "Dockerfile")) as f:
        text = f.read()
    shims = dict(re.findall(r"(tpu[\w-]*):(tpu_operator[\w.]*)", text))
    shims.update({name: f"{mod}:{func}" for mod, func, name in re.findall(
        r"from ([\w.]+) import (\w+)(?: as m)?;[^>]*> /usr/local/bin/([\w-]+)", text)})
    natives = {os.path.basename(dst) if not dst.endswith("/") else os.path.basename(src): dst
               for src, dst in re.findall(r"COPY --from=native /src/native/out/(\S+) (\S+)", text)}
    scripts = {name: ep for name, ep in pyproject_scripts().items() if name.startswith("tpu")}
    for name, mod in shims.items():
        assert scripts[name].split(":")[0] == mod.split(":")[0], (name, mod)
    return scripts, natives


def test_command_table_maps_one_to_one_onto_the_reference_s():
    scripts, natives = reference_image_table()
    assert len(scripts) == 17
    assert {as_port_name(n): as_port_entry(ep) for n, ep in scripts.items()} == images.install_table()
    ref_natives = {}
    for name, dst in natives.items():
        path = os.path.join(dst, name) if dst.endswith("/") else dst
        ref_natives[as_port_name(name)] = os.path.join(os.path.dirname(path), as_port_name(os.path.basename(path)))
    port_natives = {os.path.basename(dst): "/usr/local/" + dst for dst in native_table().values()}
    assert ref_natives == port_natives
    # the startup probe each driver DaemonSet runs is the one its image installs
    with open(os.path.join(REPO, "assets", "state-libtpu", "0500_daemonset.yaml")) as f:
        ref_smoke = re.search(r'"(tpu[-_]smoke) &&', f.read()).group(1)
    assert as_port_name(ref_smoke) in images.exec_commands() and as_port_name(ref_smoke) in port_natives
    # where the port's readers look for them
    assert port_natives["libgpuinfo.so"] == gpuinfo.INSTALLED_LIB
    assert port_natives["gpu-metricsd-native"] == daemon.INSTALLED_NATIVE


def test_install_writes_every_command_the_containers_exec(prefix):
    commands = images.exec_commands()
    assert {"gpu-validator", "gpu_smoke", "gpu-runtime-wire", "gpu-driver-manager", "python"} <= set(commands)
    assert images.unresolved(str(prefix)) == {}
    assert images.foreign_modules(str(prefix)) == []
    assert set(commands) - images.BASE_COMMANDS <= set(os.listdir(prefix / "bin"))


def test_install_copies_the_package_with_its_version(prefix):
    lib = prefix / "lib" / "gpu-operator"
    code = "from tpu_operator_torch import _build, consts; print(consts.__file__, consts.VERSION, _build.BUILD_ROOT)"
    proc = subprocess.run([str(prefix / "bin" / "python3"), "-c", code], capture_output=True, text=True,
                          timeout=TIMEOUT_S, cwd=prefix, env=dict(os.environ, PYTHONPATH=str(lib)))
    assert proc.returncode == 0, proc.stderr
    where, version, build_root = proc.stdout.split()
    assert where == str(lib / "tpu_operator_torch" / "consts.py")
    assert version == consts.VERSION
    assert build_root == str(lib / "build" / "tpu_operator_torch")


def test_every_python_shim_answers_help(prefix):
    env = dict(os.environ, PATH=f"{prefix / 'bin'}{os.pathsep}{os.environ['PATH']}")
    env.pop("PYTHONPATH", None)
    procs = {name: subprocess.Popen([name, "--help"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    cwd=prefix, env=env)
             for name in images.install_table()}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, (name, err[-2000:])
        assert out.startswith("usage:"), (name, out[:200])


def test_gpu_smoke_is_built_and_answers(prefix):
    smoke = prefix / "bin" / "gpu_smoke"
    with open(smoke, "rb") as f:
        assert f.read(4) == b"\x7fELF"
    empty = prefix / "empty-dev"
    empty.mkdir(exist_ok=True)
    stub = prefix / "no-nvml" / "libnvidia-ml.so.1"
    proc = subprocess.run([str(smoke), "--dev-root", str(empty), "--json"], capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=dict(os.environ, NVML_LIBRARY=str(stub)))
    assert (proc.returncode, proc.stdout.strip()) == (2, "[]"), proc.stderr


def test_kernels_not_prebuilt_fail_for_want_of_nvcc(prefix, tmp_path):
    """Without nvcc a kernel library the prefix does not hold fails the
    install loudly (as it fails on a node), never falls back."""
    import shutil

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc: the prebuild would succeed")
    proc = subprocess.run(["bash", str(images.INSTALL_SCRIPT), "--prefix", str(prefix), "--python", sys.executable,
                           "--kernels"], capture_output=True, text=True, timeout=TIMEOUT_S, cwd=tmp_path,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "nvcc not found" in proc.stderr


def make_dry_run(*targets) -> list:
    proc = subprocess.run(["make", "-n", "-f", PORT_MAKEFILE, *targets], capture_output=True, text=True,
                          timeout=TIMEOUT_S, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return re.findall(r"-f (\S+) -t (\S+)", proc.stdout)


def test_make_names_the_four_dockerfiles_and_the_tags_the_cluster_pulls():
    with open(os.path.join(REPO, "tpu_operator_torch", "deploy", "gpu-operator", "values.yaml")) as f:
        op = yaml.safe_load(f)["operatorDeployment"]
    built = dict(make_dry_run("docker-build"))
    docker_dir = os.path.relpath(DOCKER, REPO)
    assert set(built) == {os.path.join(docker_dir, name) for name in DOCKERFILES}
    assert built[os.path.join(docker_dir, "Dockerfile")] == f"{op['repository']}/{op['image']}:{op['version']}"
    assert built[os.path.join(docker_dir, "Dockerfile.cuda-validator")] == consts.DEFAULT_CUDA_WORKLOAD_IMAGE
    assert built[os.path.join(docker_dir, "bundle.Dockerfile")] == \
        f"{consts.DEFAULT_REGISTRY}/gpu-operator-bundle:{consts.VERSION}"
    assert built[os.path.join(docker_dir, "must-gather.Dockerfile")] == \
        f"{consts.DEFAULT_REGISTRY}/gpu-operator-must-gather:{consts.VERSION}"
    assert dict(make_dry_run("docker-push", "DIST=multi-arch")) == built


def chart_images(values_path: str) -> set:
    with open(values_path) as f:
        values = yaml.safe_load(f)
    found = set()

    def walk(node):
        if isinstance(node, dict):
            if "repository" in node and "image" in node:
                found.add(node["image"])
            for value in node.values():
                walk(value)

    walk(values)
    return found


def test_unbuilt_chart_images_are_the_reference_s_under_the_rename():
    ref_built = {tag.rsplit(":", 1)[0].rsplit("/", 1)[1] for _, tag in re.findall(
        r"IMAGE_TAG_(\S+)\s*=\s*(\S+)", open(os.path.join(REPO, "Makefile")).read())}
    ref_unbuilt = chart_images(os.path.join(REPO, "deployments", "tpu-operator", "values.yaml")) - ref_built
    port_built = {tag.rsplit(":", 1)[0].rsplit("/", 1)[1] for _, tag in make_dry_run("docker-build")}
    port_unbuilt = chart_images(os.path.join(REPO, "tpu_operator_torch", "deploy", "gpu-operator",
                                             "values.yaml")) - port_built
    assert {VALUE_RENAMES.get(name, name) for name in ref_unbuilt} == port_unbuilt
    assert len(port_unbuilt) == 14
    with open(os.path.join(REPO, PORT_MAKEFILE)) as f:
        listed = re.search(r"no Dockerfile builds.*?here they are:\n((?:#   [^\n]*\n)+)", f.read(), re.S).group(1)
    assert set(listed.replace("#", " ").split()) == port_unbuilt
