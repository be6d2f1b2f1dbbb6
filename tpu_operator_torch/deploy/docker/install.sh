#!/usr/bin/env bash
# Install the H100 port into a prefix: the package, the command table that
# the port's pods exec, and the native programs. The gpu-operator image's
# Dockerfile runs it with --prefix /usr/local; a temporary prefix shows
# what the image holds without docker.
#
#   install.sh --prefix DIR [--python PY] [--kernels]
#
# What it writes under DIR:
#   lib/gpu-operator/tpu_operator_torch/  the package beside this script,
#                                         with the repo's versions.mk
#                                         beside it (consts.VERSION)
#   bin/<command>                         a shim for each entry of COMMANDS
#   bin/python, bin/python3               wrappers of PY, where DIR has none
#   lib/libgpuinfo.so                     gpuinfo.INSTALLED_LIB
#   bin/gpu_smoke                         the driver container's startup probe
#   bin/gpu-metricsd-native               the hostengine metricsd execs
#
# The package's dependencies are not installed here. A `pip install .` of
# the repo's pyproject.toml would also write the reference package's
# tpu-* scripts, whose modules the image does not carry. So
# the Dockerfile installs torch, numpy, PyYAML, prometheus-client, grpcio
# and protobuf with pip by name, and the package is importable through
# PYTHONPATH=DIR/lib/gpu-operator: every shim sets it, and the image sets
# it for the commands that run `python -m tpu_operator_torch...` directly.
#
# The native programs are built with g++ (tpu_operator_torch.native.build)
# where this source has no build yet under lib/gpu-operator/build/.
# --kernels does the same for the CUDA kernel library, with nvcc and no
# card visible, into the directory _build.library() reads
# (lib/gpu-operator/build/tpu_operator_torch/<source hash>/); where it is
# already there (the image's final stage copies it from the build stage)
# nothing compiles, and a source that differs from it fails for want of
# nvcc.
set -euo pipefail

# name:module:function, one per pyproject.toml [project.scripts] entry of
# the port (gpu-* and gpuop-cfg); tests/test_torch_images.py holds it to
# that table and to the reference's image under the rename
COMMANDS=(
  gpu-operator:tpu_operator_torch.main:main
  gpu-validator:tpu_operator_torch.validator.main:main
  gpu-device-plugin:tpu_operator_torch.plugin.server:main
  gpu-sandbox-device-plugin:tpu_operator_torch.plugin.manager:sandbox_main
  gpu-feature-discovery:tpu_operator_torch.discovery.tfd:main
  gpu-metrics-exporter:tpu_operator_torch.exporter.exporter:main
  gpu-slice-manager:tpu_operator_torch.sliceman.slice_manager:main
  gpu-metricsd:tpu_operator_torch.metricsd.daemon:main
  gpu-driver-installer:tpu_operator_torch.operands.driver_installer:main
  gpu-driver-manager:tpu_operator_torch.operands.driver_manager:main
  gpu-runtime-wire:tpu_operator_torch.operands.runtime_wire:main
  gpu-vfio-manager:tpu_operator_torch.operands.vfio_manager:main
  gpu-vm-manager:tpu_operator_torch.operands.vm_manager:main
  gpu-vm-device-manager:tpu_operator_torch.operands.vm_manager:vm_device_main
  gpu-kata-manager:tpu_operator_torch.operands.vm_manager:kata_main
  gpu-maintenance-handler:tpu_operator_torch.operands.maintenance:main
  gpuop-cfg:tpu_operator_torch.cfg.main:main
)
# native program as native.build names it : where it is installed
NATIVE=(
  libgpuinfo.so:lib/libgpuinfo.so
  gpu_smoke:bin/gpu_smoke
  gpu_metricsd:bin/gpu-metricsd-native
)

usage() {
  echo "usage: $0 --prefix DIR [--python PY] [--kernels]" >&2
  exit 2
}

PREFIX=""
PY=python3
KERNELS=0
while [ $# -gt 0 ]; do
  case "$1" in
    --prefix) [ $# -ge 2 ] || usage; PREFIX=$2; shift 2 ;;
    --python) [ $# -ge 2 ] || usage; PY=$2; shift 2 ;;
    --kernels) KERNELS=1; shift ;;
    *) usage ;;
  esac
done
[ -n "$PREFIX" ] || usage

PKG=$(cd "$(dirname "$0")/../.." && pwd)
SRC=$(dirname "$PKG")
[ -f "$SRC/versions.mk" ] || { echo "versions.mk not found beside $PKG" >&2; exit 1; }
mkdir -p "$PREFIX/bin" "$PREFIX/lib/gpu-operator"
PREFIX=$(cd "$PREFIX" && pwd)
LIB=$PREFIX/lib/gpu-operator

# the package and the version pin; build/ beside them is kept
rm -rf "$LIB/tpu_operator_torch"
tar -C "$SRC" --exclude=__pycache__ -cf - tpu_operator_torch | tar -C "$LIB" -xf -
cp "$SRC/versions.mk" "$LIB/versions.mk"
export PYTHONPATH="$LIB${PYTHONPATH:+:$PYTHONPATH}"
# python -c puts the working directory first on sys.path: work where the
# copy is, so the builds below key and land beside it
cd "$LIB"

for name in python python3; do
  if [ ! -e "$PREFIX/bin/$name" ]; then
    printf '#!/bin/sh\nexec %s "$@"\n' "$PY" > "$PREFIX/bin/$name"
    chmod 755 "$PREFIX/bin/$name"
  fi
done

for entry in "${COMMANDS[@]}"; do
  IFS=: read -r name module func <<< "$entry"
  cat > "$PREFIX/bin/$name" <<EOF
#!/bin/sh
export PYTHONPATH="$LIB\${PYTHONPATH:+:\$PYTHONPATH}"
exec $PY -c 'import sys; sys.path.insert(0, "$LIB"); sys.argv[0] = "$name"; from $module import $func; sys.exit($func())' "\$@"
EOF
  chmod 755 "$PREFIX/bin/$name"
done

# native.build compiles only where this source hash has no build
NATIVE_DIR=$("$PY" -c '
import sys
from tpu_operator_torch.native import build
info = build.build()
print("native build: built={built} {seconds:.2f} s {dir}".format(**info), file=sys.stderr)
print(info["dir"])')
for entry in "${NATIVE[@]}"; do
  built=${entry%%:*}
  dest=$PREFIX/${entry#*:}
  cp "$NATIVE_DIR/$built" "$dest.tmp"
  chmod 755 "$dest.tmp"
  mv "$dest.tmp" "$dest"
done

if [ "$KERNELS" = 1 ]; then
  CUDA_VISIBLE_DEVICES="" "$PY" -c '
from tpu_operator_torch import _build
_build.library()
print("kernel prebuild: key={key} built={built} {seconds:.2f} s {path}".format(**_build.build_info))'
fi

echo "installed into $PREFIX: ${#COMMANDS[@]} commands, ${#NATIVE[@]} native programs"
