#!/bin/sh
# CI: tests on the virtual CPU mesh, multi-device dry-run, bench regression.
set -e
cd "$(dirname "$0")/.."
PY=${PY:-python}
JAX_PLATFORMS=cpu $PY -m pytest tests/ -q
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    $PY -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
$PY -m dc_sand_tpu.bench.regress || true   # informational
echo "CI OK"
