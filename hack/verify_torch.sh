#!/usr/bin/env bash
# CI gate of the PyTorch/CUDA port (autoscaler_tpu_torch), the twin of
# hack/verify.sh's first half: compile checks, graftlint over the port's
# tree (determinism, --cache and --jobs parity, SARIF, the analyzer's own
# package with no baseline, the kernels' certification), the wheel check,
# and the port's CPU tests. Runs on a host without a card or nvcc.
#
# Not here yet: hack/verify.sh's scenario, fleet and drill gates (its
# loadgen validation over benchmarks/scenarios/*.json onwards) wait for the
# port's tests of the canned scenarios (ROADMAP queue 1, item 8).
#
#   hack/verify_torch.sh              # PYTEST_WORKERS=4 by default
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== python syntax/compile check =="
python -m compileall -q autoscaler_tpu_torch chip_smoke.py

echo "== graftlint over the port's tree (no baseline: every rule at full strength) =="
# Fatal on any finding; the port keeps no baseline file
# (autoscaler_tpu_torch/analysis/lint-baseline.json must stay absent).
# Rule catalog: autoscaler_tpu_torch/analysis/RULES.md
if [ -f autoscaler_tpu_torch/analysis/lint-baseline.json ]; then
    echo "ERROR: autoscaler_tpu_torch/analysis/lint-baseline.json exists; fix findings at the source" >&2
    exit 1
fi
python -m autoscaler_tpu_torch.analysis --no-baseline autoscaler_tpu_torch/

echo "== graftlint determinism, --cache and --jobs parity (byte-identical JSON) =="
lint_tmp=$(mktemp -d)
trap 'rm -rf "$lint_tmp"' EXIT
lint() { python -m autoscaler_tpu_torch.analysis --no-baseline "$@" autoscaler_tpu_torch/; }
lint --format=json > "$lint_tmp/a.json"
lint --format=json --cache --cache-dir "$lint_tmp/cache" > "$lint_tmp/b.json"
lint --format=json --cache --cache-dir "$lint_tmp/cache" > "$lint_tmp/c.json"
lint --format=json --jobs 4 > "$lint_tmp/jobs.json"
for run in b c jobs; do
    if ! diff -q "$lint_tmp/a.json" "$lint_tmp/$run.json" >/dev/null; then
        echo "ERROR: graftlint's $run run differs from the plain one:" >&2
        diff "$lint_tmp/a.json" "$lint_tmp/$run.json" | head -20 >&2
        exit 1
    fi
done
python - "$lint_tmp/a.json" <<'EOF'
import json, sys
doc = json.load(open(sys.argv[1]))
assert not doc["findings"], f"findings: {doc['findings'][:3]}"
print(f"graftlint parity ok ({doc['files']} files, cold and warm cache, 4 jobs)")
EOF
# the analyzer's own package scans clean with no baseline
python -m autoscaler_tpu_torch.analysis --no-baseline autoscaler_tpu_torch/analysis/

echo "== graftlint SARIF emission and kernel certification =="
lint --format=sarif > "$lint_tmp/scan.sarif"
python - "$lint_tmp/scan.sarif" <<'EOF'
import json, sys
from pathlib import Path
from autoscaler_tpu_torch.analysis.callgraph import CallGraph
from autoscaler_tpu_torch.analysis.engine import FileModel, iter_python_files
from autoscaler_tpu_torch.analysis.purity import certify_kernels
from autoscaler_tpu_torch.analysis.rules import RULE_CATALOG
doc = json.load(open(sys.argv[1]))
assert doc["version"] == "2.1.0", doc["version"]
driver = doc["runs"][0]["tool"]["driver"]
ids = {r["id"] for r in driver["rules"]}
missing = set(RULE_CATALOG) - ids
assert not missing, f"rules absent from SARIF metadata: {sorted(missing)}"
assert not doc["runs"][0]["results"], doc["runs"][0]["results"][:3]
print(f"sarif ok ({len(ids)} rules, 0 results)")
# every KERNEL_CONTRACTS entry certified recompile-hazard-free over its reach
models = [FileModel(f, Path(f).read_text(encoding="utf-8"))
          for f in iter_python_files(["autoscaler_tpu_torch"])]
verdicts = certify_kernels(CallGraph(models))
assert verdicts, "no KERNEL_CONTRACTS kernels found"
bad = {k: v for k, v in verdicts.items() if v[0] != "certified"}
assert not bad, f"uncertified kernels: {bad}"
print(f"kernel certification ok ({len(verdicts)} kernels)")
EOF

echo "== wheel check (kernel sources, rule catalog, console scripts) =="
# built from a copy: setuptools writes build/ and *.egg-info beside the sources
wheel_tmp="$lint_tmp/wheel"
mkdir -p "$wheel_tmp/src"
cp pyproject.toml README.md "$wheel_tmp/src/"
cp -r autoscaler_tpu autoscaler_tpu_torch "$wheel_tmp/src/"
find "$wheel_tmp/src" -name __pycache__ -prune -exec rm -rf {} +
python -m pip wheel --no-deps --no-build-isolation --no-index -q -w "$wheel_tmp/dist" "$wheel_tmp/src"
python - "$wheel_tmp"/dist/*.whl <<'EOF'
import sys, zipfile
from autoscaler_tpu_torch import native_bridge
from autoscaler_tpu_torch.ops import _build
names = set(zipfile.ZipFile(sys.argv[1]).namelist())
want = {f"autoscaler_tpu_torch/csrc/{n}.cu" for n in _build.SIGNATURES}
want |= {f"autoscaler_tpu_torch/csrc/{native_bridge.SRC.name}",
         "autoscaler_tpu_torch/analysis/RULES.md"}
assert want <= names, f"the wheel lacks {sorted(want - names)}"
entry = next(n for n in names if n.endswith("entry_points.txt"))
text = zipfile.ZipFile(sys.argv[1]).read(entry).decode()
for script in ("tpu-autoscaler-torch", "tpu-autoscaler-torch-vpa",
               "tpu-autoscaler-torch-nanny", "graftlint-torch"):
    assert f"{script} = autoscaler_tpu_torch." in text, script
print(f"wheel ok ({len(names)} files, {len(want)} port data files, 4 port scripts)")
EOF

echo "== the port's CPU tests =="
python -m pytest -q -p no:cacheprovider -p xdist -n "${PYTEST_WORKERS:-4}" --dist loadfile \
    tests/test_torch_*.py
