#!/usr/bin/env bash
# CI gate of the PyTorch/CUDA port (autoscaler_tpu_torch), the twin of
# hack/verify.sh: compile checks, graftlint over the port's tree
# (determinism, --cache and --jobs parity, SARIF, the analyzer's own
# package with no baseline, the kernels' certification), the wheel check,
# the canned scenarios' gates, and the port's CPU tests. Runs on a host
# without a card or nvcc, every scenario and sidecar on the CPU.
#
# The canned scenarios' gates (hack/verify.sh's, from its loadgen
# validation to its policy-gym tune) run on the documents of
# autoscaler_tpu_torch/tools/canned, written into a temporary directory:
# nothing here reads benchmarks/. The script keeps what only the CLI's
# written files show: each document validated, each double replay
# byte-identical (trace, perf, explain, fleet, SLO, journal and tuning
# ledgers), the exported trace's schema, the sanitizer, the journal CLI's
# replay and the tune's gain. The semantic gates on the same replays (the
# fleet's fairness, typed sheds and rolling restart, the arena against the
# cold repack, the preemption flag off, the journal's reconstruction) and
# bench.py's ledger gates, as the port's own validators, are the pytest
# step's: tests/test_torch_canned_*.py. bench.py's timing and contrast
# gates (--fleet, --fleet-ha, --fleet-overload, --arena, --preempt,
# --trend) stay with the JAX package until the port has a benchmark. The
# live two-sidecar drill and the SIGTERM drain gate, and the SLO gate's
# cross-process half, need grpcio: without it they are skipped, each with
# a line that says so.
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

echo "== the canned scenarios, written from tools/canned (nothing read under benchmarks/) =="
scen="$lint_tmp/scenarios"
python -m autoscaler_tpu_torch.tools.canned --write "$scen" >/dev/null
# every loadgen run on the CPU: the port's entry points default to the card
lg() { python -m autoscaler_tpu_torch.loadgen "$@" --device cpu; }
same() {  # same LABEL A B: the two replays' files byte-identical
    if ! diff -q "$2" "$3" >/dev/null; then
        echo "ERROR: $1 is nondeterministic across identical replays:" >&2
        diff "$2" "$3" | head -20 >&2
        exit 1
    fi
}

echo "== loadgen scenario validation (specs must parse + round-trip) =="
for scenario in "$scen"/*.json; do
    python -m autoscaler_tpu_torch.loadgen validate "$scenario"
done

echo "== trace + perf-ledger determinism check (two replays must export byte-identical Chrome traces AND perf JSONL ledgers) =="
trace_tmp="$lint_tmp/trace"
mkdir -p "$trace_tmp"
lg run "$scen/kernel_fault_ladder.json" \
    --chrome-trace "$trace_tmp/a.json" --perf-ledger "$trace_tmp/a.perf.jsonl" >/dev/null
lg run "$scen/kernel_fault_ladder.json" \
    --chrome-trace "$trace_tmp/b.json" --perf-ledger "$trace_tmp/b.perf.jsonl" >/dev/null
same "trace export" "$trace_tmp/a.json" "$trace_tmp/b.json"
same "perf JSONL ledger" "$trace_tmp/a.perf.jsonl" "$trace_tmp/b.perf.jsonl"
python - "$trace_tmp/a.json" <<'EOF'
import json, sys
doc = json.load(open(sys.argv[1]))
events = doc["traceEvents"]
assert events, "empty chrome trace"
names = {e["name"] for e in events}
for required in ("main", "estimate", "deviceDispatch", "buildSnapshot", "perfRecord"):
    assert required in names, f"trace schema missing {required!r} spans"
pids = {e["pid"] for e in events if e["ph"] == "X"}
for meta in ("process_name", "thread_name"):
    named = {e["pid"] for e in events if e["ph"] == "M" and e["name"] == meta}
    assert pids <= named, f"ticks missing {meta} metadata: {sorted(pids - named)}"
dd = [e for e in events if e["name"] == "deviceDispatch" and e["ph"] == "X"
      and e["args"].get("outcome") == "ok"]
assert dd, "no served deviceDispatch spans in the replay"
for e in dd:
    assert "cache" in e["args"] and "dispatch_s" in e["args"], e["args"]
warm = [e for e in dd if e["args"].get("cache") == "hit"]
assert warm, "replay produced no warm dispatches"
for e in warm:
    assert "compile_est_s" in e["args"] and "execute_est_s" in e["args"], e["args"]
assert any("model_flops" in e["args"] for e in dd), "no cost-model attrs on any deviceDispatch span"
print(f"trace determinism ok ({len(events)} events, {len(dd)} served dispatches)")
EOF

echo "== runtime determinism sanitizer (replay must trap zero ambient reads) =="
lg run "$scen/kernel_fault_ladder.json" --sanitize >/dev/null
echo "runtime sanitizer ok"

echo "== decision-ledger determinism (two replays must write byte-identical explain JSONL) =="
explain_tmp="$lint_tmp/explain"
mkdir -p "$explain_tmp"
lg run "$scen/skip_reasons.json" --explain-ledger "$explain_tmp/a.explain.jsonl" >/dev/null
lg run "$scen/skip_reasons.json" --explain-ledger "$explain_tmp/b.explain.jsonl" >/dev/null
same "decision ledger" "$explain_tmp/a.explain.jsonl" "$explain_tmp/b.explain.jsonl"

echo "== fleet serving determinism (byte-identical fleet decision + perf ledgers) =="
fleet_tmp="$lint_tmp/fleet"
mkdir -p "$fleet_tmp"
lg run "$scen/fleet_tenants.json" --log "$fleet_tmp/a.fleet.jsonl" \
    --perf-ledger "$fleet_tmp/a.perf.jsonl" >/dev/null
lg run "$scen/fleet_tenants.json" --log "$fleet_tmp/b.fleet.jsonl" \
    --perf-ledger "$fleet_tmp/b.perf.jsonl" >/dev/null
same "fleet decision ledger" "$fleet_tmp/a.fleet.jsonl" "$fleet_tmp/b.fleet.jsonl"
same "fleet perf ledger" "$fleet_tmp/a.perf.jsonl" "$fleet_tmp/b.perf.jsonl"

echo "== SLO ledger determinism (double replay byte-identical SLO ledgers; serving spans carry client parent context) =="
slo_tmp="$lint_tmp/slo"
mkdir -p "$slo_tmp"
lg run "$scen/fleet_tenants.json" --slo-ledger "$slo_tmp/a.slo.jsonl" >/dev/null
lg run "$scen/fleet_tenants.json" --slo-ledger "$slo_tmp/b.slo.jsonl" >/dev/null
same "SLO window ledger" "$slo_tmp/a.slo.jsonl" "$slo_tmp/b.slo.jsonl"
if python -c "import grpc" 2>/dev/null; then
python - <<'EOF'
import numpy as np
from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.fleet import FleetCoalescer
from autoscaler_tpu_torch.rpc.service import TpuSimulationClient, serve

# cross-process propagation: every served BatchEstimate span adopts its
# client's trace id and names the exact rpcCall parent span
side_tracer = trace.Tracer(recorder=trace.FlightRecorder(capacity=16))
co = FleetCoalescer(buckets="16x4x8", window_s=0.002, batch_scenarios=4, device="cpu")
server, port = serve(fleet=co, tracer=side_tracer, device="cpu")
client = TpuSimulationClient(f"127.0.0.1:{port}", default_timeout_s=30.0)
rng = np.random.default_rng(0)
client_tracer = trace.Tracer(recorder=trace.FlightRecorder(capacity=4))
with client_tracer.tick("main"):
    for _ in range(2):
        client.batch_estimate(
            rng.integers(1, 100, (9, 6)).astype(np.float32), rng.random((3, 9)) > 0.2,
            rng.integers(100, 500, (3, 6)).astype(np.float32), ["g0", "g1", "g2"],
            rng.integers(1, 16, 3).astype(np.int32), max_nodes=16, tenant_id="verify")
client.close(); server.stop(0); co.stop()
client_trace = client_tracer.recorder.traces()[-1]
rpc_span_ids = {s.span_id for s in client_trace.spans if s.name == "rpcCall"}
served = [t for t in side_tracer.recorder.traces()
          if t.root.attrs.get("method") == "BatchEstimate"]
assert len(served) == 2, f"expected 2 served BatchEstimate traces, got {len(served)}"
for t in served:
    assert t.trace_id == client_trace.trace_id, (t.trace_id, client_trace.trace_id)
    assert t.root.attrs.get("parent_span_id") in rpc_span_ids, t.root.attrs
print("slo cross-process propagation ok (2 served spans under their rpcCall parents)")
EOF
else
    echo "SKIPPED: the SLO gate's cross-process propagation (no grpcio on this host)"
fi

echo "== fleet overload determinism (double replay: byte-identical fleet+SLO+perf ledgers) =="
chaos_tmp="$lint_tmp/chaos"
mkdir -p "$chaos_tmp"
lg run "$scen/fleet_overload.json" --log "$chaos_tmp/a.fleet.jsonl" \
    --slo-ledger "$chaos_tmp/a.slo.jsonl" --perf-ledger "$chaos_tmp/a.perf.jsonl" >/dev/null
lg run "$scen/fleet_overload.json" --log "$chaos_tmp/b.fleet.jsonl" \
    --slo-ledger "$chaos_tmp/b.slo.jsonl" --perf-ledger "$chaos_tmp/b.perf.jsonl" >/dev/null
for ledger in fleet slo perf; do
    same "$ledger ledger (chaos)" "$chaos_tmp/a.$ledger.jsonl" "$chaos_tmp/b.$ledger.jsonl"
done

echo "== fleet HA rolling-restart determinism (double replay byte-identical fleet+SLO ledgers) =="
ha_tmp="$lint_tmp/ha"
mkdir -p "$ha_tmp"
lg run "$scen/fleet_rolling_restart.json" --log "$ha_tmp/a.fleet.jsonl" \
    --slo-ledger "$ha_tmp/a.slo.jsonl" >/dev/null
lg run "$scen/fleet_rolling_restart.json" --log "$ha_tmp/b.fleet.jsonl" \
    --slo-ledger "$ha_tmp/b.slo.jsonl" >/dev/null
for ledger in fleet slo; do
    same "$ledger ledger (rolling restart)" "$ha_tmp/a.$ledger.jsonl" "$ha_tmp/b.$ledger.jsonl"
done

if python -c "import grpc" 2>/dev/null; then
echo "== live two-sidecar rolling-restart drill (SIGKILL one replica mid-storm: the client rebalances, zero in-deadline requests lost) =="
python - <<'EOF'
import re, subprocess, sys, threading, time
import numpy as np
import grpc
from autoscaler_tpu_torch.rpc.service import TpuSimulationClient

TIERS = ('{"gold": {"qps": 50, "burst": 100, "queue_share": 0.75, '
         '"shed_priority": 0, "tenants": ["drill-gold"]}, '
         '"default": {"qps": 50, "burst": 100, "queue_share": 0.5, '
         '"shed_priority": 10}}')

def start_sidecar():
    proc = subprocess.Popen(
        [sys.executable, "-m", "autoscaler_tpu_torch.rpc", "--address", "127.0.0.1:0",
         "--health-port", "0", "--fleet-prewarm", "false", "--fleet-shape-buckets", "16x4x8",
         "--fleet-coalesce-window-ms", "5", "--fleet-tenant-tiers", TIERS, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    while line and "serving on port" not in line:
        line = proc.stdout.readline()
    return proc, int(re.search(r"serving on port (\d+)", line).group(1))

proc_a, port_a = start_sidecar()
proc_b, port_b = start_sidecar()
try:
    client = TpuSimulationClient([f"127.0.0.1:{port_a}", f"127.0.0.1:{port_b}"],
                                 default_timeout_s=30.0, failover_base_sleep_s=0.001)
    rng = np.random.default_rng(7)
    def world():
        return (rng.integers(1, 100, (9, 6)).astype(np.float32), rng.random((3, 9)) > 0.2,
                rng.integers(100, 500, (3, 6)).astype(np.float32), ["g0", "g1", "g2"],
                rng.integers(1, 16, 3).astype(np.int32))
    worlds = [world() for _ in range(24)]
    outcomes, lock = [], threading.Lock()
    def storm(i):
        try:
            client.batch_estimate(*worlds[i], max_nodes=16, tenant_id="drill-gold")
            with lock: outcomes.append("answered")
        except grpc.RpcError as e:
            with lock: outcomes.append(f"typed:{e.code().name}")
    threads = [threading.Thread(target=storm, args=(i,)) for i in range(24)]
    for i, t in enumerate(threads):
        t.start()
        if i == 8:
            proc_a.kill()  # SIGKILL mid-storm: no drain, no goodbye
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive(), "a storm call hung through the replica kill"
    assert len(outcomes) == 24, outcomes
    lost = [o for o in outcomes if o != "answered"]
    assert not lost, f"in-deadline requests lost beyond typed sheds: {lost}"
    health = client.endpoint_health()
    dead, live = health[f"127.0.0.1:{port_a}"], health[f"127.0.0.1:{port_b}"]
    assert dead["consecutive_unavailable"] > 0 or dead["breaker"] != "closed", dead
    assert live["breaker"] == "closed" and live["consecutive_unavailable"] == 0, live
    post = [client.batch_estimate(*world(), max_nodes=16, tenant_id="drill-gold")[0].shape
            for _ in range(4)]
    assert all(s == (3,) for s in post), post
    client.close()
    assert proc_b.poll() is None, f"survivor sidecar died mid-drill: {proc_b.poll()}"
    print(f"two-sidecar drill ok (24/24 answered through a SIGKILL; dead endpoint health: "
          f"streak={dead['consecutive_unavailable']}, breaker={dead['breaker']})")
finally:
    for p in (proc_a, proc_b):
        if p.poll() is None:
            p.kill()
        p.wait()
EOF

echo "== live sidecar SIGTERM drain gate (readiness flips, admission refuses with drain detail, in-flight tickets resolve, clean exit) =="
python - <<'EOF'
import re, signal, subprocess, sys, threading, urllib.error, urllib.request
import numpy as np
import grpc
from autoscaler_tpu_torch.rpc.service import DRAIN_DETAIL, TpuSimulationClient

proc = subprocess.Popen(
    [sys.executable, "-m", "autoscaler_tpu_torch.rpc", "--address", "127.0.0.1:0",
     "--health-port", "-1", "--fleet-prewarm", "false", "--fleet-shape-buckets", "16x4x8",
     "--fleet-coalesce-window-ms", "20", "--fleet-drain-grace-s", "5.0", "--device", "cpu"],
    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
try:
    line = proc.stdout.readline()
    while line and "serving on port" not in line:
        line = proc.stdout.readline()
    port = int(re.search(r"serving on port (\d+)", line).group(1))
    health = int(re.search(r"health_port=(\d+)", line).group(1))
    assert urllib.request.urlopen(f"http://127.0.0.1:{health}/healthz", timeout=10).status == 200
    client = TpuSimulationClient(f"127.0.0.1:{port}", default_timeout_s=30.0)
    rng = np.random.default_rng(0)
    world = lambda: (rng.integers(1, 100, (9, 6)).astype(np.float32), rng.random((3, 9)) > 0.2,
                     rng.integers(100, 500, (3, 6)).astype(np.float32), ["g0", "g1", "g2"],
                     rng.integers(1, 16, 3).astype(np.int32))
    outcomes = []
    def call():
        try:
            client.batch_estimate(*world(), max_nodes=16, tenant_id="drain")
            outcomes.append("answered")
        except grpc.RpcError as e:
            outcomes.append(f"typed:{e.code().name}")
    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads: t.start()
    urllib.request.urlopen(f"http://127.0.0.1:{health}/drain", timeout=10)
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{health}/healthz", timeout=10)
        raise SystemExit("readiness did not flip on drain")
    except urllib.error.HTTPError as e:
        assert e.code == 503, e.code
    probe = TpuSimulationClient(f"127.0.0.1:{port}", default_timeout_s=10.0,
                                failover_base_sleep_s=0.001)
    try:
        probe.estimate(*world(), max_nodes=16)
        raise SystemExit("draining sidecar served a new request")
    except grpc.RpcError as e:
        assert e.code() == grpc.StatusCode.UNAVAILABLE, e.code()
        assert DRAIN_DETAIL in (e.details() or ""), e.details()
    probe.close()
    proc.send_signal(signal.SIGTERM)
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive(), "a client call hung through the drain"
    assert len(outcomes) == 4 and all(
        o == "answered" or o.startswith("typed:") for o in outcomes), outcomes
    client.close()
    rc = proc.wait(timeout=20)
    assert rc == 0, f"sidecar exited {rc}"
    print(f"live drain ok (in-flight outcomes: {sorted(outcomes)})")
finally:
    if proc.poll() is None:
        proc.kill()
    proc.wait()
EOF
else
    echo "SKIPPED: the live two-sidecar drill and the SIGTERM drain gate (no grpcio on this host)"
fi

echo "== resident-arena determinism (churn double replay: byte-identical perf and decision ledgers) =="
arena_tmp="$lint_tmp/arena"
mkdir -p "$arena_tmp"
lg run "$scen/arena_churn.json" --perf-ledger "$arena_tmp/a.perf.jsonl" \
    --explain-ledger "$arena_tmp/a.explain.jsonl" >/dev/null
lg run "$scen/arena_churn.json" --perf-ledger "$arena_tmp/b.perf.jsonl" \
    --explain-ledger "$arena_tmp/b.explain.jsonl" >/dev/null
same "arena perf ledger" "$arena_tmp/a.perf.jsonl" "$arena_tmp/b.perf.jsonl"
same "arena decision ledger" "$arena_tmp/a.explain.jsonl" "$arena_tmp/b.explain.jsonl"

echo "== preemption determinism (storm double replay: byte-identical decision ledger and log) =="
preempt_tmp="$lint_tmp/preempt"
mkdir -p "$preempt_tmp"
lg run "$scen/preemption_storm.json" --log "$preempt_tmp/a.log.json" \
    --explain-ledger "$preempt_tmp/a.explain.jsonl" >/dev/null
lg run "$scen/preemption_storm.json" --log "$preempt_tmp/b.log.json" \
    --explain-ledger "$preempt_tmp/b.explain.jsonl" >/dev/null
same "preemption decision ledger" "$preempt_tmp/a.explain.jsonl" "$preempt_tmp/b.explain.jsonl"
same "preemption decision log" "$preempt_tmp/a.log.json" "$preempt_tmp/b.log.json"

echo "== flight-journal gate (storm double journal byte-identical; the journal CLI replays it byte for byte against the decision ledger) =="
journal_tmp="$lint_tmp/journal"
mkdir -p "$journal_tmp"
lg run "$scen/preemption_storm.json" --explain-ledger "$journal_tmp/a.explain.jsonl" \
    --journal "$journal_tmp/a.journal.jsonl" >/dev/null
lg run "$scen/preemption_storm.json" --explain-ledger "$journal_tmp/b.explain.jsonl" \
    --journal "$journal_tmp/b.journal.jsonl" >/dev/null
same "flight journal" "$journal_tmp/a.journal.jsonl" "$journal_tmp/b.journal.jsonl"
python -m autoscaler_tpu_torch.journal replay "$journal_tmp/a.journal.jsonl" \
    --explain-ledger "$journal_tmp/a.explain.jsonl" --device cpu
echo "flight-journal replay parity ok"

echo "== policy-gym tuning gate (double tune byte-identical; best score non-decreasing; winner strictly beats the all-defaults policy) =="
gym_tmp="$lint_tmp/gym"
mkdir -p "$gym_tmp"
python -m autoscaler_tpu_torch.gym tune "$scen/gym_suite.json" --generations 2 --population 4 \
    --seed 12 --ledger "$gym_tmp/a.jsonl" --device cpu >/dev/null
python -m autoscaler_tpu_torch.gym tune "$scen/gym_suite.json" --generations 2 --population 4 \
    --seed 12 --ledger "$gym_tmp/b.jsonl" --device cpu >/dev/null
same "tuning ledger" "$gym_tmp/a.jsonl" "$gym_tmp/b.jsonl"
python - "$gym_tmp/a.jsonl" <<'EOF'
import sys
from autoscaler_tpu_torch.gym import load_jsonl, summarize, validate_records
records = load_jsonl(sys.argv[1])
errors = validate_records(records)
assert not errors, errors[:20]
report = summarize(records)
assert report["beats_baseline"], (
    f"tuned winner {report['winner']['total']} does not beat the all-defaults baseline "
    f"{report['baseline_total']}")
traj = report["best_trajectory"]
assert traj == sorted(traj), f"best-of-generation decreased: {traj}"
print(f"gym tune ok ({report['generations']} generations, {report['rollouts']} rollouts, "
      f"improvement {report['improvement']})")
EOF

echo "== the port's CPU tests =="
python -m pytest -q -p no:cacheprovider -p xdist -n "${PYTEST_WORKERS:-4}" --dist loadfile \
    tests/test_torch_*.py
