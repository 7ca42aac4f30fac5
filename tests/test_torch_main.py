"""The port's process entry point (autoscaler_tpu_torch/main.py) against
the JAX package's: the same flags (dest, default, type) plus ``--device``
alone, equal options from the same command lines, the crash-only loop of
tests/test_resilience.py::TestCrashOnlyRunLoop and
tests/test_observability.py::TestCLI, every endpoint of the
observability server against the JAX server on twin autoscalers, and
``main()`` itself: a bounded run on the CPU, and the JAX package's
fail-closed exit for each binding without what it needs."""
import dataclasses
import json
import urllib.error
import urllib.request

import pytest

import autoscaler_tpu.debugging as jdebugging
import autoscaler_tpu.main as jmain
import autoscaler_tpu_torch.debugging as tdebugging
import autoscaler_tpu_torch.main as tmain
from autoscaler_tpu_torch.metrics.healthcheck import HealthCheck
from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics, MetricsRegistry
from test_torch_static_autoscaler import JAX, TORCH, build_world, exposition, tick
from torch_parity import port_label

GB = 1024**3


def actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_but_for_device():
    ref, port = actions(jmain.build_arg_parser()), actions(tmain.build_arg_parser())
    assert set(port) - set(ref) == {"device"} and set(ref) <= set(port)
    for dest, a in ref.items():
        b = port[dest]
        # each package parses booleans with its own _bool_flag: by name
        assert (b.option_strings, b.default, getattr(b.type, "__name__", None), b.nargs,
                b.const, type(b).__name__) == (
            a.option_strings, a.default, getattr(a.type, "__name__", None), a.nargs,
            a.const, type(a).__name__), dest
    assert port["device"].default is None
    for text in ("true", "1", "yes", "on", "false", "0", "No", "off"):
        assert tmain._bool_flag(text) == jmain._bool_flag(text)


ARGVS = {
    "defaults": [],
    "test_cli": ["--scan-interval", "5", "--expander", "priority,least-waste",
                 "--max-nodes-total", "50", "--cores-total", "4:100"],
    "knobs": ["--initial-node-group-backoff-duration", "60",
              "--scale-down-unready-enabled", "false", "--node-delete-delay-after-taint", "2.5",
              "--cordon-node-before-terminating", "--ignore-daemonsets-utilization",
              "--ignore-taint", "node.startup/init", "--ignore-taint", "vendor/agent-not-ready",
              "--balancing-ignore-label", "custom/pool-id", "--cluster-name", "prod-west",
              "--namespace", "autoscaler", "--status-config-map-name", "my-status",
              "--arena-enabled=true", "--journal-probe-interval=3", "--memory-total=1:64"],
    # the reference's own flags (main.go:119-134), as the wide refit runs them
    "reference": ["--scale-down-candidates-pool-ratio=1.0",
                  "--scale-down-non-empty-candidates-count=0",
                  "--max-drain-parallelism=10", "--max-scale-down-parallelism=20",
                  "--scale-down-utilization-threshold=0.6",
                  "--scale-down-unneeded-time=300", "--max-empty-bulk-delete=20"],
}


@pytest.mark.parametrize("argv", sorted(ARGVS))
def test_options_from_args_match_jax(argv):
    ref = jmain.options_from_args(jmain.build_arg_parser().parse_args(ARGVS[argv]))
    out = tmain.options_from_args(tmain.build_arg_parser().parse_args(ARGVS[argv] + ["--device=cpu"]))
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


class Flaky:
    """tests/test_resilience.py's flaky autoscaler on the port's metrics."""

    def __init__(self, fail_first_n=0, fail_forever=False, fail_odd=False):
        self.calls = 0
        self.fail_first_n, self.fail_forever, self.fail_odd = fail_first_n, fail_forever, fail_odd
        self.health_check = HealthCheck()
        self.metrics = AutoscalerMetrics(MetricsRegistry())

    def run_once(self, now_ts):
        self.calls += 1
        if (self.fail_forever or self.calls <= self.fail_first_n
                or (self.fail_odd and self.calls % 2 == 1)):
            raise RuntimeError(f"injected crash #{self.calls}")
        self.health_check.update_last_success()


def test_run_loop_survives_crashes():
    a = Flaky(fail_first_n=3)
    assert tmain.run_loop(a, scan_interval_s=0.0, max_iterations=6) is True
    assert a.calls == 6 and a.metrics.errors_total.get(type="internalError") == 3


def test_run_loop_max_consecutive_failures_hard_exits(capsys):
    a = Flaky(fail_forever=True)
    assert tmain.run_loop(a, scan_interval_s=0.0, max_consecutive_failures=3) is False
    assert a.calls == 3 and "supervisor restart" in capsys.readouterr().err


def test_run_loop_success_resets_consecutive_count():
    a = Flaky(fail_odd=True)
    assert tmain.run_loop(a, 0.0, max_iterations=8, max_consecutive_failures=2) is True
    assert a.calls == 8


def test_run_loop_bounded_on_the_port():
    w = build_world(TORCH, [("g", 0, 10, 1000, 2 * GB)], {"g": 1})
    tmain.run_loop(w.sa, scan_interval_s=0.0, max_iterations=3)
    assert w.sa.metrics.function_duration.count(function="main") == 3


def twin_servers():
    """Both packages' servers (profiling on) on twin autoscalers, each
    after two ticks of a world with pending pods, a debugger attached."""
    servers = []
    for k, main, debugging in ((JAX, jmain, jdebugging), (TORCH, tmain, tdebugging)):
        pods = [k.tu.build_test_pod(f"p{i}", cpu_m=900, mem=1 * GB) for i in range(3)]
        w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1}, pods)
        w.sa.debugger = debugging.DebuggingSnapshotter()
        tick(w, 0.0)
        tick(w, 10.0)
        server = main.ObservabilityServer(w.sa, "127.0.0.1:0", profiling=True)
        servers.append((w, server, server.start()))
    return servers


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


SAME = ("/health-check", "/explainz", "/explainz?tick=1", "/explainz?pod=default/p0",
        "/explainz?group=g", "/explainz?tick=x", "/sloz", "/sloz?slo=tick_duration",
        "/sloz?slo=nope", "/journalz", "/journalz?tick=0", "/journalz?diff=0,1",
        "/journalz?tick=9", "/tracez?id=x", "/tracez?format=bad", "/debug/pprof/",
        "/debug/pprof/nope", "/nope", "/perfz", "/perfz?tick=99999", "/perfz?tick=bogus",
        "/perfz/nope")


def perf_detail(body: str, jax: bool) -> dict:
    """A /perfz?tick= body, the JAX package's under the name map."""
    rec = json.loads(body)
    if jax:
        for d in rec["dispatches"]:
            d["route"] = port_label("route", d["route"])
    return rec


def test_server_endpoints_match_jax():
    (jw, jserver, jport), (tw, tserver, tport) = twin_servers()
    try:
        for path in SAME:
            assert get(tport, path) == get(jport, path), path
        code, body = get(tport, "/metrics")
        assert code == 200 and "cluster_autoscaler_nodes_count" in body
        assert exposition(tw) == exposition(jw)
        for path in ("/tracez", "/tracez?id=1", "/tracez?format=chrome"):
            (jc, jb), (tc, tb) = get(jport, path), get(tport, path)
            assert tc == jc == 200 and json.loads(tb), path
        (jc, jb), (tc, tb) = get(jport, "/status"), get(tport, "/status")
        # the header line carries the wall clock of the request
        assert tc == jc == 200 and tb.splitlines()[1:] == jb.splitlines()[1:]
        assert get(tport, "/snapshotz")[0] == 200          # armed for the next loop
        # /perfz: one record a tick, the same as the JAX package's under
        # the name map (the listing is in SAME)
        listing = json.loads(get(tport, "/perfz")[1])
        assert [t["tick"] for t in listing["ticks"]] == [0, 1]
        for t in listing["ticks"]:
            path = f"/perfz?tick={t['tick']}"
            (jc, jb), (tc, tb) = get(jport, path), get(tport, path)
            assert tc == jc == 200 and perf_detail(tb, False) == perf_detail(jb, True), path
        assert listing["ticks"][0]["dispatches"] >= 1
        for path in ("/debug/pprof/heap", "/debug/pprof/threadz"):
            assert get(tport, path)[0] == 200, path
    finally:
        jserver.stop()
        tserver.stop()


def test_main_runs_the_loop_on_the_cpu(capsys):
    assert tmain.main(["--provider=test", "--max-iterations=2", "--scan-interval=0",
                       "--address=127.0.0.1:0", "--device=cpu"]) == 0
    assert "device cpu" in capsys.readouterr().out


MAIN_CPU = ["--max-iterations=1", "--scan-interval=0", "--address=127.0.0.1:0", "--device=cpu"]


@pytest.mark.parametrize("flag", ["--compile-cache-dir", "--jax-compilation-cache-dir"])
def test_main_compile_cache_dir_selects_the_kernel_directory(monkeypatch, tmp_path, flag):
    """--compile-cache-dir (or its JAX spelling) moves the kernels' and the
    native rung's directories for the run, and back after it; on the CPU
    nothing is built there."""
    from autoscaler_tpu_torch import native_bridge
    from autoscaler_tpu_torch.ops import _build

    seen = []
    monkeypatch.setattr(tmain, "preload_kernels",
                        lambda device: seen.append((device.type, _build.BUILD_DIR,
                                                    native_bridge.lib_path().parent)))
    before = _build.BUILD_DIR, native_bridge.lib_path()
    target = tmp_path / "kernels"
    assert tmain.main(MAIN_CPU + [f"{flag}={target}"]) == 0
    assert seen == [("cpu", target, target / "native")]
    assert (_build.BUILD_DIR, native_bridge.lib_path()) == before
    assert not target.exists()


@pytest.mark.parametrize("argv", [[], ["--compile-cache-dir="]])
def test_main_without_the_flag_keeps_the_default_directory(monkeypatch, argv):
    """Without --compile-cache-dir (or with it empty) the kernels stay in
    the default directory, the native rung in its native/, and on the CPU
    nothing is built or loaded."""
    from autoscaler_tpu_torch import native_bridge
    from autoscaler_tpu_torch.ops import _build

    def refuse(*names):
        raise AssertionError(f"built on the CPU: {names}")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    dirs = []
    real = tmain.preload_kernels
    monkeypatch.setattr(tmain, "preload_kernels", lambda device: (
        dirs.append((_build.BUILD_DIR, native_bridge.lib_path().parent)), real(device))[1])
    assert tmain.main(MAIN_CPU + argv) == 0
    assert dirs == [(_build.default_dir(), _build.default_dir() / "native")]
    assert tmain.kernel_dir(tmain.build_arg_parser().parse_args(argv), argv) is None


def outcome(main, argv, capsys):
    """(exit code or the exception's type, stderr) of one main() call."""
    try:
        code = main(argv)
    except Exception as e:  # noqa: BLE001 - compared across packages
        code = type(e).__name__
    return code, capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--provider=gce"], ["--provider=externalgrpc"], ["--provider=externalgrpc-ref"],
    ["--provider=clusterapi"], ["--kube-api=in-cluster"], ["--kubeconfig=/nonexistent"],
    ["--leader-elect=true"],
])
def test_unported_bindings_exit_2(argv, capsys):
    """Each binding without what it needs fails closed as the JAX package's
    main() does: the same exit code (2, or the same exception where the JAX
    package raises, as for in-cluster credentials off a cluster) and the
    same message."""
    ref = outcome(jmain.main, argv, capsys)
    out = outcome(tmain.main, argv + ["--device=cpu"], capsys)
    assert out == ref
    assert ref[0] == (2 if argv != ["--kube-api=in-cluster"] else "FileNotFoundError")
    assert "not ported yet" not in out[1]


def test_unknown_provider_exits_2(capsys):
    assert tmain.main(["--provider=nope", "--device=cpu"]) == 2
    assert "unknown cloud provider" in capsys.readouterr().err


def test_perfz_gated_like_tracez():
    """tests/test_perf.py::TestPerfzEndpoint::test_perfz_gated_like_tracez on
    the port: --perf-enabled=false answers 404, as the JAX package does."""
    answers = []
    for k, main in ((JAX, jmain), (TORCH, tmain)):
        w = build_world(k, [("g", 0, 10, 1000, 2 * GB)], {"g": 1}, perf_enabled=False)
        tick(w, 0.0)
        server = main.ObservabilityServer(w.sa, "127.0.0.1:0")
        port = server.start()
        try:
            answers.append(get(port, "/perfz"))
        finally:
            server.stop()
    assert answers[0] == answers[1] and answers[1][0] == 404


# -- the bindings ---------------------------------------------------------------------------------------
def _kube_fixture():
    from test_kube_client import FakeApiServer, node_json, pod_json

    s = FakeApiServer()
    s.nodes["n1"] = node_json("n1", cpu="2", mem="4Gi", provider_id="test:///n1")
    for i in range(3):
        s.pods[f"default/p{i}"] = pod_json(f"p{i}", cpu="1500m", mem="1Gi")
    s.configmaps["cluster-autoscaler-priority-expander"] = {
        "metadata": {"name": "cluster-autoscaler-priority-expander"},
        "data": {"priorities": json.dumps({"10": [".*"]})}}
    return s


def _write_paths(writes):
    """(method, path) of a write log, the Lease's renewals left out (their
    number follows the wall clock)."""
    return sorted({(w[0], w[1].split("?")[0]) for w in writes if "/leases" not in w[1]})


BASE = ["--max-iterations=2", "--scan-interval=0", "--address=127.0.0.1:0"]


def _run_binding(main, kind, tmp_path, extra):
    """One main() run of binding ``kind`` against fresh fakes: → (exit
    code, the kube fake's write paths, the cloud fake's)."""
    from autoscaler_tpu_torch.tools import binding_probe as bp

    if kind in ("kube-api", "kubeconfig", "priority-configmap"):
        kube = _kube_fixture()
        try:
            argv = BASE + ["--provider=test", "--leader-elect=true"]
            if kind == "kubeconfig":
                import yaml

                path = tmp_path / f"kc-{id(main)}"
                path.write_text(yaml.safe_dump({
                    "current-context": "dev",
                    "contexts": [{"name": "dev", "context": {"cluster": "c", "user": "u"}}],
                    "clusters": [{"name": "c", "cluster": {"server": kube.url}}],
                    "users": [{"name": "u", "user": {"token": "t"}}]}))
                argv.append(f"--kubeconfig={path}")
            else:
                argv.append(f"--kube-api={kube.url}")
            if kind == "priority-configmap":
                argv += ["--expander=priority,least-waste",
                         "--expander-priority-config-map=cluster-autoscaler-priority-expander"]
            return main(argv + extra), _write_paths(kube.writes), []
        finally:
            kube.close()
    if kind == "gce":
        from test_gce_rest import MIG, PROJECT, ZONE, FakeComputeServer

        compute, kube = FakeComputeServer(), _kube_fixture()
        token = tmp_path / "token"
        token.write_text("tok")
        try:
            rc = main(BASE + ["--provider=gce", f"--gce-api-url={compute.url}",
                              f"--gce-token-file={token}", f"--kube-api={kube.url}",
                              "--expander=price",
                              f"--nodes=0:10:projects/{PROJECT}/zones/{ZONE}/instanceGroups/{MIG}"]
                      + extra)
            return rc, _write_paths(kube.writes), sorted({(m, p) for m, p, _, _ in compute.requests
                                                          if m == "POST"})
        finally:
            compute.close()
            kube.close()
    if kind == "clusterapi":
        from autoscaler_tpu_torch.utils.test_utils import build_test_node, build_test_pod

        with bp.FakeServers.start() as servers:
            tmpl = build_test_node("t", cpu_m=4000)
            servers.load("machinedeployments", [bp.machine_deployment_json(
                "default", "workers", 0, 5, 0, tmpl)])
            servers.load("pods", [bp.pod_json(build_test_pod(f"p{i}", cpu_m=1500))
                                  for i in range(3)])
            rc = main(BASE + ["--provider=clusterapi", f"--kube-api={servers.kube_url}",
                              "--leader-elect=true"] + extra)
            return rc, _write_paths(servers.writes()), []
    # externalgrpc and externalgrpc-ref: the JAX package's server for both
    import autoscaler_tpu.cloudprovider.external_grpc as jext
    import autoscaler_tpu.rpc.refcompat as jref
    from autoscaler_tpu.cloudprovider.test_provider import TestCloudProvider
    from autoscaler_tpu.utils.test_utils import build_test_node

    backing = TestCloudProvider()
    backing.add_node_group("pool", 0, 5, 0, build_test_node("t", cpu_m=4000))
    serve = jext.serve_cloud_provider if kind == "externalgrpc" else jref.serve_ref_provider
    server, port = serve(backing)
    cfg = tmp_path / "cloud.yaml"
    cfg.write_text(f"address: 127.0.0.1:{port}\n")
    kube = _kube_fixture()
    try:
        rc = main(BASE + [f"--provider={kind}", f"--cloud-config={cfg}",
                          f"--kube-api={kube.url}"] + extra)
        return rc, _write_paths(kube.writes), [("target", backing._groups["pool"].target_size())]
    finally:
        server.stop(None)
        kube.close()


@pytest.mark.parametrize("kind", ["kube-api", "kubeconfig", "priority-configmap", "gce",
                                  "clusterapi", "externalgrpc", "externalgrpc-ref"])
def test_main_runs_each_binding_as_jax(kind, tmp_path, capsys):
    """main() with each binding against fresh fakes, two iterations: the
    port exits as the JAX package does, and the fakes saw the same writes
    (a scale-up among them)."""
    ref = _run_binding(jmain.main, kind, tmp_path, [])
    out = _run_binding(tmain.main, kind, tmp_path, ["--device=cpu"])
    capsys.readouterr()
    assert out == ref and ref[0] == 0
    assert any("cluster-autoscaler-status" in p for _, p in ref[1])


FAIL_CLOSED = {
    "kube-api-and-kubeconfig": ["--kube-api=http://127.0.0.1:1", "--kubeconfig=/x"],
    "leader-elect-unbound": ["--leader-elect=true"],
    "gce-no-token": ["--provider=gce", "--gce-api-url=COMPUTE"],
    "gce-no-kube": ["--provider=gce", "--gce-api-url=COMPUTE", "--gce-token-file=TOKEN",
                    "--nodes=0:10:projects/proj/zones/us-central2-b/instanceGroups/tpu-pool"],
    "gce-discovery-no-project": ["--provider=gce", "--gce-api-url=COMPUTE",
                                 "--gce-token-file=TOKEN",
                                 "--node-group-auto-discovery=mig:namePrefix=x"],
    "gce-bad-nodes": ["--provider=gce", "--gce-api-url=COMPUTE", "--gce-token-file=TOKEN",
                      "--nodes=bogus"],
    "externalgrpc-no-address": ["--provider=externalgrpc"],
    "externalgrpc-config-no-address": ["--provider=externalgrpc", "--cloud-config=EMPTY"],
    "externalgrpc-ref-unreadable": ["--provider=externalgrpc-ref", "--cloud-config=/nonexistent"],
    "clusterapi-unbound": ["--provider=clusterapi"],
    "clusterapi-bad-discovery": ["--provider=clusterapi", "--kube-api=http://127.0.0.1:1",
                                 "--node-group-auto-discovery=aws:x=y"],
    "priority-configmap-unbound": ["--expander-priority-config-map=m"],
}


@pytest.mark.parametrize("case", sorted(FAIL_CLOSED))
def test_bindings_fail_closed_as_jax(case, tmp_path, capsys):
    """Each binding without what it needs exits as the JAX package's main()
    does, with the same message. The gce cases talk to a local recorded
    compute server (the provider lists its MIGs before the kube check)."""
    from test_gce_rest import FakeComputeServer

    token, empty = tmp_path / "token", tmp_path / "empty.yaml"
    token.write_text("t")
    empty.write_text("other: 1\n")
    compute = FakeComputeServer()
    try:
        argv = [a.replace("TOKEN", str(token)).replace("EMPTY", str(empty))
                .replace("COMPUTE", compute.url) for a in FAIL_CLOSED[case]]
        ref = outcome(jmain.main, argv + BASE, capsys)
        out = outcome(tmain.main, argv + BASE + ["--device=cpu"], capsys)
    finally:
        compute.close()
    assert out == ref
    assert ref[0] == 2 and ref[1]
