"""The port's Helm chart (deploy/chart/tpu-autoscaler-torch), its plain
manifests (deploy/tpu-autoscaler-torch*.yaml) and Dockerfile.torch, the
twins of tests/test_chart.py's checks: every template renders to valid
YAML with the default values, every flag the control plane, the sidecar
and the fleet pass parses under the port's own parsers, the containers on
the card request ``nvidia.com/gpu`` and pass ``--device=cuda`` while the
host's pass ``--device=cpu``, only the card's name the image's prebuilt
kernel directory and no volume hides it, and the Dockerfile's COPY sources, entry point and prebuild
hold together. The renderer is tests/test_chart.py's, copied."""
import importlib.util
import pathlib
import re
import tomllib

import pytest
import yaml

import autoscaler_tpu_torch.main as tmain
from autoscaler_tpu_torch.addonresizer import main as nanny_main
from autoscaler_tpu_torch.rpc import __main__ as rpc_main
from autoscaler_tpu_torch.vpa import main as vpa_main

REPO = pathlib.Path(__file__).parent.parent
CHART = REPO / "deploy" / "chart" / "tpu-autoscaler-torch"
DOCKERFILE = REPO / "Dockerfile.torch"
# the installed default directory of the image's virtualenv (ops/_build.py)
PREBUILT = "/opt/venv/share/autoscaler_tpu_torch/kernels"


def load_values():
    return yaml.safe_load((CHART / "values.yaml").read_text())


def render(text, values, namespace="kube-system"):
    """Minimal helm renderer: ``{{ .Values.x.y }}`` / ``{{ $.Values.x.y }}``
    / ``{{ .Release.Namespace }}`` substitution, whole-line
    ``{{- if .Values.x }} … {{- end }}`` guards, and whole-line
    ``{{- range $i := until (int .Values.x) }} … {{- end }}`` loops with
    ``{{ $i }}`` in the body (the fleet-HA per-replica endpoint wiring) —
    the chart deliberately sticks to these forms so it stays testable
    without a helm binary."""

    def lookup(path):
        cur = values
        for part in path.split(".")[2:]:
            cur = cur[part]
        return cur

    IF_RE = re.compile(r"^\s*\{\{-?\s*if\s+(\.Values\.[\w.]+)\s*-?\}\}\s*$")
    RANGE_RE = re.compile(
        r"^\s*\{\{-?\s*range\s+\$(\w+)\s*:=\s*until\s+"
        r"\(int\s+(\.Values\.[\w.]+)\)\s*-?\}\}\s*$"
    )
    END_RE = re.compile(r"^\s*\{\{-?\s*end\s*-?\}\}\s*$")

    def parse(lines, i):
        """→ (block nodes, index past the closing end, end-seen). Nodes:
        ("line", text) | ("if", path, body) | ("range", var, path, body)."""
        nodes = []
        while i < len(lines):
            line = lines[i]
            if END_RE.match(line):
                return nodes, i + 1, True
            m = IF_RE.match(line)
            if m:
                body, i, closed = parse(lines, i + 1)
                assert closed, "unclosed {{- if }}"
                nodes.append(("if", m.group(1), body))
                continue
            m = RANGE_RE.match(line)
            if m:
                body, i, closed = parse(lines, i + 1)
                assert closed, "unclosed {{- range }}"
                nodes.append(("range", m.group(1), m.group(2), body))
                continue
            nodes.append(("line", line))
            i += 1
        return nodes, i, False

    def sub_line(line, env):
        def sub(m):
            expr = m.group(1).strip()
            if expr in (".Release.Namespace", "$.Release.Namespace"):
                return namespace
            if expr.startswith(".Values.") or expr.startswith("$.Values."):
                return str(lookup(expr.lstrip("$")))
            if expr.startswith("$") and expr[1:] in env:
                return str(env[expr[1:]])
            raise AssertionError(f"unsupported template expr {expr!r}")

        return re.sub(r"\{\{([^}]+)\}\}", sub, line)

    out = []

    def emit(nodes, env):
        for node in nodes:
            if node[0] == "line":
                out.append(sub_line(node[1], env))
            elif node[0] == "if":
                # helm truthiness for our value types: empty string /
                # false / 0 / None are falsy
                if lookup(node[1]):
                    emit(node[2], env)
            else:
                _, var, path, body = node
                for k in range(int(lookup(path))):
                    emit(body, {**env, var: k})

    lines = text.splitlines()
    nodes, _, closed = parse(lines, 0)
    assert not closed, "unbalanced {{- end }}"
    emit(nodes, {})
    return "\n".join(out) + "\n"


def rendered(values=None, name="deployment.yaml"):
    return list(yaml.safe_load_all(render((CHART / "templates" / name).read_text(),
                                          values or load_values())))


def pod_specs(values=None):
    """Every pod spec the chart renders: the Deployment's and the
    StatefulSet's."""
    (dep,) = rendered(values)
    sts = rendered(values, "sidecar-fleet.yaml")[0]
    return {"deployment": dep["spec"]["template"]["spec"],
            "statefulset": sts["spec"]["template"]["spec"]}


def container(spec, name):
    return next(c for c in spec["containers"] if c["name"] == name)


def test_chart_and_values_parse():
    chart = yaml.safe_load((CHART / "Chart.yaml").read_text())
    assert chart["name"] == "tpu-autoscaler-torch"
    values = load_values()
    assert values["rbac"]["serviceAccountName"] == "tpu-autoscaler-torch"
    assert "kernels" not in values


def test_all_templates_render_to_valid_yaml():
    """The JAX chart's layout: control plane and sidecar, the fleet
    StatefulSet and its headless Service, RBAC, the PDB."""
    values = load_values()
    kinds = set()
    for tpl in sorted((CHART / "templates").glob("*.yaml")):
        docs = list(yaml.safe_load_all(render(tpl.read_text(), values)))
        assert docs and all(d for d in docs), tpl.name
        kinds |= {d["kind"] for d in docs}
    jax_templates = {p.name for p in (REPO / "deploy" / "chart" / "tpu-autoscaler" /
                                      "templates").iterdir()}
    assert {p.name for p in (CHART / "templates").iterdir()} == jax_templates
    assert {"Deployment", "StatefulSet", "ServiceAccount", "ClusterRole",
            "ClusterRoleBinding", "Service", "PodDisruptionBudget"} <= kinds


def test_control_plane_flags_parse_in_the_port_main():
    """Every control-plane argument parses under the port's main parser,
    and the control plane stays on the host, where no kernel loads, with
    no kernel directory of its own."""
    control = container(pod_specs()["deployment"], "control-plane")
    parser = tmain.build_arg_parser()
    for arg in control["args"]:
        assert arg.split("=")[0] in parser._option_string_actions, arg
    args = parser.parse_args(control["args"])
    assert args.device == "cpu"
    assert tmain.kernel_dir(args, control["args"]) is None


@pytest.mark.parametrize("where", ["deployment", "statefulset"])
def test_sidecar_flags_parse_in_the_port_launcher(where):
    """The in-pod sidecar and the fleet replicas run the port's launcher,
    and every flag they pass parses under its parser."""
    sidecar = container(pod_specs()[where], "cuda-sidecar")
    cmd = sidecar["command"]
    assert cmd[:3] == ["python", "-m", "autoscaler_tpu_torch.rpc"]
    parser = rpc_main.build_arg_parser()
    for arg in cmd[3:]:
        if arg.startswith("--"):
            assert arg in parser._option_string_actions, f"{where} passes unknown flag {arg}"
    args = parser.parse_args(cmd[3:])
    assert args.device == "cuda" and args.compile_cache_dir == PREBUILT


@pytest.mark.parametrize("where", ["deployment", "statefulset"])
def test_the_card_container_requests_a_gpu(where):
    """The sidecar requests one nvidia.com/gpu on an H100 node pool and
    tolerates its taint; no container asks for a TPU."""
    spec = pod_specs()[where]
    sidecar = container(spec, "cuda-sidecar")
    assert sidecar["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert spec["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert {"key": "nvidia.com/gpu", "operator": "Exists",
            "effect": "NoSchedule"} in spec["tolerations"]
    text = yaml.safe_dump(spec)
    assert "google.com/tpu" not in text and "gke-tpu" not in text


def hides(mount_path: str) -> bool:
    mount = mount_path.rstrip("/") + "/"
    return (PREBUILT + "/").startswith(mount)


@pytest.mark.parametrize("where", ["deployment", "statefulset"])
def test_no_volume_hides_the_prebuilt_directory(where):
    """No volume is mounted over the image's prebuilt directory (or a
    parent of it) in the pod, and only the card's container names it."""
    spec = pod_specs()[where]
    for c in spec["containers"]:
        for mount in c.get("volumeMounts", []):
            assert not hides(mount["mountPath"]), (where, c["name"], mount)
        named = [a for a in c.get("command", []) + c.get("args", [])
                 if a.startswith("--compile-cache-dir")]
        assert named == (["--compile-cache-dir"] if c["name"] == "cuda-sidecar" else []), c["name"]
    assert hides(PREBUILT) and hides("/opt/venv") and not hides("/var/cache")


def test_rbac_covers_loop_needs():
    (role,) = rendered(name="clusterrole.yaml")
    granted = {(res, verb) for rule in role["rules"] for res in rule["resources"]
               for verb in rule["verbs"]}
    for need in [("nodes", "update"), ("pods/eviction", "create"), ("configmaps", "update"),
                 ("leases", "update"), ("poddisruptionbudgets", "list")]:
        assert need in granted, need


def test_sidecar_drain_wiring():
    values = load_values()
    sidecar = container(pod_specs()["deployment"], "cuda-sidecar")
    cmd = sidecar["command"]
    for flag, value in [
        ("--fleet-max-queue-depth", str(values["fleet"]["maxQueueDepth"])),
        ("--fleet-tenant-qps", str(values["fleet"]["tenantQps"])),
        ("--fleet-tenant-burst", str(values["fleet"]["tenantBurst"])),
        ("--fleet-drain-grace-s", str(values["fleet"]["drainGraceS"])),
        ("--health-port", str(values["sidecar"]["healthPort"])),
    ]:
        assert cmd[cmd.index(flag) + 1] == value, flag
    port = values["sidecar"]["healthPort"]
    assert sidecar["readinessProbe"]["httpGet"] == {"path": "/healthz", "port": port}
    assert sidecar["lifecycle"]["preStop"]["httpGet"] == {"path": "/drain", "port": port}


def test_fleet_ha_replica_wiring():
    """sidecar.replicas sizes the StatefulSet and the control plane's
    --rpc-address list (in-pod endpoint + one DNS name a replica)."""
    import json

    values = load_values()
    values["sidecar"]["replicas"] = 3
    (dep,) = rendered(values)
    control = container(dep["spec"]["template"]["spec"], "control-plane")
    addrs = [a.split("=", 1)[1] for a in control["args"] if a.startswith("--rpc-address=")]
    assert addrs == [values["sidecar"]["grpcAddress"]] + [
        f"tpu-autoscaler-torch-sidecar-{i}.tpu-autoscaler-torch-sidecar.kube-system.svc:9090"
        for i in range(3)]
    sts, svc = rendered(values, "sidecar-fleet.yaml")
    assert sts["spec"]["replicas"] == 3 and svc["spec"]["clusterIP"] == "None"
    assert sts["spec"]["serviceName"] == svc["metadata"]["name"] == \
        "tpu-autoscaler-torch-sidecar"
    cmd = container(sts["spec"]["template"]["spec"], "cuda-sidecar")["command"]
    assert "default" in json.loads(cmd[cmd.index("--fleet-tenant-tiers") + 1])


# -- the plain manifests

def plain(name):
    """A manifest under deploy/ with each ${X:-default} at its default and
    ${X} at a placeholder."""
    text = (REPO / "deploy" / name).read_text()
    text = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", text)
    text = re.sub(r"\$\{\w+\}", "placeholder", text)
    return list(yaml.safe_load_all(text))


def test_plain_manifest_passes_port_flags_and_asks_for_a_gpu():
    (dep,) = plain("tpu-autoscaler-torch.yaml")
    spec = dep["spec"]["template"]["spec"]
    control = container(spec, "control-plane")
    args = tmain.build_arg_parser().parse_args(control["args"])
    assert args.device == "cpu" and tmain.kernel_dir(args, control["args"]) is None
    assert "volumeMounts" not in control and "volumes" not in spec
    sidecar = container(spec, "cuda-sidecar")
    assert sidecar["command"][:3] == ["python", "-m", "autoscaler_tpu_torch.rpc"]
    sidecar_args = rpc_main.build_arg_parser().parse_args(sidecar["command"][3:])
    assert sidecar_args.device == "cuda" and sidecar_args.compile_cache_dir == PREBUILT
    assert "volumeMounts" not in sidecar
    assert sidecar["resources"]["limits"] == {"nvidia.com/gpu": 1}


def console_scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_plain_vpa_manifest_runs_the_port_scripts():
    """The VPA and the nanny run the port's console scripts; their
    arguments parse under the port's parsers; the VPA stays on the host."""
    docs = [d for d in plain("tpu-autoscaler-torch-vpa.yaml") if d["kind"] == "Deployment"]
    parsers = {"tpu-autoscaler-torch-vpa": vpa_main, "tpu-autoscaler-torch-nanny": nanny_main}
    scripts = console_scripts()
    for dep in docs:
        (c,) = dep["spec"]["template"]["spec"]["containers"]
        (script,) = c["command"]
        assert scripts[script].startswith("autoscaler_tpu_torch.")
        args = parsers[script].build_arg_parser().parse_args(c["args"])
        if script.endswith("-vpa"):
            assert args.device == "cpu"


# -- Dockerfile.torch

def docker_lines():
    """Dockerfile.torch's instructions, continuation lines joined."""
    text = re.sub(r"\\\n", " ", DOCKERFILE.read_text())
    return [line.strip() for line in text.splitlines()
            if line.strip() and not line.strip().startswith("#")]


def test_dockerfile_copy_sources_exist():
    copies = [line.split()[1:-1] for line in docker_lines() if line.startswith("COPY ")]
    local = [src for srcs in copies if not srcs[0].startswith("--from") for src in srcs]
    assert "autoscaler_tpu_torch" in local and "pyproject.toml" in local
    for src in local:
        assert (REPO / src).exists(), src


def test_dockerfile_entrypoint_is_a_port_console_script():
    import json

    (entry,) = [line for line in docker_lines() if line.startswith("ENTRYPOINT ")]
    (script,) = json.loads(entry[len("ENTRYPOINT "):])
    assert console_scripts()[script] == "autoscaler_tpu_torch.main:main"
    (cmd,) = [line for line in docker_lines() if line.startswith("CMD ")]
    jax = (REPO / "Dockerfile").read_text()
    assert cmd in jax and "EXPOSE 8085" in docker_lines()


def test_dockerfile_prebuild_module_imports_and_fills_the_default():
    """The RUN lines' ``python -m`` modules import, the prebuild among
    them, and the directory it asserts is the chart's and the manifest's."""
    modules = [m for line in docker_lines() if line.startswith("RUN ")
               for m in re.findall(r"python -m ([\w.]+)", line)]
    assert "autoscaler_tpu_torch.ops.build_kernels" in modules
    for module in modules:
        if module in ("pip", "venv"):
            continue
        assert importlib.util.find_spec(module) is not None, module
    assert f"'{PREBUILT}'" in DOCKERFILE.read_text()
    assert "COPY autoscaler_tpu " not in DOCKERFILE.read_text()
