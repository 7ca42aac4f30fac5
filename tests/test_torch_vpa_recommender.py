"""The VPA recommender, its checkpoints and one ``VpaRunner`` pass
(``autoscaler_tpu_torch/vpa/``) on the CPU against the JAX package, bit for
bit (tolerance 0): the same seeded samples into both packages' models.

- ``PercentileRecommender.recommend`` and ``CheckpointManager.store`` after
  every pass of a seeded feed (CPU samples, memory peaks with window
  replacements, an OOM), each ``Recommendation`` and checkpoint dict equal
  (``torch_parity.canon``);
- each package's checkpoints loaded into the other's model, and the feed
  carried on from there;
- ``VpaRunner.run_once`` twins on tests/test_vpa_kube.py's fake API server,
  one server a package: every pass's stats, the writes the servers saw
  (status PATCHes, evictions, checkpoint objects) and the VPA statuses and
  checkpoint objects they hold (less each checkpoint's wall-clock write
  stamp), equal.
"""
import numpy as np
import pytest

import autoscaler_tpu.kube.client as jclient
import autoscaler_tpu.vpa.kube_io as jkube_io
import autoscaler_tpu.vpa.main as jmain
import autoscaler_tpu.vpa.recommender as jrec
import autoscaler_tpu_torch.kube.client as tclient
import autoscaler_tpu_torch.vpa.kube_io as tkube_io
import autoscaler_tpu_torch.vpa.main as tmain
import autoscaler_tpu_torch.vpa.recommender as trec
from test_kube_client import FakeApiServer, pod_json
from test_vpa_kube import deployment_json, metrics_json, vpa_json
from torch_parity import canon

DAY = 86400.0
T0 = 1.7e9
PKGS = {"jax": (jrec, {}), "torch": (trec, {"device": "cpu"})}


def twin_models():
    return {k: mod.ClusterStateModel(**kw) for k, (mod, kw) in PKGS.items()}


def feed(models, rng, t, keys, pods_per_key=6, oom=False):
    """One pass of samples: a CPU sample and a memory peak per pod (some
    pods' peaks rising within their window), an OOM on one key."""
    K = len(keys) * pods_per_key
    owners = [keys[i % len(keys)] for i in range(K)]
    pods = [f"pod-{i}" for i in range(K)]
    cores = rng.lognormal(np.log(0.3), 0.4, K)
    peaks = rng.lognormal(np.log(6e8), 0.3, K)
    ts = t + rng.uniform(0.0, 60.0, K)
    for name, model in models.items():
        mod = PKGS[name][0]
        ks = [mod.ContainerKey(*k) for k in owners]
        model.add_cpu_samples(ks, cores, ts)
        model.add_memory_peaks(ks, peaks, ts, pods)
        if oom:
            model.observe_oom(mod.ContainerKey(*keys[0]), 2.5e9, t + 30.0, pods[0])


def views(models, now_ts):
    out = {}
    for name, model in models.items():
        mod = PKGS[name][0]
        recs = mod.PercentileRecommender(model).recommend(now_ts=now_ts)
        out[name] = (sorted((canon(k), canon(r)) for k, r in recs.items()),
                     canon(mod.CheckpointManager(model).store()))
    return out


KEYS = [(f"vpa-{v}", c, ns) for v in range(5) for c in ("app", "sidecar")
        for ns in ("default", "team-b")][:14]


def test_recommend_and_store_match_over_passes():
    rng = np.random.default_rng(0)
    models = twin_models()
    # history at real epochs (the first batch re-references both banks),
    # then live passes a minute apart, one a day later, one past ten
    # half-lives
    for k, t in enumerate([T0 - 8 * DAY + h * 3600.0 for h in range(0, 192, 24)]
                          + [T0 + 60.0 * m for m in range(4)] + [T0 + DAY, T0 + 12 * DAY]):
        feed(models, rng, t, KEYS, oom=(k == 9))
        got = views(models, t + 120.0)
        assert got["jax"] == got["torch"], f"pass {k}"
    recs = trec.PercentileRecommender(models["torch"]).recommend(now_ts=T0 + 12 * DAY)
    assert len(recs) == len(KEYS) and models["torch"].cpu.num_series == 64


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_checkpoints_load_across_the_packages(direction):
    rng = np.random.default_rng(1)
    src = direction.split("-to-")[0]
    models = twin_models()
    feed(models, rng, T0, KEYS)
    stored = PKGS[src][0].CheckpointManager(models[src]).store()
    fresh = twin_models()
    for name, model in fresh.items():
        mod = PKGS[name][0]
        mod.CheckpointManager(model).load([mod.Checkpoint(**c.__dict__) for c in stored])
    assert views(fresh, T0 + 60.0)["jax"] == views(fresh, T0 + 60.0)["torch"]
    feed(fresh, rng, T0 + 3600.0, KEYS)
    got = views(fresh, T0 + 3700.0)
    assert got["jax"] == got["torch"]


# -- VpaRunner.run_once on the fake API server -----------------------------------------

CLIENT = {"jax": (jclient, jkube_io, jmain), "torch": (tclient, tkube_io, tmain)}


def world(srv):
    """Two VPAs (Auto in default, Auto in team-b on another deployment), 8
    and 5 pods whose requests sit well below their seeded usage."""
    for ns, name, n in (("default", "hamster", 8), ("team-b", "mole", 5)):
        labels = {"app": name}
        srv.vpas[f"{ns}/{name}-vpa"] = vpa_json(name=f"{name}-vpa", ns=ns)
        srv.vpas[f"{ns}/{name}-vpa"]["spec"]["targetRef"]["name"] = name
        srv.deployments[f"{ns}/{name}"] = deployment_json(name=name, ns=ns, labels=labels)
        for i in range(n):
            srv.pods[f"{ns}/{name}-{i}"] = pod_json(f"{name}-{i}", ns=ns, cpu="100m",
                                                    mem="128Mi", labels=labels)


def usage(srv, rng):
    srv.pod_metrics = [
        metrics_json(p["metadata"]["name"], container=p["metadata"]["name"].rsplit("-", 1)[0],
                     cpu=f"{int(rng.integers(200, 900))}m",
                     mem=f"{int(rng.integers(200_000, 900_000))}k",
                     ns=p["metadata"]["namespace"])
        for p in srv.pods.values()
    ]


def runner(name, srv):
    client_mod, kube_io, main = CLIENT[name]
    client = client_mod.KubeRestClient(srv.url)
    api = client_mod.KubeClusterAPI(client)
    holder = {}
    r = main.VpaRunner(
        kube_io.VpaKubeBinding(client), api,
        kube_io.KubeMetricsSource(client, lambda: holder["r"].last_pod_labels),
        checkpoint_store=kube_io.VpaCheckpointStore(client),
        **PKGS[name][1],
    )
    holder["r"] = r
    return r


def stamped(checkpoints):
    """The checkpoint objects without their write's wall-clock stamp."""
    return {key: {**obj, "status": {k: v for k, v in obj["status"].items()
                                    if k != "lastUpdateTime"}}
            for key, obj in checkpoints.items()}


def test_vpa_runner_passes_match_on_the_fake_api():
    servers = {name: FakeApiServer() for name in PKGS}
    try:
        runners = {}
        for name, srv in servers.items():
            world(srv)
            runners[name] = runner(name, srv)
        for k in range(6):
            stats = {}
            for name, srv in servers.items():
                usage(srv, np.random.default_rng(100 + k))
                stats[name] = runners[name].run_once(now_ts=T0 + 60.0 * k)
            assert stats["jax"] == stats["torch"], k
            j, t = servers["jax"], servers["torch"]
            assert j.writes == t.writes, k
            assert j.vpas == t.vpas, k
            assert stamped(j.checkpoints) == stamped(t.checkpoints), k
            assert sorted(j.pods) == sorted(t.pods), k
        evictions = [p for m, p in servers["torch"].writes if "eviction" in p]
        statuses = [p for m, p in servers["torch"].writes if p.endswith("/status")]
        assert evictions and len(statuses) >= 6 and servers["torch"].checkpoints
    finally:
        for srv in servers.values():
            srv.close()


# -- tools/vpa_probe: chip_smoke's 3z and 4t at a small size --------------------------


def test_vpa_probe_at_a_small_size():
    """The probe's world, warm start and passes on the CPU: a
    recommendation a series and a status a VPA every pass, evictions, the
    warm start's four K5 calls captured, the same outputs run after run,
    and the webhook over HTTP and HTTPS answering as ``review_pod``."""
    from autoscaler_tpu_torch.tools import vpa_probe

    world = vpa_probe.vpa_world(**vpa_probe.SMALL)
    capture = []
    first = vpa_probe.run_vpa(world, "cpu", passes=2, capture=capture)
    assert vpa_probe.problems(first) == []
    assert first["replay"]["samples"] > 2 * vpa_probe.SMALL["history_pods"] * 192 * 0.5
    assert len(capture) == 4 and all(torch_equal_after(c) for c in capture)
    again = vpa_probe.run_vpa(vpa_probe.vpa_world(**vpa_probe.SMALL), "cpu", passes=2)
    assert vpa_probe.comparable(first) == vpa_probe.comparable(again)
    for https in (False, True):
        hook = vpa_probe.admission_check(first["runner"], https=https)
        assert hook == {"reviews": 8, "patched": 8, "equal": True}, (https, hook)
    line = vpa_probe.summary(first)
    assert line["series"] == 12 and len(line["passes"]) == 2


def torch_equal_after(call):
    """A captured K5 call's output is its plain version on its operands."""
    import torch

    from autoscaler_tpu_torch.ops import histogram as ops_histogram

    before, index, values, after = call
    want = ops_histogram._ordered_scatter_add_plain(before.clone(), index, values)
    return torch.equal(want.view(torch.int32), after.view(torch.int32))
