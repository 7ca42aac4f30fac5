"""Node autoprovisioning on the port (autoscaler_tpu_torch/processors/
nodegroups.py) against the JAX package: every case of tests/test_nap.py
runs on both packages' objects, passes the JAX test's assertions on each,
and the two packages' candidates, templates and scale-up results are equal
(by ``torch_parity.canon``, tolerance 0)."""
import types

import pytest

import autoscaler_tpu.cloudprovider.test_provider as jprov
import autoscaler_tpu.clusterstate.registry as jreg
import autoscaler_tpu.config.options as jopts
import autoscaler_tpu.core.scaleup.orchestrator as jorch
import autoscaler_tpu.kube.objects as jobj
import autoscaler_tpu.processors.nodegroups as jnap
import autoscaler_tpu.processors.pipeline as jpipe
import autoscaler_tpu.utils.test_utils as jtu
import autoscaler_tpu_torch.cloudprovider.test_provider as tprov
import autoscaler_tpu_torch.clusterstate.registry as treg
import autoscaler_tpu_torch.config.options as topts
import autoscaler_tpu_torch.core.scaleup.orchestrator as torch_orch
import autoscaler_tpu_torch.kube.objects as tobj
import autoscaler_tpu_torch.processors.nodegroups as tnap
import autoscaler_tpu_torch.processors.pipeline as tpipe
import autoscaler_tpu_torch.utils.test_utils as ttu
from torch_parity import canon

JAX = types.SimpleNamespace(name="jax", prov=jprov, reg=jreg, opts=jopts, orch=jorch, obj=jobj,
                            nap=jnap, pipe=jpipe, tu=jtu, kw={})
TORCH = types.SimpleNamespace(name="torch", prov=tprov, reg=treg, opts=topts, orch=torch_orch,
                              obj=tobj, nap=tnap, pipe=tpipe, tu=ttu, kw={"device": "cpu"})
GB = jtu.GB


def shapes(k):
    return [
        k.nap.MachineShape("small", 2000, 8 * GB, price_per_hour=0.07),
        k.nap.MachineShape("big", 16000, 64 * GB, price_per_hour=0.54),
        k.nap.MachineShape("tpu4", 112000, 192 * GB, tpu=4, price_per_hour=4.8),
    ]


def processor_for(k, provider, **kw):
    def factory(candidate):
        return provider.add_node_group(
            candidate.id(), 0, candidate.max_size(), 0, candidate.template_node_info(),
            price_per_hour=candidate.price_per_hour, autoprovisioned=True,
        )

    return k.nap.AutoprovisioningNodeGroupListProcessor(factory, shapes(k), **kw)


def orchestrator(k, provider, proc):
    opts = k.opts.AutoscalingOptions()
    csr = k.reg.ClusterStateRegistry(provider, opts)
    return k.orch.ScaleUpOrchestrator(provider, opts, csr, node_group_list_processor=proc,
                                      **k.kw)


def node_affinity(k, key, op, values):
    return k.obj.Affinity(node_selector_terms=(k.obj.LabelSelector(
        match_expressions=(k.obj.LabelSelectorRequirement(key, op, values),)),))


def cand_view(cands):
    return [(c.id(), c.exist(), c.autoprovisioned(), c.max_size(),
             canon(c.template_node_info())) for c in cands]


# each case: (k) → what it returns, which the JAX test's assertions read
def unfittable_pod(k):
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 0, k.tu.build_test_node("t", cpu_m=1000))
    pod = k.tu.build_test_pod("p", cpu_m=4000, mem=1 * GB)
    cands = processor_for(k, provider).process(provider, [pod], provider.node_groups())
    assert len(cands) == 1 and cands[0].id().startswith("nap-big-")
    assert not cands[0].exist() and cands[0].autoprovisioned()
    return cand_view(cands)


def fittable_pod(k):
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 0, k.tu.build_test_node("t", cpu_m=8000, mem=32 * GB))
    pod = k.tu.build_test_pod("p", cpu_m=4000, mem=1 * GB)
    cands = processor_for(k, provider).process(provider, [pod], provider.node_groups())
    assert cands == []
    return cands


def tpu_pod(k):
    provider = k.prov.TestCloudProvider()
    pod = k.tu.build_test_pod("p", cpu_m=1000, node_selector={"pool": "train"})
    pod.requests = k.obj.Resources(cpu_m=1000, memory=1 * GB, tpu=4, pods=1)
    cands = processor_for(k, provider).process(provider, [pod], [])
    tmpl = cands[0].template_node_info()
    assert len(cands) == 1 and tmpl.allocatable.tpu == 4 and tmpl.labels["pool"] == "train"
    return cand_view(cands)


def dedupe(k):
    provider = k.prov.TestCloudProvider()
    pods = [k.tu.build_test_pod(f"p{i}", cpu_m=4000) for i in range(5)]
    pods.append(k.tu.build_test_pod("huge", cpu_m=999000))
    cands = processor_for(k, provider).process(provider, pods, [])
    assert len(cands) == 1
    return cand_view(cands)


def budget(k):
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("nap-old", 0, 10, 0, k.tu.build_test_node("t", cpu_m=100),
                            autoprovisioned=True)
    proc = processor_for(k, provider, max_autoprovisioned_groups=1)
    cands = proc.process(provider, [k.tu.build_test_pod("p", cpu_m=4000)],
                         provider.node_groups())
    assert cands == []
    return cands


def candidate_wins(k):
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 0, k.tu.build_test_node("t", cpu_m=1000))
    orch = orchestrator(k, provider, processor_for(k, provider))
    result = orch.scale_up([k.tu.build_test_pod("p", cpu_m=4000, mem=1 * GB)], [], now_ts=0.0)
    assert result.scaled_up and result.chosen_group.startswith("nap-big-")
    created = [g for g in provider.node_groups() if g.id() == result.chosen_group]
    assert created and created[0].exist() and created[0].target_size() >= 1
    assert created[0].autoprovisioned()
    return canon(result), [(g.id(), g.target_size()) for g in provider.node_groups()]


def existing_preferred(k):
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("g", 0, 10, 0, k.tu.build_test_node("t", cpu_m=8000, mem=32 * GB))
    orch = orchestrator(k, provider, processor_for(k, provider))
    result = orch.scale_up([k.tu.build_test_pod("p", cpu_m=4000)], [], now_ts=0.0)
    assert result.scaled_up and result.chosen_group == "g"
    assert all(not g.id().startswith("nap-") for g in provider.node_groups())
    return canon(result)


def failed_creation(k):
    provider = k.prov.TestCloudProvider()

    def exploding_factory(candidate):
        raise RuntimeError("cloud quota exceeded")

    proc = k.nap.AutoprovisioningNodeGroupListProcessor(exploding_factory, shapes(k))
    orch = orchestrator(k, provider, proc)
    pod = k.tu.build_test_pod("p", cpu_m=4000, mem=1 * GB)
    r1 = orch.scale_up([pod], [], now_ts=0.0)
    assert not r1.scaled_up and r1.error
    r2 = orch.scale_up([pod], [], now_ts=1.0)
    assert not r2.scaled_up and r2.error is None
    assert any(g.startswith("nap-") for g in r2.skipped_groups)
    return canon(r1), canon(r2)


def collision(k):
    provider = k.prov.TestCloudProvider()
    proc = processor_for(k, provider)
    pod = k.tu.build_test_pod("p", cpu_m=4000, mem=1 * GB)
    (cand,) = proc.process(provider, [pod], [])
    live = cand.create()
    live.increase_size(3)

    class BrokenTemplate:
        def __getattr__(self, item):
            return getattr(live, item)

        def template_node_info(self):
            raise RuntimeError("template fetch failed")

    assert proc.process(provider, [pod], [BrokenTemplate()]) == []
    assert provider._groups[cand.id()].target_size() == 3
    return cand.id()


def cleanup(k):
    provider = k.prov.TestCloudProvider()
    provider.add_node_group("nap-x", 0, 10, 0, k.tu.build_test_node("t"), autoprovisioned=True)
    provider.add_node_group("keep", 0, 10, 0, k.tu.build_test_node("t2"))
    removed = k.pipe.NodeGroupManager().remove_unneeded_node_groups(provider)
    assert removed == ["nap-x"] and [g.id() for g in provider.node_groups()] == ["keep"]
    return removed


def affinity_only(k):
    provider = k.prov.TestCloudProvider()
    pod = k.tu.build_test_pod("p", cpu_m=1000,
                              affinity=node_affinity(k, "pool", "In", ("train",)))
    cands = processor_for(k, provider).process(provider, [pod], [])
    template = cands[0].template_node_info()
    assert len(cands) == 1 and template.labels.get("pool") == "train"
    assert k.nap._pod_fits_template(pod, template)
    return cand_view(cands)


def unsynthesizable(k):
    provider = k.prov.TestCloudProvider()
    pod = k.tu.build_test_pod("p", cpu_m=1000,
                              affinity=node_affinity(k, "zone-rank", "Gt", ("5",)))
    cands = processor_for(k, provider).process(provider, [pod], [])
    assert cands == []
    return cands


def distinct_affinity(k):
    provider = k.prov.TestCloudProvider()
    pods = [k.tu.build_test_pod("a", cpu_m=1000, affinity=node_affinity(k, "pool", "In",
                                                                         ("train",))),
            k.tu.build_test_pod("b", cpu_m=1000, affinity=node_affinity(k, "pool", "In",
                                                                         ("serve",)))]
    cands = processor_for(k, provider).process(provider, pods, [])
    assert len(cands) == 2 and cands[0].id() != cands[1].id()
    return cand_view(cands)


CASES = [unfittable_pod, fittable_pod, tpu_pod, dedupe, budget, candidate_wins,
         existing_preferred, failed_creation, collision, cleanup, affinity_only,
         unsynthesizable, distinct_affinity]


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_nap_case(case, pkg):
    """tests/test_nap.py's case on one package's objects."""
    case(pkg)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_nap_case_matches_jax(case):
    assert case(TORCH) == case(JAX)


def test_candidate_ids_are_stable_across_packages():
    """A candidate's id hashes its shape and labels (the backoff registry
    keys on it): both packages name the same candidates alike."""
    pods = {name: [k.tu.build_test_pod(f"p{i}", cpu_m=500 + 900 * i, mem=(1 + i) * GB,
                                       node_selector={"pool": f"p{i % 3}"})
                   for i in range(12)]
            for name, k in (("jax", JAX), ("torch", TORCH))}
    ids = {}
    for name, k in (("jax", JAX), ("torch", TORCH)):
        provider = k.prov.TestCloudProvider()
        ids[name] = [c.id() for c in processor_for(k, provider).process(provider, pods[name],
                                                                           [])]
    assert ids["torch"] == ids["jax"] and len(ids["jax"]) > 3
