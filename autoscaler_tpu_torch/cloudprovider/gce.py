"""GCE cloud provider: MIG-backed node groups with TPU node-pool support.

Reference: cluster-autoscaler/cloudprovider/gce/ — the MIG cache and target
size caching (gce_manager.go), template→Node construction
(gce/templates.go), the price model (gce/gce_price_model.go), and the
min:max:MIG-url node-group spec of the --nodes flag (main.go --nodes,
cloudprovider/gce/gce_cloud_provider.go BuildGCE). The transport is an
injectable `GceApi` so the provider logic is hermetic: `InMemoryGceApi`
simulates the instance-group API (tests, dry runs, and this zero-egress
build); a deploy site supplies an HTTP transport with the same surface.

TPU-first details the reference's GCE adapter lacks: TPU machine types
(ct5lp/ct4p/ct6e families) populate the `google.com/tpu` allocatable, carry
the GKE TPU labels (gke-tpu-accelerator, gke-tpu-topology) and the
`google.com/tpu` NoSchedule taint, and are priced per chip; the snapshot
packer's sanitizer (utils/tpu.py, reference utils/tpu/tpu.go:57) already
strips cloud-tpus.google.com requests before simulation.

The port's copy of ``autoscaler_tpu/cloudprovider/gce.py``.
"""
from __future__ import annotations

import abc
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    InstanceErrorClass,
    InstanceErrorInfo,
    InstanceState,
    NodeGroup,
    NodeGroupError,
    PricingModel,
    ResourceLimiter,
)
from autoscaler_tpu_torch.kube.objects import Node, Pod, Resources, Taint
from autoscaler_tpu_torch.utils.cache import ExpiringCache

GB = 1024**3

# machine type → (cpu_m, memory_bytes, gpu, tpu_chips). A practical subset of
# the GCE catalog (reference templates.go reads this from the API; hermetic
# builds need a table) plus the GKE TPU VM shapes.
MACHINE_TYPES: Dict[str, Tuple[float, float, float, float]] = {
    "e2-standard-2": (2000, 8 * GB, 0, 0),
    "e2-standard-4": (4000, 16 * GB, 0, 0),
    "e2-standard-8": (8000, 32 * GB, 0, 0),
    "n2-standard-4": (4000, 16 * GB, 0, 0),
    "n2-standard-8": (8000, 32 * GB, 0, 0),
    "n2-standard-16": (16000, 64 * GB, 0, 0),
    "n1-standard-8-gpu": (8000, 30 * GB, 1, 0),
    "a2-highgpu-1g": (12000, 85 * GB, 1, 0),
    "a2-highgpu-8g": (96000, 680 * GB, 8, 0),
    # TPU v5e (ct5lp): 1/4/8 chips per VM
    "ct5lp-hightpu-1t": (24000, 48 * GB, 0, 1),
    "ct5lp-hightpu-4t": (112000, 192 * GB, 0, 4),
    "ct5lp-hightpu-8t": (224000, 384 * GB, 0, 8),
    # TPU v4 (ct4p) and v6e (ct6e)
    "ct4p-hightpu-4t": (240000, 407 * GB, 0, 4),
    "ct6e-standard-4t": (180000, 720 * GB, 0, 4),
    "ct6e-standard-8t": (360000, 1440 * GB, 0, 8),
}

# $/hour on-demand (approximate catalog values; the price *model* structure is
# what matters — reference gce_price_model.go hardcodes the same kind of
# table). TPU types are priced per chip-hour.
HOURLY_PRICES: Dict[str, float] = {
    "e2-standard-2": 0.067,
    "e2-standard-4": 0.134,
    "e2-standard-8": 0.268,
    "n2-standard-4": 0.194,
    "n2-standard-8": 0.388,
    "n2-standard-16": 0.776,
    "n1-standard-8-gpu": 2.78,
    "a2-highgpu-1g": 3.67,
    "a2-highgpu-8g": 29.39,
    "ct5lp-hightpu-1t": 1.20,
    "ct5lp-hightpu-4t": 4.80,
    "ct5lp-hightpu-8t": 9.60,
    "ct4p-hightpu-4t": 12.88,
    "ct6e-standard-4t": 11.00,
    "ct6e-standard-8t": 22.00,
}
SPOT_DISCOUNT = 0.6  # preemptible/spot ≈ 40% of on-demand (price model knob)

TPU_RESOURCE_LABEL = "cloud.google.com/gke-tpu-accelerator"
TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
TPU_TAINT_KEY = "google.com/tpu"
GPU_LABEL = "cloud.google.com/gke-accelerator"

_MIG_URL = re.compile(
    r"(?:https://.*?/)?projects/(?P<project>[^/]+)/zones/(?P<zone>[^/]+)"
    r"/instanceGroups/(?P<name>[^/]+)$"
)


def parse_mig_url(url: str) -> Tuple[str, str, str]:
    """→ (project, zone, name). Accepts full URLs or the bare
    projects/…/zones/…/instanceGroups/… path (reference gce_url.go)."""
    m = _MIG_URL.match(url)
    if not m:
        raise ValueError(f"not a MIG url: {url!r}")
    return m.group("project"), m.group("zone"), m.group("name")


@dataclass
class MigTemplate:
    """What the instance template says a new VM looks like
    (reference templates.go buildNodeFromTemplate)."""

    machine_type: str
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    spot: bool = False
    tpu_topology: str = ""  # e.g. "2x4" for a ct5lp-hightpu-8t pool


@dataclass
class MigInstance:
    name: str
    state: InstanceState = InstanceState.RUNNING
    error: Optional[InstanceErrorInfo] = None


class GceApi(abc.ABC):
    """The injectable transport: exactly the instance-group API calls the
    provider needs (reference gce/autoscaling_gce_client.go surface).

    CONCURRENCY CONTRACT: `list_instances` is called from a small thread
    pool during refresh (the --gce-concurrent-refreshes analog), so
    implementations must tolerate concurrent read calls — use a stateless
    request function or per-call connections (RestGceApi does), not one
    shared non-thread-safe HTTP client. Mutations (resize/delete) are only
    ever issued from the actuation path, one at a time per group."""

    @abc.abstractmethod
    def get_target_size(self, project: str, zone: str, mig: str) -> int: ...

    @abc.abstractmethod
    def resize(self, project: str, zone: str, mig: str, size: int) -> None: ...

    @abc.abstractmethod
    def delete_instances(
        self, project: str, zone: str, mig: str, names: Sequence[str]
    ) -> None: ...

    @abc.abstractmethod
    def list_instances(self, project: str, zone: str, mig: str) -> List[MigInstance]: ...

    @abc.abstractmethod
    def get_template(self, project: str, zone: str, mig: str) -> MigTemplate: ...

    def list_migs(self) -> List[Tuple[str, str, str]]:
        """(project, zone, name) of every MIG visible to the credentials —
        the discovery surface behind --node-group-auto-discovery
        (reference cloudprovider/gce MIG auto-discovery by name prefix).
        Default empty: transports without list permission discover nothing."""
        return []


class InMemoryGceApi(GceApi):
    """Hermetic GCE: resize creates CREATING instances that become RUNNING on
    settle(); quota caps inject OUT_OF_RESOURCES errors the way a stockout
    region does. Serves tests and zero-egress environments."""

    def __init__(self) -> None:
        self._migs: Dict[Tuple[str, str, str], Dict] = {}
        self.calls: List[Tuple] = []

    def list_migs(self) -> List[Tuple[str, str, str]]:
        return list(self._migs.keys())

    def add_mig(
        self,
        project: str,
        zone: str,
        name: str,
        template: MigTemplate,
        target_size: int = 0,
        quota: Optional[int] = None,
    ) -> None:
        key = (project, zone, name)
        self._migs[key] = {
            "template": template,
            "target": target_size,
            "instances": [
                MigInstance(f"{name}-{i}") for i in range(target_size)
            ],
            "quota": quota,
            "seq": target_size,
        }

    def _mig(self, project: str, zone: str, name: str) -> Dict:
        try:
            return self._migs[(project, zone, name)]
        except KeyError:
            raise NodeGroupError(f"no such MIG {project}/{zone}/{name}")

    def get_target_size(self, project: str, zone: str, mig: str) -> int:
        return self._mig(project, zone, mig)["target"]

    def resize(self, project: str, zone: str, mig: str, size: int) -> None:
        self.calls.append(("resize", mig, size))
        m = self._mig(project, zone, mig)
        while size > m["target"]:
            name = f"{mig}-{m['seq']}"
            m["seq"] += 1
            if m["quota"] is not None and len(m["instances"]) >= m["quota"]:
                m["instances"].append(
                    MigInstance(
                        name,
                        InstanceState.CREATING,
                        InstanceErrorInfo(
                            InstanceErrorClass.OUT_OF_RESOURCES,
                            "QUOTA_EXCEEDED",
                            "no capacity in zone",
                        ),
                    )
                )
            else:
                m["instances"].append(MigInstance(name, InstanceState.CREATING))
            m["target"] += 1
        if size < m["target"]:
            # shrink: cancel CREATING instances first (newest first), then
            # drop RUNNING ones — mirrors a MIG resize-down deleting VMs
            surplus = m["target"] - size
            keep: List[MigInstance] = []
            for inst in reversed(m["instances"]):
                if surplus > 0 and inst.state == InstanceState.CREATING:
                    surplus -= 1
                else:
                    keep.append(inst)
            keep.reverse()
            while surplus > 0 and keep:
                keep.pop()
                surplus -= 1
            m["instances"] = keep
        m["target"] = size

    def delete_instances(
        self, project: str, zone: str, mig: str, names: Sequence[str]
    ) -> None:
        self.calls.append(("delete", mig, tuple(names)))
        m = self._mig(project, zone, mig)
        doomed = set(names)
        before = len(m["instances"])
        m["instances"] = [i for i in m["instances"] if i.name not in doomed]
        removed = before - len(m["instances"])  # unknown names don't shrink target
        m["target"] = max(0, m["target"] - removed)

    def list_instances(self, project: str, zone: str, mig: str) -> List[MigInstance]:
        return list(self._mig(project, zone, mig)["instances"])

    def get_template(self, project: str, zone: str, mig: str) -> MigTemplate:
        return self._mig(project, zone, mig)["template"]

    def settle(self) -> None:
        """Finish provisioning: CREATING instances without errors → RUNNING
        (the fake analog of VMs booting and registering)."""
        for m in self._migs.values():
            for inst in m["instances"]:
                if inst.state == InstanceState.CREATING and inst.error is None:
                    inst.state = InstanceState.RUNNING


def build_node_from_template(
    name: str, zone: str, tmpl: MigTemplate, provider_id: str = ""
) -> Node:
    """Template → hypothetical Node (reference templates.go:buildNodeFromTemplate
    + BuildGenericLabels). TPU machine shapes populate google.com/tpu and the
    GKE TPU labels/taint so the predicate mask sees the pool correctly."""
    try:
        cpu_m, mem, gpu, tpu = MACHINE_TYPES[tmpl.machine_type]
    except KeyError:
        raise NodeGroupError(f"unknown machine type {tmpl.machine_type!r}")
    labels = {
        "kubernetes.io/hostname": name,
        "topology.kubernetes.io/zone": zone,
        "node.kubernetes.io/instance-type": tmpl.machine_type,
        **tmpl.labels,
    }
    taints = list(tmpl.taints)
    if tpu > 0:
        labels.setdefault(TPU_RESOURCE_LABEL, _tpu_family(tmpl.machine_type))
        if tmpl.tpu_topology:
            labels.setdefault(TPU_TOPOLOGY_LABEL, tmpl.tpu_topology)
        if not any(t.key == TPU_TAINT_KEY for t in taints):
            taints.append(Taint(TPU_TAINT_KEY, "present", "NoSchedule"))
    if gpu > 0:
        labels.setdefault(GPU_LABEL, "nvidia-tesla-a100")
    if tmpl.spot:
        labels.setdefault("cloud.google.com/gke-spot", "true")
    return Node(
        name=name,
        allocatable=Resources(cpu_m=cpu_m, memory=mem, gpu=gpu, tpu=tpu, pods=110),
        labels=labels,
        taints=taints,
        provider_id=provider_id,
    )


def _tpu_family(machine_type: str) -> str:
    if machine_type.startswith("ct5lp"):
        return "tpu-v5-lite-podslice"
    if machine_type.startswith("ct4p"):
        return "tpu-v4-podslice"
    if machine_type.startswith("ct6e"):
        return "tpu-v6e-slice"
    return "tpu"


class GceMig(NodeGroup):
    """One managed instance group (reference gce/gce_cloud_provider.go Mig)."""

    def __init__(
        self,
        manager: "GceManager",
        project: str,
        zone: str,
        name: str,
        min_size: int,
        max_size: int,
    ):
        self._manager = manager
        self.project = project
        self.zone = zone
        self.name = name
        self._min = min_size
        self._max = max_size

    def id(self) -> str:
        return f"{self.project}/{self.zone}/{self.name}"

    def min_size(self) -> int:
        return self._min

    def max_size(self) -> int:
        return self._max

    def target_size(self) -> int:
        return self._manager.target_size(self)

    def increase_size(self, delta: int) -> None:
        if delta <= 0:
            raise NodeGroupError("size increase must be positive")
        new = self.target_size() + delta
        if new > self._max:
            raise NodeGroupError(
                f"size increase too large: {new} > max {self._max}"
            )
        self._manager.resize(self, new)

    def delete_nodes(self, nodes: Sequence[Node]) -> None:
        if self.target_size() - len(nodes) < self._min:
            raise NodeGroupError("deletion would violate min size")
        names = [n.name for n in nodes]
        mine = {i.name for i in self._manager.instances(self)}
        for name in names:
            if name not in mine:
                raise NodeGroupError(f"{name} does not belong to {self.id()}")
        self._manager.delete_instances(self, names)

    def decrease_target_size(self, delta: int) -> None:
        if delta <= 0:
            raise NodeGroupError("size decrease must be positive")
        current = self.target_size()
        running = sum(
            1
            for i in self._manager.instances(self)
            if i.state == InstanceState.RUNNING
        )
        if current - delta < running:
            raise NodeGroupError(
                "attempt to delete existing nodes via decrease_target_size"
            )
        self._manager.resize(self, current - delta)

    def nodes(self) -> List[Instance]:
        out = []
        for mi in self._manager.instances(self):
            out.append(
                Instance(
                    id=f"gce://{self.project}/{self.zone}/{mi.name}",
                    state=mi.state,
                    error_info=mi.error,
                )
            )
        return out

    def template_node_info(self) -> Node:
        tmpl = self._manager.template(self)
        return build_node_from_template(f"{self.name}-template", self.zone, tmpl)

    def template(self) -> MigTemplate:
        return self._manager.template(self)


class GceManager:
    """Caching layer between MIGs and the API (reference gce_manager.go:
    target sizes and templates are cached with a TTL and invalidated on
    mutation, so one reconcile loop does O(groups) API reads at most)."""

    def __init__(self, api: GceApi, cache_ttl_s: float = 60.0):
        self.api = api
        self._target_cache: ExpiringCache = ExpiringCache(cache_ttl_s)
        self._template_cache: ExpiringCache = ExpiringCache(10 * cache_ttl_s)
        self._instance_cache: ExpiringCache = ExpiringCache(cache_ttl_s)

    def target_size(self, mig: GceMig) -> int:
        v = self._target_cache.get(mig.id())
        if v is None:
            v = self.api.get_target_size(mig.project, mig.zone, mig.name)
            self._target_cache.put(mig.id(), v)
        return v

    def resize(self, mig: GceMig, size: int) -> None:
        self.api.resize(mig.project, mig.zone, mig.name, size)
        self._target_cache.invalidate(mig.id())
        self._instance_cache.invalidate(mig.id())

    def delete_instances(self, mig: GceMig, names: Sequence[str]) -> None:
        self.api.delete_instances(mig.project, mig.zone, mig.name, names)
        self._target_cache.invalidate(mig.id())
        self._instance_cache.invalidate(mig.id())

    def instances(self, mig: GceMig) -> List[MigInstance]:
        v = self._instance_cache.get(mig.id())
        if v is None:
            v = self.api.list_instances(mig.project, mig.zone, mig.name)
            self._instance_cache.put(mig.id(), v)
        return v

    def template(self, mig: GceMig) -> MigTemplate:
        v = self._template_cache.get(mig.id())
        if v is None:
            v = self.api.get_template(mig.project, mig.zone, mig.name)
            self._template_cache.put(mig.id(), v)
        return v

    def invalidate(self) -> None:
        self._target_cache.invalidate()
        self._instance_cache.invalidate()


class GcePriceModel(PricingModel):
    """reference gce/gce_price_model.go: machine-type table + spot discount;
    pod price = proportional share of the cheapest machine fitting it."""

    def node_price(self, node: Node, start_s: float, end_s: float) -> float:
        hours = max(0.0, end_s - start_s) / 3600.0
        mt = node.labels.get("node.kubernetes.io/instance-type", "")
        base = HOURLY_PRICES.get(mt)
        if base is None:
            # fall back to a per-resource estimate (reference does the same
            # for custom machine types)
            base = (
                node.allocatable.cpu_m / 1000.0 * 0.033
                + node.allocatable.memory / GB * 0.0044
                + node.allocatable.gpu * 2.0
                + node.allocatable.tpu * 1.2
            )
        if node.labels.get("cloud.google.com/gke-spot") == "true":
            base *= 1.0 - SPOT_DISCOUNT
        return base * hours

    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float:
        hours = max(0.0, end_s - start_s) / 3600.0
        return (
            pod.requests.cpu_m / 1000.0 * 0.033
            + pod.requests.memory / GB * 0.0044
            + pod.requests.gpu * 2.0
            + pod.requests.tpu * 1.2
        ) * hours


class GceCloudProvider(CloudProvider):
    def __init__(
        self,
        manager: GceManager,
        migs: Sequence[GceMig],
        resource_limiter: Optional[ResourceLimiter] = None,
    ):
        self._manager = manager
        self._migs = list(migs)
        self._limiter = resource_limiter or ResourceLimiter()
        self._node_to_mig: Dict[str, GceMig] = {}
        self.refresh()

    def name(self) -> str:
        return "gce"

    def node_groups(self) -> List[NodeGroup]:
        return list(self._migs)

    def node_group_for_node(self, node: Node) -> Optional[NodeGroup]:
        # providerID form gce://project/zone/instance (reference
        # gce_cloud_provider.go NodeGroupForNode → instance→MIG cache)
        return self._node_to_mig.get(node.provider_id or node.name)

    def get_resource_limiter(self) -> ResourceLimiter:
        return self._limiter

    def pricing(self) -> Optional[PricingModel]:
        return GcePriceModel()

    def gpu_label(self) -> str:
        return GPU_LABEL

    # --gce-concurrent-refreshes (reference main.go:194, default 1 —
    # serial): MIG instance listings are independent HTTP calls; raising
    # this fetches them on a worker pool. Set via build_gce_provider.
    concurrent_refreshes = 1

    def refresh(self) -> None:
        self._manager.invalidate()
        node_to_mig: Dict[str, GceMig] = {}
        migs = list(self._migs)
        if len(migs) > 1 and self.concurrent_refreshes > 1:
            from concurrent.futures import ThreadPoolExecutor

            workers = min(self.concurrent_refreshes, len(migs))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                listings = list(pool.map(self._manager.instances, migs))
        else:
            listings = [self._manager.instances(mig) for mig in migs]
        for mig, instances in zip(migs, listings):
            for inst in instances:
                pid = f"gce://{mig.project}/{mig.zone}/{inst.name}"
                node_to_mig[pid] = mig
                node_to_mig[inst.name] = mig
        # swap atomically: concurrent readers never see a half-built map
        self._node_to_mig = node_to_mig


def parse_auto_discovery_spec(spec: str) -> Dict[str, object]:
    """'mig:namePrefix=<pfx>,min=<m>,max=<M>' → {"prefix", "min", "max"} —
    the reference's GCE auto-discovery spec format
    (--node-group-auto-discovery, cloudprovider/gce MIG auto-discovery)."""
    kind, _, rest = spec.partition(":")
    if kind != "mig" or not rest:
        raise ValueError(f"bad auto-discovery spec {spec!r} (want mig:namePrefix=...)")
    out: Dict[str, object] = {"prefix": "", "min": 0, "max": 1000}
    for part in rest.split(","):
        k, _, v = part.partition("=")
        if k == "namePrefix":
            out["prefix"] = v
        elif k == "min":
            out["min"] = int(v)
        elif k == "max":
            out["max"] = int(v)
        else:
            raise ValueError(f"unknown auto-discovery key {k!r} in {spec!r}")
    if not out["prefix"]:
        raise ValueError(f"auto-discovery spec {spec!r} needs namePrefix")
    return out


def build_gce_provider(
    specs: Sequence[str],
    api: GceApi,
    resource_limiter: Optional[ResourceLimiter] = None,
    cache_ttl_s: float = 60.0,
    auto_discovery: Sequence[str] = (),
    concurrent_refreshes: int = 1,
) -> GceCloudProvider:
    """specs: 'min:max:projects/P/zones/Z/instanceGroups/NAME' — the
    reference's --nodes flag format (main.go --nodes, spec parsing in
    cloudprovider/gce). auto_discovery: 'mig:namePrefix=...,min=...,max=...'
    specs (--node-group-auto-discovery); MIGs matching a prefix and not
    already explicitly configured are added with the spec's size bounds."""
    manager = GceManager(api, cache_ttl_s)
    migs = []
    for spec in specs:
        parts = spec.split(":", 2)
        if len(parts) != 3:
            raise ValueError(f"bad node group spec {spec!r} (want min:max:url)")
        lo, hi, url = int(parts[0]), int(parts[1]), parts[2]
        project, zone, name = parse_mig_url(url)
        migs.append(GceMig(manager, project, zone, name, lo, hi))
    explicit = {(m.project, m.zone, m.name) for m in migs}
    listed = api.list_migs() if auto_discovery else []  # one cloud call
    for disc_spec in auto_discovery:
        disc = parse_auto_discovery_spec(disc_spec)
        for project, zone, name in listed:
            key = (project, zone, name)
            if key in explicit or not name.startswith(str(disc["prefix"])):
                continue
            explicit.add(key)
            migs.append(
                GceMig(manager, project, zone, name, int(disc["min"]), int(disc["max"]))
            )
    provider = GceCloudProvider(manager, migs, resource_limiter)
    provider.concurrent_refreshes = max(int(concurrent_refreshes), 1)
    return provider
