"""Kubernetes-API JSON ↔ framework object converters.

The reference consumes typed client-go objects (utils/kubernetes/listers.go:38
hands apiv1.Node/apiv1.Pod straight to the simulator); this framework's
objects are the dense-tensor-friendly dataclasses in kube/objects.py, so the
real control-plane binding needs one honest translation layer. Quantity
grammar follows apimachinery's resource.Quantity (suffix table) for the
subset CA reads: cpu, memory, ephemeral-storage, pods, and the gpu/tpu
extended resources.

The port's copy of ``autoscaler_tpu/kube/convert.py``.
"""
from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.kube import objects as k8s

# extended-resource names mapped onto the dense gpu/tpu columns
GPU_RESOURCE = "nvidia.com/gpu"
TPU_RESOURCE = "google.com/tpu"
MIRROR_ANNOTATION = "kubernetes.io/config.mirror"

_SUFFIX = {
    "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}


def parse_quantity(s: Any) -> float:
    """resource.Quantity string → float in base units ('100m' → 0.1)."""
    if isinstance(s, (int, float)):
        return float(s)
    s = str(s).strip()
    if not s:
        return 0.0
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suffix in sorted(_SUFFIX, key=len, reverse=True):
        if suffix and s.endswith(suffix):
            return float(s[: -len(suffix)]) * _SUFFIX[suffix]
    return float(s)


def parse_cpu_millis(s: Any) -> float:
    return parse_quantity(s) * 1000.0


def format_cpu_quantity(cores: float, minimum_m: int = 1) -> str:
    """cores → resource.Quantity millicores string ('0.25' → '250m')."""
    return format_cpu_millis(cores * 1000, minimum_m)


def format_cpu_millis(cpu_m: float, minimum_m: int = 1) -> str:
    """millicores → resource.Quantity string, no lossy unit round-trip."""
    return f"{max(int(round(cpu_m)), minimum_m)}m"


def format_memory_quantity(b: float, minimum: int = 1) -> str:
    """bytes → plain-integer resource.Quantity string."""
    return str(max(int(round(b)), minimum))


def parse_timestamp(s: Optional[str]) -> float:
    """RFC3339 → epoch seconds (0.0 when absent)."""
    if not s:
        return 0.0
    try:
        return datetime.datetime.fromisoformat(s.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return 0.0


def format_timestamp(ts: float) -> str:
    return (
        datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )


_DEDICATED_RESOURCES = frozenset(
    {"cpu", "memory", "ephemeral-storage", "pods", GPU_RESOURCE, TPU_RESOURCE}
)


def resources_from_map(m: Optional[Dict[str, Any]]) -> k8s.Resources:
    m = m or {}
    # every key beyond the dedicated columns is a named extended resource
    # (hugepages-*, vendor device plugins) and keeps its own identity —
    # NodeResourcesFit scores each name separately (PREDICATES divergence 4)
    extended = tuple(sorted(
        (name, qty)
        for name, v in m.items()
        if name not in _DEDICATED_RESOURCES and (qty := parse_quantity(v)) != 0
    ))
    return k8s.Resources(
        cpu_m=parse_cpu_millis(m.get("cpu", 0)),
        memory=parse_quantity(m.get("memory", 0)),
        ephemeral=parse_quantity(m.get("ephemeral-storage", 0)),
        gpu=parse_quantity(m.get(GPU_RESOURCE, 0)),
        tpu=parse_quantity(m.get(TPU_RESOURCE, 0)),
        pods=parse_quantity(m.get("pods", 0)),
        extended=extended,
    )


def _label_selector(sel: Optional[Dict[str, Any]]) -> k8s.LabelSelector:
    sel = sel or {}
    exprs = tuple(
        k8s.LabelSelectorRequirement(
            key=e.get("key", ""),
            operator=e.get("operator", "In"),
            values=tuple(e.get("values") or ()),
        )
        for e in sel.get("matchExpressions") or ()
    )
    return k8s.LabelSelector(
        match_labels=tuple(sorted((sel.get("matchLabels") or {}).items())),
        match_expressions=exprs,
    )


def _node_term_selector(term: Dict[str, Any]) -> k8s.LabelSelector:
    """One nodeSelectorTerm (matchExpressions + matchFields) → LabelSelector,
    with Kubernetes semantics preserved: metadata.name matchFields translate
    to the packer's node-name sentinel key, any other field key makes the
    term unsatisfiable (conservative — dropping it would over-admit), and an
    EMPTY term matches NO objects (an empty LabelSelector here would match
    everything, so the never-matching sentinel is emitted instead). Shared
    by pod/DaemonSet node affinity and PV node affinity so the field
    handling cannot drift."""
    exprs = [
        k8s.LabelSelectorRequirement(
            key=e.get("key", ""),
            operator=e.get("operator", "In"),
            values=tuple(e.get("values") or ()),
        )
        for e in term.get("matchExpressions") or ()
    ]
    for f in term.get("matchFields") or ():
        if f.get("key") == "metadata.name":
            exprs.append(
                k8s.LabelSelectorRequirement(
                    key=k8s.NODE_NAME_FIELD_KEY,
                    operator=f.get("operator", "In"),
                    values=tuple(f.get("values") or ()),
                )
            )
        else:
            exprs.append(
                k8s.LabelSelectorRequirement(
                    key=k8s.NODE_NAME_FIELD_KEY, operator="In", values=()
                )
            )
    if not exprs:
        exprs.append(
            k8s.LabelSelectorRequirement(
                key=k8s.NODE_NAME_FIELD_KEY, operator="In", values=()
            )
        )
    return k8s.LabelSelector(match_expressions=tuple(exprs))


def _node_selector_terms(affinity: Dict[str, Any]) -> Tuple[k8s.LabelSelector, ...]:
    na = (affinity.get("nodeAffinity") or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    ) or {}
    return tuple(
        _node_term_selector(term) for term in na.get("nodeSelectorTerms") or ()
    )


def _pod_affinity_terms(section: Optional[Dict[str, Any]]) -> Tuple[k8s.PodAffinityTerm, ...]:
    out = []
    for term in (section or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    ) or ():
        out.append(
            k8s.PodAffinityTerm(
                selector=_label_selector(term.get("labelSelector")),
                topology_key=term.get("topologyKey", ""),
                namespaces=tuple(term.get("namespaces") or ()),
            )
        )
    return tuple(out)


def node_from_json(obj: Dict[str, Any]) -> k8s.Node:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    ready = False
    for cond in status.get("conditions") or ():
        if cond.get("type") == "Ready":
            ready = cond.get("status") == "True"
    taints = [
        k8s.Taint(
            key=t.get("key", ""),
            value=t.get("value", ""),
            effect=t.get("effect", k8s.NO_SCHEDULE),
        )
        for t in spec.get("taints") or ()
    ]
    return k8s.Node(
        name=meta.get("name", ""),
        allocatable=resources_from_map(status.get("allocatable")),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        taints=taints,
        ready=ready,
        unschedulable=bool(spec.get("unschedulable", False)),
        creation_ts=parse_timestamp(meta.get("creationTimestamp")),
        provider_id=spec.get("providerID", ""),
    )


def daemonset_from_json(obj: Dict[str, Any]) -> k8s.DaemonSet:
    """apps/v1 DaemonSet → the autoscaler's slice (identity, nodeSelector,
    tolerations, summed per-pod container requests). Feeds --force-ds
    template charging (reference simulator/nodes.go:56)."""
    meta = obj.get("metadata") or {}
    tmpl_spec = (
        ((obj.get("spec") or {}).get("template") or {}).get("spec") or {}
    )
    requests = k8s.Resources()
    for c in tmpl_spec.get("containers") or ():
        requests = requests + resources_from_map(
            (c.get("resources") or {}).get("requests")
        )
    tolerations = [
        k8s.Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in tmpl_spec.get("tolerations") or ()
    ]
    return k8s.DaemonSet(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        node_selector=dict(tmpl_spec.get("nodeSelector") or {}),
        tolerations=tolerations,
        requests=requests,
        # the default scheduler targets DS pods via required node affinity
        # (kubernetes >=1.12); suitable_for evaluates these terms
        node_selector_terms=_node_selector_terms(
            tmpl_spec.get("affinity") or {}
        ),
    )


def csinode_limits_from_json(obj: Dict[str, Any]) -> Tuple[str, Dict[str, int]]:
    """CSINode → (node_name, {driver: allocatable_count}).

    The scheduler's NodeVolumeLimits plugin reads
    CSINode.spec.drivers[].allocatable.count; this feeds
    Node.csi_attach_limits (see PREDICATES.md, NodeVolumeLimits row)."""
    name = (obj.get("metadata") or {}).get("name", "")
    limits: Dict[str, int] = {}
    for d in (obj.get("spec") or {}).get("drivers") or ():
        count = (d.get("allocatable") or {}).get("count")
        if d.get("name") and count is not None:
            limits[d["name"]] = int(count)
    return name, limits


def pv_node_affinity_terms(pv: Dict[str, Any]) -> Tuple[k8s.LabelSelector, ...]:
    """PV.spec.nodeAffinity.required.nodeSelectorTerms → ORed LabelSelector
    terms (same JSON shape as pod node affinity; zonal and local PVs carry
    these — the VolumeBinding filter's bound-PV check, which subsumes the
    legacy VolumeZone zone-label rule).

    matchFields / empty-term semantics live in _node_term_selector."""
    req = (
        ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required") or {}
    )
    return tuple(
        _node_term_selector(term)
        for term in req.get("nodeSelectorTerms") or ()
    )


def storageclass_topology_terms(sc: Dict[str, Any]) -> Tuple[k8s.LabelSelector, ...]:
    """StorageClass.allowedTopologies → ORed LabelSelector terms (the
    VolumeBinding filter's constraint for UNBOUND WaitForFirstConsumer
    claims: provisioning must be possible in the candidate node's topology).
    matchLabelExpressions admit only key+values (In semantics)."""
    terms = []
    for topo in sc.get("allowedTopologies") or ():
        exprs = tuple(
            k8s.LabelSelectorRequirement(
                key=e.get("key", ""),
                operator="In",
                values=tuple(e.get("values") or ()),
            )
            for e in topo.get("matchLabelExpressions") or ()
        )
        if exprs:
            terms.append(k8s.LabelSelector(match_expressions=exprs))
    return tuple(terms)


def pvc_csi_index(
    pvcs: Sequence[Dict[str, Any]],
    pvs: Sequence[Dict[str, Any]],
    storage_classes: Sequence[Dict[str, Any]] = (),
) -> Dict[Tuple[str, str], Tuple[Optional[str], Optional[str], Tuple, Optional[str]]]:
    """→ {(namespace, claimName): (csi_driver | None, volumeHandle | None,
    pv_node_affinity_terms)} for claims bound to PersistentVolumes.

    The CSI part closes PREDICATES.md divergence 3: two pods sharing one RWX
    claim map to the SAME volumeHandle, so the packer's unique-handle attach
    counting sees one attachment per node, not two. Non-CSI PVs (hostPath,
    NFS, local, ...) resolve with driver=None — no attach slot — but their
    node-affinity terms STILL constrain placement (round 3: the
    VolumeBinding/VolumeZone rule). The 4th element is the claim's unique id
    when its accessModes include ReadWriteOncePod (the VolumeRestrictions
    filter input), else None."""
    pv_by_name: Dict[str, Tuple[Optional[str], Optional[str], Tuple]] = {}
    for pv in pvs:
        name = (pv.get("metadata") or {}).get("name", "")
        csi = ((pv.get("spec") or {}).get("csi")) or {}
        terms = pv_node_affinity_terms(pv)
        if csi.get("driver"):
            pv_by_name[name] = (csi["driver"], csi.get("volumeHandle", name), terms)
        elif terms:
            pv_by_name[name] = (None, None, terms)
    sc_terms: Dict[str, Tuple] = {}
    for sc in storage_classes:
        name = (sc.get("metadata") or {}).get("name", "")
        terms = storageclass_topology_terms(sc)
        if terms:
            sc_terms[name] = terms
    out: Dict[
        Tuple[str, str], Tuple[Optional[str], Optional[str], Tuple, Optional[str]]
    ] = {}
    for pvc in pvcs:
        meta = pvc.get("metadata") or {}
        spec = pvc.get("spec") or {}
        vol = spec.get("volumeName") or ""
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        rwop = (
            f"claim:{key[0]}/{key[1]}"
            if "ReadWriteOncePod" in (spec.get("accessModes") or ())
            else None
        )
        hit = pv_by_name.get(vol)
        if hit is not None:
            out[key] = hit + (rwop,)
        elif rwop and vol:
            # bound to a PV we did not index (no CSI, no affinity): the RWOP
            # exclusivity still holds
            out[key] = (None, None, (), rwop)
        elif not vol:
            # UNBOUND claim: the StorageClass's allowedTopologies constrain
            # where a WaitForFirstConsumer volume could be provisioned —
            # closing the unbound half of the VolumeBinding divergence. A
            # class without allowedTopologies (or no class) provisions
            # anywhere: unconstrained, no entry.
            terms = sc_terms.get(spec.get("storageClassName") or "")
            if terms or rwop:
                out[key] = (None, None, terms or (), rwop)
    return out


def pod_from_json(
    obj: Dict[str, Any],
    pvc_resolver: Optional[
        Callable[[str, str], Optional[Tuple[str, str]]]
    ] = None,
) -> k8s.Pod:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    annotations = dict(meta.get("annotations") or {})

    requests = k8s.Resources()
    host_ports: List[int] = []
    local_storage = False
    for c in spec.get("containers") or ():
        requests = requests + resources_from_map(
            (c.get("resources") or {}).get("requests")
        )
        for port in c.get("ports") or ():
            if port.get("hostPort"):
                host_ports.append(int(port["hostPort"]))
    csi_volumes: List[tuple] = []
    volume_affinity: List[tuple] = []
    rwop_handles: List[str] = []
    legacy_volumes: List[k8s.LegacyVolume] = []
    pod_key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
    for v in spec.get("volumes") or ():
        if "emptyDir" in v or "hostPath" in v:
            local_storage = True
        # Inline legacy in-tree sources: the VolumeRestrictions filter's
        # same-volume node-conflict rules read these directly off
        # pod.spec.volumes (vendored volume_restrictions.go isVolumeConflict)
        gce = v.get("gcePersistentDisk")
        if gce and gce.get("pdName"):
            legacy_volumes.append(k8s.LegacyVolume(
                kind="gce-pd", key=gce["pdName"],
                read_only=bool(gce.get("readOnly")),
            ))
        ebs = v.get("awsElasticBlockStore")
        if ebs and ebs.get("volumeID"):
            legacy_volumes.append(k8s.LegacyVolume(
                kind="aws-ebs", key=ebs["volumeID"],
            ))
        iscsi = v.get("iscsi")
        if iscsi and iscsi.get("iqn"):
            legacy_volumes.append(k8s.LegacyVolume(
                kind="iscsi", key=iscsi["iqn"],
                read_only=bool(iscsi.get("readOnly")),
            ))
        rbd = v.get("rbd")
        if rbd and rbd.get("image"):
            legacy_volumes.append(k8s.LegacyVolume(
                kind="rbd",
                key=f"{rbd.get('pool', 'rbd')}/{rbd['image']}",
                read_only=bool(rbd.get("readOnly")),
                monitors=tuple(rbd.get("monitors") or ()),
            ))
        csi = v.get("csi")
        if csi and csi.get("driver"):
            # inline ephemeral CSI volume: unique to this pod, so its handle
            # is synthesized from the pod identity + volume name.
            csi_volumes.append((csi["driver"], f"{pod_key}/{v.get('name', '')}"))
        pvc = v.get("persistentVolumeClaim")
        if pvc and pvc.get("claimName") and pvc_resolver is not None:
            # PVC-backed volume: resolve claim → bound PV via the caller's
            # PV/PVC listers (pvc_csi_index). CSI sources consume attach
            # slots; ANY bound PV's node-affinity terms constrain placement
            # (VolumeBinding/VolumeZone). Unbound claims resolve to nothing.
            resolved = pvc_resolver(
                meta.get("namespace", "default"), pvc["claimName"]
            )
            if resolved is not None:
                driver, handle, pv_terms, rwop = resolved
                if driver:
                    csi_volumes.append((driver, handle))
                if pv_terms:
                    volume_affinity.append(tuple(pv_terms))
                if rwop:
                    rwop_handles.append(rwop)

    owner = None
    for ref in meta.get("ownerReferences") or ():
        if ref.get("controller"):
            owner = k8s.OwnerRef(
                kind=ref.get("kind", ""), name=ref.get("name", ""), controller=True
            )
            break

    affinity_json = spec.get("affinity") or {}
    node_terms = _node_selector_terms(affinity_json)
    pod_aff = _pod_affinity_terms(affinity_json.get("podAffinity"))
    pod_anti = _pod_affinity_terms(affinity_json.get("podAntiAffinity"))
    affinity = None
    if node_terms or pod_aff or pod_anti:
        affinity = k8s.Affinity(
            node_selector_terms=node_terms,
            pod_affinity=pod_aff,
            pod_anti_affinity=pod_anti,
        )

    spread = tuple(
        k8s.TopologySpreadConstraint(
            max_skew=int(c.get("maxSkew", 1)),
            topology_key=c.get("topologyKey", ""),
            selector=_label_selector(c.get("labelSelector")),
            when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
            min_domains=(
                int(c["minDomains"]) if c.get("minDomains") is not None else None
            ),
            node_affinity_policy=c.get("nodeAffinityPolicy", "Honor"),
            node_taints_policy=c.get("nodeTaintsPolicy", "Ignore"),
            match_label_keys=tuple(c.get("matchLabelKeys") or ()),
        )
        for c in spec.get("topologySpreadConstraints") or ()
    )

    tolerations = [
        k8s.Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in spec.get("tolerations") or ()
    ]

    return k8s.Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        requests=requests,
        labels=dict(meta.get("labels") or {}),
        annotations=annotations,
        node_selector=dict(spec.get("nodeSelector") or {}),
        tolerations=tolerations,
        affinity=affinity,
        topology_spread=spread,
        owner_ref=owner,
        priority=int(spec.get("priority") or 0),
        node_name=spec.get("nodeName", ""),
        host_ports=tuple(host_ports),
        csi_volumes=tuple(csi_volumes),
        volume_node_affinity=tuple(volume_affinity),
        rwop_handles=tuple(rwop_handles),
        legacy_volumes=tuple(legacy_volumes),
        mirror=MIRROR_ANNOTATION in annotations,
        daemonset=bool(owner and owner.kind == "DaemonSet"),
        restartable=owner is not None,
        local_storage=local_storage,
        phase=(obj.get("status") or {}).get("phase") or "",
        creation_ts=parse_timestamp(meta.get("creationTimestamp")),
        deletion_ts=(
            parse_timestamp(meta["deletionTimestamp"])
            if meta.get("deletionTimestamp")
            else None
        ),
    )


def pdb_from_json(obj: Dict[str, Any]) -> k8s.PodDisruptionBudget:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    return k8s.PodDisruptionBudget(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        selector=_label_selector(spec.get("selector")),
        disruptions_allowed=int(status.get("disruptionsAllowed") or 0),
    )


def taints_to_json(taints: List[k8s.Taint]) -> List[Dict[str, str]]:
    return [{"key": t.key, "value": t.value, "effect": t.effect} for t in taints]
