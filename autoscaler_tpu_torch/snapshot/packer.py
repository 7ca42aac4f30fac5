"""Host mask engine: the subset of ``autoscaler_tpu/snapshot/packer.py``
that the scale-up estimate runs.

It holds the resource-row flattener (``resources_row``, memory and
ephemeral storage in MiB), the extended-resource schema, and
``compute_sched_mask``: the non-resource scheduler predicates
(taints/tolerations, nodeSelector, required node affinity, unschedulable
flag, host ports, CSI attach limits, volume restrictions and required
inter-pod affinity against placed pods) precomputed into a boolean [P, N]
mask. The resource-fit predicate stays in the scan, because node usage
evolves during it.

Not here yet (ROADMAP queue 1): the full ``pack`` into ``SnapshotTensors``
and the factored mask (slice 2), and the hard topology-spread rows, which
need the spread-context builders of ``snapshot/affinity.py`` (slice 3).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from autoscaler_tpu_torch.kube import objects as k8s
from autoscaler_tpu_torch.kube.objects import Node, Pod

_MIB = float(1024 * 1024)

SPREAD_NOT_PORTED = (
    "hard topology-spread rows need the spread-context builders of "
    "snapshot/affinity.py, which come with the dynamic affinity and spread "
    "slice (ROADMAP queue 1, slice 3)"
)


def extended_schema(*resource_seqs) -> Tuple[str, ...]:
    """Union of named extended-resource names across any number of
    Resources sequences, sorted — the column schema appended after the base
    NUM_RESOURCES columns. Callers pass POD-REQUEST sequences only: a name
    no pod requests can never gate a fit."""
    names: set = set()
    for seq in resource_seqs:
        for r in seq:
            if r.extended:
                names.update(name for name, _ in r.extended)
    return tuple(sorted(names))


def resources_row(
    r: k8s.Resources, pods_count: float, ext: Tuple[str, ...] = ()
) -> np.ndarray:
    """Resources → dense f32 row. Memory/ephemeral are stored in MiB (byte
    counts up to tens of GiB exceed f32's 24-bit mantissa). ``ext`` appends
    one column per named extended resource, in schema order."""
    row = np.zeros(k8s.NUM_RESOURCES + len(ext), dtype=np.float32)
    row[: k8s.NUM_RESOURCES] = r.as_tuple()
    row[k8s.MEMORY] = r.memory / _MIB
    row[k8s.EPHEMERAL] = r.ephemeral / _MIB
    row[k8s.PODS] = pods_count
    if ext and r.extended:
        em = dict(r.extended)
        for k, name in enumerate(ext):
            row[k8s.NUM_RESOURCES + k] = em.get(name, 0.0)
    return row


def _topology_domains(
    nodes: Sequence[Node], topology_key: str
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Map each node to an integer domain id for a topology key; -1 when the
    node lacks the label."""
    domains: Dict[str, int] = {}
    ids = np.full(len(nodes), -1, dtype=np.int64)
    for i, node in enumerate(nodes):
        val = node.labels.get(topology_key)
        if val is None:
            continue
        ids[i] = domains.setdefault(val, len(domains))
    return ids, domains


def _term_matches_pod(term: k8s.PodAffinityTerm, pod: Pod, self_ns: str) -> bool:
    namespaces = term.namespaces or (self_ns,)
    return pod.namespace in namespaces and term.selector.matches(pod.labels)


def _node_profile_key(node: Node, relevant_keys: frozenset) -> tuple:
    labels = tuple(
        sorted((k, v) for k, v in node.labels.items() if k in relevant_keys)
    )
    key = (tuple(node.taints), labels, node.unschedulable)
    if k8s.NODE_NAME_FIELD_KEY in relevant_keys:
        # a name-pinned PV makes the verdict node-identity-dependent
        key += (node.name,)
    return key


def _pod_profile_key(pod: Pod) -> tuple:
    aff = pod.affinity
    return (
        tuple(pod.tolerations),
        tuple(sorted(pod.node_selector.items())),
        aff.node_selector_terms if aff else (),
        pod.volume_node_affinity,
    )


def _node_port_counts(
    pods: Sequence[Pod], node_of_pod: Sequence[int]
) -> Dict[int, Dict[int, int]]:
    """node index → {host port → count of placed pods occupying it}."""
    port_count: Dict[int, Dict[int, int]] = {}
    for i, pod in enumerate(pods):
        j = node_of_pod[i]
        if j >= 0:
            counts = port_count.setdefault(j, {})
            for p in pod.host_ports:
                counts[p] = counts.get(p, 0) + 1
    return port_count


def _node_csi_attached(
    pods: Sequence[Pod], node_of_pod: Sequence[int]
) -> Dict[int, Dict[str, set]]:
    """node index → {csi driver → set of attached volume handles}."""
    attached: Dict[int, Dict[str, set]] = {}
    for i, pod in enumerate(pods):
        j = node_of_pod[i]
        if j >= 0 and pod.csi_volumes:
            per_driver = attached.setdefault(j, {})
            for driver, handle in pod.csi_volumes:
                per_driver.setdefault(driver, set()).add(handle)
    return attached


def _pod_csi_counts(pod: Pod) -> Tuple[Tuple[str, int], ...]:
    """Per-driver count of the pod's unique volume handles, sorted."""
    if not pod.csi_volumes:
        return ()
    counts: Dict[str, set] = {}
    for driver, handle in pod.csi_volumes:
        counts.setdefault(driver, set()).add(handle)
    return tuple(sorted((d, len(h)) for d, h in counts.items()))


def _csi_fits(
    pod_counts: Tuple[Tuple[str, int], ...],
    node_attached: Dict[str, set],
    limits: Dict[str, int],
) -> bool:
    """NodeVolumeLimits verdict treating all the pod's volumes as new on the
    node."""
    for driver, n_new in pod_counts:
        limit = limits.get(driver)
        if limit is not None and len(node_attached.get(driver, ())) + n_new > limit:
            return False
    return True


def _profile_factorization(
    nodes: Sequence[Node],
    pods: Sequence[Pod],
    node_of_pod: Sequence[int],
    port_count: Dict[int, Dict[int, int]],
    csi_attached: Dict[int, Dict[str, set]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (pod_prof_id [P], node_prof_id [N], prof_mask [CP, CN]) for the
    class-structured predicates: unschedulable, taints/tolerations,
    nodeSelector + required node affinity, host ports and CSI limits,
    evaluated once per (pod profile × node profile)."""
    P, N = len(pods), len(nodes)
    csi_relevant = {d for pod in pods for d, _ in pod.csi_volumes}

    relevant: set = set()
    for pod in pods:
        relevant.update(pod.node_selector.keys())
        if pod.affinity:
            for term in pod.affinity.node_selector_terms:
                relevant.update(k for k, _ in term.match_labels)
                relevant.update(r.key for r in term.match_expressions)
        for vol_terms in pod.volume_node_affinity:
            for term in vol_terms:
                relevant.update(k for k, _ in term.match_labels)
                relevant.update(r.key for r in term.match_expressions)
    relevant_keys = frozenset(relevant)

    node_profiles: Dict[tuple, int] = {}
    node_prof_id = np.zeros(N, np.int64)
    node_exemplar: List[Tuple[Node, Dict[int, int], Dict[str, set]]] = []
    for j, node in enumerate(nodes):
        ports = port_count.get(j, {})
        attached = csi_attached.get(j, {})
        csi_key = tuple(
            sorted(
                (d, len(attached.get(d, ())), node.csi_attach_limits.get(d, -1))
                for d in csi_relevant
            )
        )
        key = (
            _node_profile_key(node, relevant_keys),
            tuple(sorted(ports.items())),
            csi_key,
        )
        pid = node_profiles.setdefault(key, len(node_profiles))
        node_prof_id[j] = pid
        if pid == len(node_exemplar):
            node_exemplar.append((node, ports, attached))

    pod_profiles: Dict[tuple, int] = {}
    pod_prof_id = np.zeros(P, np.int64)
    pod_exemplar: List[Pod] = []
    for i, pod in enumerate(pods):
        key = (
            _pod_profile_key(pod),
            tuple(sorted(pod.host_ports)),
            _pod_csi_counts(pod),
        )
        pid = pod_profiles.setdefault(key, len(pod_profiles))
        pod_prof_id[i] = pid
        if pid == len(pod_exemplar):
            pod_exemplar.append(pod)

    prof_mask = np.ones((max(len(pod_exemplar), 1), max(len(node_exemplar), 1)), bool)
    for pi, pod in enumerate(pod_exemplar):
        pod_csi = _pod_csi_counts(pod)
        for nj, (node, ports, attached) in enumerate(node_exemplar):
            prof_mask[pi, nj] = _class_verdict(pod, node, ports, attached, pod_csi)
    return pod_prof_id, node_prof_id, prof_mask


def _class_verdict(
    pod: Pod, node: Node, ports: Dict, attached: Dict, pod_csi
) -> bool:
    """One (pod-profile, node-profile) cell: the class-structured predicate
    chain."""
    return (
        not node.unschedulable
        and k8s.pod_tolerates_taints(pod, node.taints)
        and k8s.node_matches_selector(pod, node)
        and k8s.pod_volumes_match_node(pod, node)
        and not any(ports.get(p, 0) > 0 for p in pod.host_ports)
        and _csi_fits(pod_csi, attached, node.csi_attach_limits)
    )


def _self_cell_value(pod: Pod, node: Node, port_counts: Dict, attached: Dict) -> bool:
    """Corrected verdict for a placed pod's cell on its OWN node: its own
    port/volume contribution must not count against it."""
    conflict = any(port_counts.get(p, 0) > 1 for p in pod.host_ports)
    pod_drivers = {d for d, _ in pod.csi_volumes}
    csi_ok = all(
        len(attached.get(d, ())) <= limit
        for d, limit in node.csi_attach_limits.items()
        if d in pod_drivers
    )
    return (
        not node.unschedulable
        and k8s.pod_tolerates_taints(pod, node.taints)
        and k8s.node_matches_selector(pod, node)
        and k8s.pod_volumes_match_node(pod, node)
        and not conflict
        and csi_ok
    )


def _self_cell_overrides(
    nodes: Sequence[Node],
    pods: Sequence[Pod],
    node_of_pod: Sequence[int],
    port_count: Dict[int, Dict[int, int]],
    csi_attached: Dict[int, Dict[str, set]],
) -> List[Tuple[int, int, bool]]:
    """→ [(pod_idx, node_idx, value)] corrections for the cells the port and
    CSI class factors get wrong: a placed pod on its OWN node."""
    out: List[Tuple[int, int, bool]] = []
    for i, pod in enumerate(pods):
        j = node_of_pod[i]
        if j < 0 or not (pod.host_ports or pod.csi_volumes):
            continue
        value = _self_cell_value(
            pod, nodes[j], port_count.get(j, {}), csi_attached.get(j, {})
        )
        out.append((i, j, value))
    return out


def _rwop_conflict_rows(pods: Sequence[Pod], node_of_pod: Sequence[int]) -> set:
    """Rows blocked by the VolumeRestrictions ReadWriteOncePod rule: a live
    pod whose RWOP claim another live PLACED pod uses fails on every node."""
    placed_count: Dict[str, int] = {}
    for i, pod in enumerate(pods):
        if pod.rwop_handles and pod.deletion_ts is None and node_of_pod[i] >= 0:
            for h in set(pod.rwop_handles):
                placed_count[h] = placed_count.get(h, 0) + 1
    if not placed_count:
        return set()
    out = set()
    for i, pod in enumerate(pods):
        if not pod.rwop_handles or pod.deletion_ts is not None:
            continue
        own = 1 if node_of_pod[i] >= 0 else 0
        if any(
            placed_count.get(h, 0) - own >= 1 for h in set(pod.rwop_handles)
        ):
            out.add(i)
    return out


def _legacy_conflict_nodes(
    pods: Sequence[Pod],
    node_of_pod: Sequence[int],
) -> Dict[int, set]:
    """Per-row blocked-node sets from the legacy in-tree same-volume rules:
    pod i cannot go on node j when a live pod placed on j mounts a
    conflicting volume."""
    users: List[Tuple[int, Pod]] = [
        (i, p)
        for i, p in enumerate(pods)
        if p.legacy_volumes and p.deletion_ts is None
    ]
    if len(users) < 2:
        return {}
    placed: Dict[Tuple[str, str], List[Tuple[int, int, k8s.LegacyVolume]]] = {}
    for i, p in users:
        j = node_of_pod[i]
        if j >= 0:
            for v in p.legacy_volumes:
                placed.setdefault((v.kind, v.key), []).append((i, j, v))
    if not placed:
        return {}
    out: Dict[int, set] = {}
    for i, p in users:
        blocked = set()
        for v in p.legacy_volumes:
            for qi, j, qv in placed.get((v.kind, v.key), ()):
                if qi != i and v.conflicts(qv):
                    blocked.add(j)
        if blocked:
            out[i] = blocked
    return out


def _apply_row_rules(
    mask: np.ndarray,
    nodes: Sequence[Node],
    pods: Sequence[Pod],
    node_of_pod: Sequence[int],
    interpod: bool,
) -> None:
    """Apply the volume-restriction and inter-pod (anti-)affinity rules vs
    placed pods to the dense [P, N] mask, in place."""
    P, N = len(pods), len(nodes)
    if any(
        c.when_unsatisfiable == "DoNotSchedule"
        for pod in pods
        for c in pod.topology_spread
    ):
        raise NotImplementedError(SPREAD_NOT_PORTED)

    placed = [
        (i, pods[i], node_of_pod[i]) for i in range(P) if node_of_pod[i] >= 0
    ]
    for i in _rwop_conflict_rows(pods, node_of_pod):
        mask[i] = False
    for i, blocked in _legacy_conflict_nodes(pods, node_of_pod).items():
        for j in blocked:
            if j < N:
                mask[i, j] = False

    if not interpod:
        return

    domain_cache: Dict[str, Tuple[np.ndarray, Dict[str, int]]] = {}

    def domains_for(key: str):
        if key not in domain_cache:
            domain_cache[key] = _topology_domains(nodes, key)
        return domain_cache[key]

    # Required inter-pod (anti-)affinity vs already-placed pods, including
    # the symmetric anti-affinity rule.
    for i, pod in enumerate(pods):
        aff = pod.affinity
        if aff is None:
            continue
        for term in aff.pod_affinity:
            node_dom, _ = domains_for(term.topology_key)
            ok_domains = {
                node_dom[j]
                for (_, q, j) in placed
                if node_dom[j] >= 0 and _term_matches_pod(term, q, pod.namespace)
            }
            if _term_matches_pod(term, pod, pod.namespace):
                # Kubernetes self-match rule: a pod may satisfy its own
                # required affinity term
                allowed = node_dom >= 0
            else:
                allowed = np.isin(node_dom, list(ok_domains)) & (node_dom >= 0)
            mask[i] &= allowed
        for term in aff.pod_anti_affinity:
            node_dom, _ = domains_for(term.topology_key)
            bad_domains = {
                node_dom[j]
                for (qi, q, j) in placed
                if qi != i and node_dom[j] >= 0
                and _term_matches_pod(term, q, pod.namespace)
            }
            if bad_domains:
                mask[i] &= ~np.isin(node_dom, list(bad_domains))

    for (qi, q, j) in placed:
        if q.affinity is None:
            continue
        for term in q.affinity.pod_anti_affinity:
            node_dom, _ = domains_for(term.topology_key)
            if node_dom[j] < 0:
                continue
            in_domain = node_dom == node_dom[j]
            for i, pod in enumerate(pods):
                if i != qi and _term_matches_pod(term, pod, q.namespace):
                    mask[i] &= ~in_domain


def compute_sched_mask(
    nodes: Sequence[Node],
    pods: Sequence[Pod],
    node_of_pod: Sequence[int],
    interpod: bool = True,
) -> np.ndarray:
    """[P, N] boolean precomputed predicate mask. node_of_pod[i] is the index
    of the node pod i is placed on, -1 if pending. interpod=False skips the
    inter-pod (anti-)affinity rules (the dynamic scan's job). Pods with a
    hard topology-spread constraint raise NotImplementedError."""
    P, N = len(pods), len(nodes)
    mask = np.ones((P, N), dtype=bool)
    port_count = _node_port_counts(pods, node_of_pod)
    csi_attached = _node_csi_attached(pods, node_of_pod)
    pod_prof_id, node_prof_id, prof_mask = _profile_factorization(
        nodes, pods, node_of_pod, port_count, csi_attached
    )
    if P and N:
        mask = prof_mask[pod_prof_id][:, node_prof_id]
    for i, j, value in _self_cell_overrides(
        nodes, pods, node_of_pod, port_count, csi_attached
    ):
        mask[i, j] = value
    _apply_row_rules(mask, nodes, pods, node_of_pod, interpod)
    return mask
