"""Routing predicates of ``autoscaler_tpu/snapshot/affinity.py``: which
pending-pod sets need the dynamic (term-gated) scan. The term and
spread-context builders, and the dynamic scan itself, come with the
affinity slice (ROADMAP queue 1, slice 3); until then the port's estimator
refuses such worlds with NotImplementedError."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from autoscaler_tpu_torch.kube.objects import Pod


def volume_conflict_components(pods: Sequence[Pod]):
    """Pending-vs-pending legacy same-volume conflicts as hostname-level
    conflict components → list of (member_pod_indices, anti_pod_indices):
    within a component, an anti member must not share a node with ANY
    member. aws-ebs: everyone anti; gce-pd/iscsi: RW mounts anti; rbd: RW
    anti within a monitor-overlap connected component."""
    by_vol: Dict[Tuple[str, str], List[Tuple[int, object]]] = {}
    for i, pod in enumerate(pods):
        for v in pod.legacy_volumes:
            by_vol.setdefault((v.kind, v.key), []).append((i, v))
    out = []
    for (kind, _key), users in by_vol.items():
        if len(users) < 2:
            continue
        if kind == "rbd":
            parent = list(range(len(users)))

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for a in range(len(users)):
                for b in range(a + 1, len(users)):
                    if set(users[a][1].monitors) & set(users[b][1].monitors):
                        parent[find(a)] = find(b)
            comps: Dict[int, List[Tuple[int, object]]] = {}
            for k, u in enumerate(users):
                comps.setdefault(find(k), []).append(u)
            components = list(comps.values())
        else:
            components = [users]
        for comp in components:
            members = sorted({i for i, _ in comp})
            if len(members) < 2:
                continue
            if kind == "aws-ebs":
                antis = members
            else:
                antis = sorted({i for i, v in comp if not v.read_only})
            if antis:
                out.append((members, antis))
    return out


def has_interpod_affinity(pods: Sequence[Pod]) -> bool:
    return any(
        p.affinity is not None
        and (p.affinity.pod_affinity or p.affinity.pod_anti_affinity)
        for p in pods
    )


def has_hard_spread(pods: Sequence[Pod]) -> bool:
    return any(
        c.when_unsatisfiable == "DoNotSchedule"
        for p in pods
        for c in p.topology_spread
    )
