"""Inter-pod (anti-)affinity and hard topology spread factored into term
tensors for the estimator's dynamic scan: the port's copy of the parts of
``autoscaler_tpu/snapshot/affinity.py`` that the scale-up estimate runs.

The reference re-runs the InterPodAffinity and PodTopologySpread filter
plugins after every simulated placement inside the binpacking loop
(cluster-autoscaler/estimator/binpacking_estimator.go:119-141). Here the
dynamic part (pods placed during the current scan constraining later pods)
is factored once on the host into small dense tensors over the distinct
required terms, and the scan carries per-term placement state instead of
re-walking objects: ``ops/ffd_scan_affinity.py`` (the hand-written kernel
K3) and the torch loops of ``ops/binpack.py``.

Topology model for scale-up template nodes: a ``kubernetes.io/hostname``
term is node-level (every new template node is its own domain); any other
topology key is group-level (all new nodes of one node group share the
template's non-hostname labels). A group whose template lacks the label
can never satisfy a required affinity term over it, and never violates an
anti term.

The spread schedule context of the hinting simulator
(``build_spread_schedule_context``, ``build_spread_context_from_meta``)
counts domains over the existing nodes instead: it is built on the host
in numpy, as in JAX, and handed to ``ops/schedule.greedy_schedule`` as
nine torch tensors on the snapshot's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.kube import objects as k8s
from autoscaler_tpu_torch.kube.objects import (
    LabelSelector,
    LabelSelectorRequirement,
    Node,
    Pod,
    PodAffinityTerm,
)
from autoscaler_tpu_torch.snapshot.tensors import bucket_size

HOSTNAME_KEY = "kubernetes.io/hostname"


@dataclass
class AffinityTermTensors:
    """Dense factorization of all required (anti-)affinity terms across a
    pending-pod set. T = number of distinct terms."""

    match: np.ndarray        # [T, P] bool: term t's selector+namespace matches pod p
    aff_of: np.ndarray       # [T, P] bool: pod p requires affinity term t
    anti_of: np.ndarray      # [T, P] bool: pod p requires anti-affinity term t
    node_level: np.ndarray   # [T] bool: hostname topology (per-node domain)
    has_label: np.ndarray    # [G, T] bool: group template carries the topology label
    terms: List[PodAffinityTerm]

    @property
    def num_terms(self) -> int:
        """Real (unpadded) term count."""
        return len(self.terms)


def build_affinity_terms(
    pods: Sequence[Pod],
    templates: Sequence[Node],
    pad_pods: int | None = None,
    bucket_terms: bool = False,
    volume_components=None,  # precomputed volume_conflict_components(pods);
                             # None = compute here, () = explicitly none
) -> AffinityTermTensors:
    """Collect the distinct required terms over ``pods`` and evaluate their
    selectors once per (term, pod-label profile). Pending pods that share a
    conflicting legacy volume add one synthetic hostname-level term per
    conflict component. ``bucket_terms=True`` pads the term axis to a
    power-of-two bucket (at least 4) of all-False rows, which constrain
    nothing."""
    term_index: Dict[Tuple, int] = {}
    terms: List[PodAffinityTerm] = []
    decls: List[Tuple[int, int, bool]] = []  # (pod_idx, term_idx, is_anti)

    def intern(term: PodAffinityTerm, ns: str) -> int:
        # an empty namespaces tuple means the declaring pod's namespace, so
        # the same literal term in two namespaces is two constraints
        namespaces = term.namespaces or (ns,)
        key = (term.selector, term.topology_key, tuple(sorted(namespaces)))
        if key not in term_index:
            term_index[key] = len(terms)
            terms.append(
                PodAffinityTerm(
                    selector=term.selector,
                    topology_key=term.topology_key,
                    namespaces=tuple(sorted(namespaces)),
                )
            )
        return term_index[key]

    for i, pod in enumerate(pods):
        if pod.affinity is None:
            continue
        for term in pod.affinity.pod_affinity:
            decls.append((i, intern(term, pod.namespace), False))
        for term in pod.affinity.pod_anti_affinity:
            decls.append((i, intern(term, pod.namespace), True))

    # Synthetic hostname-level conflict terms: match = component members,
    # anti = the mounts the volume rules condemn; the scan's symmetric anti
    # rule then gives exactly the pairwise rule (RO+RO co-exist, RO+RW and
    # RW+RW never share a node). Filled by pod index, not by selector.
    vol_terms = (
        volume_conflict_components(pods)
        if volume_components is None
        else list(volume_components)
    )

    T_aff = len(terms)
    T = T_aff + len(vol_terms)
    TT = bucket_size(T, minimum=4) if bucket_terms else T
    P = pad_pods if pad_pods is not None else len(pods)
    G = len(templates)
    match = np.zeros((TT, P), bool)
    aff_of = np.zeros((TT, P), bool)
    anti_of = np.zeros((TT, P), bool)
    node_level = np.zeros((TT,), bool)
    has_label = np.zeros((G, TT), bool)

    # pod label profiles: selector verdicts depend only on (namespace, labels)
    profile_index: Dict[Tuple, int] = {}
    pod_prof = np.empty(len(pods), np.int64)
    profiles: List[Tuple[str, Dict[str, str]]] = []
    for i, pod in enumerate(pods):
        pid = profile_index.setdefault(pod.profile_key(), len(profile_index))
        pod_prof[i] = pid
        if pid == len(profiles):
            profiles.append((pod.namespace, pod.labels))

    for t, term in enumerate(terms):
        node_level[t] = term.topology_key == HOSTNAME_KEY
        prof_match = np.fromiter(
            (
                ns in term.namespaces and term.selector.matches(labels)
                for ns, labels in profiles
            ),
            bool,
            count=len(profiles),
        )
        if len(pods):
            match[t, : len(pods)] = prof_match[pod_prof]
        for g, tmpl in enumerate(templates):
            # hostname is implicit on every (template) node
            has_label[g, t] = node_level[t] or term.topology_key in tmpl.labels

    for i, t, is_anti in decls:
        (anti_of if is_anti else aff_of)[t, i] = True

    for j, (members, antis) in enumerate(vol_terms):
        t = T_aff + j
        node_level[t] = True            # a same-volume conflict is per node
        has_label[:, t] = True
        match[t, members] = True
        anti_of[t, antis] = True
        terms.append(
            PodAffinityTerm(
                # inert placeholder (In with no values matches nothing); the
                # tensor rows above are what the scan reads
                selector=LabelSelector(
                    match_expressions=(
                        LabelSelectorRequirement(
                            key="autoscaler.tpu/volume-conflict",
                            operator="In",
                            values=(),
                        ),
                    )
                ),
                topology_key=HOSTNAME_KEY,
            )
        )

    return AffinityTermTensors(
        match=match,
        aff_of=aff_of,
        anti_of=anti_of,
        node_level=node_level,
        has_label=has_label,
        terms=terms,
    )


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


_BIG = np.int32(2**30)  # "no static domain" sentinel in the spread minimums


@dataclass
class SpreadTermTensors:
    """Dense factorization of DoNotSchedule topology-spread constraints for
    the within-wave scan gate: the scan carries per-term placement counts,
    so pods placed earlier in the same wave count toward later pods' skew.
    Hostname-key terms are node-level, any other key group-level. The
    static context (counts and minimums over the existing cluster) comes
    from the optional cluster; without it the template-only world applies
    (counts 0)."""

    sp_of: np.ndarray        # [S, P] bool: pod is constrained by term s
    sp_match: np.ndarray     # [S, P] bool: pod matches selector+ns (counts AND selfMatch)
    node_level: np.ndarray   # [S] bool
    max_skew: np.ndarray     # [S] i32
    min_domains: np.ndarray  # [S] i32
    has_label: np.ndarray    # [G, S] bool: template carries the topology key
    static_count: np.ndarray   # [G, S] i32: existing matching pods in the template's domain (group-level)
    min_others: np.ndarray     # [G, S] i32: min count over OTHER static domains (BIG if none)
    static_min: np.ndarray     # [G, S] i32: hostname: min over static domains (BIG if none)
    static_domnum: np.ndarray  # [G, S] i32: hostname: number of static domains
    force_zero: np.ndarray     # [G, S] bool: group-level: minDomains unmet, so the min is 0

    @property
    def num_terms(self) -> int:
        return int(self.sp_of.shape[0])


def _spread_effective_selector(c, pod: Pod):
    """The constraint's selector extended with the pod's own values of its
    matchLabelKeys."""
    if not c.match_label_keys:
        return c.selector
    extra = tuple((k, pod.labels[k]) for k in c.match_label_keys if k in pod.labels)
    if not extra:
        return c.selector
    merged = dict(c.selector.match_labels)
    merged.update(extra)
    return LabelSelector(
        match_labels=tuple(sorted(merged.items())),
        match_expressions=c.selector.match_expressions,
    )


def _intern_spread_terms(pods: Sequence[Pod], with_sig: bool):
    """DoNotSchedule-constraint interning shared by the template world
    (build_spread_terms) and the mask engine's spread rows: ONE
    definition of term identity (topology key, effective selector,
    namespace, maxSkew, minDomains, inclusion policies and, when static
    context is judged with the declarer's filters, the eligibility
    signature with the pod's full constraint-key set).
    → (term_list [(c, sel, ns, declarer, all_keys)], decls [(pod_idx, t)])."""
    term_index: Dict[Tuple, int] = {}
    term_list: List[Tuple] = []
    decls: List[Tuple[int, int]] = []
    for i, pod in enumerate(pods):
        all_keys = frozenset(
            c.topology_key
            for c in pod.topology_spread
            if c.when_unsatisfiable == "DoNotSchedule"
        )
        for c in pod.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue
            sel = _spread_effective_selector(c, pod)
            sig: Tuple = ()
            if with_sig:
                sig = (
                    tuple(sorted(pod.node_selector.items())),
                    repr(pod.affinity.node_selector_terms) if pod.affinity else "",
                    tuple(
                        (t.key, t.operator, t.value, t.effect)
                        for t in pod.tolerations
                    ),
                    all_keys,
                )
            key = (
                c.topology_key, sel, pod.namespace, c.max_skew,
                c.min_domains or 1, c.node_affinity_policy,
                c.node_taints_policy, sig,
            )
            t = term_index.get(key)
            if t is None:
                t = term_index[key] = len(term_list)
                term_list.append((c, sel, pod.namespace, pod, all_keys))
            decls.append((i, t))
    return term_list, decls


def _spread_node_eligible(c, all_keys, declarer: Pod, node: Node) -> bool:
    """Whether a node contributes counts to a term: it carries ALL the
    declaring pod's constraint keys and passes the constraint's node
    inclusion policies, judged with the declaring pod's filters."""
    if not all(k in node.labels for k in all_keys):
        return False
    if c.node_affinity_policy != "Ignore" and not k8s.node_matches_selector(
        declarer, node
    ):
        return False
    if c.node_taints_policy == "Honor" and not k8s.pod_tolerates_taints(
        declarer, node.taints
    ):
        return False
    return True


# the spread schedule context's nine arrays, in order, with their dtypes
SCHEDULE_CONTEXT_DTYPES = (
    ("sp_of", np.bool_),          # [P, S]: pod row declares term s
    ("sp_match", np.bool_),       # [P, S]: pod row matches term s's selector
    ("node_dom", np.int32),       # [S, N]: node's domain id by label, -1 none
    ("sp_elig", np.bool_),        # [S, N]: node contributes counts to term s
    ("dom_valid", np.bool_),      # [S, D]: domain registered by an eligible node
    ("static_counts", np.int32),  # [S, D]: matching placed pods on eligible nodes
    ("skew", np.int32),           # [S]
    ("min_dom", np.int32),        # [S]
    ("domnum", np.int32),         # [S]: registered domains
)


def spread_context_from_numpy(arrays, device=None) -> tuple:
    """The nine arrays of a spread schedule context (JAX's tuple as numpy,
    in ``SCHEDULE_CONTEXT_DTYPES`` order) → torch tensors on ``device``
    (None = the first CUDA card), each copied, never aliased."""
    dev = resolve_device(device)
    if len(arrays) != len(SCHEDULE_CONTEXT_DTYPES):
        raise ValueError(f"expected 9 arrays, got {len(arrays)}")
    return tuple(
        torch.tensor(np.asarray(a, dtype), device=dev)
        for a, (_name, dtype) in zip(arrays, SCHEDULE_CONTEXT_DTYPES)
    )


def build_spread_context_from_meta(pending, meta, tensors):
    """The spread context for the pods ``pending`` of a packed snapshot:
    the placed pods and their nodes come from ``meta``, the arrays are
    sized to the padded ``tensors`` and land on their device."""
    placed = [p for p in meta.pods if p.node_name]
    node_of = [meta.node_index.get(p.node_name, -1) for p in placed]
    return build_spread_schedule_context(
        pending, meta.nodes, placed, node_of,
        meta.pod_index, int(tensors.pod_req.shape[0]),
        num_node_cols=int(tensors.node_valid.shape[0]),
        device=tensors.device,
    )


def build_spread_schedule_context(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    placed_pods: Sequence[Pod],
    node_of: Sequence[int],
    pod_index: Dict[str, int],
    num_pod_rows: int,
    num_node_cols: int | None = None,
    device=None,
):
    """Spread context for ``ops/schedule.greedy_schedule``: domains over
    the existing nodes (the hinting path), where ``build_spread_terms``
    counts over templates. → the nine tensors of
    ``SCHEDULE_CONTEXT_DTYPES`` on ``device`` (None = the first CUDA
    card), or None when no pending pod carries a hard constraint. Terms
    intern as the template world's do, with the eligibility signature.

    - node_dom [S, N]: a node's domain id by label (Filter judges any
      labelled node, even a policy-ineligible one: its count is 0)
    - sp_elig [S, N]: the node passes the term's inclusion policies and
      carries all the declaring pod's constraint keys
    - dom_valid [S, D]: a domain registered by at least one eligible node
    - static_counts [S, D]: matching placed pods on eligible nodes
    """
    if not has_hard_spread(pending):
        return None
    dev = resolve_device(device)
    term_list, idx_decls = _intern_spread_terms(pending, with_sig=True)
    decls = [(pod_index[pending[i].key()], t) for i, t in idx_decls]

    S_real = len(term_list)
    S = bucket_size(S_real, minimum=4)
    N = len(nodes)
    NN = max(num_node_cols if num_node_cols is not None else N, N, 1)
    sp_of = np.zeros((num_pod_rows, S), bool)
    sp_match = np.zeros((num_pod_rows, S), bool)
    # padded node columns stay -1 (no domain) and ineligible
    node_dom = np.full((S, NN), -1, np.int32)
    sp_elig = np.zeros((S, NN), bool)
    skew = np.zeros((S,), np.int32)
    min_dom = np.ones((S,), np.int32)
    domnum = np.zeros((S,), np.int32)
    doms_per_term: List[Dict[str, int]] = []
    for t, (c, sel, ns, declarer, all_keys) in enumerate(term_list):
        skew[t] = c.max_skew
        min_dom[t] = c.min_domains or 1
        dom_ids: Dict[str, int] = {}
        for j, n in enumerate(nodes):
            val = n.labels.get(c.topology_key)
            if val is None:
                continue
            node_dom[t, j] = dom_ids.setdefault(val, len(dom_ids))
            sp_elig[t, j] = _spread_node_eligible(c, all_keys, declarer, n)
        doms_per_term.append(dom_ids)
    D = bucket_size(max((len(d) for d in doms_per_term), default=1), minimum=8)
    dom_valid = np.zeros((S, D), bool)
    static_counts = np.zeros((S, D), np.int32)
    for t in range(S_real):
        for j in range(N):
            if sp_elig[t, j] and node_dom[t, j] >= 0:
                dom_valid[t, node_dom[t, j]] = True
        domnum[t] = int(dom_valid[t].sum())
    # selector verdicts depend only on (namespace, labels): evaluate them
    # once a distinct profile and count the placed pods with bincount
    prof_index: Dict[Tuple, int] = {}
    prof_of = np.empty(len(placed_pods), np.int64)
    profiles: List[Tuple[str, Dict[str, str]]] = []
    live = np.empty(len(placed_pods), bool)
    node_j = np.asarray(
        [j if j is not None else -1 for j in node_of], np.int64
    ) if placed_pods else np.empty(0, np.int64)
    for qi, q in enumerate(placed_pods):
        pid = prof_index.setdefault(q.profile_key(), len(prof_index))
        prof_of[qi] = pid
        if pid == len(profiles):
            profiles.append((q.namespace, q.labels))
        live[qi] = q.deletion_ts is None
    for t, (c, sel, ns, _declarer, _keys) in enumerate(term_list):
        if not placed_pods:
            continue
        prof_match = np.fromiter(
            (pns == ns and sel.matches(lbls) for pns, lbls in profiles),
            bool,
            count=len(profiles),
        )
        sel_pods = prof_match[prof_of] & live & (node_j >= 0)
        jj = node_j[sel_pods]
        ok = sp_elig[t, jj] & (node_dom[t, jj] >= 0)
        doms = node_dom[t, jj[ok]]
        if doms.size:
            static_counts[t, : doms.max() + 1] += np.bincount(
                doms, minlength=doms.max() + 1
            ).astype(np.int32)
    for pod_row, t in decls:
        sp_of[pod_row, t] = True
    for t, (c, sel, ns, _declarer, _keys) in enumerate(term_list):
        for p in pending:
            if p.namespace == ns and sel.matches(p.labels):
                sp_match[pod_index[p.key()], t] = True
    return spread_context_from_numpy(
        (sp_of, sp_match, node_dom, sp_elig, dom_valid, static_counts,
         skew, min_dom, domnum),
        dev,
    )

def build_spread_terms(
    pods: Sequence[Pod],
    templates: Sequence[Node],
    pad_pods: int | None = None,
    bucket_terms: bool = False,
    cluster: "Tuple[Sequence[Node], Sequence[Pod], Sequence[int]] | None" = None,
) -> SpreadTermTensors:
    """Collect distinct DoNotSchedule spread constraints over ``pods``.
    ``cluster`` = (nodes, pods, node_of_pod) gives the static domain counts
    over the live cluster; None means the template-only world. With a
    cluster, terms intern per eligibility signature, so pods with different
    selectors or tolerations get their own static rows."""
    term_list, decls = _intern_spread_terms(pods, with_sig=cluster is not None)

    S = len(term_list)
    SS = bucket_size(S, minimum=4) if bucket_terms else max(S, 1)
    P = pad_pods if pad_pods is not None else len(pods)
    G = len(templates)
    out = SpreadTermTensors(
        sp_of=np.zeros((SS, P), bool),
        sp_match=np.zeros((SS, P), bool),
        node_level=np.zeros((SS,), bool),
        max_skew=np.zeros((SS,), np.int32),
        min_domains=np.ones((SS,), np.int32),
        has_label=np.zeros((G, SS), bool),
        static_count=np.zeros((G, SS), np.int32),
        min_others=np.full((G, SS), _BIG, np.int32),
        static_min=np.full((G, SS), _BIG, np.int32),
        static_domnum=np.zeros((G, SS), np.int32),
        force_zero=np.zeros((G, SS), bool),
    )
    if S == 0:
        return out

    for i, t in decls:
        out.sp_of[t, i] = True
    for t, (c, sel, ns, _declarer, _keys) in enumerate(term_list):
        out.node_level[t] = c.topology_key == HOSTNAME_KEY
        out.max_skew[t] = c.max_skew
        out.min_domains[t] = c.min_domains or 1
        for p_i, pod in enumerate(pods):
            out.sp_match[t, p_i] = pod.namespace == ns and sel.matches(pod.labels)
        for g, tmpl in enumerate(templates):
            out.has_label[g, t] = (
                out.node_level[t] or c.topology_key in tmpl.labels
            )

    if cluster is None:
        # template-only world: no static domains; minDomains > 1 forces the
        # min to 0 for group-level terms (the new nodes' one shared domain)
        for t, (c, *_rest) in enumerate(term_list):
            if not out.node_level[t]:
                out.force_zero[:, t] = (c.min_domains or 1) > 1
        return out

    cl_nodes, cl_pods, cl_node_of = cluster
    for t, (c, sel, ns, declarer, all_keys) in enumerate(term_list):
        key = c.topology_key
        # domains come from the LABEL (hostname included), on the nodes the
        # declaring pod's filters make eligible
        eligible = [
            _spread_node_eligible(c, all_keys, declarer, n) for n in cl_nodes
        ]
        dom_of = [
            n.labels.get(key) if eligible[j] else None
            for j, n in enumerate(cl_nodes)
        ]
        counts: Dict[str, int] = {}
        for d in dom_of:
            if d is not None:
                counts.setdefault(d, 0)
        for q, j in zip(cl_pods, cl_node_of):
            if j < 0 or dom_of[j] is None:
                continue
            if (
                q.namespace == ns
                and q.deletion_ts is None
                and sel.matches(q.labels)
            ):
                counts[dom_of[j]] += 1
        if out.node_level[t]:
            for g in range(G):
                out.static_min[g, t] = min(counts.values()) if counts else _BIG
                out.static_domnum[g, t] = len(counts)
        else:
            for g, tmpl in enumerate(templates):
                dom_t = tmpl.labels.get(key)
                others = [v for d, v in counts.items() if d != dom_t]
                out.static_count[g, t] = counts.get(dom_t, 0) if dom_t else 0
                out.min_others[g, t] = min(others) if others else _BIG
                domains_num = len(counts) + (
                    0 if dom_t in counts else (1 if dom_t is not None else 0)
                )
                out.force_zero[g, t] = (c.min_domains or 1) > domains_num
    return out
