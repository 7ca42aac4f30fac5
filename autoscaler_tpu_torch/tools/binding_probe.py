"""Fake control planes for the cluster bindings, served over HTTP from a
child process: a Kubernetes API (nodes, pods, PodDisruptionBudgets,
DaemonSets, ConfigMaps, Leases, events, eviction, node patch and delete,
watch streams, the storage lists, and cluster.x-k8s.io MachineDeployments,
MachineSets and Machines with their ``/scale`` subresource) and a Compute
v1 API (managed instance groups, instance templates,
``listManagedInstances``, ``resize``, ``deleteInstances`` and zonal
operations). Both record every write as (method, path, body).

    servers = FakeServers.start()          # a spawned child process
    servers.load("nodes", [(name, node_json(n)) for n in nodes])
    client = KubeRestClient(servers.kube_url)
    ...
    servers.writes()                        # [(method, path, body), ...]
    servers.close()

The child process serves both APIs, so that serving tens of megabytes of
JSON does not compete with the caller's reconcile tick for the GIL. A
control endpoint under ``/_control/`` loads objects and applies churn
(each change is pushed to the watch streams as a watch event). A write's
answer leaves only once every open watch stream of its kind has sent the
event, as an API server's informers see their own writes soon after.

The module is stdlib only. ``node_json`` and friends turn the port's
``kube/objects`` dataclasses into the API's JSON, read field by field, so
that ``kube/convert`` gives back equal objects.
"""
from __future__ import annotations

import json
import multiprocessing
import queue
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CAPI = "/apis/cluster.x-k8s.io/v1beta1"
CAPI_GROUP = "cluster.x-k8s.io"
MACHINE_ANNOTATION = f"{CAPI_GROUP}/machine"
DELETE_MACHINE = f"{CAPI_GROUP}/delete-machine"
NODE_NAME_FIELD_KEY = "metadata.name"   # kube/objects.NODE_NAME_FIELD_KEY

# the kinds the fake Kubernetes API stores: kind → (list path, namespaced)
KINDS = {
    "nodes": ("/api/v1/nodes", False),
    "pods": ("/api/v1/pods", True),
    "pdbs": ("/apis/policy/v1/poddisruptionbudgets", True),
    "daemonsets": ("/apis/apps/v1/daemonsets", True),
    "pvcs": ("/api/v1/persistentvolumeclaims", True),
    "pvs": ("/api/v1/persistentvolumes", False),
    "csinodes": ("/apis/storage.k8s.io/v1/csinodes", False),
    "storageclasses": ("/apis/storage.k8s.io/v1/storageclasses", False),
    "configmaps": ("/api/v1/configmaps", True),
    "leases": ("/apis/coordination.k8s.io/v1/leases", True),
    "events": ("/api/v1/events", True),
    "machinedeployments": (f"{CAPI}/machinedeployments", True),
    "machinesets": (f"{CAPI}/machinesets", True),
    "machines": (f"{CAPI}/machines", True),
}
_LIST_PATHS = {path: kind for kind, (path, _) in KINDS.items()}
_PLURAL_OF_NAMESPACED = {
    "pods": "pods", "configmaps": "configmaps", "leases": "leases", "events": "events",
    "machinedeployments": "machinedeployments", "machinesets": "machinesets",
    "machines": "machines", "poddisruptionbudgets": "pdbs", "daemonsets": "daemonsets",
}


# -- the port's objects as the API's JSON ---------------------------------------
def cpu_quantity(cpu_m: float) -> str:
    """Millicores as a Quantity: whole cores, or millicores. (``convert``
    reads "1001m" as 1000.9999999999999 millicores, as the JAX package's
    does; the packed float32 requests round it back to 1001.)"""
    cpu_m = float(cpu_m)
    if cpu_m % 1000 == 0:
        return str(int(cpu_m // 1000))
    if cpu_m.is_integer():
        return f"{int(cpu_m)}m"
    return repr(cpu_m / 1000.0)


def plain_quantity(x: float) -> str:
    x = float(x)
    return str(int(x)) if x.is_integer() else repr(x)


def resources_json(r, pods: bool = True) -> Dict[str, str]:
    out = {}
    if r.cpu_m:
        out["cpu"] = cpu_quantity(r.cpu_m)
    for key, v in (("memory", r.memory), ("ephemeral-storage", r.ephemeral),
                   ("nvidia.com/gpu", r.gpu), ("google.com/tpu", r.tpu)):
        if v:
            out[key] = plain_quantity(v)
    if pods and r.pods:
        out["pods"] = plain_quantity(r.pods)
    for name, v in r.extended:
        out[name] = plain_quantity(v)
    return out


def _timestamp(ts: float) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


def selector_json(sel) -> dict:
    out = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, "values": list(e.values)}
            for e in sel.match_expressions
        ]
    return out


def _node_term_json(sel) -> dict:
    if sel.match_labels:
        raise ValueError("a node selector term has no matchLabels")
    exprs, fields = [], []
    for e in sel.match_expressions:
        entry = {"key": e.key, "operator": e.operator, "values": list(e.values)}
        if e.key == NODE_NAME_FIELD_KEY:
            fields.append({**entry, "key": "metadata.name"})
        else:
            exprs.append(entry)
    out = {}
    if exprs:
        out["matchExpressions"] = exprs
    if fields:
        out["matchFields"] = fields
    return out


def _affinity_terms_json(terms) -> dict:
    return {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": selector_json(t.selector), "topologyKey": t.topology_key,
         **({"namespaces": list(t.namespaces)} if t.namespaces else {})}
        for t in terms
    ]}


def node_json(node, annotations: Optional[Dict[str, str]] = None) -> dict:
    """A ``kube/objects.Node`` as a v1 Node (``annotations`` are added)."""
    if node.csi_attach_limits or any(node.daemon_overhead.as_tuple()):
        raise ValueError(f"node {node.name}: CSI limits and daemon overhead are not served")
    meta = {"name": node.name, "labels": dict(node.labels)}
    ann = {**node.annotations, **(annotations or {})}
    if ann:
        meta["annotations"] = ann
    if node.creation_ts:
        meta["creationTimestamp"] = _timestamp(node.creation_ts)
    spec = {"providerID": node.provider_id} if node.provider_id else {}
    if node.taints:
        spec["taints"] = [{"key": t.key, "value": t.value, "effect": t.effect}
                          for t in node.taints]
    if node.unschedulable:
        spec["unschedulable"] = True
    return {
        "apiVersion": "v1", "kind": "Node", "metadata": meta, "spec": spec,
        "status": {
            "allocatable": resources_json(node.allocatable),
            "conditions": [{"type": "Ready", "status": "True" if node.ready else "False"}],
        },
    }


def pod_json(pod) -> dict:
    """A ``kube/objects.Pod`` as a v1 Pod."""
    unserved = [name for name in ("csi_volumes", "volume_node_affinity", "rwop_handles",
                                  "resource_claims") if getattr(pod, name, ())]
    if unserved or pod.preemption_policy or pod.restartable != (pod.owner_ref is not None):
        raise ValueError(f"pod {pod.key()}: {unserved or 'restartable or preemption'} not served")
    meta = {"name": pod.name, "namespace": pod.namespace}
    if pod.labels:
        meta["labels"] = dict(pod.labels)
    ann = dict(pod.annotations)
    if pod.mirror:
        ann.setdefault("kubernetes.io/config.mirror", "mirror")
    if ann:
        meta["annotations"] = ann
    if pod.creation_ts:
        meta["creationTimestamp"] = _timestamp(pod.creation_ts)
    if pod.deletion_ts is not None:
        meta["deletionTimestamp"] = _timestamp(pod.deletion_ts)
    if pod.owner_ref is not None:
        if not pod.owner_ref.controller:
            raise ValueError(f"pod {pod.key()}: a non-controller owner is not served")
        meta["ownerReferences"] = [{"kind": pod.owner_ref.kind, "name": pod.owner_ref.name,
                                    "controller": True}]
    if pod.daemonset != bool(pod.owner_ref and pod.owner_ref.kind == "DaemonSet"):
        raise ValueError(f"pod {pod.key()}: daemonset flag without a DaemonSet owner")
    container = {"name": "c", "resources": {"requests": resources_json(pod.requests)}}
    if pod.host_ports:
        container["ports"] = [{"containerPort": p, "hostPort": p} for p in pod.host_ports]
    spec = {"containers": [container]}
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [{"key": t.key, "operator": t.operator, "value": t.value,
                                "effect": t.effect} for t in pod.tolerations]
    aff = pod.affinity
    if aff is not None:
        a = {}
        if aff.node_selector_terms:
            a["nodeAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [_node_term_json(t) for t in aff.node_selector_terms]}}
        if aff.pod_affinity:
            a["podAffinity"] = _affinity_terms_json(aff.pod_affinity)
        if aff.pod_anti_affinity:
            a["podAntiAffinity"] = _affinity_terms_json(aff.pod_anti_affinity)
        spec["affinity"] = a
    if pod.topology_spread:
        spec["topologySpreadConstraints"] = [
            {"maxSkew": c.max_skew, "topologyKey": c.topology_key,
             "labelSelector": selector_json(c.selector),
             "whenUnsatisfiable": c.when_unsatisfiable,
             **({"minDomains": c.min_domains} if c.min_domains is not None else {}),
             "nodeAffinityPolicy": c.node_affinity_policy,
             "nodeTaintsPolicy": c.node_taints_policy,
             **({"matchLabelKeys": list(c.match_label_keys)} if c.match_label_keys else {})}
            for c in pod.topology_spread
        ]
    if pod.priority:
        spec["priority"] = pod.priority
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    volumes = []
    if pod.local_storage:
        volumes.append({"name": "scratch", "emptyDir": {}})
    for k, v in enumerate(pod.legacy_volumes):
        if v.kind == "gce-pd":
            src = {"gcePersistentDisk": {"pdName": v.key, "readOnly": v.read_only}}
        elif v.kind == "aws-ebs":
            src = {"awsElasticBlockStore": {"volumeID": v.key}}
        elif v.kind == "iscsi":
            src = {"iscsi": {"iqn": v.key, "readOnly": v.read_only}}
        else:
            pool, _, image = v.key.partition("/")
            src = {"rbd": {"pool": pool, "image": image, "readOnly": v.read_only,
                           "monitors": list(v.monitors)}}
        volumes.append({"name": f"legacy-{k}", **src})
    if volumes:
        spec["volumes"] = volumes
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec,
            "status": {"phase": pod.phase} if pod.phase else {}}


# -- cluster.x-k8s.io objects ---------------------------------------------------------
def machine_deployment_json(ns: str, name: str, min_size: int, max_size: int,
                            replicas: int, template=None) -> dict:
    """A MachineDeployment with the autoscaler's size annotations and, for
    a ``template`` node, the scale-from-zero capacity annotations (cpu,
    memory, max pods, labels, taints)."""
    ann = {f"{CAPI_GROUP}/cluster-api-autoscaler-node-group-min-size": str(min_size),
           f"{CAPI_GROUP}/cluster-api-autoscaler-node-group-max-size": str(max_size)}
    if template is not None:
        cap = "capacity.cluster-autoscaler.kubernetes.io/"
        a = template.allocatable
        ann[cap + "cpu"] = cpu_quantity(a.cpu_m)
        ann[cap + "memory"] = plain_quantity(a.memory)
        ann[cap + "maxPods"] = plain_quantity(a.pods)
        if a.ephemeral:
            ann[cap + "ephemeral-disk"] = plain_quantity(a.ephemeral)
        if a.gpu:
            ann[cap + "gpu-count"] = plain_quantity(a.gpu)
        labels = {k: v for k, v in template.labels.items() if k != "kubernetes.io/hostname"}
        if labels:
            ann[cap + "labels"] = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        if template.taints:
            ann[cap + "taints"] = ",".join(f"{t.key}={t.value}:{t.effect}"
                                           for t in template.taints)
    return {"apiVersion": f"{CAPI_GROUP}/v1beta1", "kind": "MachineDeployment",
            "metadata": {"name": name, "namespace": ns, "annotations": ann},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"deployment": name}}}}


def machine_set_json(ns: str, name: str, deployment: str) -> dict:
    return {"apiVersion": f"{CAPI_GROUP}/v1beta1", "kind": "MachineSet",
            "metadata": {"name": name, "namespace": ns,
                         "ownerReferences": [{"kind": "MachineDeployment", "name": deployment}]},
            "spec": {"selector": {"matchLabels": {"deployment": deployment}}}}


def machine_json(ns: str, name: str, machine_set: str, deployment: str,
                 provider_id: str, phase: str = "Running") -> dict:
    return {"apiVersion": f"{CAPI_GROUP}/v1beta1", "kind": "Machine",
            "metadata": {"name": name, "namespace": ns,
                         "labels": {"deployment": deployment},
                         "ownerReferences": [{"kind": "MachineSet", "name": machine_set}]},
            "spec": {"providerID": provider_id}, "status": {"phase": phase}}


def _key(kind: str, obj: dict) -> str:
    meta = obj.get("metadata") or {}
    if KINDS[kind][1]:
        return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
    return meta.get("name", "")


# -- the fake Kubernetes API -------------------------------------------------------------
class _Store:
    """The objects of the fake Kubernetes API, each kept as its JSON text
    (a list answer joins them without serializing again) and parsed only
    when a write changes it; one resourceVersion counter for all kinds, an
    event log and the open watch streams per kind, and the write log."""

    def __init__(self):
        self.lock = threading.RLock()
        self.rv = 10
        self.blobs: Dict[str, Dict[str, bytes]] = {k: {} for k in KINDS}
        self.by_ns: Dict[str, Dict[str, Dict[str, None]]] = {k: {} for k in KINDS}
        self.events: Dict[str, List[Tuple[int, bytes]]] = {k: [] for k in KINDS}
        self.watchers: Dict[str, List[queue.Queue]] = {k: [] for k in KINDS}
        self.writes: List[tuple] = []

    def get(self, kind: str, key: str) -> Optional[dict]:
        blob = self.blobs[kind].get(key)
        return None if blob is None else json.loads(blob)

    def put(self, kind: str, obj: dict, event: Optional[str] = "MODIFIED") -> dict:
        """Store ``obj`` (new or changed) at the next resourceVersion and,
        with ``event``, push the watch event."""
        self.rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        key = _key(kind, obj)
        blob = json.dumps(obj).encode()
        if key not in self.blobs[kind] and KINDS[kind][1]:
            ns = key.split("/", 1)[0]
            self.by_ns[kind].setdefault(ns, {})[key] = None
        self.blobs[kind][key] = blob
        if event:
            self._push(kind, event, blob)
        return obj

    def delete(self, kind: str, key: str, event: bool = True) -> Optional[dict]:
        blob = self.blobs[kind].pop(key, None)
        if blob is None:
            return None
        if KINDS[kind][1]:
            self.by_ns[kind].get(key.split("/", 1)[0], {}).pop(key, None)
        obj = json.loads(blob)
        self.rv += 1
        obj["metadata"]["resourceVersion"] = str(self.rv)
        if event:
            self._push(kind, "DELETED", json.dumps(obj).encode())
        return obj

    def _push(self, kind: str, type_: str, blob: bytes) -> None:
        line = b'{"type": "' + type_.encode() + b'", "object": ' + blob + b"}\n"
        self.events[kind].append((self.rv, line))
        for q in self.watchers[kind]:
            q.put(line)

    def list_body(self, kind: str, namespace: Optional[str] = None) -> bytes:
        blobs = self.blobs[kind]
        if namespace is None:
            items = blobs.values()
        else:
            items = [blobs[k] for k in self.by_ns[kind].get(namespace, {})]
        return (b'{"kind": "List", "metadata": {"resourceVersion": "' + str(self.rv).encode()
                + b'"}, "items": [' + b", ".join(items) + b"]}")

    def delivered(self, kind: str, timeout_s: float = 2.0) -> None:
        """Wait (outside the lock) until every open watch stream of ``kind``
        has sent what was pushed to it."""
        deadline = time.monotonic() + timeout_s
        for q in list(self.watchers[kind]):
            while q.unfinished_tasks and time.monotonic() < deadline:
                time.sleep(0.0002)


def _route(path: str) -> Tuple[Optional[str], Optional[str], Optional[str], List[str]]:
    """path → (kind, namespace, name, the parts after the name)."""
    if path in _LIST_PATHS:
        return _LIST_PATHS[path], None, None, []
    parts = path.strip("/").split("/")
    if path.startswith("/api/v1/nodes/"):
        return "nodes", None, parts[3], parts[4:]
    if "namespaces" in parts:
        i = parts.index("namespaces")
        ns = parts[i + 1]
        rest = parts[i + 2:]
        if rest and rest[0] in _PLURAL_OF_NAMESPACED:
            kind = _PLURAL_OF_NAMESPACED[rest[0]]
            return kind, ns, (rest[1] if len(rest) > 1 else None), rest[2:]
    return None, None, None, []


class _KubeHandler(BaseHTTPRequestHandler):
    # set on the subclass each server is built with: the store, the
    # compute API it answers /projects/ paths with (None: the kube server),
    # and the compute state its control endpoint reads and loads
    store: _Store = None
    compute: "_Compute" = None
    control_compute: "_Compute" = None

    def log_message(self, *args):
        pass

    def _send(self, code: int, payload=None, raw: Optional[bytes] = None):
        body = raw if raw is not None else json.dumps(payload or {}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        length = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(length)) if length else None

    def _record(self, body) -> None:
        self.store.writes.append((self.command, self.path, json.loads(json.dumps(body))))

    # -- watch --------------------------------------------------------------------------
    def _watch(self, kind: str, query: str):
        store = self.store
        since = 0
        for part in query.split("&"):
            if part.startswith("resourceVersion="):
                since = int(part.split("=", 1)[1] or 0)
        q: queue.Queue = queue.Queue()
        with store.lock:
            for rv, line in store.events[kind]:
                if rv > since:
                    q.put(line)
            store.watchers[kind].append(q)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        try:
            while not self.server.stopping:
                try:
                    line = q.get(timeout=0.5)
                except queue.Empty:
                    continue
                self.wfile.write(line)
                self.wfile.flush()
                q.task_done()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            with store.lock:
                if q in store.watchers[kind]:
                    store.watchers[kind].remove(q)

    # -- reads ------------------------------------------------------------------------------
    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path.startswith("/_control/"):
            return self._control_get(path, query)
        if self.compute is not None and path.startswith("/projects/"):
            return self.compute.get(self, path, query)
        store = self.store
        kind, ns, name, sub = _route(path)
        if kind is None:
            return self._send(404, {"reason": "NotFound"})
        if "watch=1" in query:
            return self._watch(kind, query)
        with store.lock:
            if name is None:
                return self._send(200, raw=store.list_body(kind, ns))
            key = f"{ns}/{name}" if KINDS[kind][1] else name
            obj = store.get(kind, key)
        if obj is None:
            return self._send(404, {"reason": "NotFound"})
        if sub == ["scale"]:
            return self._send(200, {"kind": "Scale", "metadata": {"name": name, "namespace": ns},
                                    "spec": {"replicas": (obj.get("spec") or {}).get(
                                        "replicas", 0)}})
        return self._send(200, obj)

    # -- writes -----------------------------------------------------------------------------
    def do_POST(self):
        path, _, query = self.path.partition("?")
        body = self._body()
        if path.startswith("/_control/"):
            return self._control_post(path, body)
        if self.compute is not None and path.startswith("/projects/"):
            return self.compute.post(self, path, query, body)
        store = self.store
        kind, ns, name, sub = _route(path)
        push = None
        with store.lock:
            self._record(body)
            if kind == "pods" and sub == ["eviction"]:
                key = f"{ns}/{name}"
                if store.delete("pods", key) is None:
                    return self._send(404, {"reason": "NotFound"})
                code, answer, push = 201, {"kind": "Status", "status": "Success"}, "pods"
            elif kind in ("configmaps", "leases") and name is None:
                meta = body.setdefault("metadata", {})
                meta.setdefault("namespace", ns)
                if store.get(kind, f"{ns}/{meta.get('name', '')}") is not None:
                    return self._send(409, {"reason": "AlreadyExists"})
                code, answer = 201, store.put(kind, body, event=None)
            elif kind == "events" and name is None:
                meta = body.setdefault("metadata", {})
                meta["namespace"] = ns
                meta["name"] = f"{meta.get('generateName', 'event.')}{store.rv + 1:x}"
                code, answer = 201, store.put(kind, body, event=None)
            else:
                return self._send(404, {"reason": "NotFound"})
        if push:
            store.delivered(push)
        return self._send(code, answer)

    def do_PUT(self):
        path = self.path.partition("?")[0]
        body = self._body()
        store = self.store
        kind, ns, name, sub = _route(path)
        with store.lock:
            self._record(body)
            key = f"{ns}/{name}" if kind and KINDS[kind][1] else name
            current = store.get(kind, key) if kind and name else None
            if current is None:
                return self._send(404, {"reason": "NotFound"})
            if kind == "machinedeployments" and sub == ["scale"]:
                replicas = int((body.get("spec") or {}).get("replicas", 0))
                before = int((current.get("spec") or {}).get("replicas", 0))
                current.setdefault("spec", {})["replicas"] = replicas
                store.put(kind, current, event=None)
                if replicas < before:
                    self._reap_machines(ns, name, before - replicas)
                return self._send(200, {"kind": "Scale", "metadata": {"name": name,
                                                                       "namespace": ns},
                                        "spec": {"replicas": replicas}})
            if sub:
                return self._send(404, {"reason": "NotFound"})
            if kind == "leases":
                sent = (body.get("metadata") or {}).get("resourceVersion")
                if sent is not None and sent != current["metadata"].get("resourceVersion"):
                    return self._send(409, {"reason": "Conflict"})
            if kind not in ("leases", "configmaps"):
                return self._send(404, {"reason": "NotFound"})
            body.setdefault("metadata", {})["namespace"] = ns
            return self._send(200, store.put(kind, body, event=None))

    def _reap_machines(self, ns: str, deployment: str, count: int) -> None:
        """A MachineDeployment scaled down: its controller deletes the
        machines marked for deletion first."""
        store = self.store
        keys = list(store.by_ns["machines"].get(ns, {}))
        marked = [k for k in keys
                  if DELETE_MACHINE in (store.get("machines", k)["metadata"].get("annotations")
                                        or {})]
        for key in marked[:count]:
            store.delete("machines", key, event=False)

    def do_PATCH(self):
        path = self.path.partition("?")[0]
        body = self._body() or {}
        store = self.store
        kind, ns, name, sub = _route(path)
        push = None
        with store.lock:
            self._record(body)
            key = f"{ns}/{name}" if kind and KINDS[kind][1] else name
            current = store.get(kind, key) if kind and name and not sub else None
            if current is None:
                return self._send(404, {"reason": "NotFound"})
            if kind == "nodes":
                spec = body.get("spec") or {}
                if "taints" in spec:
                    current.setdefault("spec", {})["taints"] = spec["taints"]
                if "unschedulable" in spec:
                    current.setdefault("spec", {})["unschedulable"] = spec["unschedulable"]
                push = "nodes"
                answer = store.put(kind, current)
            elif kind == "machines":
                ann = current["metadata"].setdefault("annotations", {})
                for k, v in ((body.get("metadata") or {}).get("annotations") or {}).items():
                    if v is None:
                        ann.pop(k, None)
                    else:
                        ann[k] = v
                answer = store.put(kind, current, event=None)
            else:
                return self._send(404, {"reason": "NotFound"})
        if push:
            store.delivered(push)
        return self._send(200, answer)

    def do_DELETE(self):
        path = self.path.partition("?")[0]
        body = self._body()
        store = self.store
        kind, ns, name, sub = _route(path)
        push = None
        with store.lock:
            self._record(body)
            key = f"{ns}/{name}" if kind and KINDS[kind][1] else name
            if kind not in ("nodes", "leases") or not name or sub:
                return self._send(404, {"reason": "NotFound"})
            current = store.get(kind, key)
            if current is None:
                return self._send(404, {"reason": "NotFound"})
            want = ((body or {}).get("preconditions") or {}).get("resourceVersion")
            if want is not None and want != current["metadata"].get("resourceVersion"):
                return self._send(409, {"reason": "Conflict"})
            store.delete(kind, key, event=kind == "nodes")
            push = "nodes" if kind == "nodes" else None
        if push:
            store.delivered(push)
        return self._send(200, {"kind": "Status", "status": "Success"})

    # -- the control endpoint ---------------------------------------------------------
    def _control_get(self, path: str, query: str):
        store = self.store
        args = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
        with store.lock:
            if path == "/_control/writes":
                since = int(args.get("since", 0))
                return self._send(200, {"writes": store.writes[since:],
                                        "count": len(store.writes)})
            if path == "/_control/objects":
                kind = args["kind"]
                return self._send(200, raw=store.list_body(kind, args.get("namespace")))
            if path == "/_control/rv":
                return self._send(200, {"rv": store.rv, "last": {
                    k: (store.events[k][-1][0] if store.events[k] else 0) for k in KINDS}})
        if path == "/_control/compute":
            return self._send(200, self.control_compute.state())
        return self._send(404, {})

    def _control_post(self, path: str, body):
        store = self.store
        if path == "/_control/load":
            # {"kind": ..., "lines": "key\\tjson\\n..."} or {"kind", "objects"}
            kind = body["kind"]
            with store.lock:
                for obj in body.get("objects") or ():
                    store.put(kind, obj, event=None)
                for line in (body.get("lines") or "").split("\n"):
                    if line:
                        key, _, text = line.partition("\t")
                        store.rv += 1
                        store.blobs[kind][key] = text.encode()
                        if KINDS[kind][1]:
                            ns = key.split("/", 1)[0]
                            store.by_ns[kind].setdefault(ns, {})[key] = None
            return self._send(200, {"rv": store.rv})
        if path == "/_control/apply":
            # ops: ["put", kind, obj] | ["delete", kind, key] | ["bind", key, node]
            pushed = set()
            with store.lock:
                for op in body["ops"]:
                    if op[0] == "put":
                        store.put(op[1], op[2], event="ADDED" if store.get(
                            op[1], _key(op[1], op[2])) is None else "MODIFIED")
                        pushed.add(op[1])
                    elif op[0] == "delete":
                        store.delete(op[1], op[2])
                        pushed.add(op[1])
                    elif op[0] == "bind":
                        pod = store.get("pods", op[1])
                        pod["spec"]["nodeName"] = op[2]
                        store.put("pods", pod)
                        pushed.add("pods")
                    else:
                        return self._send(400, {"op": op[0]})
            for kind in pushed:
                store.delivered(kind)
            return self._send(200, {"rv": store.rv})
        if path == "/_control/compute":
            self.control_compute.load(body)
            return self._send(200, {})
        return self._send(404, {})


# -- the fake Compute v1 API -----------------------------------------------------------------
class _Compute:
    """Managed instance groups, instance templates, managed instances and
    DONE operations; writes are recorded as (method, path, body)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.migs: Dict[str, dict] = {}       # "project/zone/name" → MIG
        self.templates: Dict[str, dict] = {}  # name → instanceTemplate
        self.writes: List[tuple] = []
        self.ops = 0

    def load(self, body: dict) -> None:
        with self.lock:
            for mig in body.get("migs") or ():
                key = f"{mig['project']}/{mig['zone']}/{mig['name']}"
                self.migs[key] = {**mig, "instances": [dict(i) for i in mig.get("instances", ())]}
            self.templates.update(body.get("templates") or {})

    def state(self) -> dict:
        with self.lock:
            return {"migs": self.migs, "writes": self.writes}

    def _mig(self, path: str):
        parts = path.strip("/").split("/")
        # projects/{p}/zones/{z}/instanceGroupManagers/{m}[/verb]
        if len(parts) >= 6 and parts[4] == "instanceGroupManagers":
            return parts, self.migs.get(f"{parts[1]}/{parts[3]}/{parts[5]}")
        return parts, None

    def _op(self, parts) -> dict:
        self.ops += 1
        return {"kind": "compute#operation", "name": f"operation-{self.ops}",
                "zone": parts[3], "status": "DONE"}

    def get(self, handler, path: str, query: str):
        with self.lock:
            parts, mig = self._mig(path)
            if mig is not None and len(parts) == 6:
                return handler._send(200, {
                    "name": mig["name"], "targetSize": mig["targetSize"],
                    "instanceTemplate": f"global/instanceTemplates/{mig['template']}"})
            if len(parts) == 5 and parts[2:4] == ["global", "instanceTemplates"]:
                tmpl = self.templates.get(parts[4])
                return handler._send(200, tmpl) if tmpl else handler._send(404, {})
            if len(parts) == 6 and parts[4] == "operations":
                return handler._send(200, {"name": parts[5], "status": "DONE"})
            if len(parts) == 4 and parts[2:] == ["aggregated", "instanceGroupManagers"]:
                items: Dict[str, dict] = {}
                for m in self.migs.values():
                    if m["project"] == parts[1]:
                        items.setdefault(f"zones/{m['zone']}", {"instanceGroupManagers": []})[
                            "instanceGroupManagers"].append({"name": m["name"]})
                return handler._send(200, {"items": items})
        return handler._send(404, {"error": "not found"})

    def post(self, handler, path: str, query: str, body):
        with self.lock:
            self.writes.append(("POST", handler.path, body))
            parts, mig = self._mig(path)
            if mig is None or len(parts) != 7:
                return handler._send(404, {"error": "not found"})
            verb = parts[6]
            if verb == "listManagedInstances":
                self.writes.pop()   # a read, though it is a POST
                return handler._send(200, {"managedInstances": [
                    {"instance": f"projects/{mig['project']}/zones/{mig['zone']}/instances/"
                                 f"{i['name']}",
                     "currentAction": i.get("currentAction", "NONE"),
                     "instanceStatus": i.get("instanceStatus", "RUNNING")}
                    for i in mig["instances"]]})
            if verb == "resize":
                args = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
                mig["targetSize"] = int(args["size"])
                return handler._send(200, self._op(parts))
            if verb == "deleteInstances":
                gone = {u.rsplit("/", 1)[-1] for u in (body or {}).get("instances", ())}
                mig["instances"] = [i for i in mig["instances"] if i["name"] not in gone]
                mig["targetSize"] -= len(gone)
                return handler._send(200, self._op(parts))
        return handler._send(404, {"error": "not found"})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    stopping = False


def _serve(conn) -> None:
    """The child process: both APIs on free localhost ports, until the
    parent sends "stop" (or goes away)."""
    store, compute = _Store(), _Compute()
    kube_handler = type("KubeHandler", (_KubeHandler,), {
        "store": store, "compute": None, "control_compute": compute})
    compute_handler = type("ComputeHandler", (_KubeHandler,), {
        "store": store, "compute": compute, "control_compute": compute})
    servers = [_Server(("127.0.0.1", 0), kube_handler), _Server(("127.0.0.1", 0),
                                                                 compute_handler)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    conn.send([s.server_address[1] for s in servers])
    try:
        conn.recv()
    except EOFError:
        pass
    for s in servers:
        s.stopping = True
        s.shutdown()
        s.server_close()


class FakeServers:
    """The parent's handle on the child process serving both fake APIs."""

    def __init__(self, proc, conn, kube_port: int, compute_port: int):
        self.proc, self.conn = proc, conn
        self.kube_url = f"http://127.0.0.1:{kube_port}"
        self.compute_url = f"http://127.0.0.1:{compute_port}"

    @classmethod
    def start(cls) -> "FakeServers":
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_serve, args=(child,), daemon=True)
        proc.start()
        if not parent.poll(120):
            proc.kill()
            raise RuntimeError("the fake API servers did not start")
        kube_port, compute_port = parent.recv()
        return cls(proc, parent, kube_port, compute_port)

    def _call(self, path: str, body=None, raw: bool = False):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.kube_url + path, data=data,
                                     method="GET" if body is None else "POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            payload = resp.read()
        return payload if raw else json.loads(payload)

    def load(self, kind: str, items: Iterable) -> int:
        """Store objects of ``kind`` without watch events: ``items`` are
        dicts, or (key, JSON text) pairs."""
        objects, lines = [], []
        for item in items:
            if isinstance(item, dict):
                objects.append(item)
            else:
                lines.append(f"{item[0]}\t{item[1]}")
        return self._call("/_control/load", {"kind": kind, "objects": objects,
                                             "lines": "\n".join(lines)})["rv"]

    def apply(self, ops: Sequence) -> int:
        """Apply churn, each change pushed as a watch event: ["put", kind,
        obj], ["delete", kind, key], ["bind", pod key, node name]. → the
        resourceVersion after it."""
        return self._call("/_control/apply", {"ops": list(ops)})["rv"]

    def writes(self, since: int = 0) -> List[tuple]:
        return [tuple(w) for w in self._call(f"/_control/writes?since={since}")["writes"]]

    def objects(self, kind: str, namespace: Optional[str] = None) -> List[dict]:
        ns = f"&namespace={namespace}" if namespace else ""
        return json.loads(self._call(f"/_control/objects?kind={kind}{ns}", raw=True))["items"]

    def last_rv(self) -> Dict[str, int]:
        """The resourceVersion of each kind's last watch event."""
        return self._call("/_control/rv")["last"]

    def load_compute(self, migs: Sequence[dict], templates: Dict[str, dict]) -> None:
        """MIGs as {"project", "zone", "name", "targetSize", "template",
        "instances": [{"name", "currentAction", "instanceStatus"}]}."""
        self._call("/_control/compute", {"migs": list(migs), "templates": templates})

    def compute_state(self) -> dict:
        out = self._call("/_control/compute")
        out["writes"] = [tuple(w) for w in out["writes"]]
        return out

    def close(self) -> None:
        try:
            self.conn.send("stop")
        except (OSError, BrokenPipeError):
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
