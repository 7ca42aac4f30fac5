"""Real control-plane binding: HTTPS list/watch + eviction + taints + Lease.

Reference boundary being implemented:
- list/watch listers — cluster-autoscaler/utils/kubernetes/listers.go:38-250
- eviction subresource — core/scaledown/actuation/drain.go:83 (policy/v1
  Eviction POST; 429 means PDB-blocked)
- taint management — utils/taints/taints.go (JSON merge patch of spec.taints)
- leader-election Lease — main.go:525-573 (coordination.k8s.io/v1)

The transport is stdlib-only (urllib + ssl): in-cluster config reads the
service-account token/CA mounts; tests drive the same code against an
in-process recorded API server (tests/test_kube_client.py), which is the
httptest pattern the reference's client-go tests use. FakeClusterAPI stays
the unit-test double; this module is what a deployment points at a real
API server.

The port's copy of ``autoscaler_tpu/kube/client.py``.
"""
from __future__ import annotations

import json
import ssl
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from autoscaler_tpu_torch import trace
from autoscaler_tpu_torch.kube import convert
from autoscaler_tpu_torch.metrics import metrics as metrics_mod
from autoscaler_tpu_torch.utils.http import RetryPolicy, json_request
from autoscaler_tpu_torch.kube.api import ClusterAPI, EvictionError
from autoscaler_tpu_torch.kube.objects import Node, Pod, PodDisruptionBudget, Taint

SA_TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
SA_CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class _TokenBucket:
    """client-go-style flow control (reference --kube-client-qps/
    --kube-client-burst): up to `burst` requests instantly, refilled at `qps`; callers
    block until a token is available. qps <= 0 disables."""

    def __init__(self, qps: float, burst: int):
        self.qps = qps
        self.burst = max(burst, 1)
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        if self.qps <= 0:
            return
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps
                )
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)


class KubeRestClient:
    """Minimal Kubernetes REST transport (GET/POST/PATCH/PUT/DELETE + watch)."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        verify: bool = True,
        timeout_s: float = 30.0,
        user_agent: str = "tpu-autoscaler",
        qps: float = 0.0,
        burst: int = 10,
        get_retries: int = 2,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        self.user_agent = user_agent
        self._limiter = _TokenBucket(qps, burst)
        # transient-failure retries for idempotent GETs only (LISTs, object
        # reads): 429/5xx honoring Retry-After, plus transport errors, with
        # jittered bounded backoff (utils/http.RetryPolicy). Writes never
        # retry at this layer — the caller cannot know whether the server
        # applied the mutation. 0 disables.
        self.get_retries = max(int(get_retries), 0)
        if self.base_url.startswith("https"):
            ctx = ssl.create_default_context(cafile=ca_file)
            if not verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ctx: Optional[ssl.SSLContext] = ctx
        else:
            self._ctx = None

    @staticmethod
    def from_kubeconfig(
        path: str,
        context: str = "",
        user_agent: str = "tpu-autoscaler",
        qps: float = 0.0,
        burst: int = 10,
        get_retries: int = 2,
    ) -> "KubeRestClient":
        """Minimal kubeconfig loader (--kubeconfig): current-context (or the
        named one) → cluster server + CA + bearer token / client cert.
        Covers token- and cert-based kubeconfigs; exec/auth-provider plugins
        are not run — use a token-type credential for those clusters."""
        import base64
        import os
        import tempfile

        import yaml

        with open(path) as f:
            try:
                cfg = yaml.safe_load(f) or {}
            except yaml.YAMLError as e:
                raise ValueError(f"not valid kubeconfig YAML: {e}") from None
        # kubectl/client-go resolve relative credential paths against the
        # kubeconfig's own directory, not CWD
        base_dir = os.path.dirname(os.path.abspath(path))

        def resolve(p: Optional[str]) -> Optional[str]:
            if not p:
                return p
            return p if os.path.isabs(p) else os.path.join(base_dir, p)

        def by_name(section, name):
            for item in cfg.get(section) or ():
                if item.get("name") == name:
                    return item
            raise ValueError(f"kubeconfig: no {section} entry named {name!r}")

        ctx_name = context or cfg.get("current-context") or ""
        if not ctx_name:
            raise ValueError("kubeconfig: no current-context and none given")
        ctx = by_name("contexts", ctx_name).get("context") or {}
        cluster = by_name("clusters", ctx.get("cluster", "")).get("cluster") or {}
        user = by_name("users", ctx.get("user", "")).get("user") or {}

        server = cluster.get("server", "")
        if not server:
            raise ValueError("kubeconfig: cluster has no server")

        temp_files: List[str] = []

        def materialize(data_key: str, file_key: str, suffix: str):
            """inline base64 data wins over a file path; data lands in a
            private tempfile that is unlinked as soon as the SSL context has
            loaded it (never left on disk)."""
            data = cluster.get(data_key) or user.get(data_key)
            if data:
                fd, fname = tempfile.mkstemp(prefix="kubeconfig-", suffix=suffix)
                with os.fdopen(fd, "wb") as out:
                    out.write(base64.b64decode(data))
                temp_files.append(fname)
                return fname
            return resolve(cluster.get(file_key) or user.get(file_key))

        try:
            ca_file = materialize("certificate-authority-data",
                                  "certificate-authority", ".ca.crt")
            token = user.get("token", "")
            if not token and user.get("tokenFile"):
                with open(resolve(user["tokenFile"])) as f:
                    token = f.read().strip()
            has_cert = bool(
                user.get("client-certificate-data")
                or user.get("client-certificate")
            )
            has_key = bool(
                user.get("client-key-data") or user.get("client-key")
            )
            if has_cert != has_key:
                raise ValueError(
                    "kubeconfig user has a client certificate without its "
                    "key (or vice versa)"
                )
            if has_cert and not server.startswith("https"):
                raise ValueError(
                    "kubeconfig client certificates need an https server"
                )
            has_client_cert = has_cert and has_key
            if not token and not has_client_cert:
                # fail CLOSED rather than 401 at runtime — except for plain
                # http servers (kubectl proxy), which legitimately carry no
                # credentials
                if user.get("exec") or user.get("auth-provider"):
                    raise ValueError(
                        "kubeconfig user has an exec/auth-provider "
                        "credential (not supported — use a token or "
                        "client certificate)"
                    )
                if server.startswith("https"):
                    raise ValueError("kubeconfig user has no usable credential")
            client = KubeRestClient(
                server, token=token or None, ca_file=ca_file,
                verify=not cluster.get("insecure-skip-tls-verify", False),
                user_agent=user_agent, qps=qps, burst=burst,
                get_retries=get_retries,
            )
            cert = materialize(
                "client-certificate-data", "client-certificate", ".crt"
            )
            key = materialize("client-key-data", "client-key", ".key")
            if cert and key and client._ctx is not None:
                client._ctx.load_cert_chain(cert, key)
        finally:
            for fname in temp_files:  # decoded keys must not persist on disk
                try:
                    os.unlink(fname)
                except OSError:
                    pass
        return client

    @staticmethod
    def in_cluster(
        user_agent: str = "tpu-autoscaler", qps: float = 0.0, burst: int = 10,
        get_retries: int = 2,
    ) -> "KubeRestClient":
        """Service-account config, like rest.InClusterConfig."""
        import os

        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(SA_TOKEN_PATH) as f:
            token = f.read().strip()
        return KubeRestClient(
            f"https://{host}:{port}", token=token, ca_file=SA_CA_PATH,
            user_agent=user_agent, qps=qps, burst=burst,
            get_retries=get_retries,
        )

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
        stream: bool = False,
        timeout_s: Optional[float] = None,
    ):
        self._limiter.acquire()
        headers = {"User-Agent": self.user_agent}
        if body is not None:
            headers["Content-Type"] = content_type
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        # retrying boundary for idempotent reads only; watch streams have
        # their own relist loop (WatchCache) and writes must not re-send
        retry = None
        if method == "GET" and not stream and self.get_retries > 0:
            retry = RetryPolicy(attempts=self.get_retries + 1)
        # one span per control-plane request, retries included — on the
        # tick trace a kube GET retry storm is visibly attributed to the
        # phase that issued it (watch-thread requests run outside a tick
        # and trace as no-ops). The resource path is a span attribute, not
        # a metric label: trace attrs are unbounded-cardinality-safe.
        with trace.span(
            metrics_mod.KUBE_REQUEST, path=path.split("?", 1)[0],
            method=method, stream=stream,
        ):
            return json_request(
                self.base_url + path,
                method=method,
                body=body,
                headers=headers,
                timeout_s=timeout_s or self.timeout_s,
                context=self._ctx,
                on_error=ApiError,
                stream=stream,
                retry=retry,
            )

    def get(self, path: str) -> dict:
        return self._request("GET", path)

    def post(self, path: str, body: dict) -> dict:
        return self._request("POST", path, body)

    def put(self, path: str, body: dict) -> dict:
        return self._request("PUT", path, body)

    def merge_patch(self, path: str, body: dict) -> dict:
        return self._request(
            "PATCH", path, body, content_type="application/merge-patch+json"
        )

    def delete(self, path: str, body: Optional[dict] = None) -> dict:
        # body carries DeleteOptions (e.g. resourceVersion preconditions)
        return self._request("DELETE", path, body)

    def watch(
        self, path: str, resource_version: str = "", timeout_s: float = 300.0
    ) -> Iterator[dict]:
        """Streaming watch: yields {"type": ..., "object": ...} events until
        the server closes the connection."""
        sep = "&" if "?" in path else "?"
        url = f"{path}{sep}watch=1"
        if resource_version:
            url += f"&resourceVersion={resource_version}"
        resp = self._request("GET", url, stream=True, timeout_s=timeout_s)
        try:
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
        finally:
            resp.close()


class WatchCache:
    """Informer-style cache: LIST to seed, WATCH to stay fresh, relist on
    error (listers.go's informer semantics, minus the handler plumbing)."""

    def __init__(
        self,
        client: KubeRestClient,
        path: str,
        key_of: Callable[[dict], str],
    ):
        self.client = client
        self.path = path
        self.key_of = key_of
        self._lock = threading.Lock()
        self._items: Dict[str, dict] = {}
        self._resource_version = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._synced = threading.Event()

    def start(self) -> None:
        # graftlint: disable=GL004 — start() runs once, before the cache is shared with reader threads; _thread is never read concurrently
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def wait_synced(self, timeout_s: float = 10.0) -> bool:
        return self._synced.wait(timeout_s)

    @property
    def synced(self) -> bool:
        """True once the seed LIST has completed at least once."""
        return self._synced.is_set()

    def list(self) -> List[dict]:
        with self._lock:
            return list(self._items.values())

    def _relist(self) -> None:
        payload = self.client.get(self.path)
        with self._lock:
            self._items = {
                self.key_of(item): item for item in payload.get("items") or ()
            }
            self._resource_version = (payload.get("metadata") or {}).get(
                "resourceVersion", ""
            )
        self._synced.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._relist()
                with self._lock:
                    # _relist wrote it under the lock; reading it bare here
                    # is the GL011 escape shape — hold the lock on both sides
                    resource_version = self._resource_version
                for event in self.client.watch(self.path, resource_version):
                    if self._stop.is_set():
                        return
                    obj = event.get("object") or {}
                    kind = event.get("type")
                    key = self.key_of(obj)
                    with self._lock:
                        if kind in ("ADDED", "MODIFIED"):
                            self._items[key] = obj
                        elif kind == "DELETED":
                            self._items.pop(key, None)
                        rv = (obj.get("metadata") or {}).get("resourceVersion")
                        if rv:
                            self._resource_version = rv
            except ApiError:
                if self._stop.wait(1.0):
                    return


def _pod_key(obj: dict) -> str:
    meta = obj.get("metadata") or {}
    return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"


def _name_key(obj: dict) -> str:
    return (obj.get("metadata") or {}).get("name", "")


_STORAGE_PATHS = {
    "pvc": "/api/v1/persistentvolumeclaims",
    "pv": "/api/v1/persistentvolumes",
    "csinode": "/apis/storage.k8s.io/v1/csinodes",
    "storageclass": "/apis/storage.k8s.io/v1/storageclasses",
}


class KubeClusterAPI(ClusterAPI):
    """ClusterAPI over a real API server. With watch=True, list_nodes/
    list_pods serve from informer caches (one LIST + a stream instead of a
    LIST per loop); writes always go straight to the server.

    With resolve_csi=True (default) the PV/PVC/CSINode listers feed
    NodeVolumeLimits: pods' PVC-backed volumes resolve to (driver,
    volumeHandle) and nodes carry per-driver attach limits — closing
    PREDICATES.md divergence 3's "caller's job" clause. Servers without
    the storage API (404) degrade to no CSI accounting."""

    def __init__(
        self,
        client: KubeRestClient,
        watch: bool = False,
        resolve_csi: bool = True,
        record_duplicated_events: bool = False,
    ):
        self.client = client
        self._watching = watch
        self._resolve_csi = resolve_csi
        # client-go's EventCorrelator aggregates repeats; the analog here
        # suppresses identical (kind, name, reason) posts within a window
        # unless --record-duplicated-events asks for every one
        self._record_duplicated_events = record_duplicated_events
        self._recent_events: Dict[Tuple[str, str, str, str], float] = {}
        # (kind, name, reason) → (window start, distinct messages posted)
        self._event_series: Dict[Tuple[str, str, str], Tuple[float, int]] = {}
        # record_event is called from drain workers and batcher timers
        self._events_lock = threading.Lock()
        self._node_cache: Optional[WatchCache] = None
        self._pod_cache: Optional[WatchCache] = None
        self._storage_caches: Dict[str, WatchCache] = {}
        # kinds whose endpoint 404'd: absence is memoized so a server without
        # the storage API costs one probe, not three failing GETs per loop.
        # (Installing the storage API later needs a process restart — same
        # trade the reference's informer factory makes at startup.)
        self._storage_absent: set = set()
        if watch:
            self._node_cache = WatchCache(client, "/api/v1/nodes", _name_key)
            self._pod_cache = WatchCache(client, "/api/v1/pods", _pod_key)
            self._node_cache.start()
            self._pod_cache.start()
            self._node_cache.wait_synced()
            self._pod_cache.wait_synced()
            if resolve_csi:
                for kind, path in _STORAGE_PATHS.items():
                    if not self._probe_storage(path):
                        self._storage_absent.add(kind)
                        continue
                    key = _pod_key if kind == "pvc" else _name_key
                    cache = WatchCache(client, path, key)
                    cache.start()
                    cache.wait_synced()
                    self._storage_caches[kind] = cache

    def _probe_storage(self, path: str, attempts: int = 3) -> bool:
        """Does the server serve this storage endpoint? ``?limit=1`` keeps the
        probe constant-cost (the WatchCache seeds its own full LIST). Only a
        404 means absent; transient errors (429/5xx/connection blips) are
        retried, and after exhaustion the endpoint is treated as served so the
        cache's own relist loop keeps trying (self-healing) instead of
        permanently disabling CSI accounting on a startup blip."""
        for attempt in range(attempts):
            try:
                self.client.get(path + "?limit=1")
                return True
            except ApiError as e:
                if e.status == 404:
                    return False
                if attempt + 1 < attempts:
                    time.sleep(0.5)
        return True

    def close(self) -> None:
        for cache in (
            self._node_cache,
            self._pod_cache,
            *self._storage_caches.values(),
        ):
            if cache is not None:
                cache.stop()

    # -- reads ---------------------------------------------------------------
    def _list_storage(self, kind: str) -> List[dict]:
        cache = self._storage_caches.get(kind)
        if cache is not None:
            if not cache.synced:
                # The seed LIST hasn't succeeded yet (e.g. a 503 outlasting
                # the probe's retries): an empty answer here would silently
                # erase attach limits, so fail the loop like the non-watch
                # path; the cache's relist loop keeps retrying behind us.
                raise ApiError(0, f"{kind} informer cache not yet synced")
            return cache.list()
        if kind in self._storage_absent:
            return []
        try:
            return self.client.get(_STORAGE_PATHS[kind]).get("items") or []
        except ApiError as e:
            if e.status == 404:
                self._storage_absent.add(kind)
                return []
            # Transient failure: propagate — silently returning [] would
            # erase every attach limit for the loop and let the packer place
            # pods past exhausted CSI slots. The loop fails and retries, the
            # same way a failed node/pod LIST fails RunOnce.
            raise

    def list_nodes(self) -> List[Node]:
        if self._node_cache is not None:
            items = self._node_cache.list()
        else:
            items = self.client.get("/api/v1/nodes").get("items") or []
        nodes = [convert.node_from_json(o) for o in items]
        if self._resolve_csi:
            limits = dict(
                convert.csinode_limits_from_json(o)
                for o in self._list_storage("csinode")
            )
            for n in nodes:
                lim = limits.get(n.name)
                if lim:
                    n.csi_attach_limits.update(lim)
        return nodes

    def list_pods(self) -> List[Pod]:
        if self._pod_cache is not None:
            items = self._pod_cache.list()
        else:
            items = self.client.get("/api/v1/pods").get("items") or []
        resolver = None
        if self._resolve_csi:
            # Lazy: the PVC/PV LISTs only happen if some pod actually mounts
            # a claim — a PVC-free cluster pays zero extra requests per loop.
            memo: List[Optional[dict]] = [None]

            def resolver(ns: str, claim: str):
                if memo[0] is None:
                    pvcs = self._list_storage("pvc")
                    # storage classes matter only for UNBOUND claims (the
                    # WaitForFirstConsumer allowedTopologies rule) — the
                    # common all-bound steady state skips the extra LIST
                    scs = (
                        self._list_storage("storageclass")
                        if any(
                            not ((c.get("spec") or {}).get("volumeName"))
                            for c in pvcs
                        )
                        else []
                    )
                    memo[0] = convert.pvc_csi_index(
                        pvcs, self._list_storage("pv"), scs
                    )
                return memo[0].get((ns, claim))

        return [convert.pod_from_json(o, pvc_resolver=resolver) for o in items]

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        items = (
            self.client.get("/apis/policy/v1/poddisruptionbudgets").get("items") or []
        )
        return [convert.pdb_from_json(o) for o in items]

    def pod_exists(self, pod_key: str) -> bool:
        ns, _, name = pod_key.partition("/")
        try:
            self.client.get(f"/api/v1/namespaces/{ns}/pods/{name}")
            return True
        except ApiError as e:
            if e.status == 404:
                return False
            raise

    # -- writes --------------------------------------------------------------
    def evict_pod(self, pod: Pod) -> None:
        """policy/v1 Eviction (drain.go:83); 429 = blocked by PDB."""
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod.name, "namespace": pod.namespace},
        }
        try:
            self.client.post(
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/eviction", body
            )
        except ApiError as e:
            raise EvictionError(f"evicting {pod.key()}: {e}") from None

    def _patch_taints(self, node_name: str, mutate: Callable[[List[Taint]], List[Taint]]) -> None:
        obj = self.client.get(f"/api/v1/nodes/{node_name}")
        node = convert.node_from_json(obj)
        new_taints = mutate(list(node.taints))
        self.client.merge_patch(
            f"/api/v1/nodes/{node_name}",
            {"spec": {"taints": convert.taints_to_json(new_taints)}},
        )

    def add_taint(self, node_name: str, taint: Taint) -> None:
        def mutate(taints: List[Taint]) -> List[Taint]:
            if any(t.key == taint.key for t in taints):
                return taints
            return taints + [taint]

        self._patch_taints(node_name, mutate)

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        self._patch_taints(
            node_name, lambda taints: [t for t in taints if t.key != taint_key]
        )

    def cordon_node(self, node_name: str) -> None:
        self.client.merge_patch(
            f"/api/v1/nodes/{node_name}", {"spec": {"unschedulable": True}}
        )

    def uncordon_node(self, node_name: str) -> None:
        self.client.merge_patch(
            f"/api/v1/nodes/{node_name}", {"spec": {"unschedulable": False}}
        )

    def write_configmap(self, namespace: str, name: str, data: dict) -> None:
        body = {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": namespace},
            "data": {k: str(v) for k, v in data.items()},
        }
        path = f"/api/v1/namespaces/{namespace}/configmaps/{name}"
        try:
            self.client.put(path, body)
        except ApiError as e:
            if e.status != 404:
                raise
            self.client.post(f"/api/v1/namespaces/{namespace}/configmaps", body)

    def list_daemonsets(self) -> List:
        """apps/v1 DaemonSets for --force-ds template charging; servers
        without the apps group (unlikely, but symmetric with the storage
        probes) degrade to none."""
        try:
            items = self.client.get("/apis/apps/v1/daemonsets").get("items") or []
        except ApiError as e:
            if e.status == 404:
                return []
            raise
        return [convert.daemonset_from_json(o) for o in items]

    def read_configmap(self, namespace: str, name: str) -> Optional[dict]:
        try:
            obj = self.client.get(
                f"/api/v1/namespaces/{namespace}/configmaps/{name}"
            )
        except ApiError as e:
            if e.status == 404:
                return None
            raise
        return obj.get("data") or {}

    def delete_node_object(self, node_name: str) -> None:
        try:
            self.client.delete(f"/api/v1/nodes/{node_name}")
        except ApiError as e:
            if e.status != 404:
                raise

    EVENT_DEDUP_WINDOW_S = 600.0
    # max distinct messages per (kind, name, reason) per window — the
    # reference EventAggregator's similar-event spike threshold
    EVENT_SERIES_CAP = 10

    def record_event(self, kind: str, name: str, reason: str, message: str) -> None:
        # message is part of the dedup key: successive DISTINCT failure
        # messages under one reason (e.g. different eviction errors) each
        # land once per window, while repeats stay suppressed. EVERY
        # message novel *in this window* (first-seen or recurring after
        # expiry) also counts against a per-(kind, name, reason) cap of
        # EVENT_SERIES_CAP per window, so a message embedding a changing
        # detail (timestamps, retry-after) can't flood the apiserver — the
        # same spike guard as the reference EventAggregator's
        # 10-similar-events threshold. The decision + slot reservation is
        # one atomic lock hold (drain workers post concurrently); a failed
        # POST rolls the reservation back so a never-landed event isn't
        # suppressed on retry.
        key = (kind, name, reason, message)
        series = (kind, name, reason)
        if not self._record_duplicated_events:
            now = time.monotonic()
            with self._events_lock:
                last = self._recent_events.get(key)
                if last is not None and now - last < self.EVENT_DEDUP_WINDOW_S:
                    return  # correlator-suppressed repeat
                start, count = self._event_series.get(series, (now, 0))
                if now - start >= self.EVENT_DEDUP_WINDOW_S:
                    start, count = now, 0  # window rolled over
                if count >= self.EVENT_SERIES_CAP:
                    return  # aggregator-suppressed spike
                # reserve before the POST: concurrent callers at count
                # CAP-1 must not all pass the check and overshoot
                self._event_series[series] = (start, count + 1)
                self._recent_events[key] = now
                if len(self._recent_events) > 4096:  # bound the window store
                    cutoff = now - self.EVENT_DEDUP_WINDOW_S
                    self._recent_events = {
                        k: t
                        for k, t in self._recent_events.items()
                        if t >= cutoff
                    }
                    self._event_series = {
                        s: (st, c)
                        for s, (st, c) in self._event_series.items()
                        if now - st < self.EVENT_DEDUP_WINDOW_S
                    }
        body = {
            "metadata": {"generateName": f"{name}.", "namespace": "default"},
            "involvedObject": {"kind": kind, "name": name},
            "reason": reason,
            "message": message,
            "type": "Normal",
            "source": {"component": "autoscaler-tpu"},
        }
        try:
            self.client.post("/api/v1/namespaces/default/events", body)
        except ApiError:
            if not self._record_duplicated_events:
                with self._events_lock:
                    if self._recent_events.get(key) == now:
                        del self._recent_events[key]
                    st, c = self._event_series.get(series, (now, 0))
                    if st == start and c > 0:
                        self._event_series[series] = (st, c - 1)


class KubeLease:
    """coordination.k8s.io/v1 Lease backend for utils/leaderelection.Lease
    (the reference's resourcelock.LeasesResourceLock, main.go:556)."""

    def __init__(
        self,
        client: KubeRestClient,
        name: str = "autoscaler-tpu",
        namespace: str = "kube-system",
        ttl_s: float = 15.0,
    ):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.ttl_s = ttl_s

    @property
    def _path(self) -> str:
        return (
            f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases/{self.name}"
        )

    def _body(
        self, holder: str, now_ts: float, resource_version: Optional[str] = None
    ) -> dict:
        meta: dict = {"name": self.name, "namespace": self.namespace}
        if resource_version:
            # optimistic-concurrency guard: the apiserver rejects the PUT
            # with 409 if anyone wrote the Lease since our GET — the same
            # contract client-go's resourcelock relies on. Without it two
            # replicas observing an expired lease could both PUT and both
            # believe they acquired (split brain for up to renew_deadline).
            meta["resourceVersion"] = resource_version
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": meta,
            "spec": {
                "holderIdentity": holder,
                "leaseDurationSeconds": int(self.ttl_s),
                "renewTime": convert.format_timestamp(now_ts),
            },
        }

    def try_acquire(self, holder: str, now_ts: float) -> bool:
        try:
            current = self.client.get(self._path)
        except ApiError as e:
            if e.status != 404:
                return False
            try:
                self.client.post(
                    f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases",
                    self._body(holder, now_ts),
                )
                return True
            except ApiError:
                # 409 here = another replica created it first: lost the race
                return False
        spec = current.get("spec") or {}
        other = spec.get("holderIdentity")
        renewed = convert.parse_timestamp(spec.get("renewTime"))
        if other and other != holder and now_ts - renewed < self.ttl_s:
            return False
        rv = (current.get("metadata") or {}).get("resourceVersion")
        try:
            self.client.put(self._path, self._body(holder, now_ts, rv))
            return True
        except ApiError:
            # 409 = a concurrent writer took the lease between GET and PUT
            return False

    def release(self, holder: str) -> None:
        try:
            current = self.client.get(self._path)
        except ApiError:
            return
        if (current.get("spec") or {}).get("holderIdentity") == holder:
            rv = (current.get("metadata") or {}).get("resourceVersion")
            try:
                self.client.delete(
                    self._path,
                    {"preconditions": {"resourceVersion": rv}} if rv else None,
                )
            except ApiError:
                pass
