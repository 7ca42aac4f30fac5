"""VPA admission controller: mutating webhook that patches pod requests at
create time.

Reference: vertical-pod-autoscaler/pkg/admission-controller/logic/server.go
:37,59 — the webhook server receives an AdmissionReview for pod CREATE,
matches a VPA by target selector, and returns a base64 JSONPatch setting each
container's resource requests to the (policy-clamped) recommendation; pods
are never rejected, only patched (failurePolicy Ignore). Certificate
provisioning (certs.go / gencerts.sh) lives in vpa/certs.py — pass a
CertBundle to serve HTTPS in-process, or omit it to terminate TLS in front.

The patch computation is a pure function (`review_pod`) so it is testable
without sockets; `AdmissionServer` wraps it in a stdlib HTTP server.

The port's copy of ``autoscaler_tpu/vpa/admission.py``.
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from autoscaler_tpu_torch.kube.convert import (
    format_cpu_quantity,
    format_memory_quantity,
)
from autoscaler_tpu_torch.vpa.api import UpdateMode, Vpa, match_vpa
from autoscaler_tpu_torch.vpa.recommender import ContainerKey, Recommendation


def _cpu_str(cores: float) -> str:
    return format_cpu_quantity(cores, minimum_m=0)


def _mem_str(b: float) -> str:
    return format_memory_quantity(b, minimum=0)


_SUFFIX = {
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
}


def _parse_qty(s) -> Optional[float]:
    """Kubernetes quantity string → float (cores for cpu incl. 'm' suffix,
    bytes for memory incl. binary/decimal suffixes). None if unparseable."""
    if s is None:
        return None
    s = str(s).strip()
    try:
        if s.endswith("m"):
            return float(s[:-1]) / 1000.0
        for suf, mult in _SUFFIX.items():
            if s.endswith(suf):
                return float(s[: -len(suf)]) * mult
        return float(s)
    except ValueError:
        return None


def _proportional_limit(
    limits: Dict, requests: Dict, resource: str, new_request: float
) -> Optional[float]:
    """Scale the container's declared limit by the request change, keeping the
    original request:limit ratio — the reference's GetProportionalLimit
    (admission-controller/resource/pod/patch/resource_updates.go). Without
    this, raising a request above a declared limit yields a pod the apiserver
    rejects at validation (requests must be <= limits). When no original
    request was declared, Kubernetes defaults it to the limit, so the ratio is
    1 and the new limit equals the new request."""
    lim = _parse_qty(limits.get(resource))
    if lim is None or lim <= 0:
        return None
    orig = _parse_qty(requests.get(resource))
    if orig is None or orig <= 0:
        orig = lim
    return new_request * lim / orig


def review_pod(
    review: Dict,
    vpas: List[Vpa],
    recommendations: Dict[ContainerKey, Recommendation],
) -> Dict:
    """AdmissionReview request dict → AdmissionReview response dict with a
    JSONPatch over /spec/containers/N/resources/requests. Always allowed;
    patch only when a matching VPA (mode != Off) has a recommendation."""
    request = review.get("request", {})
    uid = request.get("uid", "")
    pod = request.get("object", {}) or {}
    meta = pod.get("metadata", {}) or {}
    namespace = request.get("namespace") or meta.get("namespace", "default")
    labels = meta.get("labels", {}) or {}

    response: Dict = {"uid": uid, "allowed": True}
    out = {
        "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
        "kind": "AdmissionReview",
        "response": response,
    }

    vpa = match_vpa(vpas, namespace, labels)
    if vpa is None or vpa.update_mode == UpdateMode.OFF:
        return out

    patches: List[Dict] = []
    containers = (pod.get("spec", {}) or {}).get("containers", []) or []
    for i, container in enumerate(containers):
        name = container.get("name", "")
        rec = recommendations.get(ContainerKey(vpa.name, name, vpa.namespace))
        if rec is None:
            continue
        clamped = vpa.clamp(name, rec)
        if clamped is None:  # container scaling Off
            continue
        resources = container.get("resources") or {}
        if "resources" not in container:
            patches.append({"op": "add", "path": f"/spec/containers/{i}/resources", "value": {}})
        if "requests" not in resources:
            patches.append(
                {"op": "add", "path": f"/spec/containers/{i}/resources/requests", "value": {}}
            )
        patches.append(
            {
                "op": "add",
                "path": f"/spec/containers/{i}/resources/requests/cpu",
                "value": _cpu_str(clamped.target_cpu),
            }
        )
        patches.append(
            {
                "op": "add",
                "path": f"/spec/containers/{i}/resources/requests/memory",
                "value": _mem_str(clamped.target_memory),
            }
        )
        limits = resources.get("limits") or {}
        requests = resources.get("requests") or {}
        cpu_lim = _proportional_limit(limits, requests, "cpu", clamped.target_cpu)
        if cpu_lim is not None:
            patches.append(
                {
                    "op": "add",
                    "path": f"/spec/containers/{i}/resources/limits/cpu",
                    "value": _cpu_str(cpu_lim),
                }
            )
        mem_lim = _proportional_limit(limits, requests, "memory", clamped.target_memory)
        if mem_lim is not None:
            patches.append(
                {
                    "op": "add",
                    "path": f"/spec/containers/{i}/resources/limits/memory",
                    "value": _mem_str(mem_lim),
                }
            )
    if patches:
        # one breadcrumb per pod (reference vpaUpdates annotation); adding the
        # single key preserves existing annotations — an "add" of the whole
        # map would wipe them (RFC 6902: add on an existing member replaces)
        if meta.get("annotations") is None:
            patches.append({"op": "add", "path": "/metadata/annotations", "value": {}})
        patches.append(
            {
                "op": "add",
                "path": "/metadata/annotations/vpaUpdates",
                "value": f"Pod resources updated by {vpa.name}",
            }
        )
    if patches:
        response["patchType"] = "JSONPatch"
        response["patch"] = base64.b64encode(
            json.dumps(patches).encode()
        ).decode()
    return out


class AdmissionServer:
    """Stdlib HTTP wrapper: POST /mutate with an AdmissionReview body."""

    def __init__(
        self,
        vpas: List[Vpa],
        recommendations: Dict[ContainerKey, Recommendation],
        host: str = "127.0.0.1",
        port: int = 0,
        tls: Optional["CertBundle"] = None,
    ):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (stdlib API)
                if self.path != "/mutate":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    review = json.loads(self.rfile.read(length) or b"{}")
                    body = json.dumps(
                        review_pod(review, outer.vpas, outer.recommendations)
                    ).encode()
                except (ValueError, KeyError) as e:
                    self.send_error(400, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/health-check":
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"ok")
                else:
                    self.send_error(404)

            def log_message(self, *args):
                pass

        self.vpas = vpas
        self.recommendations = recommendations
        self.tls = tls
        if tls is None:
            self._server = ThreadingHTTPServer((host, port), Handler)
        else:
            # Handshake must NOT run in the accept loop: wrapping the
            # listening socket makes accept() perform the full handshake in
            # the serve_forever thread, so one stalled client (half-open
            # connection, port scan) would block every subsequent webhook
            # request — and with failurePolicy Ignore, pods would silently
            # admit unpatched. Wrap per-connection with a lazy handshake (it
            # then happens in the per-request handler thread) plus a socket
            # timeout so dead clients release their thread.
            ssl_ctx = tls.server_ssl_context()

            class TlsServer(ThreadingHTTPServer):
                def get_request(self):
                    sock, addr = self.socket.accept()
                    sock.settimeout(30.0)
                    return (
                        ssl_ctx.wrap_socket(
                            sock, server_side=True, do_handshake_on_connect=False
                        ),
                        addr,
                    )

                def handle_error(self, request, client_address):
                    # failed handshakes/dead clients are the client's
                    # problem; anything else (a handler bug) must keep the
                    # stdlib traceback — with failurePolicy Ignore a silent
                    # failure means pods admit unpatched with no trail
                    import socket
                    import ssl as _ssl
                    import sys

                    exc = sys.exc_info()[1]  # sys.exception() needs 3.11+
                    if isinstance(
                        exc, (_ssl.SSLError, socket.timeout, ConnectionError)
                    ):
                        return
                    super().handle_error(request, client_address)

            self._server = TlsServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
