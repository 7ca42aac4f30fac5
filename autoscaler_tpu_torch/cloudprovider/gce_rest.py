"""GCE REST transport: the real compute-API binding behind `GceApi`.

Reference: cluster-autoscaler/cloudprovider/gce/autoscaling_gce_client.go —
InstanceGroupManagers.{Get,Resize:198,DeleteInstances:264,
ListManagedInstances:282} plus instance-template reads (templates.go). The
Go SDK calls map onto these REST endpoints, which this module speaks with
stdlib urllib:

    GET  …/zones/{z}/instanceGroupManagers/{m}
    POST …/zones/{z}/instanceGroupManagers/{m}/resize?size=N
    POST …/zones/{z}/instanceGroupManagers/{m}/deleteInstances
    POST …/zones/{z}/instanceGroupManagers/{m}/listManagedInstances
    GET  …/global/instanceTemplates/{t}
    GET  …/aggregated/instanceGroupManagers

Auth is an injectable token callable (deploy sites pass a metadata-server
or SA refresher); `base_url` is injectable so the transport is hermetically
testable against a recorded HTTP server (tests/test_gce_rest.py) — the same
httptest pattern as kube/client.py. Zero-egress environments keep using
InMemoryGceApi; this class exists so a real deployment binds without
writing transport code.

The port's copy of ``autoscaler_tpu/cloudprovider/gce_rest.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from autoscaler_tpu_torch.utils.http import json_request

from autoscaler_tpu_torch.cloudprovider.gce import GceApi, MigInstance, MigTemplate
from autoscaler_tpu_torch.cloudprovider.interface import (
    InstanceErrorClass,
    InstanceErrorInfo,
    InstanceState,
    NodeGroupError,
)
from autoscaler_tpu_torch.kube.objects import Taint

DEFAULT_BASE_URL = "https://compute.googleapis.com/compute/v1"

# currentAction/instanceStatus → InstanceState (reference
# autoscaling_gce_client.go listManagedInstances status mapping)
_CREATING_ACTIONS = {"CREATING", "CREATING_WITHOUT_RETRIES", "RECREATING"}
_DELETING_ACTIONS = {"DELETING", "ABANDONING"}

# lastAttempt error codes → error class (reference
# autoscaling_gce_client.go:~330 error categorization)
_OUT_OF_RESOURCES_CODES = {
    "RESOURCE_POOL_EXHAUSTED", "ZONE_RESOURCE_POOL_EXHAUSTED",
    "ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS", "QUOTA_EXCEEDED",
}


class RestGceApi(GceApi):
    """`GceApi` over the compute REST API."""

    def __init__(
        self,
        token_fn: Callable[[], str],
        base_url: str = DEFAULT_BASE_URL,
        timeout_s: float = 30.0,
        user_agent: str = "tpu-autoscaler",
        project: Optional[str] = None,  # required for list_migs discovery
        op_timeout_s: float = 300.0,    # whole-operation deadline — NOT the
                                        # per-request timeout: TPU/VM slice
                                        # creation legitimately takes minutes
        op_poll_s: float = 5.0,         # reference waitForOp polls every 5s
    ):
        self.token_fn = token_fn
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.user_agent = user_agent
        self.project = project
        self.op_timeout_s = op_timeout_s
        self.op_poll_s = op_poll_s

    # -- transport -----------------------------------------------------------
    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        return json_request(
            self.base_url + path,
            method=method,
            body=body,
            headers={
                "Authorization": f"Bearer {self.token_fn()}",
                "User-Agent": self.user_agent,
            },
            timeout_s=self.timeout_s,
            on_error=lambda status, detail: NodeGroupError(
                f"GCE API {method} {path}: "
                + (f"HTTP {status} {detail}" if status else detail)
            ),
        )

    def _mig_path(self, project: str, zone: str, mig: str) -> str:
        return f"/projects/{project}/zones/{zone}/instanceGroupManagers/{mig}"

    def _paged(self, method: str, path: str, body: Optional[dict] = None):
        """Yield every page of a paginated list call (the reference client
        pages through all results; maxResults defaults to 500 server-side,
        so ignoring nextPageToken silently truncates big MIGs)."""
        token = ""
        while True:
            sep = "&" if "?" in path else "?"
            page_path = path + (f"{sep}pageToken={token}" if token else "")
            payload = self._request(method, page_path, body)
            yield payload
            token = payload.get("nextPageToken", "")
            if not token:
                return

    def _finish_operation(self, project: str, zone: str, op: dict) -> None:
        """Mutations return a zonal Operation; a 200 only means the request
        was accepted. Wait for DONE (bounded) and surface operation errors —
        the reference client does the same (autoscaling_gce_client.go
        waitForOp); fire-and-forget would report failed deletes/resizes as
        successes."""
        import time as _time

        deadline = _time.monotonic() + self.op_timeout_s
        name = op.get("name", "")
        while op.get("status") != "DONE":
            if not name or _time.monotonic() >= deadline:
                raise NodeGroupError(
                    f"GCE operation {name or '<unnamed>'} not DONE within "
                    f"{self.op_timeout_s}s (status={op.get('status')})"
                )
            _time.sleep(self.op_poll_s)
            op = self._request(
                "GET", f"/projects/{project}/zones/{zone}/operations/{name}"
            )
        err = (op.get("error") or {}).get("errors") or ()
        if err:
            first = err[0]
            raise NodeGroupError(
                f"GCE operation {name} failed: "
                f"{first.get('code', '')} {first.get('message', '')}"
            )

    # -- GceApi surface ------------------------------------------------------
    def get_target_size(self, project: str, zone: str, mig: str) -> int:
        payload = self._request("GET", self._mig_path(project, zone, mig))
        size = payload.get("targetSize")
        if size is None:  # keep the NodeGroupError contract on odd payloads
            raise NodeGroupError(
                f"MIG {project}/{zone}/{mig}: response lacks targetSize "
                f"(keys: {sorted(payload)})"
            )
        return int(size)

    def resize(self, project: str, zone: str, mig: str, size: int) -> None:
        op = self._request(
            "POST", self._mig_path(project, zone, mig) + f"/resize?size={int(size)}"
        )
        self._finish_operation(project, zone, op)

    def delete_instances(
        self, project: str, zone: str, mig: str, names: Sequence[str]
    ) -> None:
        instances = [
            f"projects/{project}/zones/{zone}/instances/{n}" for n in names
        ]
        op = self._request(
            "POST",
            self._mig_path(project, zone, mig) + "/deleteInstances",
            {"instances": instances},
        )
        self._finish_operation(project, zone, op)

    def list_instances(self, project: str, zone: str, mig: str) -> List[MigInstance]:
        out: List[MigInstance] = []
        for payload in self._paged(
            "POST", self._mig_path(project, zone, mig) + "/listManagedInstances"
        ):
            for mi in payload.get("managedInstances") or ():
                name = (mi.get("instance") or "").rsplit("/", 1)[-1]
                action = mi.get("currentAction", "NONE")
                status = mi.get("instanceStatus", "")
                error = None
                if action in _CREATING_ACTIONS:
                    state = InstanceState.CREATING
                elif action in _DELETING_ACTIONS:
                    state = InstanceState.DELETING
                elif status and status != "RUNNING":
                    # currentAction NONE but the VM is STOPPED/TERMINATED/
                    # SUSPENDED (e.g. preempted spot/TPU capacity): dead
                    # capacity must not count as healthy — surface it as a
                    # problem instance so the health machinery reacts
                    state = InstanceState.CREATING
                    error = InstanceErrorInfo(
                        error_class=InstanceErrorClass.OTHER,
                        error_code=status,
                        error_message=f"instance status {status}",
                    )
                else:
                    state = InstanceState.RUNNING
                errors = ((mi.get("lastAttempt") or {}).get("errors") or {}).get(
                    "errors"
                ) or ()
                if errors and state == InstanceState.CREATING and error is None:
                    first = errors[0]
                    code = first.get("code", "")
                    error = InstanceErrorInfo(
                        error_class=(
                            InstanceErrorClass.OUT_OF_RESOURCES
                            if code in _OUT_OF_RESOURCES_CODES
                            else InstanceErrorClass.OTHER
                        ),
                        error_code=code,
                        error_message=first.get("message", ""),
                    )
                out.append(MigInstance(name, state, error))
        return out

    def get_template(self, project: str, zone: str, mig: str) -> MigTemplate:
        mig_obj = self._request("GET", self._mig_path(project, zone, mig))
        tmpl_url = mig_obj.get("instanceTemplate", "")
        tmpl_name = tmpl_url.rsplit("/", 1)[-1]
        if not tmpl_name:
            raise NodeGroupError(f"MIG {mig} has no instanceTemplate")
        # honor the template's scope: regional instance templates
        # (…/regions/{r}/instanceTemplates/{t}) are standard for MIGs; only
        # fall back to global when the URL carries no region segment
        parts = tmpl_url.split("/")
        if "regions" in parts:
            region = parts[parts.index("regions") + 1]
            tmpl_path = (
                f"/projects/{project}/regions/{region}/instanceTemplates/{tmpl_name}"
            )
        else:
            tmpl_path = f"/projects/{project}/global/instanceTemplates/{tmpl_name}"
        tmpl = self._request("GET", tmpl_path)
        props = tmpl.get("properties") or {}
        machine_type = (props.get("machineType") or "").rsplit("/", 1)[-1]
        labels = dict(props.get("labels") or {})
        scheduling = props.get("scheduling") or {}
        spot = bool(
            scheduling.get("preemptible")
            or scheduling.get("provisioningModel") == "SPOT"
        )
        # GKE node taints ride the template labels in this model; kube-env
        # metadata parsing (reference templates.go extractTaintsFromKubeEnv)
        # is the deploy site's if it uses kube-env
        taints: List[Taint] = []
        return MigTemplate(
            machine_type=machine_type,
            labels=labels,
            taints=taints,
            spot=spot,
            tpu_topology=labels.get("cloud.google.com/gke-tpu-topology", ""),
        )

    def list_migs(self) -> List[Tuple[str, str, str]]:
        if not self.project:
            return []  # discovery needs a project scope
        out: List[Tuple[str, str, str]] = []
        for payload in self._paged(
            "GET", f"/projects/{self.project}/aggregated/instanceGroupManagers"
        ):
            for scope, entry in (payload.get("items") or {}).items():
                if not scope.startswith("zones/"):
                    continue
                zone = scope.split("/", 1)[1]
                for m in entry.get("instanceGroupManagers") or ():
                    out.append((self.project, zone, m.get("name", "")))
        return out
