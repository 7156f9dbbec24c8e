"""Async Kubernetes REST client: own copy of the part of
``tpu_operator/k8s/client.py`` the node validator uses (get, create,
delete, a merge patch, list with a label selector; in-cluster config from
the service account), plus
``set_owner_reference`` from ``tpu_operator/k8s/objects.py``.

``aiohttp`` is imported when the first session opens, so a validator
component that never talks to the apiserver (libtpu, pjrt, the in-process
jax and perf) runs where aiohttp is not installed.
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# (group, kind) -> (version, plural, namespaced): the kinds the validator
# reads or writes
_RESOURCES = {
    ("", "Node"): ("v1", "nodes", False),
    ("", "Pod"): ("v1", "pods", True),
    ("", "Service"): ("v1", "services", True),
    ("", "Event"): ("v1", "events", True),
    ("apps", "DaemonSet"): ("v1", "daemonsets", True),
}

# a GET, DELETE or merge PATCH (each idempotent) that meets a 5xx, a 429 or
# a dropped connection is tried this many times in all, the waits doubling
# from the first
_ATTEMPTS = 3
_FIRST_BACKOFF_S = 0.2
_REQUEST_TIMEOUT_S = 30.0


@dataclass
class Config:
    base_url: str
    token: Optional[str] = None
    ca_file: Optional[str] = None

    @classmethod
    def in_cluster(cls) -> "Config":
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        token = None
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        return cls(
            base_url=f"https://{host}:{port}",
            token=token,
            ca_file=ca_path if os.path.exists(ca_path) else None,
        )

    @classmethod
    def from_env(cls) -> "Config":
        """KUBERNETES_API_URL override (tests / out-of-cluster), else in-cluster."""
        url = os.environ.get("KUBERNETES_API_URL")
        if url:
            return cls(base_url=url, token=os.environ.get("KUBERNETES_API_TOKEN"))
        return cls.in_cluster()


class ApiError(Exception):
    def __init__(self, status: int, reason: str, body: Any = None):
        self.status = status
        self.reason = reason
        self.body = body
        super().__init__(f"{status} {reason}")

    @property
    def not_found(self) -> bool:
        return self.status == 404

    @property
    def already_exists(self) -> bool:
        return self.status == 409 and self.reason == "AlreadyExists"


def resource_path(group: str, kind: str, namespace: Optional[str] = None,
                  name: Optional[str] = None) -> str:
    try:
        version, plural, namespaced = _RESOURCES[(group, kind)]
    except KeyError:
        raise ValueError(f"unknown resource {group}/{kind}") from None
    parts = [f"/api/{version}" if not group else f"/apis/{group}/{version}"]
    if namespaced and namespace:
        parts.append(f"namespaces/{namespace}")
    elif namespaced and name:
        raise ValueError(f"namespace required for namespaced resource {plural}")
    parts.append(plural)
    if name:
        parts.append(name)
    return "/".join(parts)


def _group_of(obj: dict) -> str:
    api_version = obj.get("apiVersion", "")
    return api_version.split("/", 1)[0] if "/" in api_version else ""


def set_owner_reference(obj: dict, owner: dict, controller: bool = True) -> None:
    """Make ``owner`` the controller of ``obj`` (garbage collection follows)."""
    ref = {
        "apiVersion": owner["apiVersion"],
        "kind": owner["kind"],
        "name": owner["metadata"]["name"],
        "uid": owner["metadata"].get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": True,
    }
    refs = obj.setdefault("metadata", {}).setdefault("ownerReferences", [])
    for existing in refs:
        if existing.get("uid") == ref["uid"] and existing.get("name") == ref["name"]:
            existing.update(ref)
            return
    refs.append(ref)


class ApiClient:
    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config.from_env()
        self._session = None

    async def __aenter__(self) -> "ApiClient":
        await self.session()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def session(self):
        import aiohttp

        if self._session is None or self._session.closed:
            headers = {"Accept": "application/json"}
            if self.config.token:
                headers["Authorization"] = f"Bearer {self.config.token}"
            connector = None
            if self.config.base_url.startswith("https") and self.config.ca_file:
                import ssl

                connector = aiohttp.TCPConnector(
                    ssl=ssl.create_default_context(cafile=self.config.ca_file))
            self._session = aiohttp.ClientSession(
                base_url=self.config.base_url, headers=headers, connector=connector,
                timeout=aiohttp.ClientTimeout(total=_REQUEST_TIMEOUT_S),
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
        self._session = None

    async def _request(self, method: str, path: str, body: Any = None,
                       params: Optional[dict] = None,
                       content_type: str = "application/json") -> Any:
        """One request; GET, DELETE and PATCH are retried on transient
        failures (POST never is: a lost response may hide a created
        object)."""
        import aiohttp

        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": content_type} if body is not None else {}
        attempts = _ATTEMPTS if method in ("GET", "DELETE", "PATCH") else 1
        attempt = 0
        while True:
            attempt += 1
            retry = attempt < attempts
            try:
                sess = await self.session()
                async with sess.request(method, path, params=params, data=data,
                                        headers=headers) as resp:
                    text = await resp.text()
                    try:
                        payload = json.loads(text) if text else None
                    except json.JSONDecodeError:
                        payload = text
                    if resp.status < 400:
                        return payload
                    reason = (payload.get("reason", resp.reason) if isinstance(payload, dict)
                              else resp.reason)
                    error = ApiError(resp.status, str(reason), payload)
                if not (retry and (error.status >= 500 or error.status == 429)):
                    raise error
            except (aiohttp.ClientError, OSError, asyncio.TimeoutError):
                if not retry:
                    raise
            await asyncio.sleep(_FIRST_BACKOFF_S * 2 ** (attempt - 1))

    async def get(self, group: str, kind: str, name: str, namespace: Optional[str] = None) -> dict:
        return await self._request("GET", resource_path(group, kind, namespace, name))

    async def list_items(self, group: str, kind: str, namespace: Optional[str] = None,
                         label_selector: Optional[str] = None) -> list[dict]:
        params = {"labelSelector": label_selector} if label_selector else None
        listing = await self._request("GET", resource_path(group, kind, namespace),
                                      params=params)
        return (listing or {}).get("items", [])

    async def create(self, obj: dict) -> dict:
        meta = obj.get("metadata", {})
        path = resource_path(_group_of(obj), obj.get("kind", ""), meta.get("namespace"))
        return await self._request("POST", path, body=obj)

    async def patch(self, group: str, kind: str, name: str, patch: Any,
                    namespace: Optional[str] = None) -> dict:
        """A JSON merge patch (RFC 7386): the keys given replace the
        object's, a null deletes one."""
        return await self._request("PATCH", resource_path(group, kind, namespace, name),
                                   body=patch, content_type="application/merge-patch+json")

    async def delete(self, group: str, kind: str, name: str, namespace: Optional[str] = None,
                     ignore_not_found: bool = True) -> Optional[dict]:
        try:
            return await self._request("DELETE", resource_path(group, kind, namespace, name))
        except ApiError as e:
            if e.not_found and ignore_not_found:
                return None
            raise
