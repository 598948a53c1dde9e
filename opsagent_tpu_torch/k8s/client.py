"""Kubernetes API client: kubeconfig loading, discovery, GET-as-YAML, and
server-side apply (the port's copy of ``opsagent_tpu/k8s/client.py``).

``get_kube_config`` takes the in-cluster service account, else
``$KUBECONFIG`` / ``~/.kube/config``; ``K8sClient.get_yaml`` maps a
resource name through API discovery, GETs the object and renders it as
YAML; ``apply_yaml`` server-side applies each document of a multi-document
manifest (field manager ``application/apply-patch``). All over the
Kubernetes REST API with the standard library's HTTP, and YAML through the
port's own reader and writer (``utils/yamlio.py``), which give PyYAML's
bytes and values.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any

from ..utils import yamlio

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sError(Exception):
    pass


@dataclass
class KubeConfig:
    server: str = ""
    token: str = ""
    ca_cert_path: str = ""
    client_cert_path: str = ""
    client_key_path: str = ""
    insecure: bool = False
    namespace: str = "default"
    _tempfiles: list[str] = field(default_factory=list, repr=False)


def _write_temp(data: bytes, cfg: KubeConfig, suffix: str) -> str:
    f = tempfile.NamedTemporaryFile(delete=False, suffix=suffix)
    f.write(data)
    f.close()
    cfg._tempfiles.append(f.name)
    return f.name


def _load_kubeconfig_file(path: str) -> KubeConfig:
    with open(path, "r", encoding="utf-8") as f:
        doc = yamlio.safe_load(f) or {}
    ctx_name = doc.get("current-context", "")
    contexts = {c["name"]: c.get("context", {}) for c in doc.get("contexts", [])}
    clusters = {c["name"]: c.get("cluster", {}) for c in doc.get("clusters", [])}
    users = {u["name"]: u.get("user", {}) for u in doc.get("users", [])}
    ctx = contexts.get(ctx_name) or (next(iter(contexts.values())) if contexts else {})
    cluster = clusters.get(ctx.get("cluster", "")) or (
        next(iter(clusters.values())) if clusters else {}
    )
    user = users.get(ctx.get("user", "")) or (next(iter(users.values())) if users else {})

    cfg = KubeConfig(
        server=cluster.get("server", ""),
        insecure=bool(cluster.get("insecure-skip-tls-verify", False)),
        namespace=ctx.get("namespace", "default"),
    )
    if "certificate-authority" in cluster:
        cfg.ca_cert_path = cluster["certificate-authority"]
    elif "certificate-authority-data" in cluster:
        cfg.ca_cert_path = _write_temp(
            base64.b64decode(cluster["certificate-authority-data"]), cfg, ".crt"
        )
    cfg.token = user.get("token", "")
    if "client-certificate" in user:
        cfg.client_cert_path = user["client-certificate"]
    elif "client-certificate-data" in user:
        cfg.client_cert_path = _write_temp(
            base64.b64decode(user["client-certificate-data"]), cfg, ".crt"
        )
    if "client-key" in user:
        cfg.client_key_path = user["client-key"]
    elif "client-key-data" in user:
        cfg.client_key_path = _write_temp(
            base64.b64decode(user["client-key-data"]), cfg, ".key"
        )
    return cfg


def get_kube_config() -> KubeConfig:
    """In-cluster service account first, then $KUBECONFIG / ~/.kube/config."""
    if os.path.isfile(os.path.join(_SA_DIR, "token")) and os.environ.get(
        "KUBERNETES_SERVICE_HOST"
    ):
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(_SA_DIR, "token"), "r", encoding="utf-8") as f:
            token = f.read().strip()
        ns = "default"
        ns_path = os.path.join(_SA_DIR, "namespace")
        if os.path.isfile(ns_path):
            with open(ns_path, "r", encoding="utf-8") as f:
                ns = f.read().strip() or "default"
        return KubeConfig(
            server=f"https://{host}:{port}",
            token=token,
            ca_cert_path=os.path.join(_SA_DIR, "ca.crt"),
            namespace=ns,
        )
    path = os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
    if not os.path.isfile(path):
        raise K8sError(f"no kubeconfig found at {path} and not running in-cluster")
    return _load_kubeconfig_file(path)


class K8sClient:
    """Thin typed REST client with API discovery."""

    def __init__(self, config: KubeConfig | None = None):
        self.cfg = config or get_kube_config()
        self._discovery: dict[str, tuple[str, str, str, bool]] | None = None

    # -- transport ---------------------------------------------------------
    def _ssl_context(self) -> ssl.SSLContext | None:
        if not self.cfg.server.startswith("https"):
            return None
        if self.cfg.insecure:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        else:
            ctx = ssl.create_default_context(
                cafile=self.cfg.ca_cert_path or None
            )
        if self.cfg.client_cert_path:
            ctx.load_cert_chain(self.cfg.client_cert_path, self.cfg.client_key_path)
        return ctx

    def request(
        self,
        method: str,
        path: str,
        body: bytes | None = None,
        content_type: str = "application/json",
        query: dict[str, str] | None = None,
    ) -> Any:
        url = self.cfg.server.rstrip("/") + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers = {"Accept": "application/json", "Content-Type": content_type}
        if self.cfg.token:
            headers["Authorization"] = f"Bearer {self.cfg.token}"
        req = urllib.request.Request(url, data=body, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30, context=self._ssl_context()) as r:
                raw = r.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")[:800]
            raise K8sError(f"{method} {path}: HTTP {e.code}: {detail}") from e
        except urllib.error.URLError as e:
            raise K8sError(f"{method} {path}: {e.reason}") from e
        if not raw:
            return None
        return json.loads(raw)

    # -- discovery (RESTMapper equivalent) ---------------------------------
    def _discover(self) -> dict[str, tuple[str, str, str, bool]]:
        """Build {alias -> (group, version, plural, namespaced)} from the
        apiserver's discovery endpoints."""
        if self._discovery is not None:
            return self._discovery
        mapping: dict[str, tuple[str, str, str, bool]] = {}

        def add(group: str, version: str, res: dict[str, Any]) -> None:
            plural = res.get("name", "")
            if "/" in plural:  # subresource like pods/log
                return
            entry = (group, version, plural, bool(res.get("namespaced")))
            aliases = {plural, res.get("singularName", ""), res.get("kind", "").lower()}
            aliases.update(res.get("shortNames", []) or [])
            for a in aliases:
                if a and a not in mapping:
                    mapping[a] = entry

        core = self.request("GET", "/api/v1") or {}
        for res in core.get("resources", []):
            add("", "v1", res)
        groups = (self.request("GET", "/apis") or {}).get("groups", [])
        for g in groups:
            pref = g.get("preferredVersion", {}).get("groupVersion") or ""
            if not pref:
                continue
            gv = self.request("GET", f"/apis/{pref}") or {}
            grp, _, ver = pref.partition("/")
            for res in gv.get("resources", []):
                add(grp, ver, res)
        self._discovery = mapping
        return mapping

    def _resource_path(
        self, resource: str, namespace: str, name: str = ""
    ) -> str:
        mapping = self._discover()
        key = resource.lower()
        if key not in mapping:
            raise K8sError(f"unknown resource type: {resource}")
        group, version, plural, namespaced = mapping[key]
        base = f"/api/{version}" if not group else f"/apis/{group}/{version}"
        if namespaced:
            path = f"{base}/namespaces/{namespace or self.cfg.namespace}/{plural}"
        else:
            path = f"{base}/{plural}"
        if name:
            path += f"/{name}"
        return path

    # -- public ------------------------------------------------------------
    def get_yaml(self, resource: str, name: str, namespace: str = "") -> str:
        """Fetch a live object and render it as YAML."""
        obj = self.request("GET", self._resource_path(resource, namespace, name))
        return yamlio.safe_dump(obj, sort_keys=False, allow_unicode=True)

    def apply_yaml(self, manifests: str) -> list[str]:
        """Server-side apply every document in a multi-doc YAML string.
        Returns a list of "kind/name" applied."""
        applied: list[str] = []
        for doc in yamlio.safe_load_all(manifests):
            if not doc:
                continue
            api_version = doc.get("apiVersion", "")
            kind = doc.get("kind", "")
            meta = doc.get("metadata", {}) or {}
            name = meta.get("name", "")
            namespace = meta.get("namespace", "")
            if not api_version or not kind or not name:
                raise K8sError(
                    f"manifest missing apiVersion/kind/metadata.name: {doc}"
                )
            path = self._resource_path(kind.lower(), namespace, name)
            self.request(
                "PATCH",
                path,
                body=yamlio.safe_dump(doc).encode("utf-8"),
                content_type="application/apply-patch+yaml",
                query={
                    "fieldManager": "application/apply-patch",
                    "force": "true",
                },
            )
            applied.append(f"{kind}/{name}")
        return applied


# Module-level conveniences over a client from the environment's config.
def get_yaml(resource: str, name: str, namespace: str = "") -> str:
    return K8sClient().get_yaml(resource, name, namespace)


def apply_yaml(manifests: str) -> list[str]:
    return K8sClient().apply_yaml(manifests)
