"""Upstream kube-apiserver connection config: kubeconfig and in-cluster.

Mirrors the reference's RestConfigFunc resolution
(the Go proxy's pkg/proxy/options.go:223-263,429-449): an explicit
kubeconfig file (cluster server/CA, user token or client cert, selected by
context) or, inside a pod, the in-cluster service-account environment
(KUBERNETES_SERVICE_HOST/PORT + /var/run/secrets/.../{token,ca.crt}).

Inline ``*-data`` fields (base64) are materialized to private temp files
because ``ssl.SSLContext.load_cert_chain`` only takes paths; the files
live for the process lifetime.
"""

from __future__ import annotations

import base64
import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import yaml

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeconfigError(ValueError):
    pass


@dataclass
class UpstreamConfig:
    """Everything HttpUpstream needs to dial the apiserver."""

    url: str
    token: Optional[str] = None
    ca_file: Optional[str] = None
    client_cert: Optional[str] = None
    client_key: Optional[str] = None
    insecure_skip_verify: bool = False


def _materialize(data_b64: str, suffix: str) -> str:
    """base64 inline data -> private temp file path (0600)."""
    try:
        raw = base64.b64decode(data_b64)
    except (ValueError, TypeError) as e:
        raise KubeconfigError(f"invalid base64 in kubeconfig: {e}") from None
    fd, path = tempfile.mkstemp(prefix="sdbkp-kubeconfig-", suffix=suffix)
    with os.fdopen(fd, "wb") as f:
        f.write(raw)
    return path


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries or []:
        if e.get("name") == name:
            return e.get(what) or {}
    raise KubeconfigError(f"kubeconfig has no {what} named {name!r}")


def load_kubeconfig(path: str,
                    context: Optional[str] = None) -> UpstreamConfig:
    """Resolve a kubeconfig file to an UpstreamConfig, honoring
    current-context (or an explicit context name). Relative file
    references resolve against the kubeconfig's own directory, as
    kubectl/client-go do."""
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    base_dir = os.path.dirname(os.path.abspath(path))

    def resolve(p: Optional[str]) -> Optional[str]:
        if not p:
            return p
        return p if os.path.isabs(p) else os.path.join(base_dir, p)
    ctx_name = context or doc.get("current-context")
    if not ctx_name:
        raise KubeconfigError(
            f"kubeconfig {path!r} has no current-context "
            "(pass an explicit context)")
    ctx = _by_name(doc.get("contexts"), ctx_name, "context")
    cluster = _by_name(doc.get("clusters"), ctx.get("cluster"), "cluster")
    user = _by_name(doc.get("users"), ctx.get("user"), "user") \
        if ctx.get("user") else {}

    server = cluster.get("server")
    if not server:
        raise KubeconfigError(
            f"kubeconfig cluster {ctx.get('cluster')!r} has no server")

    ca_file = resolve(cluster.get("certificate-authority"))
    if cluster.get("certificate-authority-data"):
        ca_file = _materialize(cluster["certificate-authority-data"],
                               ".ca.pem")
    cert = resolve(user.get("client-certificate"))
    if user.get("client-certificate-data"):
        cert = _materialize(user["client-certificate-data"], ".crt.pem")
    key = resolve(user.get("client-key"))
    if user.get("client-key-data"):
        key = _materialize(user["client-key-data"], ".key.pem")
    token = user.get("token")
    if not token and user.get("tokenFile"):
        token = open(resolve(user["tokenFile"])).read().strip()

    return UpstreamConfig(
        url=server,
        token=token,
        ca_file=ca_file,
        client_cert=cert,
        client_key=key,
        insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify")),
    )


def in_cluster_available(env=os.environ,
                         sa_dir: str = SERVICE_ACCOUNT_DIR) -> bool:
    return ("KUBERNETES_SERVICE_HOST" in env
            and "KUBERNETES_SERVICE_PORT" in env
            and os.path.exists(os.path.join(sa_dir, "token")))


def in_cluster_config(env=os.environ,
                      sa_dir: str = SERVICE_ACCOUNT_DIR) -> UpstreamConfig:
    """The pod service-account config (reference options.go:258-263 uses
    rest.InClusterConfig)."""
    host = env.get("KUBERNETES_SERVICE_HOST")
    port = env.get("KUBERNETES_SERVICE_PORT")
    if not host or not port:
        raise KubeconfigError(
            "not running in-cluster (KUBERNETES_SERVICE_HOST/PORT unset)")
    token_path = os.path.join(sa_dir, "token")
    if not os.path.exists(token_path):
        raise KubeconfigError(f"service account token missing: {token_path}")
    ca_path = os.path.join(sa_dir, "ca.crt")
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # IPv6 service host
    return UpstreamConfig(
        url=f"https://{host}:{port}",
        token=open(token_path).read().strip(),
        ca_file=ca_path if os.path.exists(ca_path) else None,
    )
