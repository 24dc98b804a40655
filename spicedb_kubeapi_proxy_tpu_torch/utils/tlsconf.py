"""TLS context construction for the ``tcp://`` engine protocol.

The reference's remote backend endpoint defaults to TLS (system or custom
CA, CA verification skippable, plaintext only behind an explicit
``--spicedb-insecure``; the reference's pkg/proxy/options.go:325-369).
The engine wire mirrors that flag shape: an engine host serves TLS from a
cert/key pair (optionally demanding client certificates), and clients
verify against the system store or a custom CA bundle unless explicitly
told to skip verification or go plaintext. The shared bearer token rides
INSIDE the channel either way — TLS protects the token and every
relationship in transit; the token authenticates the peer.
"""

from __future__ import annotations

import ssl
from typing import Optional


class TLSConfigError(ValueError):
    pass


def server_ssl_context(cert_file: str, key_file: str,
                       client_ca_file: Optional[str] = None
                       ) -> ssl.SSLContext:
    """Serving context for an engine host. A ``client_ca_file``
    additionally REQUIRES client certificates signed by that CA (mutual
    TLS), on top of the bearer token."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    try:
        ctx.load_cert_chain(cert_file, key_file)
    except (OSError, ssl.SSLError) as e:
        raise TLSConfigError(
            f"cannot load serving cert/key ({cert_file}, {key_file}): {e}"
        ) from None
    if client_ca_file:
        try:
            ctx.load_verify_locations(cafile=client_ca_file)
        except (OSError, ssl.SSLError) as e:
            raise TLSConfigError(
                f"cannot load client CA {client_ca_file}: {e}") from None
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(ca_file: Optional[str] = None,
                       skip_verify: bool = False,
                       client_cert_file: Optional[str] = None,
                       client_key_file: Optional[str] = None
                       ) -> ssl.SSLContext:
    """Connecting context for proxies / followers. Default: full
    verification against the system trust store; ``ca_file`` REPLACES the
    trust store with that bundle (pinning — a publicly-trusted MITM cert
    must not pass when the operator named a private CA, matching the
    reference's CAPath mode); ``skip_verify`` keeps TLS (confidentiality)
    but trusts any presented certificate (SkipVerifyCA)."""
    if ca_file:
        try:
            # cafile= at construction loads ONLY this bundle: the system
            # store is never consulted (create_default_context skips
            # load_default_certs when an explicit CA source is given)
            ctx = ssl.create_default_context(cafile=ca_file)
        except (OSError, ssl.SSLError) as e:
            raise TLSConfigError(
                f"cannot load CA bundle {ca_file}: {e}") from None
    else:
        ctx = ssl.create_default_context()
    if skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if client_cert_file:
        try:
            ctx.load_cert_chain(client_cert_file, client_key_file)
        except (OSError, ssl.SSLError) as e:
            raise TLSConfigError(
                f"cannot load client cert/key ({client_cert_file}, "
                f"{client_key_file}): {e}") from None
    return ctx
