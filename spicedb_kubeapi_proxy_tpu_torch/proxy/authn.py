"""Authentication: header and TLS client-certificate authenticators.

Mirrors the reference's two modes (the Go proxy's pkg/proxy/authn.go):

- embedded-mode header authenticator (``authn.go:78-119``): the caller's
  identity arrives in ``X-Remote-User`` / ``X-Remote-Group`` /
  ``X-Remote-Extra-*`` headers;
- built-in client-cert authentication (``authn.go:40-47``, kube's x509
  CommonName user conversion): a TLS peer certificate verified against
  the configured client CA maps CommonName -> user and Organization
  values -> groups — the identity shape the reference's e2e harness
  stamps per user (``e2e/e2e_test.go:215-318``).
"""

from __future__ import annotations

from typing import Optional

from ..rules.input import UserInfo

USER_HEADER = "X-Remote-User"
GROUP_HEADER = "X-Remote-Group"
EXTRA_HEADER_PREFIX = "X-Remote-Extra-"


class AuthenticationError(Exception):
    pass


class HeaderAuthenticator:
    def authenticate(self, headers: dict[str, str]) -> UserInfo:
        name = None
        groups: list[str] = []
        extra: dict[str, list[str]] = {}
        for k, v in headers.items():
            lk = k.lower()
            if lk == USER_HEADER.lower():
                name = v
            elif lk == GROUP_HEADER.lower():
                # repeated headers may arrive comma-joined
                groups.extend(g.strip() for g in v.split(",") if g.strip())
            elif lk.startswith(EXTRA_HEADER_PREFIX.lower()):
                key = k[len(EXTRA_HEADER_PREFIX):].lower()
                extra.setdefault(key, []).extend(
                    x.strip() for x in v.split(",") if x.strip())
        if not name:
            raise AuthenticationError(f"no {USER_HEADER} header present")
        return UserInfo(name=name, groups=groups, extra=extra)


class TokenFileAuthenticator:
    """kube's static token file (--token-auth-file): CSV rows of
    ``token,user,uid[,"group1,group2"]`` (authn.go:40-47 wires the same
    kube authenticator). Comparison is constant-time per row."""

    def __init__(self, path: str):
        import csv
        import hmac as _hmac

        self._hmac = _hmac
        self._rows: list[tuple[str, UserInfo]] = []
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row or row[0].lstrip().startswith("#"):
                    continue
                if len(row) < 3:
                    raise ValueError(
                        f"token file {path!r}: rows need token,user,uid")
                groups = [g.strip() for g in row[3].split(",")
                          if g.strip()] if len(row) > 3 else []
                self._rows.append((
                    row[0].encode(),
                    UserInfo(name=row[1], uid=row[2], groups=groups)))

    def authenticate_token(self, token: str) -> Optional[UserInfo]:
        # compare BYTES: str compare_digest raises on non-ASCII input,
        # which an anonymous client could trigger at will (500 not 401)
        presented = token.encode("utf-8", "surrogateescape")
        found = None
        for tok, user in self._rows:  # constant-time, no early exit
            if self._hmac.compare_digest(tok, presented):
                found = user
        return found


class ClientCertAuthenticator:
    """Maps a verified TLS peer certificate to a user identity the way
    kube's x509 authenticator does: CommonName is the user name, each
    Organization value is a group. The ssl module has already verified
    the chain against the configured client CA before this runs."""

    def authenticate_peer(self, peercert: dict) -> UserInfo:
        name = None
        groups: list[str] = []
        for rdn in peercert.get("subject", ()):
            for key, value in rdn:
                if key == "commonName" and name is None:
                    name = value
                elif key == "organizationName":
                    groups.append(value)
        if not name:
            raise AuthenticationError(
                "client certificate has no CommonName")
        return UserInfo(name=name, groups=groups, extra={})
