"""OIDC bearer-token authentication.

The last of the reference's four built-in authenticators
(the Go proxy's pkg/proxy/authn.go:40-47 wires kube's client-cert, OIDC,
token-file, and request-header stack): an IDP-issued JWT arrives as
``Authorization: Bearer``, is verified against the issuer's JWKS, and its
claims map to a kube user identity. Flags mirror the kube-apiserver OIDC
option names (--oidc-issuer-url, --oidc-client-id, --oidc-username-claim,
--oidc-username-prefix, --oidc-groups-claim, --oidc-groups-prefix,
--oidc-ca-file, --oidc-signing-algs), and the claim-mapping rules follow
kube's documented semantics:

- ``iss`` must equal the configured issuer exactly;
- ``aud`` must contain the client id (string or array form);
- ``exp``/``nbf`` enforced with a small clock skew;
- username = the username claim, prefixed with ``<issuer>#`` by default
  when the claim is not ``email`` (``-`` disables prefixing, any other
  value IS the prefix);
- with ``email`` as the username claim, a present-but-false
  ``email_verified`` rejects the token;
- groups claim may be a string or an array of strings, each prefixed
  with the groups prefix.

JWKS keys are fetched from the issuer's discovery document (or an
explicit ``jwks_uri``), cached, and refreshed on unknown ``kid`` with a
rate limit so an attacker cannot hammer the IDP through us.

A copy of the JAX package's ``proxy/oidc.py`` over the port's own
``rules.input.UserInfo`` and ``proxy/jose.py``.
"""

from __future__ import annotations

import json
import logging
import ssl
import threading
import time
import urllib.request
from typing import Callable, Optional

from ..rules.input import UserInfo
from . import jose

log = logging.getLogger("sdbkp.torch.oidc")

DISCOVERY_PATH = "/.well-known/openid-configuration"
DEFAULT_ALGS = ("RS256",)  # kube's default --oidc-signing-algs
ALL_ALGS = ("RS256", "RS384", "RS512", "ES256", "ES384")
# minimum seconds between JWKS refetches triggered by unknown kids
REFRESH_COOLDOWN = 10.0


class OIDCError(Exception):
    pass


def parse_signing_algs(spec: str) -> tuple:
    """Comma-separated alg spec -> validated tuple (shared by options
    validation and the authenticator constructor so they cannot drift)."""
    algs = tuple(a.strip() for a in spec.split(",") if a.strip())
    bad = [a for a in algs if a not in ALL_ALGS]
    if not algs or bad:
        raise OIDCError(
            f"invalid signing algs {spec!r} "
            f"(supported: {', '.join(ALL_ALGS)})")
    return algs


def _default_fetch(url: str, ca_file: Optional[str],
                   timeout: float) -> bytes:
    ctx = None
    if url.startswith("https://"):
        ctx = ssl.create_default_context(cafile=ca_file)
    with urllib.request.urlopen(url, timeout=timeout, context=ctx) as r:
        return r.read()


class OIDCAuthenticator:
    """Verifies bearer JWTs; ``authenticate_token`` returns the mapped
    :class:`UserInfo` or ``None`` (the serving layer turns a presented-
    but-rejected credential into a 401). Thread-safe."""

    def __init__(self, issuer_url: str, client_id: str,
                 username_claim: str = "sub",
                 username_prefix: Optional[str] = None,
                 groups_claim: Optional[str] = None,
                 groups_prefix: str = "",
                 ca_file: Optional[str] = None,
                 required_claims: Optional[dict] = None,
                 signing_algs: tuple = DEFAULT_ALGS,
                 jwks_uri: Optional[str] = None,
                 skew: float = 10.0,
                 fetch: Optional[Callable[[str], bytes]] = None,
                 http_timeout: float = 10.0):
        if not issuer_url or not client_id:
            raise OIDCError("issuer_url and client_id are required")
        signing_algs = parse_signing_algs(",".join(signing_algs))
        # kube compares the token's iss claim to the configured issuer URL
        # EXACTLY (a trailing-slash difference rejects); only the discovery
        # URL construction normalizes the slash.
        self.issuer = issuer_url
        self._issuer_base = issuer_url.rstrip("/")
        self.client_id = client_id
        self.username_claim = username_claim
        self.username_prefix = username_prefix
        self.groups_claim = groups_claim
        self.groups_prefix = groups_prefix
        # kube --oidc-required-claim key=value pairs: every pair must be
        # present with exactly that string value
        self.required_claims = dict(required_claims or {})
        self.signing_algs = tuple(signing_algs)
        self.skew = skew
        self._jwks_uri = jwks_uri
        # bounds how long a refresh-needing validation may wait behind an
        # in-flight fetch (waiters use ~2x: discovery + JWKS)
        self.http_timeout = http_timeout
        self._fetch = fetch or (
            lambda url: _default_fetch(url, ca_file, http_timeout))
        # _lock guards the key map + refresh stamp only; the network fetch
        # runs OUTSIDE it, serialized by _refresh_lock (single-flight), so
        # a hung IDP socket never blocks validations whose kid is cached.
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._keys: Optional[dict[str, dict]] = None  # kid -> JWK
        self._keys_unnamed: list[dict] = []  # JWKs without a kid
        self._last_refresh = 0.0

    # -- JWKS ----------------------------------------------------------------

    def _discover_jwks_uri(self) -> str:
        url = self._issuer_base + DISCOVERY_PATH
        doc = json.loads(self._fetch(url))
        if doc.get("issuer", "").rstrip("/") != self._issuer_base:
            raise OIDCError(
                f"discovery document issuer {doc.get('issuer')!r} does not "
                f"match configured issuer {self.issuer!r}")
        uri = doc.get("jwks_uri")
        if not uri:
            raise OIDCError("discovery document has no jwks_uri")
        return uri

    def _refresh(self) -> None:
        """Network half of a JWKS refresh. Caller holds _refresh_lock (so
        fetches are single-flight) but NOT _lock — concurrent validations
        against the cached map proceed while this blocks on the IDP."""
        if self._jwks_uri is None:
            self._jwks_uri = self._discover_jwks_uri()
        doc = json.loads(self._fetch(self._jwks_uri))
        keys: dict[str, dict] = {}
        unnamed: list[dict] = []
        for k in doc.get("keys", []):
            if k.get("use") not in (None, "sig"):
                continue
            if k.get("kid"):
                keys[k["kid"]] = k
            else:
                unnamed.append(k)
        with self._lock:
            self._keys = keys
            self._keys_unnamed = unnamed

    def _stamp_attempt(self) -> None:
        # stamp the ATTEMPT, not just success: with the IDP down, a storm
        # of forged-kid tokens must not translate into a fetch per token
        with self._lock:
            self._last_refresh = time.monotonic()

    def _candidate_keys(self, kid: Optional[str]) -> list[dict]:
        """JWKs to try for a token, refreshing on an unknown kid (key
        rotation) no more than once per cooldown window.

        Stale-while-revalidate: a validation whose kid is in the cached
        map never touches the network or waits on a fetch in flight; only
        requests that actually need a refresh (cold start, unknown kid)
        serialize on the single-flight lock — the winner fetches once,
        waiters then read the refreshed cache instead of 401ing, and the
        wait is bounded by the fetch's http_timeout. The cooldown stamp
        still caps fetch frequency under forged-kid storms or a down
        IDP."""
        with self._lock:
            keys = self._keys
            last = self._last_refresh
        if keys is not None:
            if kid is None:
                with self._lock:
                    return list(self._keys.values()) + \
                        list(self._keys_unnamed)
            k = keys.get(kid)
            if k is not None:
                return [k]
            # unknown kid — plausible key rotation; at most one refetch
            # per cooldown window. All needers serialize on the lock: the
            # winner fetches, waiters re-read the refreshed map when it
            # releases (a rotation fetch window must not 401 the very
            # tokens the rotation is for)
            if time.monotonic() - last > REFRESH_COOLDOWN:
                # wait bounded by what a healthy fetch can take: a hung
                # IDP must not stall rotation-window requests longer than
                # the fetch's own timeout would
                if not self._refresh_lock.acquire(
                        timeout=self.http_timeout * 2):
                    return []
                try:
                    # re-check under the lock: the fetch may have just
                    # finished — back-to-back fetches would defeat the
                    # cooldown's forged-kid-storm defense
                    with self._lock:
                        last = self._last_refresh
                        k = (self._keys or {}).get(kid)
                    if k is None and \
                            time.monotonic() - last > REFRESH_COOLDOWN:
                        self._stamp_attempt()
                        self._refresh()
                finally:
                    self._refresh_lock.release()
                with self._lock:
                    k = (self._keys or {}).get(kid)
                return [k] if k is not None else []
            return []
        # no key map yet (first token, or every earlier fetch failed):
        # retry only past the cooldown. One fetcher at a time; the others
        # WAIT on the lock (bounded by the fetch's http_timeout) and then
        # validate against the freshly-cached keys — a proxy restart
        # under a fleet reconnect storm must not convert one fetch's
        # latency into a burst of spurious 401s
        # the cooldown decision happens UNDER the lock: the attempt stamp
        # is written before the fetch starts, so a pre-lock check cannot
        # tell "a fetch is in flight right now" (wait for it) from "the
        # last fetch just failed" (cool down)
        if not self._refresh_lock.acquire(timeout=self.http_timeout * 2):
            raise OIDCError("JWKS fetch timed out behind an in-flight "
                            "refresh")
        try:
            # re-check under the lock (see the rotation branch above): a
            # just-finished fetch that still yielded no keys means the
            # IDP is down — cool down instead of immediately refetching
            with self._lock:
                last = self._last_refresh
                have_keys = self._keys is not None
            if not have_keys and last and \
                    time.monotonic() - last <= REFRESH_COOLDOWN:
                raise OIDCError("JWKS unavailable (cooling down)")
            if not have_keys:
                self._stamp_attempt()
                self._refresh()
        finally:
            self._refresh_lock.release()
        with self._lock:
            assert self._keys is not None  # _refresh raises on failure
            if kid is not None:
                k = self._keys.get(kid)
                return [k] if k is not None else []
            return list(self._keys.values()) + list(self._keys_unnamed)

    # -- token validation ----------------------------------------------------

    def authenticate_token(self, token: str) -> Optional[UserInfo]:
        try:
            return self._authenticate(token)
        except (jose.JoseError, OIDCError) as e:
            log.info("oidc: rejecting token: %s", e)
            return None
        except Exception as e:  # JWKS fetch failures etc.
            log.warning("oidc: verification unavailable: %s", e)
            return None

    def _authenticate(self, token: str) -> Optional[UserInfo]:
        header, claims, signing_input, sig = jose.parse_compact(token)
        alg = header.get("alg")
        if alg not in self.signing_algs:
            raise OIDCError(f"alg {alg!r} not in accepted set "
                            f"{self.signing_algs}")
        # exact comparison, matching kube: a trailing-slash difference
        # between the token's iss and the configured issuer REJECTS
        if claims.get("iss") != self.issuer:
            raise OIDCError(f"issuer {claims.get('iss')!r} does not match "
                            f"{self.issuer!r}")
        keys = self._candidate_keys(header.get("kid"))
        if not keys:
            raise OIDCError(f"no JWKS key for kid {header.get('kid')!r}")
        verified = False
        for k in keys:
            try:
                if jose.verify_jws(header, signing_input, sig, k):
                    verified = True
                    break
            except jose.JoseError:
                # a mismatched key TYPE among kid-less candidates (EC key
                # tried against an RS token) must not abort the scan —
                # later keys may still legitimately verify
                continue
        if not verified:
            raise OIDCError("signature verification failed")
        self._validate_time(claims)
        self._validate_audience(claims)
        for k, v in self.required_claims.items():
            if claims.get(k) != v:
                raise OIDCError(
                    f"required claim {k}={v!r} not satisfied "
                    f"(got {claims.get(k)!r})")
        return self._map_identity(claims)

    def _validate_time(self, claims: dict) -> None:
        now = time.time()
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)):
            raise OIDCError("token has no exp claim")
        if now > exp + self.skew:
            raise OIDCError("token is expired")
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and now < nbf - self.skew:
            raise OIDCError("token not yet valid (nbf)")

    def _validate_audience(self, claims: dict) -> None:
        aud = claims.get("aud")
        if isinstance(aud, str):
            ok = aud == self.client_id
        elif isinstance(aud, list):
            ok = self.client_id in aud
        else:
            ok = False
        if not ok:
            raise OIDCError(
                f"audience {aud!r} does not include {self.client_id!r}")

    def _map_identity(self, claims: dict) -> UserInfo:
        raw = claims.get(self.username_claim)
        if not isinstance(raw, str) or not raw:
            raise OIDCError(
                f"username claim {self.username_claim!r} missing or not a "
                "string")
        if self.username_claim == "email":
            verified = claims.get("email_verified")
            # kube parses bool-ish strings via strconv.ParseBool; IDPs do
            # emit "true" as a string in the wild
            if isinstance(verified, str):
                verified = verified.strip().lower() in ("1", "t", "true")
            if verified is not None and verified is not True:
                raise OIDCError("email_verified is not true")
        prefix = self.username_prefix
        if prefix is None:
            # kube default: non-email claims are prefixed with `issuer#`
            # so `system:` names cannot be minted by the IDP
            prefix = "" if self.username_claim == "email" \
                else self.issuer + "#"
        elif prefix == "-":
            prefix = ""
        name = prefix + raw
        groups: list[str] = []
        if self.groups_claim:
            g = claims.get(self.groups_claim)
            if isinstance(g, str):
                g = [g]
            if g is not None:
                if not isinstance(g, list) or \
                        not all(isinstance(x, str) for x in g):
                    raise OIDCError(
                        f"groups claim {self.groups_claim!r} must be a "
                        "string or array of strings")
                groups = [self.groups_prefix + x for x in g]
        return UserInfo(name=name, groups=groups, extra={})


class ChainTokenAuthenticator:
    """Tries bearer authenticators in order; first mapped identity wins
    (kube's union token authenticator shape). Returns None when every
    member rejects — the serving layer then answers 401."""

    def __init__(self, members: list):
        self.members = list(members)

    def authenticate_token(self, token: str) -> Optional[UserInfo]:
        for m in self.members:
            user = m.authenticate_token(token)
            if user is not None:
                return user
        return None
