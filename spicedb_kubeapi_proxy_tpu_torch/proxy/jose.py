"""JWS (JWT) signature verification primitives — pure stdlib.

Supports the asymmetric algorithms kube's OIDC authenticator accepts
(RS256/384/512, ES256/384): RSASSA-PKCS1-v1_5 via one modular
exponentiation against the JWK modulus, ECDSA via textbook short-
Weierstrass point arithmetic over P-256/P-384. No third-party crypto
dependency: verification needs only public-key math, and the proxy image
must not grow a pip requirement for it (the reference gets this from
kube's apiserver libraries, the Go proxy's pkg/proxy/authn.go:40-47).
A copy of the JAX package's ``proxy/jose.py``: the port imports nothing
of that package.

Symmetric algorithms (HS*) are deliberately ABSENT: accepting them would
let anyone holding the (public!) JWKS document mint tokens.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
from typing import Optional


class JoseError(Exception):
    pass


def b64url_decode(s: str) -> bytes:
    try:
        return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
    except (ValueError, TypeError) as e:
        raise JoseError(f"bad base64url segment: {e}") from None


def b64url_encode(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def parse_compact(token: str) -> tuple[dict, dict, bytes, bytes]:
    """Split a compact JWS into (header, claims, signing_input, signature).
    Structure-only — no signature or claims validation happens here."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JoseError(f"compact JWS needs 3 segments, got {len(parts)}")
    h, p, s = parts
    try:
        header = json.loads(b64url_decode(h))
        claims = json.loads(b64url_decode(p))
    except ValueError as e:
        raise JoseError(f"bad JWS JSON: {e}") from None
    if not isinstance(header, dict) or not isinstance(claims, dict):
        raise JoseError("JWS header/claims must be objects")
    return header, claims, f"{h}.{p}".encode(), b64url_decode(s)


_HASHES = {
    "RS256": "sha256", "RS384": "sha384", "RS512": "sha512",
    "ES256": "sha256", "ES384": "sha384",
}

# DER DigestInfo prefixes for EMSA-PKCS1-v1_5 (RFC 8017 §9.2 notes)
_DIGEST_INFO = {
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


def rsa_pkcs1v15_verify(n: int, e: int, message: bytes, sig: bytes,
                        hash_name: str) -> bool:
    """RSASSA-PKCS1-v1_5: recover EM = sig^e mod n and compare against the
    deterministic expected encoding (full-length compare, no parsing of
    attacker-controlled padding — immune to lenient-padding bugs)."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    digest = hashlib.new(hash_name, message).digest()
    t = _DIGEST_INFO[hash_name] + digest
    ps_len = k - len(t) - 3
    if ps_len < 8:
        return False
    expected = b"\x00\x01" + b"\xff" * ps_len + b"\x00" + t
    return hmac.compare_digest(em, expected)


# -- elliptic curves ---------------------------------------------------------


class Curve:
    """Short-Weierstrass curve y² = x³ + ax + b over GF(p), order n."""

    __slots__ = ("p", "a", "b", "n", "gx", "gy", "size")

    def __init__(self, p, a, b, n, gx, gy):
        self.p, self.a, self.b, self.n = p, a, b, n
        self.gx, self.gy = gx, gy
        self.size = (n.bit_length() + 7) // 8

    def on_curve(self, P: Optional[tuple]) -> bool:
        if P is None:
            return True
        x, y = P
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        p = self.p
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None  # P + (-P)
            m = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            m = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (m * m - x1 - x2) % p
        return x3, (m * (x1 - x3) - y1) % p

    def mul(self, k: int, P) -> Optional[tuple]:
        R = None
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.add(P, P)
            k >>= 1
        return R


P256 = Curve(
    p=0xffffffff00000001000000000000000000000000ffffffffffffffffffffffff,
    a=-3,
    b=0x5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b,
    n=0xffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2fc632551,
    gx=0x6b17d1f2e12c4247f8bce6e563a440f277037d812deb33a0f4a13945d898c296,
    gy=0x4fe342e2fe1a7f9b8ee7eb4a7c0f9e162bce33576b315ececbb6406837bf51f5,
)

P384 = Curve(
    p=int("fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
          "effffffff0000000000000000ffffffff", 16),
    a=-3,
    b=int("b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
          "c656398d8a2ed19d2a85c8edd3ec2aef", 16),
    n=int("ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372ddf"
          "581a0db248b0a77aecec196accc52973", 16),
    gx=int("aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a38"
           "5502f25dbf55296c3a545e3872760ab7", 16),
    gy=int("3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c0"
           "0a60b1ce1d7e819d7a431d7c90ea0e5f", 16),
)

_CURVES = {"ES256": P256, "ES384": P384, "P-256": P256, "P-384": P384}


def ecdsa_verify(curve: Curve, qx: int, qy: int, message: bytes,
                 sig: bytes, hash_name: str) -> bool:
    """ECDSA over the given curve; ``sig`` is the JWS raw ``r || s``
    fixed-width encoding (RFC 7518 §3.4), not DER."""
    if len(sig) != 2 * curve.size:
        return False
    r = int.from_bytes(sig[:curve.size], "big")
    s = int.from_bytes(sig[curve.size:], "big")
    n = curve.n
    if not (0 < r < n and 0 < s < n):
        return False
    Q = (qx, qy)
    if not curve.on_curve(Q) or Q is None:
        return False
    digest = hashlib.new(hash_name, message).digest()
    e = int.from_bytes(digest, "big")
    # left-truncate the digest to the order's bit length (FIPS 186-4)
    extra = max(0, 8 * len(digest) - n.bit_length())
    e >>= extra
    w = pow(s, -1, n)
    u1 = e * w % n
    u2 = r * w % n
    R = curve.add(curve.mul(u1, (curve.gx, curve.gy)), curve.mul(u2, Q))
    if R is None:
        return False
    return R[0] % n == r


def verify_jws(header: dict, signing_input: bytes, sig: bytes,
               jwk: dict) -> bool:
    """Verify one JWS signature against one JWK. The caller has already
    picked the key (kid) and validated that ``alg`` is allowed."""
    alg = header.get("alg")
    hash_name = _HASHES.get(alg)
    if hash_name is None:
        raise JoseError(f"unsupported alg {alg!r}")
    kty = jwk.get("kty")
    if alg.startswith("RS"):
        if kty != "RSA":
            raise JoseError(f"alg {alg} needs an RSA key, got {kty!r}")
        n = int.from_bytes(b64url_decode(jwk["n"]), "big")
        e = int.from_bytes(b64url_decode(jwk["e"]), "big")
        return rsa_pkcs1v15_verify(n, e, signing_input, sig, hash_name)
    if alg.startswith("ES"):
        if kty != "EC":
            raise JoseError(f"alg {alg} needs an EC key, got {kty!r}")
        curve = _CURVES.get(jwk.get("crv", ""))
        if curve is None or curve is not _CURVES[alg]:
            raise JoseError(
                f"curve {jwk.get('crv')!r} does not match alg {alg}")
        qx = int.from_bytes(b64url_decode(jwk["x"]), "big")
        qy = int.from_bytes(b64url_decode(jwk["y"]), "big")
        return ecdsa_verify(curve, qx, qy, signing_input, sig, hash_name)
    raise JoseError(f"unsupported alg {alg!r}")


# -- signing (test fixtures / local issuance only) ---------------------------


def rsa_pkcs1v15_sign(n: int, d: int, message: bytes,
                      hash_name: str) -> bytes:
    """Produce an RSASSA-PKCS1-v1_5 signature from a raw private exponent.
    Exists for JWKS test fixtures — the proxy itself never signs."""
    k = (n.bit_length() + 7) // 8
    digest = hashlib.new(hash_name, message).digest()
    t = _DIGEST_INFO[hash_name] + digest
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def ecdsa_sign(curve: Curve, d: int, message: bytes, k: int,
               hash_name: str) -> bytes:
    """Raw-``r||s`` ECDSA signature with an explicit nonce ``k`` —
    test-fixture helper; real signers need RFC 6979 or a CSPRNG nonce."""
    n = curve.n
    digest = hashlib.new(hash_name, message).digest()
    e = int.from_bytes(digest, "big") >> max(
        0, 8 * len(digest) - n.bit_length())
    R = curve.mul(k, (curve.gx, curve.gy))
    r = R[0] % n
    s = pow(k, -1, n) * (e + r * d) % n
    if r == 0 or s == 0:
        raise JoseError("bad nonce")
    return r.to_bytes(curve.size, "big") + s.to_bytes(curve.size, "big")
