"""PyTorch port, OIDC bearer authentication (proxy/jose.py,
proxy/oidc.py) held against the JAX package.

Every case of test_oidc.py runs here on the port (``port_cases``: the
same bodies, its engine on the CPU). Then the two packages side by side:
one corpus of tokens (valid, expired, forged, wrong audience or issuer,
unknown kid, the claim-mapping variants) through each package's
authenticator maps to the same identities, and the signing primitives
give the same bytes. Last, the port's proxy with ``--oidc-*`` options
authenticates a bearer token end to end against a loopback issuer
(discovery and JWKS over HTTP), and each ``--oidc-*`` flag, refused
before, is accepted by the proxy's CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from spicedb_kubeapi_proxy_tpu.proxy import jose as jjose
from spicedb_kubeapi_proxy_tpu.proxy import oidc as joidc
from spicedb_kubeapi_proxy_tpu_torch.proxy import jose as tjose
from spicedb_kubeapi_proxy_tpu_torch.proxy import oidc as toidc

from torch_parity import port_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = os.path.join(REPO, "deploy", "rules.yaml")

_CASES = port_cases("test_oidc.py", replacements=(
    # the port's engine runs where it is told: the CPU here
    ("    engine = Engine()\n", '    engine = Engine(device="cpu")\n'),
    ('""", upstream=object())', '""", upstream=object(), device="cpu")'),
))
globals().update(_CASES)

_C = _CASES["test_valid_token_maps_identity_with_default_prefix"].__globals__
ISSUER, CLIENT_ID = _C["ISSUER"], _C["CLIENT_ID"]
sign_jwt, std_claims = _C["sign_jwt"], _C["std_claims"]
rsa_jwk, ec_jwk = _C["rsa_jwk"], _C["ec_jwk"]


def test_every_jax_case_runs_on_the_port():
    assert len(_CASES) == 24
    assert _C["OIDCAuthenticator"] is toidc.OIDCAuthenticator
    assert _C["jose"] is tjose


# -- both packages ------------------------------------------------------------


def _auth(mod, **over):
    kw = dict(issuer_url=ISSUER, client_id=CLIENT_ID, jwks_uri="jwks",
              fetch=lambda url: json.dumps(
                  {"keys": [rsa_jwk(), ec_jwk()]}).encode(),
              signing_algs=("RS256", "ES256"))
    kw.update(over)
    return mod.OIDCAuthenticator(**kw)


def _corpus():
    now = time.time()
    toks = [
        sign_jwt(std_claims()),
        sign_jwt(std_claims(sub="bob", groups=["dev", "ops"])),
        sign_jwt(std_claims(groups="solo")),
        sign_jwt(std_claims(aud=["x", CLIENT_ID])),
        sign_jwt(std_claims(email="a@b.test", email_verified="true")),
        sign_jwt(std_claims(email="a@b.test", email_verified=False)),
        sign_jwt(std_claims(exp=now - 120)),
        sign_jwt(std_claims(nbf=now + 3600)),
        sign_jwt(std_claims(iss=ISSUER + "/")),
        sign_jwt(std_claims(aud="other")),
        sign_jwt(std_claims(tenant="acme")),
        sign_jwt(std_claims(), kid="ghost"),
        sign_jwt(std_claims(), alg="ES256", kid="ec-1"),
        sign_jwt(std_claims(), kid=None),
        sign_jwt(std_claims(groups=[1, 2])),
        "forged.token.here",
        "",
    ]
    good = toks[0]
    head, body, sig = good.split(".")
    toks.append(".".join((head, body, sig[:-2] + ("AA" if sig[-2:] != "AA"
                                                   else "BB"))))
    return toks


@pytest.mark.parametrize("over", [
    {},
    {"username_prefix": "-"},
    {"username_prefix": "oidc:", "groups_claim": "groups",
     "groups_prefix": "g:"},
    {"username_claim": "email"},
    {"required_claims": {"tenant": "acme"}},
    {"signing_algs": ("RS256",)},
], ids=["defaults", "no-prefix", "groups", "email", "required", "rs-only"])
def test_both_packages_map_every_token_alike(over):
    got = {}
    for name, mod in (("jax", joidc), ("torch", toidc)):
        a = _auth(mod, **over)
        got[name] = [None if u is None else (u.name, list(u.groups))
                     for u in map(a.authenticate_token, _corpus())]
    assert got["torch"] == got["jax"]
    assert any(g is not None for g in got["torch"])
    assert any(g is None for g in got["torch"])


def test_both_packages_sign_and_parse_the_same_bytes():
    n, d = _C["RSA_N"], _C["RSA_D"]
    for alg, h in (("RS256", "sha256"), ("RS384", "sha384"),
                   ("RS512", "sha512")):
        msg = f"covered {alg}".encode()
        assert tjose.rsa_pkcs1v15_sign(n, d, msg, h) \
            == jjose.rsa_pkcs1v15_sign(n, d, msg, h)
    ec_d = _C["EC_D"]
    assert tjose.ecdsa_sign(tjose.P256, ec_d, b"m", 12345, "sha256") \
        == jjose.ecdsa_sign(jjose.P256, ec_d, b"m", 12345, "sha256")
    tok = sign_jwt(std_claims(sub="carol"))
    tj, jj = tjose.parse_compact(tok), jjose.parse_compact(tok)
    assert tj == jj
    assert tjose.b64url_encode(b"\x00\xff") == jjose.b64url_encode(
        b"\x00\xff")
    assert toidc.parse_signing_algs("RS256, ES256") \
        == joidc.parse_signing_algs("RS256, ES256")
    for bad in ("HS256", "", "RS256,none"):
        with pytest.raises(toidc.OIDCError):
            toidc.parse_signing_algs(bad)
        with pytest.raises(joidc.OIDCError):
            joidc.parse_signing_algs(bad)


# -- the port's proxy behind a loopback issuer ---------------------------------


class _Issuer:
    """Discovery and JWKS served over HTTP on loopback."""

    def __init__(self):
        state = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/.well-known/openid-configuration":
                    body = json.dumps({"issuer": state.url,
                                       "jwks_uri": state.url + "/keys"})
                elif self.path == "/keys":
                    state.jwks_fetches += 1
                    body = json.dumps({"keys": [rsa_jwk()]})
                else:
                    self.send_error(404)
                    return
                raw = body.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *a):
                pass

        self.jwks_fetches = 0
        self.srv = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_port}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


def test_port_proxy_authenticates_a_bearer_token_end_to_end(tmp_path):
    import asyncio

    from spicedb_kubeapi_proxy_tpu_torch.engine import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import (
        parse_relationship,
    )
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemory import (
        InMemoryClient,
    )
    from spicedb_kubeapi_proxy_tpu_torch.proxy.oidc import OIDCAuthenticator
    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import Options

    issuer = _Issuer()
    try:
        kube = InMemoryKube()
        for ns in ("dev", "prod"):
            kube.put("namespaces", ns)
        cfg = Options(rule_files=[RULES], upstream=kube, device="cpu",
                      oidc_issuer_url=issuer.url, oidc_client_id=CLIENT_ID,
                      oidc_username_prefix="-",
                      workflow_database_path=str(tmp_path / "dtx.sqlite"),
                      ).complete()
        assert isinstance(cfg.server.token_authenticator, OIDCAuthenticator)
        cfg.engine.write_relationships([WriteOp("touch", parse_relationship(
            "namespace:dev#creator@user:alice"))])

        def bearer(claims, **kw):
            return {"Authorization": "Bearer " + sign_jwt(claims, **kw)}

        async def go():
            await cfg.workflow.resume_pending()
            c = InMemoryClient(cfg.server.handle)
            iss = {"iss": issuer.url}
            r = await c.get("/api/v1/namespaces",
                            headers=bearer(std_claims(**iss)))
            assert r.status == 200, r.body
            names = [i["metadata"]["name"]
                     for i in json.loads(r.body)["items"]]
            assert names == ["dev"]
            r = await c.get("/api/v1/namespaces",
                            headers=bearer(std_claims(sub="bob", **iss)))
            assert r.status == 200
            assert json.loads(r.body)["items"] == []
            # expired, unknown kid, forged: 401, never a header identity
            for h in (bearer(std_claims(exp=time.time() - 600, **iss)),
                      bearer(std_claims(**iss), kid="ghost"),
                      {"Authorization": "Bearer forged.token.here",
                       "X-Remote-User": "alice"}):
                r = await c.get("/api/v1/namespaces", headers=h)
                assert r.status == 401, (h, r.status)
            await cfg.workflow.shutdown()

        asyncio.run(go())
        assert issuer.jwks_fetches >= 1
    finally:
        issuer.close()


_OIDC_FLAGS = (
    ("--oidc-issuer-url", ["https://idp.test"], "oidc_issuer_url"),
    ("--oidc-client-id", ["kube"], "oidc_client_id"),
    ("--oidc-username-claim", ["email"], "oidc_username_claim"),
    ("--oidc-username-prefix", ["corp:"], "oidc_username_prefix"),
    ("--oidc-groups-claim", ["groups"], "oidc_groups_claim"),
    ("--oidc-groups-prefix", ["g:"], "oidc_groups_prefix"),
    ("--oidc-ca-file", ["/dev/null"], "oidc_ca_file"),
    ("--oidc-signing-algs", ["RS256,ES256"], "oidc_signing_algs"),
    ("--oidc-required-claim", ["tenant=acme"], "oidc_required_claims"),
)


@pytest.mark.parametrize("flag,args,dest", _OIDC_FLAGS,
                         ids=[f for f, _, _ in _OIDC_FLAGS])
def test_oidc_flag_is_accepted(flag, args, dest):
    from spicedb_kubeapi_proxy_tpu.proxy import options as jopts
    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import (
        add_flags,
        options_from_args,
    )

    argv = ["--rule-file", RULES, "--upstream-url", "http://127.0.0.1:1",
            "--device", "cpu", flag, *args]
    if flag != "--oidc-issuer-url":
        argv += ["--oidc-issuer-url", "https://idp.test"]
    if flag != "--oidc-client-id":
        argv += ["--oidc-client-id", "kube"]
    parser = argparse.ArgumentParser()
    add_flags(parser)
    opts = options_from_args(parser.parse_args(argv))
    opts.validate()
    # the JAX proxy parses the same flags into the same options
    jparser = argparse.ArgumentParser()
    jopts.add_flags(jparser)
    jo = jopts.options_from_args(jparser.parse_args(
        [a for a in argv if a not in ("--device", "cpu")]))
    got = getattr(opts, dest)
    assert got == getattr(jo, dest)
    assert got == (args if dest == "oidc_required_claims" else args[0])
