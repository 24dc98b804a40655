"""Plain NumPy reference of the pods schema family: who may view a pod.

The schema (BENCH_SCHEMA, or MESH_SCHEMA with nested groups and the
``ip_allowlist`` caveat on flat pod viewers) reads:

    group#member        = user | group#member
    namespace#view      = viewer (user | group#member) + creator
    pod#view            = viewer (user [with ip_allowlist]) + creator
                          + namespace->view

This module evaluates exactly that, from the generator's integer rows:
group membership as a boolean [users, groups] table closed under the
nested-group rows, each user's namespaces through the namespace viewer
grants, and each pod's direct viewers by user (for lists) or as sorted
(pod, user) keys (for checks). A
caveated grant counts when its caveat holds under its stored context
merged with the request's; a caveat whose parameter neither gives is
false (fail-closed). It imports neither ``torch`` nor the program.
"""

from __future__ import annotations

import ipaddress
import json
from typing import Optional

import numpy as np

# the row kinds this reference evaluates; any other is refused, so a
# generator that grows a new kind cannot be judged by a partial reading
KINDS = ("group#member@user", "group#member@group#member",
         "namespace#viewer@group#member", "namespace#viewer@user",
         "namespace#creator@user", "pod#namespace@namespace",
         "pod#viewer@user", "pod#creator@user")


def ip_allowlist(ctx: dict) -> bool:
    """``ip in allowed``: the address lies in one of the allowed ranges."""
    if "ip" not in ctx or "allowed" not in ctx:
        return False
    ip = ipaddress.ip_address(str(ctx["ip"]))
    return any(ip in ipaddress.ip_network(str(a), strict=False)
               for a in ctx["allowed"])


CAVEATS = {"ip_allowlist": ip_allowlist}


class Reference:
    def __init__(self, cfg: dict, data: dict):
        unknown = set(data["rows"]) - set(KINDS)
        if unknown:
            raise ValueError(f"reference cannot evaluate {sorted(unknown)}")
        names = data["names"]
        self.n_pods, self.n_users = len(names["pod"]), len(names["user"])
        n_groups, n_ns = len(names["group"]), len(names["namespace"])
        rows = data["rows"]

        def kind(k):
            return rows.get(k, (np.zeros(0, np.int64),) * 2)

        # member[u, g]: u is a member of g, directly or through nesting
        member = np.zeros((self.n_users, n_groups), dtype=bool)
        g, u = kind("group#member@user")[:2]
        member[u, g] = True
        parent, child = kind("group#member@group#member")[:2]
        for _ in range(n_groups):
            before = int(member.sum())
            for p, c in zip(parent.tolist(), child.tolist()):
                member[:, p] |= member[:, c]
            if int(member.sum()) == before:
                break
        # ns_view[u, n]: u views namespace n
        ns_view = np.zeros((self.n_users, n_ns), dtype=bool)
        n, g = kind("namespace#viewer@group#member")[:2]
        for ni, gi in zip(n.tolist(), g.tolist()):
            ns_view[:, ni] |= member[:, gi]
        for k in ("namespace#viewer@user", "namespace#creator@user"):
            n, u = kind(k)[:2]
            ns_view[u, n] = True
        self.ns_view = ns_view
        p, n = kind("pod#namespace@namespace")[:2]
        # a pod may sit in several namespaces: keep (pod, ns) pairs
        self.pod_ns = (p, n)
        # direct viewers: pod, user and stored-context index (-1:
        # unconditional) of each grant; indexed on first use
        pods, users, ctxs = [], [], []
        for k in ("pod#viewer@user", "pod#creator@user"):
            r = kind(k)
            pods.append(r[0])
            users.append(r[1])
            ctxs.append(r[2] if len(r) > 2 else np.full(len(r[0]), -1))
        self.g_pod = np.concatenate(pods).astype(np.int64)
        self.g_user = np.concatenate(users).astype(np.int64)
        self.g_ctx = np.concatenate(ctxs).astype(np.int64)
        self._by_user = self._by_key = None
        cav = cfg.get("caveat")
        self.caveat = CAVEATS[cav["name"]] if cav else None
        self.stored = ([json.loads(c) for c in cav["stored_contexts"]]
                       if cav else [])

    def _passing(self, context: Optional[dict]) -> np.ndarray:
        """Per stored-context index (and -1, last): whether a grant under
        it counts for a request with ``context``."""
        ok = [bool(self.caveat({**s, **(context or {})}))
              for s in self.stored]
        return np.asarray(ok + [True], dtype=bool)

    def _user_index(self):
        """Each user's grants, as a CSR over users."""
        if self._by_user is None:
            u = self.g_user
            # a radix sort where the users fit 16 bits
            order = np.argsort(u.astype(np.uint16) if self.n_users <= 1 << 16
                               else u, kind="stable")
            ptr = np.searchsorted(u[order], np.arange(self.n_users + 1))
            self._by_user = (self.g_pod[order], self.g_ctx[order], ptr)
        return self._by_user

    def _key_index(self):
        """The grants' (pod * n_users + user) keys, sorted."""
        if self._by_key is None:
            key = self.g_pod * self.n_users + self.g_user
            order = np.argsort(key)
            self._by_key = (key[order], self.g_ctx[order])
        return self._by_key

    def lookup(self, user: int, context: Optional[dict]) -> np.ndarray:
        """bool [n_pods]: the pods ``user`` may view."""
        out = np.zeros(self.n_pods, dtype=bool)
        p, n = self.pod_ns
        out[p[self.ns_view[user, n]]] = True
        pods, ctx, ptr = self._user_index()
        lo, hi = ptr[user], ptr[user + 1]
        ok = self._passing(context)[ctx[lo:hi]]
        out[pods[lo:hi][ok]] = True
        return out

    def check(self, pods: np.ndarray, users: np.ndarray,
              context: Optional[dict]) -> np.ndarray:
        """bool per (pod, user) pair: whether the user may view the pod."""
        pods, users = np.asarray(pods), np.asarray(users)
        key, key_ctx = self._key_index()
        q = pods.astype(np.int64) * self.n_users + users
        out = np.zeros(len(q), dtype=bool)
        passing = self._passing(context)
        lo = np.searchsorted(key, q, side="left")
        hi = np.searchsorted(key, q, side="right")
        for i in np.flatnonzero(hi > lo).tolist():
            out[i] = bool(passing[key_ctx[lo[i]:hi[i]]].any())
        p, n = self.pod_ns
        pod_ns = np.full(self.n_pods, -1, dtype=np.int64)
        pod_ns[p] = n
        if len(p) != len(np.unique(p)):
            raise ValueError("check assumes one namespace a pod")
        has = pod_ns[pods] >= 0
        out[has] |= self.ns_view[users[has], pod_ns[pods[has]]]
        return out
