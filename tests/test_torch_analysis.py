"""PyTorch port, the invariant lint suite (tools/analysis/) run over the
port's package with the port's own allowlist and metrics table.

The five passes (loop-blocking, lock-discipline, fail-closed,
jit-stability, metrics-contract) run over ``spicedb_kubeapi_proxy_tpu_
torch`` exactly as ``make analyze`` runs them over the JAX package, with
the port-owned allowlist ``spicedb_kubeapi_proxy_tpu_torch/lint/
allowlist.txt`` (each entry the twin of a JAX entry, its justification
checked against the port's code). The metrics-contract pass checks both
directions against one ``## Metrics reference`` table, so it gets a
temporary root whose ``docs/operations.md`` holds the repo table's rows
for the families the port registers plus the port-owned rows of
``lint/metrics.md``: a JAX-only family is then no finding against the
port, and a port family without a row is one. Nothing under tools/ or
docs/ changes.

The lock-discipline and loop-blocking passes know JAX's device syncs
only. The last cases add torch's (``.item()``, ``.cpu()``, ``.tolist()``
and ``torch.cuda.synchronize``) to their tables inside the test and run
them over the port, loadgen/ and chaos/ included, with ``lint/
torch_syncs.txt``: each entry there says what its receiver is, and the
test checks that against the module.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.analysis import core, metrics_contract  # noqa: E402
from tools.analysis.run import PASSES  # noqa: E402
from tools.analysis.run import main as run_main  # noqa: E402

PKG = "spicedb_kubeapi_proxy_tpu_torch"
LINT = os.path.join(REPO, PKG, "lint")
ALLOWLIST = os.path.join(LINT, "allowlist.txt")


def _rows(path):
    """name -> the table row line, for ``path``'s metrics section."""
    rows = {}
    in_section = False
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if line.startswith("## "):
                in_section = line.strip() == metrics_contract.SECTION
                continue
            m = metrics_contract._ROW_RE.match(line) if in_section else None
            if m:
                rows[m.group("name")] = line.rstrip("\n")
    return rows


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    """A root holding the port (a link to it: finding paths stay
    ``spicedb_kubeapi_proxy_tpu_torch/...``) and a docs/operations.md
    whose metrics table is the port's families' rows."""
    root = tmp_path_factory.mktemp("port-lint")
    os.symlink(os.path.join(REPO, PKG), root / PKG)
    mods = core.load_modules(REPO, [PKG])
    fam, _ = metrics_contract._collect_code(mods)
    repo_rows = _rows(os.path.join(REPO, metrics_contract.DOCS_REL))
    own_rows = _rows(os.path.join(LINT, "metrics.md"))
    assert not set(own_rows) & set(repo_rows), \
        "a port-owned row duplicates a repo row"
    rows = [repo_rows[n] for n in sorted(fam) if n in repo_rows]
    rows += [own_rows[n] for n in sorted(own_rows)]
    (root / "docs").mkdir()
    (root / "docs" / "operations.md").write_text(
        "# Operations\n\n" + metrics_contract.SECTION + "\n\n"
        "| family | kind | labels | meaning |\n|---|---|---|---|\n"
        + "\n".join(rows) + "\n")
    return str(root)


def _run(port_root, *extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_main(["--root", port_root, "--allowlist", ALLOWLIST,
                       "--strict", *extra, PKG])
    return rc, out.getvalue()


def test_the_port_passes_the_whole_suite_with_its_allowlist(port_root):
    rc, out = _run(port_root)
    assert rc == 0, out
    assert " 0 new / " in out, out
    assert "stale allowlist" not in out, out  # every entry still matches


@pytest.mark.parametrize("rule", list(PASSES))
def test_each_pass_is_clean_on_the_port(port_root, rule):
    rc, out = _run(port_root, "--select", rule)
    assert rc == 0, out
    assert " 0 new / " in out, out


def test_every_allowlist_entry_twins_a_jax_entry_with_its_own_reason():
    jax = core.Allowlist.load(os.path.join(REPO, "tools", "analysis",
                                           "allowlist.txt"))
    port = core.Allowlist.load(ALLOWLIST)
    assert not port.malformed
    twins = {fp.replace("spicedb_kubeapi_proxy_tpu/", PKG + "/", 1)
             for fp in jax.entries}
    assert set(port.entries) <= twins
    with open(ALLOWLIST) as fh:
        lines = [ln for ln in fh if ln.strip() and not ln.startswith("#")]
    assert len(lines) == len(port.entries) == 22
    with open(os.path.join(REPO, "tools", "analysis",
                           "allowlist.txt")) as fh:
        jax_reasons = {ln.split("#", 1)[1].strip() for ln in fh
                       if "#" in ln and not ln.startswith("#")}
    for ln in lines:
        assert ln.split("#", 1)[1].strip() not in jax_reasons, ln


def test_every_port_family_has_exactly_one_row(port_root):
    mods = core.load_modules(REPO, [PKG])
    fam, dynamic = metrics_contract._collect_code(mods)
    assert [(m.path, n.lineno) for m, n in dynamic] == [
        (m.path, n.lineno) for m, n in dynamic
        if m.path.endswith("obs/slo.py")]
    rows = _rows(os.path.join(port_root, "docs", "operations.md"))
    assert set(rows) == set(fam)
    own = _rows(os.path.join(LINT, "metrics.md"))
    assert {"engine_kernel_builds_total", "engine_kernel_build_seconds",
            "proxy_filter_python_path_total",
            "scaleout_read_route_retries_total"} <= set(own)


def test_an_undocumented_port_family_is_a_finding(port_root, tmp_path):
    """The gate bites: drop one port-owned row and the run fails on
    exactly that family."""
    root = tmp_path / "root"
    root.mkdir()
    os.symlink(os.path.join(REPO, PKG), root / PKG)
    (root / "docs").mkdir()
    text = open(os.path.join(port_root, "docs", "operations.md")).read()
    text = "\n".join(ln for ln in text.splitlines()
                     if "`engine_kernel_builds_total`" not in ln) + "\n"
    (root / "docs" / "operations.md").write_text(text)
    rc, out = _run(str(root), "--select", "metrics-contract")
    assert rc == 1
    assert "`engine_kernel_builds_total` is registered but missing" in out


# -- torch device syncs under a lock or on the event loop -------------------

TORCH_SYNCS = os.path.join(LINT, "torch_syncs.txt")
SYNC_METHODS = ("item", "cpu", "tolist")


@pytest.fixture
def torch_sync_tables(monkeypatch):
    """The two passes' tables with torch's device syncs added (patched
    here: tools/analysis/ stays as it is)."""
    from tools.analysis import lock_discipline, loop_blocking

    for m in SYNC_METHODS:
        monkeypatch.setitem(lock_discipline.BLOCKING_METHODS, m,
                            "torch device sync")
        monkeypatch.setitem(loop_blocking.BLOCKING_METHODS, m,
                            "torch device sync")
    monkeypatch.setitem(lock_discipline.BLOCKING_UNDER_LOCK,
                        "torch.cuda.synchronize", "torch device sync")
    monkeypatch.setitem(loop_blocking.BLOCKING_CALLS,
                        "torch.cuda.synchronize", "torch device sync")


def _merged_allowlist(tmp_path, extra: bool = True) -> str:
    path = tmp_path / "allowlist.txt"
    text = open(ALLOWLIST).read()
    if extra:
        text += open(TORCH_SYNCS).read()
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("rule", ["lock-discipline", "loop-blocking"])
def test_torch_syncs_are_clean_on_the_port(port_root, tmp_path, rule,
                                           torch_sync_tables):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_main(["--root", port_root, "--allowlist",
                       _merged_allowlist(tmp_path), "--strict",
                       "--select", rule, PKG])
    assert rc == 0, out.getvalue()
    assert " 0 new / " in out.getvalue(), out.getvalue()


def test_torch_syncs_gate_bites_and_covers_loadgen_and_chaos(
        port_root, tmp_path, torch_sync_tables):
    """Without its entries the patched run finds exactly the syncs the
    entries name; a torch sync under a lock and on the loop is a finding
    (the tables are live); and the passes read loadgen/ and chaos/."""
    from tools.analysis import lock_discipline, loop_blocking

    mods = core.load_modules(REPO, [PKG])
    paths = {m.path for m in mods}
    for sub in ("loadgen/driver.py", "loadgen/sweep.py",
                "chaos/campaign.py", "chaos/schedule.py"):
        assert f"{PKG}/{sub}" in paths
    found = {(f.rule, f.path, f.scope, f.token)
             for f in lock_discipline.run(mods) + loop_blocking.run(mods)
             if f.token.split("-under-")[0] in SYNC_METHODS
             or "synchronize" in f.token}
    listed = {tuple(fp.split("|")) for fp in
              core.Allowlist.load(TORCH_SYNCS).entries}
    assert found == listed and len(listed) == 2
    src = (
        "import threading, torch\n"
        "class K:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def f(self, t):\n"
        "        with self._lock:\n"
        "            t.item()\n"
        "            torch.cuda.synchronize()\n"
        "    async def g(self, t):\n"
        "        return t.cpu()\n")
    root = tmp_path / "bite"
    (root / "pkg").mkdir(parents=True)
    (root / "pkg" / "__init__.py").write_text("")
    (root / "pkg" / "k.py").write_text(src)
    got = sorted(f.token for f in
                 lock_discipline.run(core.load_modules(str(root), ["pkg"]))
                 + loop_blocking.run(core.load_modules(str(root), ["pkg"])))
    assert got == ["cpu", "item-under-_lock",
                   "torch.cuda.synchronize-under-_lock"]


def test_every_torch_sync_entry_states_its_receiver_truly():
    """A "numpy" entry's module imports no torch, so its receiver cannot
    be a tensor; every entry carries its own reason."""
    import ast

    lines = [ln for ln in open(TORCH_SYNCS)
             if ln.strip() and not ln.startswith("#")]
    entries = core.Allowlist.load(TORCH_SYNCS)
    assert not entries.malformed and len(lines) == len(entries.entries)
    for ln in lines:
        fp, reason = (x.strip() for x in ln.split("#", 1))
        rule, path, scope, token = fp.split("|")
        assert reason.startswith("numpy:"), ln
        tree = ast.parse(open(os.path.join(REPO, path)).read())
        imported = {a.name.split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names}
        imported |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert "torch" not in imported, path
        assert "np.flatnonzero" in _scope_source(tree, scope), ln


def _scope_source(tree, scope: str) -> str:
    import ast

    cls, fn = scope.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name == fn:
                    return ast.unparse(item)
    raise AssertionError(f"no {scope}")
