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

Not yet linted: the lock-discipline pass knows JAX's device syncs under a
lock, not torch's (``.item()``, ``.cpu()``, ``.tolist()``,
``torch.cuda.synchronize``).
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
