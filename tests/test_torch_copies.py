"""The port's host layer is a copy of the reference's, kept in step: each
copied module, with its docstrings and comments dropped and the package
name in absolute imports normalized, parses to the same syntax tree as
its babble_tpu counterpart. A fix made on one side only fails here."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "babble_tpu")
PORT = os.path.join(REPO, "babble_tpu_torch")

# the port's own modules in the copied packages, each with its reason
OWN = {
    "hashgraph/__init__.py": "exports hashgraph_from_events; sqlite_store waits",
    "hashgraph/carry.py": "the port's DAG carrier, no counterpart",
    "utils/__init__.py": "netaddr is not copied",
    "obs/__init__.py": "the Observability members the host layer reads",
    "obs/devledger.py": "host-clock accounting only; the device-time ledger waits",
}
PACKAGES = ("common", "crypto", "peers", "obs", "hashgraph", "utils")


def port_modules():
    out = []
    for pkg in PACKAGES:
        for name in sorted(os.listdir(os.path.join(PORT, pkg))):
            rel = f"{pkg}/{name}"
            if name.endswith(".py") and rel not in OWN:
                out.append(rel)
    return out


def normalized_tree(path: str, package: str) -> str:
    """ast.dump of the module with every docstring removed and
    `package` renamed to a placeholder in absolute imports."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if node.module.split(".")[0] == package:
                node.module = "PKG" + node.module[len(package):]
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == package:
                    alias.name = "PKG" + alias.name[len(package):]
    return ast.dump(tree)


def test_copied_packages_cover_the_issue_list():
    mods = set(port_modules())
    for m in ("common/errors.py", "crypto/keys.py", "peers/peers.py",
              "obs/provenance.py", "hashgraph/hashgraph.py", "utils/codec.py"):
        assert m in mods


@pytest.mark.parametrize("rel", port_modules())
def test_copied_module_matches_the_reference(rel):
    ref = os.path.join(REF, rel)
    assert os.path.exists(ref), f"{rel} has no counterpart in babble_tpu"
    assert normalized_tree(os.path.join(PORT, rel), "babble_tpu_torch") == \
        normalized_tree(ref, "babble_tpu"), (
            f"babble_tpu_torch/{rel} drifted from babble_tpu/{rel}: port the fix")


@pytest.mark.parametrize("rel", sorted(OWN))
def test_own_modules_differ_from_any_counterpart(rel):
    """A module listed as the port's own exists, and where the reference
    has one of the same name, really differs from it (else it belongs
    under the drift check)."""
    assert os.path.exists(os.path.join(PORT, rel))
    ref = os.path.join(REF, rel)
    if os.path.exists(ref):
        assert normalized_tree(os.path.join(PORT, rel), "babble_tpu_torch") != \
            normalized_tree(ref, "babble_tpu")
