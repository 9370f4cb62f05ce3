"""The reference's static gate (``tools/vet``) over the port.

* ``python -m tools.vet tpushare_torch``: every per-file rule (the AST
  lint rules and strict typing) reports no violation, the command exits
  0, and every ``# vet: ignore[...]`` pragma in the port gives its reason.
* The whole-program engines over the port's own call graph: the lock
  flow (lock-order cycles, blocking calls under a lock) and the resource
  protocols, which find the port's two declared ``PROTOCOLS`` (the
  router's ``page-charge`` and the autoscaler's ``drain-cordon``), report
  no violation. The engines' budget manifests name the reference's paths
  (``tools/vet/*_budget.json``), so their entries, stale for the port,
  are left out.
"""

from __future__ import annotations

import os

from tools.vet.__main__ import ALL_RULES, main
from tools.vet.engine import check_tree, iter_pragmas, iter_py_files, \
    pragma_justified

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpushare_torch")


def test_the_port_is_clean_under_every_per_file_rule():
    violations = check_tree([PORT], ALL_RULES)
    assert violations == [], "\n".join(v.render() for v in violations)


def test_the_command_exits_clean(capsys):
    assert main([PORT]) == 0
    assert "tools.vet: clean" in capsys.readouterr().out


def test_every_pragma_of_the_port_gives_its_reason():
    known = {r.rule_id for r in ALL_RULES} | {
        "blocking-under-lock", "lock-order-cycle"}
    total, naked = 0, []
    for path in iter_py_files([PORT]):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for lineno, ids, why in iter_pragmas(src):
            if not set(ids) & known:
                continue
            total += 1
            if not pragma_justified(why):
                naked.append(f"{path}:{lineno}")
    assert total >= 10
    assert not naked, naked


def _program():
    from tools.vet.flow.analysis import build_program
    return build_program(PORT)


def _own(violations) -> list:
    """Violations in the port's files (not the reference's manifests)."""
    return [v for v in violations
            if os.path.abspath(v.path).startswith(PORT + os.sep)]


def test_the_lock_flow_over_the_port_is_clean():
    from tools.vet.flow import analyze
    found = _own(analyze(program=_program()))
    assert found == [], "\n".join(v.render() for v in found)


def test_the_resource_protocols_over_the_port_hold():
    from tools.vet.protocol import analyze
    from tools.vet.protocol.analysis import collect_protocols
    program = _program()
    assert sorted(p["protocol"] for p in collect_protocols(program)) == [
        "drain-cordon", "page-charge"]
    found = _own(analyze(program=program))
    assert found == [], "\n".join(v.render() for v in found)
