"""The reference's own test stories, run against the port's modules.

``load(name)`` reads ``tests/<name>.py`` (a frozen test of the JAX
package's control plane, which imports no JAX), points each of its
imports of ``tpushare`` at ``tpushare_torch``, each of its imports of
another reference test at that test's port copy and each of its imports
of the capacity planner (``import simulate`` with ``tools/`` on the path,
or ``from tools import simulate as sim``) at its twin,
``tools/simulate_torch.py``, and executes the result as a module of its
own. A ``tests/test_torch_*.py`` file picks the test
classes it runs from that module, drops the cases that read something the
port does not have yet (``/metrics``, decision traces) by name, and
supplies an ``api`` fixture over the port's fake apiserver. The stories
themselves, their data and their asserts are the reference's, unchanged.
"""

from __future__ import annotations

import os
import re
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))

_IMPORT = re.compile(r"^(\s*)(from|import) tpushare(\.| )", re.M)
_TEST_IMPORT = re.compile(r"^(\s*)from tests\.(test_\w+) import", re.M)
_SIM_IMPORT = re.compile(r"^(\s*)import simulate$", re.M)
_SIM_FROM = re.compile(r"^(\s*)from tools import simulate as (\w+)$", re.M)


def source(name: str, drop: tuple[str, ...] = ()) -> str:
    """The reference test's text with its imports pointed at the port,
    less the import lines in ``drop`` (of modules the port has not yet;
    the cases that use them are left out)."""
    with open(os.path.join(HERE, f"{name}.py"), encoding="utf-8") as f:
        text = f.read()
    for line in drop:
        assert f"\n{line}\n" in text, line
        text = text.replace(f"\n{line}\n", "\n")
    text = _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)} tpushare_torch"
                       f"{m.group(3)}", text)
    text = _SIM_IMPORT.sub(r"\1import simulate_torch as simulate", text)
    text = _SIM_FROM.sub(r"\1from tools import simulate_torch as \2", text)
    return _TEST_IMPORT.sub(
        lambda m: f"{m.group(1)}from tests.torch_reference_stories."
                  f"{m.group(2)} import", text)


def load(name: str, drop: tuple[str, ...] = ()) -> types.ModuleType:
    """``tests/<name>.py`` over the port, as module
    ``tests.torch_reference_stories.<name>`` (built once)."""
    full = f"{__name__}.{name}"
    mod = sys.modules.get(full)
    if mod is None:
        mod = types.ModuleType(full)
        mod.__file__ = os.path.join(HERE, f"{name}.py")
        sys.modules[full] = mod
        setattr(sys.modules[__name__], name, mod)
        exec(compile(source(name, drop), mod.__file__, "exec"),
             mod.__dict__)
    return mod


def pick(mod: types.ModuleType, classes: list[str],
         leave_out: tuple[str, ...] = ()) -> dict:
    """Subclasses of ``mod``'s test classes, each without the methods
    named in ``leave_out`` ("Class.test_name"), keyed by class name."""
    out = {}
    for cname in classes:
        base = getattr(mod, cname)
        gone = {entry.split(".", 1)[1] for entry in leave_out
                if entry.split(".", 1)[0] == cname}
        # A None attribute shadows the inherited test: nothing to collect.
        attrs = {name: None for name in gone}
        out[cname] = type(cname, (base,), attrs)
    return out
