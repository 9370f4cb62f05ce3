"""How long a process of the port takes to start on this host.

Times, from this process, fresh interpreters that import ``torch`` and
``tpushare_torch.entry`` (a gang rank's first step) one at a time and
eight at once, in this process's env and again with a bytecode cache
under ``build/`` (``PYTHONPYCACHEPREFIX``, bytecode writing on: its first
run fills it), and one more under ``-X importtime`` for the modules that
take longest. ``chip_smoke.py`` starts some hundred such processes (gang
ranks, tenants), so what one costs sets how its phases are laid out.

    python3 tools/process_start_probe.py [--runs 3] [--top 12]

Prints one JSON object: seconds for each run, whether this env forbids
writing bytecode, and the top modules by cumulative import microseconds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(code: str, n: int, *flags: str,
           cache: str | None = None) -> tuple[float, list[str]]:
    """Seconds until ``n`` interpreters running ``code`` at once have all
    exited, and their standard errors; with ``cache``, they read and
    write bytecode there."""
    env = {**os.environ, "PYTHONPATH": REPO}
    if cache is not None:
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        env["PYTHONPYCACHEPREFIX"] = cache
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *flags, "-c", code], env=env,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    errs = [p.communicate()[1] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{code!r} failed:\n{errs[0][-2000:]}")
    return time.perf_counter() - t0, errs


def importtime_top(code: str, top: int) -> list[tuple[str, int]]:
    """The ``top`` modules by cumulative import microseconds."""
    _, errs = _start(code, 1, "-X", "importtime")
    rows = []
    for line in errs[0].splitlines():
        parts = line.split("|")
        if line.startswith("import time:") and len(parts) == 3:
            try:
                rows.append((parts[2].strip(), int(parts[1])))
            except ValueError:
                continue
    return sorted(rows, key=lambda r: -r[1])[:top]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    out = {"python": sys.version.split()[0],
           "dont_write_bytecode": "PYTHONDONTWRITEBYTECODE" in os.environ}
    cache = os.path.join(REPO, "build", "pycache-probe")
    shutil.rmtree(cache, ignore_errors=True)
    for name, code in (("torch", "import torch"),
                       ("entry", "import tpushare_torch.entry")):
        out[name + "_s"] = [_start(code, 1)[0] for _ in range(args.runs)]
        out[name + "_x8_s"] = _start(code, 8)[0]
    code = "import tpushare_torch.entry"
    out["entry_cached_s"] = [_start(code, 1, cache=cache)[0]
                             for _ in range(args.runs)]
    out["entry_cached_x8_s"] = _start(code, 8, cache=cache)[0]
    shutil.rmtree(cache, ignore_errors=True)
    out["entry_importtime_us"] = importtime_top("import tpushare_torch.entry",
                                                args.top)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
