"""Start a gang of rank processes on this host, as an indexed Job and the
device plugin would start a gang's pods.

Each rank is a subprocess of ``python <argv>`` with the env a gang member
gets in a pod: the gang's name and size (``TPUSHARE_POD_GROUP``,
``TPUSHARE_POD_GROUP_SIZE``), its index (``JOB_COMPLETION_INDEX``), the
coordinator's address (``TPUSHARE_COORDINATOR``) and, with ``grant_gib``,
an HBM-slice grant on card 0 (``TPUSHARE_CHIP_IDX``,
``TPUSHARE_HBM_POD_GIB``, ``TPUSHARE_HBM_CHIP_GIB``). So the rank joins
its gang through ``torchenv.init_distributed``, driven by
``torchenv.distributed_spec``, as in a pod. ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` say that the ranks share this host.

With ``envs``, rank i runs instead in ``envs[i]`` (a gang member's
Allocate response, say) plus only the coordinator's address and its
``JOB_COMPLETION_INDEX``.

Each rank prints one JSON line as the last line of its standard output;
:func:`launch` returns them in rank order. A gang that is not done by its
deadline is killed and fails, and so is the rest of a gang once one rank
has failed (the others would wait for it in a collective).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from tpushare_torch.utils import const

#: The checkout that holds this package: ranks import it from there.
_ROOT = str(Path(__file__).resolve().parents[2])
#: The gang's pod-group name.
GROUP = "gang"


class GangError(RuntimeError):
    """A rank failed, printed no result, or the gang outran its deadline."""


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_env(group: str, size: int, index: int, coordinator: str,
             grant_gib: int | None = None,
             card_gib: int | None = None) -> dict[str, str]:
    """The env of gang member ``index``: what the device plugin injects
    (group, size, coordinator, grant) and what an indexed Job sets."""
    env = {
        const.ENV_POD_GROUP: group,
        const.ENV_POD_GROUP_SIZE: str(size),
        "JOB_COMPLETION_INDEX": str(index),
        const.ENV_COORDINATOR: coordinator,
        "LOCAL_RANK": str(index),
        "LOCAL_WORLD_SIZE": str(size),
    }
    if grant_gib is not None:
        env.update({const.ENV_CHIP_IDX: "0",
                    const.ENV_HBM_POD: str(grant_gib),
                    const.ENV_HBM_CHIP: str(card_gib)})
    return env


def _tail(path: Path, limit: int = 4000) -> str:
    text = path.read_text(encoding="utf-8", errors="replace")
    return text[-limit:]


def launch(argv: list[str], world: int, *, deadline_s: float,
           coordinator: str | None = None,
           grant_gib: int | None = None, card_gib: int | None = None,
           env: dict[str, str] | None = None,
           envs: list[dict[str, str]] | None = None) -> list[dict]:
    """Run ``python *argv`` as ``world`` ranks of one gang and return each
    rank's last stdout line, parsed as JSON, in rank order.

    ``coordinator`` defaults to a free port on localhost. Each rank runs
    in this process's environment, ``env`` added, and :func:`gang_env`
    (group, size, index, coordinator, and the grant of ``grant_gib``);
    or, with ``envs``, in ``envs[i]`` and ``env`` alone, to which the
    launcher adds only ``TPUSHARE_COORDINATOR`` and ``JOB_COMPLETION_INDEX``
    (``grant_gib`` and ``card_gib`` must then be None). Either way this
    checkout comes first on ``PYTHONPATH``. Raises :class:`GangError`
    (after killing every rank still running) when a rank exits nonzero or
    prints no JSON line, or when ``deadline_s`` seconds pass before every
    rank has exited."""
    if envs is not None and (len(envs) != world or grant_gib is not None
                             or card_gib is not None):
        raise ValueError(f"envs needs one env a rank ({len(envs)} for "
                         f"{world}) and no grant_gib or card_gib")
    coordinator = coordinator or f"localhost:{free_port()}"

    def rank_env(i: int) -> dict[str, str]:
        if envs is None:
            out = {**os.environ, **(env or {}),
                   **gang_env(GROUP, world, i, coordinator, grant_gib,
                              card_gib)}
        else:
            out = {**envs[i], **(env or {}),
                   const.ENV_COORDINATOR: coordinator,
                   "JOB_COMPLETION_INDEX": str(i)}
        out["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, out.get("PYTHONPATH")) if p)
        return out

    with tempfile.TemporaryDirectory(prefix="tpushare-gang-") as tmp:
        procs, outs, errs = [], [], []
        try:
            for i in range(world):
                out, err = Path(tmp, f"{i}.out"), Path(tmp, f"{i}.err")
                outs.append(out)
                errs.append(err)
                with open(out, "wb") as fo, open(err, "wb") as fe:
                    procs.append(subprocess.Popen(
                        [sys.executable, *argv],
                        env=rank_env(i),
                        stdin=subprocess.DEVNULL, stdout=fo, stderr=fe))
            end = time.monotonic() + deadline_s
            while None in [p.poll() for p in procs]:
                failed = [i for i, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed:
                    i = failed[0]
                    raise GangError(f"rank {i} exited with "
                                    f"{procs[i].returncode}:\n"
                                    f"{_tail(errs[i])}")
                if time.monotonic() > end:
                    raise GangError(
                        f"gang of {world} not done after {deadline_s} s; "
                        f"killed. rank 0 stderr:\n{_tail(errs[0])}")
                time.sleep(0.05)
            results = []
            for i, p in enumerate(procs):
                if p.returncode != 0:
                    raise GangError(f"rank {i} exited with {p.returncode}:"
                                    f"\n{_tail(errs[i])}")
                lines = outs[i].read_text(encoding="utf-8").splitlines()
                try:
                    results.append(json.loads(lines[-1]))
                except (IndexError, json.JSONDecodeError) as exc:
                    raise GangError(f"rank {i} printed no JSON line "
                                    f"({exc}):\n{_tail(outs[i])}\n"
                                    f"{_tail(errs[i])}") from exc
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
