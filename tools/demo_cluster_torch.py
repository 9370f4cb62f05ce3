"""Run the PyTorch port's extender stack against a simulated fleet.

The port's twin of ``tools/demo_cluster.py``: the same flags and the same
stdin protocol, over the port's stack (``tpushare_torch``): a fake
apiserver is populated with nodes, the port's controller + HTTP extender
serve on ``PORT``, and a tiny scheduler loop binds any pod you create
through the HTTP API — so you can drive filter/bind/inspect with curl.
The port's continuous profiler is armed from the environment
(``TPUSHARE_PROFILE``, on by default), as its entry point arms it.

    python tools/demo_cluster_torch.py [--port 39999] [--nodes 2]

stdin takes ``NAME HBM_GIB`` (e.g. ``w1 8``) or ``NAME <N>c`` for N whole
chips (e.g. ``ring 4c``).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

from tpushare_torch.cmd.main import serve_stack, shutdown_stack
from tpushare_torch.k8s.builders import make_node, make_pod
from tpushare_torch.k8s.fake import FakeApiServer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=39999)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--hbm", type=int, default=16)
    ap.add_argument("--tpu-type", default="v5e")
    ap.add_argument("--topology", default="2x2x1")
    args = ap.parse_args()

    api = FakeApiServer()
    for i in range(args.nodes):
        api.create_node(make_node(
            f"{args.tpu_type}-{i}", chips=args.chips, hbm_per_chip=args.hbm,
            topology=args.topology, tpu_type=args.tpu_type))

    # The demo is an operator surface: arm the continuous profiler the
    # way the real entrypoint does (TPUSHARE_PROFILE, default on), so
    # /debug/hotspots and /debug/profile/continuous work out of the box.
    from tpushare_torch import profiling
    profiling.arm_from_env()

    stack, server = serve_stack(api, ("127.0.0.1", args.port))
    print(f"extender listening on http://127.0.0.1:{args.port} with "
          f"{args.nodes} simulated {args.tpu_type} nodes "
          f"({args.chips} chips x {args.hbm} GiB)", flush=True)
    print("create pods on stdin: NAME HBM_GIB (e.g. 'demo1 8'), or "
          "NAME <N>c for N whole chips (e.g. 'ring 4c' — stays Pending "
          "when fragmented; watch /debug/defrag); they are created in "
          "the fake apiserver and scheduled via the HTTP API", flush=True)

    import urllib.request

    def schedule(name: str, hbm: int, chips: int = 0) -> None:
        pod = api.create_pod(make_pod(name, hbm=hbm, chips=chips))
        names = [n.name for n in api.list_nodes()]
        req = urllib.request.Request(
            f"http://127.0.0.1:{args.port}/tpushare-scheduler/filter",
            data=json.dumps({"Pod": pod.raw, "NodeNames": names}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            result = json.loads(resp.read())
        if not result["NodeNames"]:
            print(f"pod {name}: unschedulable: {result['FailedNodes']}",
                  flush=True)
            return
        # Full verb sequence like the real scheduler: prioritize the
        # survivors and bind the top-scoring host (this is what makes
        # TPUSHARE_SCORING visible in the demo).
        req = urllib.request.Request(
            f"http://127.0.0.1:{args.port}/tpushare-scheduler/prioritize",
            data=json.dumps({"Pod": pod.raw,
                             "NodeNames": result["NodeNames"]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            ranked = json.loads(resp.read())
        target = max(ranked, key=lambda e: e["Score"])["Host"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{args.port}/tpushare-scheduler/bind",
            data=json.dumps({"PodName": name, "PodNamespace": "default",
                             "PodUID": pod.uid, "Node": target}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as resp:
                json.loads(resp.read())
            print(f"pod {name}: bound to {target}", flush=True)
        except urllib.error.HTTPError as e:
            print(f"pod {name}: bind failed: {e.read().decode()}", flush=True)

    try:
        for line in sys.stdin:
            parts = line.split()
            if len(parts) == 2 and parts[1].isdigit():
                schedule(parts[0], int(parts[1]))
            elif (len(parts) == 2 and parts[1].endswith("c")
                    and parts[1][:-1].isdigit()):
                schedule(parts[0], 0, chips=int(parts[1][:-1]))
            elif parts:
                print(f"usage: NAME HBM_GIB | NAME <N>c (got {line!r})",
                      flush=True)
    except KeyboardInterrupt:
        pass
    shutdown_stack(stack, server)


if __name__ == "__main__":
    main()
