"""Names of the device plugin's grant contract.

A copy of the names the tenant runtime and the allocation use from
``tpushare/utils/const.py``; the port keeps its own copy so that it
never imports the JAX package.
"""

#: Pod annotation naming the granted chip(s) by host index.
ANN_CHIP_IDX = "tpushare.io/chip-idx"

ENV_CHIP_IDX = "TPUSHARE_CHIP_IDX"
ENV_HBM_POD = "TPUSHARE_HBM_POD_GIB"
ENV_HBM_CHIP = "TPUSHARE_HBM_CHIP_GIB"

#: Where the tenant process writes its HBM-usage heartbeat (JSON file),
#: read back by the device plugin's grant watchdog.
ENV_USAGE_FILE = "TPUSHARE_USAGE_FILE"

#: Gang metadata injected so a member can join its gang's process group:
#: its group's name and size (the worker index and coordinator address
#: come from standard k8s mechanisms, read by
#: ``tpushare_torch.runtime.torchenv.distributed_spec``).
ENV_POD_GROUP = "TPUSHARE_POD_GROUP"
ENV_POD_GROUP_SIZE = "TPUSHARE_POD_GROUP_SIZE"

#: Coordinator address ("host:port") of the gang's process group; usually
#: the group's rank-0 headless-service DNS name.
ENV_COORDINATOR = "TPUSHARE_COORDINATOR"

#: Host directory under which each HBM-slice pod gets its own heartbeat
#: subdirectory (``<dir>/<pod uid>/usage.json``), mounted into that pod
#: alone.
USAGE_DIR_DEFAULT = "/var/run/tpushare/usage"

#: The NVIDIA container runtime exposes the cards this names (host
#: indices) and numbers them from 0 inside the container.
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
#: The CUDA ordinals a process may use, as its container numbers them.
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
