"""Environment names of the device plugin's grant contract.

A copy of the names the tenant runtime reads from
``tpushare/utils/const.py``; the port keeps its own copy so that it
never imports the JAX package.
"""

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
