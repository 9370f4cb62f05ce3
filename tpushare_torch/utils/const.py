"""Environment names of the device plugin's grant contract.

A copy of the four names the tenant runtime reads from
``tpushare/utils/const.py``; the port keeps its own copy so that it
never imports the JAX package.
"""

ENV_CHIP_IDX = "TPUSHARE_CHIP_IDX"
ENV_HBM_POD = "TPUSHARE_HBM_POD_GIB"
ENV_HBM_CHIP = "TPUSHARE_HBM_CHIP_GIB"

#: Where the tenant process writes its HBM-usage heartbeat (JSON file),
#: read back by the device plugin's grant watchdog.
ENV_USAGE_FILE = "TPUSHARE_USAGE_FILE"
