"""Names of the grant contract: resources, annotations and env.

A copy of the names the tenant runtime, the allocation, the node daemon,
the grant watchdog and the scheduler extender use from
``tpushare/utils/const.py``, letter for letter: the extender reads what
the daemon writes under these names, and the daemon what the extender
writes. The port keeps its own copy so that it never imports the JAX
package.
"""

#: Extended resources the daemon advertises and pods request: HBM GiB
#: of one card, and whole cards. The names are the extender's and the
#: pod specs', whatever the accelerator.
HBM_RESOURCE = "tpushare.io/tpu-hbm"
CHIP_RESOURCE = "tpushare.io/tpu-chip"

#: Pod annotation naming the granted chip(s) by host index.
ANN_CHIP_IDX = "tpushare.io/chip-idx"

#: The bind-time grant record the extender writes: GiB granted, the
#: card's GiB, the two-phase flag ("false" at bind, "true" once the
#: device plugin's Allocate pinned the pod) and the nanosecond assume
#: time that orders the plugin's matching of pending pods.
ANN_HBM_POD = "tpushare.io/hbm-pod"
ANN_HBM_CHIP = "tpushare.io/hbm-chip"
ANN_ASSIGNED = "tpushare.io/assigned"
ANN_ASSUME_TIME = "tpushare.io/assume-time"
ASSIGNED_FALSE = "false"
ASSIGNED_TRUE = "true"
#: The decision trace's key on a bound pod, and the causal parent of that
#: decision (the scheduler's ``traceparent``): the extender writes both
#: with the grant and a rollback strips both with it. Observational only:
#: the ledger's rebuild never reads them.
ANN_TRACE_ID = "tpushare.io/trace-id"
ANN_TRACE_PARENT = "tpushare.io/trace-parent"

#: What a gang's rollback strips from a member so it schedules afresh.
GRANT_ANNOTATIONS = (ANN_CHIP_IDX, ANN_HBM_POD, ANN_HBM_CHIP,
                     ANN_ASSIGNED, ANN_ASSUME_TIME, ANN_TRACE_ID,
                     ANN_TRACE_PARENT)

#: What the grant watchdog writes onto a pod: its reported GiB in use
#: (one decimal), and "true" while that is above its grant.
ANN_HBM_USED = "tpushare.io/hbm-used"
ANN_OVERRUN = "tpushare.io/grant-overrun"

#: Node annotations the daemon publishes: per-card GiB ("79,79"), the
#: chip topology (empty on NVIDIA cards: no ICI mesh), the model, and
#: the multi-host slice the node belongs to.
ANN_NODE_CHIP_HBM = "tpushare.io/chip-hbm"
ANN_NODE_TOPOLOGY = "tpushare.io/topology"
ANN_NODE_TPU_TYPE = "tpushare.io/tpu-type"
ANN_NODE_SLICE = "tpushare.io/slice-id"

#: The whole multi-host slice's chip topology and this host's worker
#: index in it (row-major over the slice's host grid).
ANN_NODE_SLICE_TOPOLOGY = "tpushare.io/slice-topology"
ANN_NODE_WORKER = "tpushare.io/worker-index"

#: GKE's well-known labels, the fallbacks when the annotations above are
#: absent.
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
GKE_TPU_WORKER_LABEL = "cloud.google.com/gke-tpu-worker-id"
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"

#: Pod label naming the tenant a pod's usage is charged to (default: its
#: namespace).
LABEL_TENANT = "tpushare.io/tenant"

#: The ConfigMap of per-tenant quota specs (trusted only from
#: ``TPUSHARE_QUOTA_NAMESPACE``): each data key a tenant, or
#: QUOTA_DEFAULT_KEY for the spec of tenants without their own; each
#: value a JSON object of ``guaranteeHBM`` / ``limitHBM`` (GiB) and
#: ``guaranteeChips`` / ``limitChips``.
QUOTA_CONFIGMAP = "tpushare-quotas"
QUOTA_DEFAULT_KEY = "*"

#: The ConfigMap of pod-journey SLO objectives, trusted only from the
#: namespace ``TPUSHARE_SLO_NAMESPACE`` names (kube-system by default), as
#: the quota table is. Each data key is an objective's name, each value a
#: JSON object of ``signal`` (``pod_e2e`` or ``filter_latency``),
#: ``objective``, ``thresholdSeconds`` and an optional ``fastBurn``; with
#: no ConfigMap the defaults of ``slo/config.py`` hold.
SLO_CONFIGMAP = "tpushare-slos"

#: A gang member's pod group and its minimum size.
ANN_POD_GROUP = "tpushare.io/pod-group"
ANN_POD_GROUP_MIN = "tpushare.io/pod-group-min"
#: "false" (or "0", "no") keeps a committed gang's survivors running
#: when a member dies and the group falls below its minimum; by default
#: the controller deletes them so their cards return.
ANN_POD_GROUP_REAP = "tpushare.io/pod-group-reap"

#: A gang's requested slice shape in chip dims ("4x4x4").
ANN_SLICE_SHAPE = "tpushare.io/slice-shape"

#: Per-pod scoring policy for the prioritize verb and the chip picker,
#: and its legal values (the fleet default is ``TPUSHARE_SCORING``).
ANN_SCORING = "tpushare.io/scoring"
SCORING_POLICIES = ("binpack", "spread")

#: Chip index meaning "no assignment recorded".
NO_CHIP = -1

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

#: "true" while the pod's workload has a checkpoint save in flight (it
#: sets and clears it around the save). The defrag planner never moves
#: such a pod: an eviction then would lose the save and the progress
#: since the one before.
ANN_CKPT_IN_FLIGHT = "tpushare.io/checkpoint-in-flight"

#: The NVIDIA container runtime exposes the cards this names (host
#: indices) and numbers them from 0 inside the container.
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
#: The CUDA ordinals a process may use, as its container numbers them.
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
