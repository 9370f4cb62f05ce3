"""Validating admission webhook: reject impossible TPU requests at
CREATE time instead of letting them pend forever.

The port's copy of ``tpushare/scheduler/admission.py``; its responses are
the reference's, byte for byte.

gpushare had no admission control: its oversize demo pod (a 16276-GiB
request) just sits Pending with a scheduler event the user must know to
go look for. This webhook closes
that gap: the apiserver POSTs an ``AdmissionReview`` for every pod
CREATE, and requests that can never be satisfied by the current fleet —
an HBM slice larger than the largest chip, a chip count no node has, a
malformed gang annotation — are rejected synchronously with a message
saying exactly why and what the fleet's limits are. Self-contradictory
manifests (both resource types on one pod) are rejected as deliberate
policy: the allocator would silently ignore the HBM limit, which is
worse than an explicit error at submit time.

Checks are *fleet-shape* checks, not capacity checks: a request that
merely doesn't fit right now is left Pending for the scheduler/preemptor
to resolve (rejecting on transient capacity would turn autoscaling and
churn into admission failures). Only requests impossible under the
current fleet's geometry are refused; if the ledger knows no TPU nodes
at all the webhook allows everything (fail-open, matching the
``failurePolicy: Ignore`` registration in
``config/tpushare-admission-webhook.yaml``).
"""

from __future__ import annotations

import logging
from typing import Callable

from tpushare_torch.api.objects import Pod
from tpushare_torch.cache.cache import SchedulerCache
from tpushare_torch.utils import const
from tpushare_torch.utils import node as nodeutils
from tpushare_torch.utils import pod as podutils

log = logging.getLogger(__name__)


class Admission:
    name = "tpushare-admission"

    def __init__(self, cache: SchedulerCache,
                 node_lister: Callable[[], list] | None = None) -> None:
        self.cache = cache
        #: enumerate fleet nodes (informer lister); cache.get_node_infos
        #: only knows nodes already touched by a filter call.
        self.node_lister = node_lister

    # ------------------------------------------------------------------ #
    # Fleet geometry
    # ------------------------------------------------------------------ #

    def _fleet_shape(self) -> tuple[int, int, int]:
        """(largest single chip GiB, most chips on one node, nodes seen).

        Reads chip capacities straight off the lister's node documents —
        NOT through ``cache.get_node_info`` — so a CREATE on a
        5000-node cluster costs one in-memory list walk, never builds
        ledgers for non-TPU nodes, and never inflates metrics/inspect
        with 0-chip entries."""
        max_chip, max_chips, nodes = 0, 0, 0
        if self.node_lister is not None:
            node_docs = self.node_lister()
            cap_lists = [nodeutils.get_chip_capacities(n)
                         for n in node_docs]
        else:
            cap_lists = [[c.total_hbm for c in info.chips.values()]
                         for info in self.cache.get_node_infos()]
        for caps in cap_lists:
            if not caps:
                continue
            nodes += 1
            max_chip = max(max_chip, max(caps))
            max_chips = max(max_chips, len(caps))
        return max_chip, max_chips, nodes

    # ------------------------------------------------------------------ #
    # Validation
    # ------------------------------------------------------------------ #

    def validate(self, pod: Pod) -> tuple[bool, str]:
        """(allowed, reason). Only rejects requests that are impossible
        under the current fleet geometry or self-contradictory."""
        req_hbm = podutils.get_hbm_from_pod_resource(pod)
        req_chips = podutils.get_chips_from_pod_resource(pod)

        if req_hbm <= 0 and req_chips <= 0:
            return True, ""  # not a TPU pod: none of our business

        if req_hbm > 0 and req_chips > 0:
            return False, (
                f"a pod may request {const.HBM_RESOURCE} (an HBM slice of "
                f"one chip) or {const.CHIP_RESOURCE} (whole chips), not "
                "both — the grant protocols are mutually exclusive")

        group = pod.annotations.get(const.ANN_POD_GROUP)
        if group is not None:
            if not group:
                return False, (
                    f"annotation {const.ANN_POD_GROUP} must not be empty")
            # An ABSENT min is legal — the planner defaults it to 1
            # (utils/pod.get_pod_group + _get_group clamp), and manifests
            # that scheduled fine before this webhook was installed must
            # keep working after. Only an explicit
            # value that is unparseable or < 1 is a manifest bug.
            raw_min = pod.annotations.get(const.ANN_POD_GROUP_MIN)
            if raw_min is not None:
                try:
                    minimum = int(raw_min)
                except ValueError:
                    minimum = -1
                if minimum < 1:
                    return False, (
                        f"gang pod (annotation {const.ANN_POD_GROUP}="
                        f"{group!r}) has explicit {const.ANN_POD_GROUP_MIN}="
                        f"{raw_min!r}; when set it must be an integer >= 1 "
                        "(omit it to default to 1)")

        scoring = pod.annotations.get(const.ANN_SCORING)
        if scoring is not None and scoring not in const.SCORING_POLICIES:
            # The prioritizer falls back to the fleet default on unknown
            # values (a typo must not break scoring when this webhook is
            # absent), but with the webhook installed the typo is caught
            # where the user can see it: at CREATE.
            return False, (
                f"annotation {const.ANN_SCORING}={scoring!r} is not a "
                f"scoring policy; expected one of "
                f"{', '.join(const.SCORING_POLICIES)}")

        max_chip, max_chips, nodes = self._fleet_shape()
        if nodes == 0:
            return True, ""  # fleet unknown: fail open

        # The allocator places a pod's AGGREGATE HBM on one chip (the
        # containers then share that chip's grant — see
        # nodeinfo.assume/pick_chips summing across containers), so the
        # sum is what must fit the largest chip.
        if req_hbm > max_chip:
            return False, (
                f"pod requests {req_hbm} GiB {const.HBM_RESOURCE} "
                f"(summed across containers) but the largest chip in the "
                f"fleet has {max_chip} GiB — a pod's HBM slice lives on a "
                f"single chip (ask for whole chips via "
                f"{const.CHIP_RESOURCE} to span chips)")
        if req_chips > max_chips:
            return False, (
                f"pod requests {req_chips} {const.CHIP_RESOURCE} but the "
                f"largest node in the fleet has {max_chips} chips — "
                "multi-host jobs are expressed as a gang of per-host pods "
                f"(annotations {const.ANN_POD_GROUP}/"
                f"{const.ANN_POD_GROUP_MIN}), not one giant pod")
        return True, ""

    # ------------------------------------------------------------------ #
    # AdmissionReview wire protocol
    # ------------------------------------------------------------------ #

    def handle(self, review: dict) -> dict:
        """Consume a ``admission.k8s.io/v1 AdmissionReview`` request and
        return the response form. Malformed reviews are allowed through
        (fail-open: this webhook is an early-warning, not a gate the
        cluster's health depends on)."""
        request = review.get("request") or {}
        uid = request.get("uid", "")
        obj = request.get("object") or {}
        allowed, reason = True, ""
        if obj.get("kind", "Pod") == "Pod":
            try:
                allowed, reason = self.validate(Pod(obj))
            except Exception:
                log.exception("admission validate crashed; allowing")
        response: dict = {"uid": uid, "allowed": allowed}
        if not allowed:
            response["status"] = {"code": 422, "message": reason}
            log.info("admission rejected pod %s/%s: %s",
                     obj.get("metadata", {}).get("namespace", "default"),
                     obj.get("metadata", {}).get("name", "?"), reason)
        return {
            "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
            "kind": "AdmissionReview",
            "response": response,
        }
