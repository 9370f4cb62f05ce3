"""The port's admission webhook (``tpushare_torch/scheduler/admission.py``)
against the JAX package's.

The reference's stories of ``tests/test_admission.py``, unchanged, over
the port's modules (``tests/torch_reference_stories.py``); then both
``serve_stack``s over HTTP (``tests/test_torch_extender_e2e.py``'s
``Pair``), fed the same fleet, answer a table of AdmissionReviews: pods
that fit, that ask more GiB than a card holds (96 GiB against 79 GiB
H100 cards), more cards than a node has, both resources, a malformed or
absent gang minimum, an unknown scoring policy, a pod that asks for no
card, a review of another kind, a malformed review, and an empty fleet
(fail-open). Each answer must be the same bytes on both.
"""

from __future__ import annotations

import json

import pytest

from tests import torch_reference_stories as R
from tests.test_torch_extender_e2e import H100, Pair
from tests.torch_obs_reset import fresh_port_obs  # noqa: F401
from tpushare.k8s.builders import make_node, make_pod
from tpushare_torch.k8s.fake import FakeApiServer
from tpushare_torch.utils import const

globals().update(R.pick(R.load("test_admission"), [
    "TestValidate", "TestAdmissionReviewWire", "TestScoringAnnotation"]))


@pytest.fixture
def api():
    """The reference's stories run over the port's fake apiserver."""
    return FakeApiServer()


def review(obj, uid: str = "rev-1") -> dict:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "object": obj}}


GANG = {const.ANN_POD_GROUP: "ring"}
REVIEWS = {
    "fits": review(make_pod("a", hbm=16)),
    "card_size": review(make_pod("b", hbm=79)),
    "over_a_card": review(make_pod("c", hbm=96)),
    "containers_sum": review(make_pod("d", container_hbm=[40, 40])),
    "whole_node": review(make_pod("e", chips=8)),
    "over_a_node": review(make_pod("f", chips=16)),
    "both": review(make_pod("g", hbm=8, chips=1)),
    "gang_ok": review(make_pod("h", chips=8, annotations={
        **GANG, const.ANN_POD_GROUP_MIN: "4"})),
    "gang_no_min": review(make_pod("i", chips=8, annotations=GANG)),
    "gang_bad_min": review(make_pod("j", chips=8, annotations={
        **GANG, const.ANN_POD_GROUP_MIN: "zero"})),
    "gang_zero_min": review(make_pod("k", chips=8, annotations={
        **GANG, const.ANN_POD_GROUP_MIN: "0"})),
    "gang_empty": review(make_pod("l", chips=8, annotations={
        const.ANN_POD_GROUP: ""})),
    "scoring_typo": review(make_pod("m", hbm=8, annotations={
        const.ANN_SCORING: "binpak"})),
    "scoring_spread": review(make_pod("n", hbm=8, annotations={
        const.ANN_SCORING: "spread"})),
    "no_card": review(make_pod("o")),
    "other_kind": review({"kind": "Deployment", "metadata": {"name": "x"}}),
    "no_request": {"apiVersion": "admission.k8s.io/v1beta1"},
    "null_request": {"request": None},
}


@pytest.fixture(scope="module")
def fleet():
    pair = Pair()
    for i in range(3):
        pair.create_node(make_node(f"h100-{i}", **H100))
    pair.idle()
    yield pair
    pair.close()


@pytest.mark.parametrize("case", sorted(REVIEWS))
def test_reviews_answer_byte_for_byte(fleet, case):
    outs = [side.post("/validate", REVIEWS[case]) for side in fleet.sides]
    assert outs[1] == outs[0]
    assert outs[0][0] == 200
    doc = json.loads(outs[0][1])
    denied = {"over_a_card", "containers_sum", "over_a_node", "both",
              "gang_bad_min", "gang_zero_min", "gang_empty", "scoring_typo"}
    assert doc["response"]["allowed"] is (case not in denied), doc
    if case == "over_a_card":
        assert "the largest chip in the fleet has 79 GiB" in (
            doc["response"]["status"]["message"])


def test_an_empty_fleet_fails_open():
    pair = Pair()
    try:
        outs = [side.post("/validate", REVIEWS["over_a_card"])
                for side in pair.sides]
        assert outs[1] == outs[0]
        assert json.loads(outs[0][1])["response"] == {"uid": "rev-1",
                                                      "allowed": True}
    finally:
        pair.close()
