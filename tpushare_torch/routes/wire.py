"""Wire-format fast paths for the scheduling verbs.

The port's copy of ``tpushare/routes/wire.py``. At 1024 nodes the
extender's wire clock is dominated by the framing around the verbs, not
the verbs: the same pod document is parsed again on every filter and
prioritize call, and a 1k-candidate response is encoded twice. Both are
cut on the repeat shapes kube-scheduler sends, with byte-exact fallbacks
to the general parser and encoder for everything else:

* :func:`parse_extender_args` splits the body at ``NodeNames`` and looks
  the pod segment up in a bounded memo keyed by its exact bytes; any
  other layout falls back to one ``json.loads``. Memoized ``Pod`` objects
  are shared across requests and read only.
* :func:`encode_filter_result` and :func:`encode_host_priorities` build
  the response from cached per-name byte fragments, byte-equal to
  ``json.dumps(..., separators=(",", ":"))`` of the general form.

Caches are plain dicts changed under the GIL and cleared at their cap.
"""

from __future__ import annotations

import json
from typing import Any

from tpushare_torch.api.extender import (ExtenderArgs, ExtenderFilterResult,
                                         HostPriority)
from tpushare_torch.api.objects import Pod

#: Distinct pod documents memoized at once. A scheduler drives one
#: pod's sequence at a time per cycle; 64 covers deep backlogs.
POD_MEMO_CAP = 64
#: Distinct JSON-encoded name/reason fragments kept. Names are the
#: fleet (bounded); reasons are a small family of templates.
FRAG_CAP = 4096

#: pod-segment bytes -> parsed Pod (shared, read-only).
_pod_memo: dict[bytes, Pod] = {}
#: node name -> its JSON encoding as bytes (b'"name"').
_name_frag: dict[str, bytes] = {}
#: prioritize entry prefix: name -> b'{"Host":"name","Score":'.
_host_frag: dict[str, bytes] = {}


def memo_stats() -> dict[str, int]:
    """The memos' fill, for ``/debug/http``."""
    return {"podMemo": len(_pod_memo), "nameFragments": len(_name_frag),
            "hostFragments": len(_host_frag)}


# ------------------------------------------------------------------------- #
# Parse fast path
# ------------------------------------------------------------------------- #

_POD_PREFIXES = (b'{"Pod":', b'{"Pod": ')
_NODENAMES_KEY = b'"NodeNames"'


def _fast_parse(raw: bytes) -> ExtenderArgs | None:
    """The repeat-shape parse: split the body at the ``NodeNames`` key,
    memo-hit the pod segment, parse only the candidate list. ``None``
    means "not this shape" — the caller falls back to the general
    parser, so a miss can never change semantics, only speed."""
    if not raw.startswith(_POD_PREFIXES):
        return None
    # The real NodeNames key follows the pod document in this layout;
    # rfind survives the same substring hiding inside pod annotation
    # strings (any mis-split fails the segment parse and falls back).
    split = raw.rfind(_NODENAMES_KEY)
    if split <= 0:
        return None
    comma = raw.rfind(b",", 0, split)
    if comma <= 0:
        return None
    pod_bytes = raw[raw.index(b":") + 1:comma]
    pod = _pod_memo.get(pod_bytes)
    if pod is None:
        try:
            doc = json.loads(pod_bytes)
        except ValueError:
            return None
        if not isinstance(doc, dict):
            return None
        pod = Pod(doc)
        if len(_pod_memo) >= POD_MEMO_CAP:
            _pod_memo.clear()
        _pod_memo[pod_bytes] = pod
    try:
        rest = json.loads(b"{" + raw[comma + 1:])
    except ValueError:
        return None
    if not isinstance(rest, dict):
        return None
    names = rest.get("NodeNames")
    if not isinstance(names, list):
        return None
    if rest.get("Nodes") or rest.get("nodes"):
        # Mixed Nodes+NodeNames body: rare enough to take the slow
        # path rather than replicate from_json's precedence here.
        return None
    return ExtenderArgs(pod=pod, node_names=names, nodes=None)


def parse_extender_args(raw: bytes, doc: dict | None = None) -> ExtenderArgs:
    """Parse a filter/prioritize body: fast path on the repeat shape,
    ``ExtenderArgs.from_json`` otherwise. ``doc`` short-circuits to the
    general parser when the caller already holds the parsed body."""
    if doc is None:
        args = _fast_parse(raw)
        if args is not None:
            return args
        doc = json.loads(raw)
        if not isinstance(doc, dict):
            raise ValueError(
                f"request body must be a JSON object, got "
                f"{type(doc).__name__}")
    return ExtenderArgs.from_json(doc)


# ------------------------------------------------------------------------- #
# Encode fast path
# ------------------------------------------------------------------------- #


def _frag(name: str) -> bytes:
    frag = _name_frag.get(name)
    if frag is None:
        frag = json.dumps(name, separators=(",", ":")).encode()
        if len(_name_frag) >= FRAG_CAP:
            _name_frag.clear()
        _name_frag[name] = frag
    return frag


def _host_prefix(name: str) -> bytes:
    frag = _host_frag.get(name)
    if frag is None:
        frag = b'{"Host":' + _frag(name) + b',"Score":'
        if len(_host_frag) >= FRAG_CAP:
            _host_frag.clear()
        _host_frag[name] = frag
    return frag


def _dumps(doc: Any) -> bytes:
    return json.dumps(doc, separators=(",", ":")).encode()


def encode_filter_result(result: ExtenderFilterResult) -> bytes:
    """The filter response as bytes, assembled incrementally from
    cached name fragments — byte-compatible with
    ``json.dumps(result.to_json(), separators=(",", ":"))``. The full
    ``Nodes`` form takes the general encoder (its payload is the node
    documents, not the name list)."""
    if result.nodes is not None:
        return _dumps(result.to_json())
    out = [b'{"FailedNodes":']
    if result.failed_nodes:
        # Reasons come from a small template family but carry request-
        # specific numbers; one C-level dumps of the dict beats
        # fragment assembly here.
        out.append(_dumps(result.failed_nodes))
    else:
        out.append(b"{}")
    out.append(b',"Error":')
    out.append(_dumps(result.error))
    out.append(b',"NodeNames":')
    if result.node_names is None:
        out.append(b"null")
    elif result.node_names:
        out.append(b"[" + b",".join(
            _frag(n) for n in result.node_names) + b"]")
    else:
        out.append(b"[]")
    out.append(b',"Nodes":null}')
    return b"".join(out)


def encode_host_priorities(entries: list[HostPriority]) -> bytes:
    """The prioritize response (a bare JSON array of Host/Score pairs)
    from cached per-host prefixes — byte-compatible with the general
    encoder over ``host_priority_list_to_json``."""
    if not entries:
        return b"[]"
    return b"[" + b",".join(
        _host_prefix(e.host) + str(e.score).encode() + b"}"
        for e in entries) + b"]"
