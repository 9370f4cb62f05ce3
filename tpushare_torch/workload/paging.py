"""KV-cache page and admission-bucket constants.

A copy of the constants of ``tpushare/workload/paging.py`` that the
slot server needs; the page pool itself comes with the paged server.
"""

from __future__ import annotations

import os

#: Tokens per KV-cache page (``TPUSHARE_KV_PAGE``, default 64).
PAGE_TOKENS: int = int(os.environ.get("TPUSHARE_KV_PAGE", "64"))

#: Admission buckets: prompts are padded up to one of these lengths.
PROMPT_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048)


def pages_for(tokens: int, page_tokens: int = PAGE_TOKENS) -> int:
    """Pages needed to hold ``tokens`` KV rows (ceil division)."""
    if page_tokens <= 0:
        raise ValueError(f"page_tokens must be > 0, got {page_tokens}")
    if tokens <= 0:
        return 0
    return -(-tokens // page_tokens)
