"""Inference serving: KV-cache prefill, single-token decode, and the
continuous-batching slot server, ported from ``tpushare/workload/serving.py``.

PyTorch runs eagerly, so every index is a concrete value: where the JAX
code clamps inside ``jit`` (``dynamic_update_slice``), this module
validates and raises with the same messages. Cache writes are in place:
the cache and server state handed to a function are consumed, and the
returned ones are the same objects, updated. Everything runs under
``torch.inference_mode()``.

Sampling draws from an explicit ``torch.Generator`` on the logits'
device; it cannot reproduce JAX's threefry bits, only the contract
(temperature 0 is greedy, the same generator state gives the same
stream).
"""

from __future__ import annotations

import torch

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import model as M
from tpushare_torch.workload.paging import PROMPT_BUCKETS


def init_cache(cfg: M.ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> list[dict]:
    """Preallocated per-layer KV slots, [B, max_len, H, D] each."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_heads, cfg.head_dim)
    with torch.inference_mode():
        return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
                for _ in range(cfg.n_layers)]


def cache_hbm_bytes(cfg: M.ModelConfig, batch: int, max_len: int) -> int:
    """What the cache itself costs: 2 (K and V) x layers x B x L x H x D
    x itemsize."""
    per = batch * max_len * cfg.n_heads * cfg.head_dim
    return 2 * cfg.n_layers * per * cfg.dtype.itemsize


def _check_temperature(temperature: float, generator) -> None:
    if temperature < 0:
        raise ValueError(
            f"temperature must be >= 0, got {temperature} "
            "(a negative value would silently mean greedy)")
    if temperature > 0 and generator is None:
        raise ValueError(
            "temperature > 0 requires an explicit torch.Generator")


def _pick(logits: torch.Tensor, temperature: float,
          generator: torch.Generator | None) -> torch.Tensor:
    """Next token from [B, vocab] logits: argmax at temperature 0, else a
    draw from softmax(logits / temperature)."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def prefill(params: M.Transformer, tokens: torch.Tensor, cache: list[dict],
            attn_fn=None) -> tuple[torch.Tensor, list[dict]]:
    """Run the prompt [B, L] through the model, filling ``cache[:, :L]``
    in place. Returns ``(logits [B, vocab] for the last position, cache)``."""
    if attn_fn is None:
        attn_fn = M.causal_attention
    B, L = tokens.shape
    if L > cache[0]["k"].shape[1]:
        raise ValueError(
            f"prompt length {L} exceeds cache max_len "
            f"{cache[0]['k'].shape[1]}")
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    x = params.embed[tokens]
    for block, slots in zip(params.blocks, cache):
        q, k, v = M.qkv_proj(block, x, positions)
        slots["k"][:, :L] = k
        slots["v"][:, :L] = v
        x = x + M.out_proj(block, attn_fn(q, k, v))
        x = M.ffn_block(block, x)
    return M.logits_from_hidden(params, x[:, -1]), cache


@torch.inference_mode()
def decode_step(params: M.Transformer, cache: list[dict],
                token: torch.Tensor, pos: int
                ) -> tuple[torch.Tensor, list[dict]]:
    """One generated token: write ``token``'s K/V at slot ``pos`` and
    attend it against the cached prefix (the offset form of the causal
    mask, ``pos >= slot``). Returns (next-token logits, cache)."""
    pos = int(pos)
    max_len = cache[0]["k"].shape[1]
    if not 0 <= pos < max_len:
        raise ValueError(f"decode position {pos} outside cache max_len "
                         f"{max_len}")
    B = token.shape[0]
    positions = torch.full((B, 1), pos, device=token.device)
    x = params.embed[token][:, None, :]
    for block, slots in zip(params.blocks, cache):
        q, k, v = M.qkv_proj(block, x, positions)
        slots["k"][:, pos] = k[:, 0]
        slots["v"][:, pos] = v[:, 0]
        out = M.causal_attention(q, slots["k"], slots["v"], q_offset=pos)
        x = x + M.out_proj(block, out)
        x = M.ffn_block(block, x)
    return M.logits_from_hidden(params, x[:, 0]), cache


@torch.inference_mode()
def generate(params: M.Transformer, tokens: torch.Tensor,
             cfg: M.ModelConfig, n_new: int, max_len: int, attn_fn=None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Prompt [B, L] -> [B, L + n_new] token ids.

    ``temperature == 0`` is greedy argmax; ``> 0`` samples each token
    from ``softmax(logits / temperature)`` with ``generator``, which is
    required then. ``attn_fn`` is the prefill attention (decode attends
    one query against the cache); pass ``flash_attention`` for the
    kernel."""
    _check_temperature(temperature, generator)
    B, L = tokens.shape
    if L + n_new > max_len:
        raise ValueError(
            f"L + n_new = {L + n_new} exceeds cache max_len {max_len}")
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    logits, cache = prefill(params, tokens, cache, attn_fn=attn_fn)
    out = []
    for pos in range(L, L + n_new):
        token = _pick(logits, temperature, generator).to(tokens.dtype)
        out.append(token)
        logits, cache = decode_step(params, cache, token, pos)
    return torch.cat([tokens, torch.stack(out, dim=1)], dim=1)


# --------------------------------------------------------------------------
# Continuous decode admission (per-slot positions + slot recycling)
# --------------------------------------------------------------------------
#
# State is a fixed [SLOTS, max_len] cache plus per-slot position,
# activity and last-token vectors. ``admit`` prefills a prompt into a
# free slot mid-flight; ``serve_chunk`` advances every active slot by n
# tokens, writing each step's K/V into a small per-chunk ring and
# flushing the ring into the cache once per chunk.


def init_server_state(cfg: M.ModelConfig, slots: int, max_len: int,
                      device: str | torch.device = "cuda") -> dict:
    """Fresh all-slots-free server state."""
    dev = resolve_device(device)
    with torch.inference_mode():
        return {
            "cache": init_cache(cfg, slots, max_len, device=dev),
            "pos": torch.zeros(slots, dtype=torch.long, device=dev),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
            "token": torch.zeros(slots, dtype=torch.long, device=dev),
        }


@torch.inference_mode()
def admit(params: M.Transformer, state: dict, prompt: torch.Tensor,
          slot: int, attn_fn=None, true_len: int | None = None,
          temperature: float = 0.0,
          generator: torch.Generator | None = None) -> dict:
    """Prefill ``prompt`` [Lp] into ``slot`` and mark it active.

    A prompt padded at its end to a bucket passes its real length as
    ``true_len``: causal prefill keeps real tokens from seeing the pads,
    the slot's position starts at ``true_len``, and the first token
    comes from position ``true_len - 1``. ``temperature``/``generator``
    sample that first token (``generate``'s semantics)."""
    Lp = prompt.shape[0]
    max_len = state["cache"][0]["k"].shape[1]
    slots = state["pos"].shape[0]
    s = int(slot)
    if not 0 <= s < slots:
        raise ValueError(
            f"slot {s} outside [0, {slots}) — an out-of-range slot "
            f"would silently corrupt slot {slots - 1}'s cache")
    if Lp > max_len:
        raise ValueError(
            f"prompt length {Lp} exceeds cache max_len {max_len}")
    if true_len is None and Lp >= max_len:
        raise ValueError(
            f"prompt length {Lp} leaves no decode room in cache "
            f"max_len {max_len} (need Lp < max_len, or pass true_len)")
    tl = Lp if true_len is None else int(true_len)
    if not 1 <= tl <= Lp:
        raise ValueError(
            f"true_len {tl} outside [1, {Lp}] (the padded prompt's "
            f"length) — a clamped index would silently corrupt the "
            f"stream")
    if tl >= max_len:
        raise ValueError(
            f"true_len {tl} leaves no decode room in cache "
            f"max_len {max_len}")
    _check_temperature(temperature, generator)
    if attn_fn is None:
        attn_fn = M.causal_attention
    tokens = prompt[None, :]
    positions = torch.arange(Lp, device=prompt.device)[None, :]
    x = params.embed[tokens]
    for block, slots_ in zip(params.blocks, state["cache"]):
        q, k, v = M.qkv_proj(block, x, positions)
        slots_["k"][s, :Lp] = k[0]
        slots_["v"][s, :Lp] = v[0]
        x = x + M.out_proj(block, attn_fn(q, k, v))
        x = M.ffn_block(block, x)
    logits = M.logits_from_hidden(params, x[:, tl - 1])
    state["pos"][s] = tl
    state["active"][s] = True
    state["token"][s] = _pick(logits, temperature, generator)[0]
    return state


@torch.inference_mode()
def release(state: dict, slot: int) -> dict:
    """Retire ``slot``; its cache rows are recycled by the next admit."""
    state["active"][int(slot)] = False
    return state


def _fused_chunk_step(params: M.Transformer, cache: list[dict],
                      base_mask: torch.Tensor, n_steps: int,
                      pos: torch.Tensor, active: torch.Tensor,
                      token: torch.Tensor, ring: list[dict], t: int,
                      temperature: torch.Tensor | None,
                      generator: torch.Generator | None):
    """One token for every active slot. Each slot attends its committed
    prefix (cache rows before the chunk, ``base_mask``) plus this chunk's
    ring rows ``0..t``, under one softmax over the concatenated scores.
    Inactive slots compute masked work but neither advance nor emit."""
    max_len = cache[0]["k"].shape[1]
    x = params.embed[token][:, None, :]                  # [B, 1, d]
    positions = pos[:, None]
    ring_mask = torch.arange(n_steps, device=pos.device)[None, :] <= t
    for block, slots_, rg in zip(params.blocks, cache, ring):
        q, k, v = M.qkv_proj(block, x, positions)
        rg["k"][:, t] = k[:, 0]
        rg["v"][:, t] = v[:, 0]
        scale = 1.0 / q.shape[-1] ** 0.5
        qf = q.float()
        s_main = torch.einsum("bqhd,bkhd->bhqk", qf,
                              slots_["k"].float()) * scale
        s_ring = torch.einsum("bqhd,bkhd->bhqk", qf, rg["k"].float()) * scale
        s_main = s_main.masked_fill(~base_mask[:, None, None, :], -1e30)
        s_ring = s_ring.masked_fill(~ring_mask[None, None, :, :], -1e30)
        probs = torch.softmax(torch.cat([s_main, s_ring], dim=-1), dim=-1)
        # Masked entries softmax to exactly 0, so stale cache rows and
        # unwritten ring rows contribute nothing.
        p_main = probs[..., :max_len].to(v.dtype)
        p_ring = probs[..., max_len:].to(v.dtype)
        out = (torch.einsum("bhqk,bkhd->bqhd", p_main, slots_["v"])
               + torch.einsum("bhqk,bkhd->bqhd", p_ring, rg["v"]))
        x = x + M.out_proj(block, out)
        x = M.ffn_block(block, x)
    logits = M.logits_from_hidden(params, x[:, 0])
    nxt = logits.argmax(dim=-1)
    if temperature is not None:
        scaled = logits / temperature.clamp_min(1e-6)[:, None]
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=generator)[:, 0]
        nxt = torch.where(temperature > 0, sampled, nxt)
    token = torch.where(active, nxt, token)
    emitted = torch.where(active, token, torch.full_like(token, -1))
    # A slot whose next write would land past max_len self-retires.
    pos = torch.where(active, pos + 1, pos)
    active = active & (pos < max_len)
    return pos, active, token, emitted


@torch.inference_mode()
def serve_chunk(params: M.Transformer, state: dict, n_steps: int,
                temperature: torch.Tensor | None = None,
                generator: torch.Generator | None = None
                ) -> tuple[dict, torch.Tensor]:
    """Advance every active slot ``n_steps`` tokens. Returns (state,
    emitted [n_steps, SLOTS]); emitted[t, b] is slot b's token at step
    t, or -1 while the slot was inactive.

    ``temperature`` [SLOTS] enables per-slot sampling (0 entries stay
    greedy) from ``generator``, which is required then."""
    slots = state["pos"].shape[0]
    if temperature is not None:
        if generator is None:
            raise ValueError(
                "temperature requires an explicit torch.Generator")
        temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                      device=state["pos"].device)
        if temperature.shape != (slots,):
            raise ValueError(
                f"temperature must be a per-slot [{slots}] vector "
                f"(0 entries stay greedy), got shape "
                f"{tuple(temperature.shape)}")
        if bool((temperature < 0).any()):
            raise ValueError(
                "negative temperature entries would silently mean "
                "greedy; use 0 for greedy slots")
    cache, start_pos = state["cache"], state["pos"]
    max_len, H, D = cache[0]["k"].shape[1:]
    dev = start_pos.device
    base_mask = torch.arange(max_len, device=dev)[None, :] < start_pos[:, None]
    ring = [{"k": torch.zeros((slots, n_steps, H, D), dtype=c["k"].dtype,
                              device=dev),
             "v": torch.zeros((slots, n_steps, H, D), dtype=c["v"].dtype,
                              device=dev)} for c in cache]
    pos, active, token = start_pos, state["active"], state["token"]
    emitted = []
    for t in range(n_steps):
        pos, active, token, em = _fused_chunk_step(
            params, cache, base_mask, n_steps, pos, active, token, ring, t,
            temperature, generator)
        emitted.append(em)
    emitted = torch.stack(emitted)                      # [C, B]

    # Flush the ring into the cache once per chunk: row (b, t) goes to
    # cache row start + t; steps where the slot was inactive are masked
    # out before the index write.
    valid = (emitted >= 0).T                            # [B, C]
    rows = start_pos[:, None] + torch.arange(n_steps, device=dev)[None, :]
    b_idx = torch.arange(slots, device=dev)[:, None].expand(slots, n_steps)
    bi, ri = b_idx[valid], rows[valid]
    for slots_, rg in zip(cache, ring):
        slots_["k"][bi, ri] = rg["k"][valid]
        slots_["v"][bi, ri] = rg["v"][valid]
    state.update(pos=pos, active=active, token=token)
    return state, emitted


# --------------------------------------------------------------------------
# Bucketed admission
# --------------------------------------------------------------------------

#: bucket length -> {"admits": n}. The JAX package also counts jit-cache
#: misses per bucket; eager PyTorch compiles nothing per shape, so there
#: is nothing to count. Single-writer: the loop that owns admissions.
_ADMISSION_STATS: dict[int, dict[str, int]] = {}


def bucket_len(n: int, buckets: tuple[int, ...] = PROMPT_BUCKETS,
               max_len: int | None = None) -> int:
    """Smallest bucket >= ``n``, capped at ``max_len`` when given (padding
    to the cache is legal, past it is not). Raises when the prompt
    exceeds the cache, or every bucket with no ``max_len`` to fall back
    on."""
    if max_len is not None and n > max_len:
        raise ValueError(
            f"prompt length {n} exceeds cache max_len {max_len}")
    for b in sorted(buckets):
        if b >= n:
            return b if max_len is None else min(b, max_len)
    if max_len is not None:
        return max_len
    raise ValueError(
        f"prompt length {n} exceeds the largest admission bucket "
        f"{max(buckets)}")


def pad_to_bucket(prompt: torch.Tensor,
                  buckets: tuple[int, ...] = PROMPT_BUCKETS,
                  max_len: int | None = None) -> tuple[torch.Tensor, int]:
    """(prompt zero-padded to its bucket, true_len) for :func:`admit`."""
    n = prompt.shape[0]
    b = bucket_len(n, buckets, max_len)
    if b == n:
        return prompt, n
    return torch.cat([prompt, prompt.new_zeros(b - n)]), n


def admit_bucketed(params: M.Transformer, state: dict, prompt: torch.Tensor,
                   slot: int, *, buckets: tuple[int, ...] = PROMPT_BUCKETS,
                   attn_fn=None, temperature: float = 0.0,
                   generator: torch.Generator | None = None) -> dict:
    """:func:`admit` through the bucket table: pad to the bucket, pass the
    real length as ``true_len``, and count the admission per bucket."""
    max_len = state["cache"][0]["k"].shape[1]
    padded, tl = pad_to_bucket(prompt, buckets, max_len)
    out = admit(params, state, padded, slot, attn_fn=attn_fn, true_len=tl,
                temperature=temperature, generator=generator)
    entry = _ADMISSION_STATS.setdefault(int(padded.shape[0]), {"admits": 0})
    entry["admits"] += 1
    return out


def admission_stats() -> dict[int, dict[str, int]]:
    """Per-bucket admission counts: ``{bucket: {"admits": n}}``."""
    return {b: dict(e) for b, e in sorted(_ADMISSION_STATS.items())}


def reset_admission_stats() -> None:
    _ADMISSION_STATS.clear()


def max_batch_for_grant(cfg: M.ModelConfig, grant_hbm_gib: float,
                        max_len: int, headroom: float = 0.8) -> int:
    """Largest decode batch that fits a tpushare HBM grant: the weights
    once, then one KV-cache row per concurrent sequence, within
    ``headroom`` of the grant. 0 when the weights alone do not fit.

    Weight bytes come from the real module built on the ``meta`` device
    (no allocation), so they cannot drift from ``init_params``."""
    budget = grant_hbm_gib * (1 << 30) * headroom
    shapes = M.Transformer(cfg, "meta")
    params_bytes = sum(p.numel() * p.element_size()
                       for p in shapes.parameters())
    if params_bytes >= budget:
        return 0
    per_seq = cache_hbm_bytes(cfg, batch=1, max_len=max_len)
    return int((budget - params_bytes) // per_seq)
