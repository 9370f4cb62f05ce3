"""Inference serving: KV-cache prefill, single-token decode, and the
continuous-batching slot server, ported from ``tpushare/workload/serving.py``.

Every index is checked on the host as a concrete value: where the JAX
code clamps inside ``jit`` (``dynamic_update_slice``), this module
validates and raises with the same messages. Cache writes are in place:
the cache and server state handed to a function are consumed, and the
returned ones are the same objects, updated. Everything runs under
``torch.inference_mode()``.

The steps the JAX package jits run through :mod:`graphs`: ``generate``,
``admit`` (so ``admit_bucketed``), ``serve_chunk``, the paged chunk, the
chunked and paged prefill pieces and their finalize replay a CUDA graph
on the card after their first call of a key, and run the same bodies
eagerly on the CPU. So the bodies never read a device value on the host:
an admission's slot, true length and piece offset are 1-element device
tensors (the flash forward reads the offset on the card), a sampled
step's temperature is a device tensor, and the chunk's once-per-chunk
flush has a fixed shape. Tensor-parallel ``generate`` is compiled too, a
rank's graph under an NCCL mesh (``graphs.captures``), eager under gloo.

Sampling draws from an explicit ``torch.Generator`` on the logits'
device; it cannot reproduce JAX's threefry bits, only the contract
(temperature 0 is greedy, the same generator state gives the same
stream, compiled or not).

``prefill``, ``decode_step`` and ``generate`` also run tensor-parallel:
the rank's tp shard of the weights and its H / tp heads of the cache,
with the tp pair of all-reduces ``model.forward`` takes as ``tp``.

Chunked and paged admission prefill a prompt in pieces; each piece's
attention is the flash forward at the piece's offset against the slot's
whole row (the kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import paging
from tpushare_torch.workload.paging import (PAGE_TOKENS, PROMPT_BUCKETS,
                                            pages_for)


def _tp_size(tp) -> int:
    return 1 if tp is None else dist.get_world_size(tp)


def init_cache(cfg: M.ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda", tp=None) -> list[dict]:
    """Preallocated per-layer KV slots, [B, max_len, H, D] each; with the
    tensor-parallel group ``tp``, the rank's H / tp heads."""
    dev = resolve_device(device)
    if cfg.n_heads % _tp_size(tp):
        raise ValueError(f"{cfg.n_heads} heads do not split over "
                         f"tp={_tp_size(tp)}")
    shape = (batch, max_len, cfg.n_heads // _tp_size(tp), cfg.head_dim)
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


def _temperature(temperature: float,
                 device: torch.device) -> torch.Tensor | None:
    """A checked temperature as a compiled step reads it: None at 0
    (greedy), else a 1-element fp32 tensor on ``device``."""
    if temperature == 0:
        return None
    return torch.full((1,), temperature, dtype=torch.float32, device=device)


def _pick(logits: torch.Tensor, temperature: torch.Tensor | None,
          generator: torch.Generator | None) -> torch.Tensor:
    """Next token from [B, vocab] logits: argmax where ``temperature`` is
    None, else a draw from softmax(logits / temperature)."""
    if temperature is None:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def prefill(params: M.Transformer, tokens: torch.Tensor, cache: list[dict],
            attn_fn=None, tp=None) -> tuple[torch.Tensor, list[dict]]:
    """Run the prompt [B, L] through the model, filling ``cache[:, :L]``
    in place. Returns ``(logits [B, vocab] for the last position, cache)``.

    With the tensor-parallel group ``tp``, ``params`` are the rank's tp
    shard (``parallel.shard_params``) and ``cache`` its heads
    (``init_cache(..., tp=tp)``): attention runs over the rank's heads,
    and the tp pair of all-reduces around the projections and the ffn
    gives every rank of the group the same logits."""
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
        q, k, v = M.qkv_proj(block, x, positions, tp)
        slots["k"][:, :L] = k
        slots["v"][:, :L] = v
        x = x + M.out_proj(block, attn_fn(q, k, v), tp)
        x = M.ffn_block(block, x, tp)
    return M.logits_from_hidden(params, x[:, -1]), cache


@torch.inference_mode()
def decode_step(params: M.Transformer, cache: list[dict],
                token: torch.Tensor, pos: int, tp=None
                ) -> tuple[torch.Tensor, list[dict]]:
    """One generated token: write ``token``'s K/V at slot ``pos`` and
    attend it against the cached prefix (the offset form of the causal
    mask, ``pos >= slot``). Returns (next-token logits, cache). ``tp`` as
    :func:`prefill` takes it."""
    pos = int(pos)
    max_len = cache[0]["k"].shape[1]
    if not 0 <= pos < max_len:
        raise ValueError(f"decode position {pos} outside cache max_len "
                         f"{max_len}")
    B = token.shape[0]
    positions = torch.full((B, 1), pos, device=token.device)
    x = params.embed[token][:, None, :]
    for block, slots in zip(params.blocks, cache):
        q, k, v = M.qkv_proj(block, x, positions, tp)
        slots["k"][:, pos] = k[:, 0]
        slots["v"][:, pos] = v[:, 0]
        out = _decode_attention(q, slots["k"], slots["v"], pos)
        x = x + M.out_proj(block, out, tp)
        x = M.ffn_block(block, x, tp)
    return M.logits_from_hidden(params, x[:, 0]), cache


#: Bytes of the fp32 copy of K one decode attention call may make. The
#: plain attention converts the whole cache layer to fp32 (and ``einsum``
#: lays it out again), 8 GiB a layer at a whole-card batch of 4096-token
#: rows, on top of a cache that ``max_batch_for_grant`` sized to fill the
#: grant; rows past this bound are attended in slices.
DECODE_ATTN_SLICE_BYTES = 1 << 30


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """``causal_attention`` of one position against the cache, over
    slices of rows whose fp32 K stays within
    :data:`DECODE_ATTN_SLICE_BYTES`; every row's arithmetic is that of the
    whole batch at once."""
    b, max_len, h, d = k.shape
    rows = max(1, DECODE_ATTN_SLICE_BYTES // (max_len * h * d * 4))
    if rows >= b:
        return M.causal_attention(q, k, v, q_offset=pos)
    return torch.cat([M.causal_attention(q[i:i + rows], k[i:i + rows],
                                         v[i:i + rows], q_offset=pos)
                      for i in range(0, b, rows)])


@torch.inference_mode()
def generate(params: M.Transformer, tokens: torch.Tensor,
             cfg: M.ModelConfig, n_new: int, max_len: int, attn_fn=None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             mesh: par.Mesh | None = None) -> torch.Tensor:
    """Prompt [B, L] -> [B, L + n_new] token ids.

    ``temperature == 0`` is greedy argmax; ``> 0`` samples each token
    from ``softmax(logits / temperature)`` with ``generator``, which is
    required then. ``attn_fn`` is the prefill attention (decode attends
    one query against the cache); pass ``flash_attention`` for the
    kernel.

    Tensor-parallel decode over a :class:`parallel.Mesh`, as the JAX
    package's ``generate`` runs on dp × tp shardings: ``params`` are the
    rank's tp shard, ``tokens`` the global prompt, which every rank holds
    alike; each rank generates its dp shard of the rows over its H / tp
    heads (:func:`prefill`'s ``tp``), and the global [B, L + n_new]
    stream comes back on every rank. Ranks along sp (and pp) are
    replicas. Every rank of a tp group holds the same logits, so at
    ``temperature > 0`` each must pass a generator seeded alike to pick
    the same token.

    The prefill and the whole decode loop are one compiled step
    (:mod:`graphs`) a (B, L, n_new, max_len, attn_fn, sampled), the twin
    of the JAX ``scan``; each step's position is baked in, as
    ``static_argnames`` bakes ``n_new``, and the temperature is an
    input, as JAX traces it. Under a mesh the key holds its shape and the
    rank's coordinates, and the body ends with the dp gather of the
    stream; a sampled step registers the rank's generator, as on one
    device."""
    _check_temperature(temperature, generator)
    B, L = tokens.shape
    if L + n_new > max_len:
        raise ValueError(
            f"L + n_new = {L + n_new} exceeds cache max_len {max_len}")
    tp = mesh.tp_group if mesh is not None and mesh.tp > 1 else None
    if mesh is not None:
        tokens = par.place_batch(mesh, tokens, sequence=False)

    temp = _temperature(temperature, tokens.device)

    def body(tokens, *temps):
        t = temps[0] if temps else None
        cache = init_cache(cfg, tokens.shape[0], max_len,
                           device=tokens.device, tp=tp)
        logits, cache = prefill(params, tokens, cache, attn_fn=attn_fn,
                                tp=tp)
        out = []
        for pos in range(L, L + n_new):
            token = _pick(logits, t, generator).to(tokens.dtype)
            out.append(token)
            logits, cache = decode_step(params, cache, token, pos, tp=tp)
        stream = torch.cat([tokens, torch.stack(out, dim=1)], dim=1)
        if mesh is not None and mesh.dp > 1:
            stream = C.all_gather(stream, mesh.dp_group, 0)
        return stream

    inputs = (tokens,) if temp is None else (tokens, temp)
    return graphs.run("generate", body, inputs,
                      static=(cfg, n_new, max_len, attn_fn),
                      bound=params.parameters,
                      generator=None if temp is None else generator,
                      mesh=mesh)


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
    sample that first token (``generate``'s semantics).

    An admission is one compiled step (:mod:`graphs`) a (prompt length,
    ``attn_fn``, sampled), with the slot, true length and temperature as
    device tensors, as the JAX package's ``_admit`` traces them; the
    slot's position, activity and token are copied in and back out."""
    Lp = prompt.shape[0]
    max_len = state["cache"][0]["k"].shape[1]
    s, tl = _check_admit(Lp, max_len, state["pos"].shape[0], slot,
                         true_len, temperature, generator)
    if attn_fn is None:
        attn_fn = M.causal_attention
    cache = state["cache"]

    def body(prompt, slot, true_len, pos, active, token, *temps):
        positions = torch.arange(Lp, device=prompt.device)[None, :]
        x = params.embed[prompt[None, :]]
        for block, slots_ in zip(params.blocks, cache):
            q, k, v = M.qkv_proj(block, x, positions)
            slots_["k"][:, :Lp].index_copy_(0, slot, k)
            slots_["v"][:, :Lp].index_copy_(0, slot, v)
            x = x + M.out_proj(block, attn_fn(q, k, v))
            x = M.ffn_block(block, x)
        out = {"pos": pos, "active": active, "token": token}
        _finalize_admit(params, out, slot, true_len,
                        x[0].index_select(0, true_len - 1),
                        temps[0] if temps else None, generator)
        return pos, active, token

    dev = state["pos"].device
    temp = _temperature(temperature, dev)
    got = graphs.run(
        "admit", body,
        (prompt, _scalar(s, dev), _scalar(tl, dev), state["pos"],
         state["active"], state["token"]) + (() if temp is None else (temp,)),
        static=(attn_fn,),
        bound=lambda: (*params.parameters(), *_cache_tensors(cache)),
        generator=None if temp is None else generator)
    for name, t in zip(("pos", "active", "token"), got):
        if t is not state[name]:
            state[name].copy_(t)
    return state


def _scalar(value: int, device: torch.device) -> torch.Tensor:
    """``value`` as a 1-element long tensor on ``device``: an index a
    compiled body reads on the device (a 0-d one would be read on the
    host)."""
    return torch.full((1,), value, dtype=torch.long, device=device)


def _cache_tensors(layers: list[dict]) -> list[torch.Tensor]:
    return [layer[kv] for layer in layers for kv in ("k", "v")]


def _check_admit(Lp: int, max_len: int, slots: int, slot: int,
                 true_len: int | None, temperature: float,
                 generator: torch.Generator | None) -> tuple[int, int]:
    """The admission paths' shared checks; returns (slot, true_len)."""
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
    return s, tl


def _finalize_admit(params: M.Transformer, state: dict, slot: torch.Tensor,
                    true_len: torch.Tensor, hidden: torch.Tensor,
                    temperature: torch.Tensor | None,
                    generator: torch.Generator | None) -> dict:
    """An admission's tail, for contiguous and paged state alike: the
    first token from the final hidden state ``hidden`` [1, d] at position
    ``true_len - 1``, and the slot marked active at ``true_len`` (the
    checks left decode room). ``slot`` and ``true_len`` are
    :func:`_scalar` tensors and ``temperature`` is :func:`_temperature`'s,
    so nothing here is read on the host."""
    logits = M.logits_from_hidden(params, hidden)
    state["pos"].index_copy_(0, slot, true_len)
    state["active"].index_fill_(0, slot, True)
    state["token"].index_copy_(0, slot, _pick(logits, temperature, generator))
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
    greedy) from ``generator``, which is required then.

    A chunk is one compiled step (:mod:`graphs`) a (slots, max_len,
    ``n_steps``, sampled): the decode steps and the flush, with the
    temperature vector an input."""
    temperature = _serve_temperature(state, temperature, generator)
    cache = state["cache"]
    slots, max_len = cache[0]["k"].shape[:2]

    def body(pos, active, token, *temps):
        start = {"pos": pos, "active": active, "token": token}
        pos, active, token, emitted, ring = _decode_chunk(
            params, cache, start, n_steps, temps[0] if temps else None,
            generator)
        # Row (b, t) goes to cache row start + t of slot b, in the
        # [slots x max_len] rows of each layer.
        rows = (start["pos"][:, None]
                + torch.arange(n_steps, device=pos.device)[None, :])
        flat = (torch.arange(slots, device=pos.device)[:, None] * max_len
                + rows.clamp(max=max_len - 1))
        _flush_ring([layer[kv].view(slots * max_len, *layer[kv].shape[2:])
                     for layer in cache for kv in ("k", "v")],
                    [rg[kv] for rg in ring for kv in ("k", "v")],
                    flat, (emitted >= 0).T)
        return pos, active, token, emitted

    pos, active, token, emitted = _run_chunk(
        "serve_chunk", body, state, n_steps, temperature, generator,
        lambda: (*params.parameters(), *_cache_tensors(cache)))
    state.update(pos=pos, active=active, token=token)
    return state, emitted


def _run_chunk(name: str, body, state: dict, n_steps: int,
               temperature: torch.Tensor | None,
               generator: torch.Generator | None, bound):
    """A chunk's body through :mod:`graphs`, compiled by (slots,
    ``n_steps``, sampled, the bound cache); ``body(pos, active, token,
    *temperature)``."""
    sampled = () if temperature is None else (temperature,)
    return graphs.run(name, body,
                      (state["pos"], state["active"], state["token"],
                       *sampled),
                      static=(n_steps,), bound=bound,
                      generator=generator if sampled else None)


def _flush_ring(dst: list[torch.Tensor], ring: list[torch.Tensor],
                flat: torch.Tensor, valid: torch.Tensor) -> None:
    """The once-per-chunk flush: entry (b, t) of each ring [B, C, H, D]
    goes to row ``flat[b, t]`` of its destination [N, H, D] where
    ``valid[b, t]``, and nothing else changes.

    The write has one shape whatever the data, so it reads nothing on
    the host: every invalid entry is sent to the row of one valid entry
    with that entry's value (with none valid, to its own row with the
    row's value), so duplicate targets always carry equal values and no
    row that no valid step writes changes. Valid targets are distinct:
    a slot's steps write distinct rows, and decode writes only a
    stream's private pages."""
    n = valid.numel()
    valid, flat = valid.reshape(n), flat.reshape(n)
    first = valid.to(torch.int8).argmax().reshape(1)
    target = torch.where(valid, flat, flat.index_select(0, first))
    keep = valid[:, None, None]
    for d, r in zip(dst, ring):
        r = r.reshape(n, *r.shape[2:])
        canon = torch.where(valid.any(), r.index_select(0, first),
                            d.index_select(0, target.index_select(0, first)))
        d.index_put_((target,), torch.where(keep, r, canon))


def _serve_temperature(state: dict, temperature,
                       generator: torch.Generator | None
                       ) -> torch.Tensor | None:
    """A chunk's per-slot temperature as an fp32 [SLOTS] tensor, checked
    (None stays None: every slot greedy)."""
    if temperature is None:
        return None
    slots = state["pos"].shape[0]
    if generator is None:
        raise ValueError("temperature requires an explicit torch.Generator")
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
    return temperature


def _decode_chunk(params: M.Transformer, cache: list[dict], state: dict,
                  n_steps: int, temperature: torch.Tensor | None,
                  generator: torch.Generator | None):
    """``n_steps`` fused steps over ``cache`` (per layer [SLOTS, max_len,
    H, D], read-only) from ``state``'s positions, activity and tokens.
    Returns (pos, active, token, emitted [n_steps, SLOTS], ring): the
    ring holds each step's K/V for the caller's flush."""
    start_pos = state["pos"]
    slots = start_pos.shape[0]
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
    return pos, active, token, torch.stack(emitted), ring


# --------------------------------------------------------------------------
# Chunked prefill: admission sliced into pieces
# --------------------------------------------------------------------------
#
# ``admit`` prefills the whole prompt in one call, so a 1024-token
# admission stalls every running slot for the whole prefill. The chunked
# path slices the prompt into fixed-size pieces; the caller can run
# ``serve_chunk`` steps between pieces (:func:`admit_interleaved`), so an
# admission costs the running batch a bounded pause per piece. A piece at
# ``offset`` writes its K/V into the slot's rows [offset, offset + C) and
# attends the slot's whole max_len row, as the JAX package's
# ``dynamic_slice`` does: the flash forward with ``q_offset = offset`` read
# on the device, whose causal mask hides the rows past offset + C (the
# kernel never loads them).
#
# Each piece is one compiled step (:mod:`graphs`) a (C, cache), the twin
# of the JAX package's jitted ``_prefill_chunk``: the slot, the offset (or
# the paged piece index) and the true length are device scalars, so one
# graph serves every piece of every prompt in every slot. The tail,
# ``_finalize_admit``, is one more, greedy or sampled.


def _run_piece(params: M.Transformer, tokens: torch.Tensor,
               offset: torch.Tensor, true_len: torch.Tensor,
               carry: torch.Tensor, store_kv) -> torch.Tensor:
    """One ``[C]`` piece of a prompt at the global position ``offset`` (a
    :func:`_scalar`). ``store_kv(layer, k, v)`` stores the piece's K/V
    [1, C, H, D] and returns the keys and values the piece attends, the
    slot's whole [1, max_len, H, D] row each. Returns ``carry`` [1, d],
    replaced by the final hidden state at position ``true_len - 1`` when
    this piece holds it, selected on the device as JAX's ``where`` over a
    clamped index."""
    C = tokens.shape[0]
    rows = offset + torch.arange(C, device=tokens.device)
    # The kernel reads (q_offset, kv_offset) = (offset, 0) on the card.
    pair = torch.cat([offset, torch.zeros_like(offset)]).to(torch.int32)
    x = params.embed[tokens][None, :]
    for i, block in enumerate(params.blocks):
        q, k, v = M.qkv_proj(block, x, rows[None, :])
        ck, cv = store_kv(i, k, v)
        out = FA.flash_block_with_lse(q, ck, cv, q_offset=pair[0:1],
                                      kv_offset=pair[1:2])[0]
        x = x + M.out_proj(block, out)
        x = M.ffn_block(block, x)
    idx = true_len - 1 - offset
    inside = (idx >= 0) & (idx < C)
    hidden = x[0].index_select(0, idx.clamp(0, C - 1))
    return torch.where(inside[:, None], hidden, carry)


def _prefill_chunk(params: M.Transformer, state: dict, piece: torch.Tensor,
                   slot: torch.Tensor, offset: torch.Tensor,
                   true_len: torch.Tensor, carry: torch.Tensor
                   ) -> torch.Tensor:
    """Prefill one piece into ``slot``'s cache rows [offset, offset + C),
    all three :func:`_scalar` tensors; it attends the slot's whole row,
    gathered into a buffer of its own (JAX's ``dynamic_slice``). One
    compiled step a (C, cache). Returns the carried hidden state [1, d]."""
    cache = state["cache"]
    max_len = cache[0]["k"].shape[1]

    def body(piece, slot, offset, true_len, carry):
        flat = slot * max_len + offset + torch.arange(
            piece.shape[0], device=piece.device)

        def store_kv(i, k, v):
            layer = cache[i]
            for kv, new in (("k", k), ("v", v)):
                t = layer[kv]
                t.view(-1, *t.shape[2:]).index_copy_(0, flat, new[0])
            return (layer["k"].index_select(0, slot),
                    layer["v"].index_select(0, slot))

        return _run_piece(params, piece, offset, true_len, carry, store_kv)

    return graphs.run("prefill_chunk", body,
                      (piece, slot, offset, true_len, carry),
                      bound=lambda: (*params.parameters(),
                                     *_cache_tensors(cache)))


def _finalize_compiled(params: M.Transformer, state: dict, slot: int,
                       true_len: int, carry: torch.Tensor,
                       temperature: float,
                       generator: torch.Generator | None) -> dict:
    """:func:`_finalize_admit` of a chunked or paged admission as one
    compiled step (:mod:`graphs`), greedy or sampled, the twin of the JAX
    package's jitted ``_finalize_admit`` / ``_finalize_admit_paged``:
    slot, true length, carry and temperature are inputs, the slot's
    position, activity and token copied in and back out. It touches no
    cache, so contiguous and paged servers of one slot count share it."""
    dev = state["pos"].device
    temp = _temperature(temperature, dev)

    def body(slot, true_len, carry, pos, active, token, *temps):
        out = {"pos": pos, "active": active, "token": token}
        _finalize_admit(params, out, slot, true_len, carry,
                        temps[0] if temps else None, generator)
        return pos, active, token

    got = graphs.run(
        "finalize_admit", body,
        (_scalar(slot, dev), _scalar(true_len, dev), carry, state["pos"],
         state["active"], state["token"]) + (() if temp is None else (temp,)),
        bound=params.parameters,
        generator=None if temp is None else generator)
    for name, t in zip(("pos", "active", "token"), got):
        if t is not state[name]:
            state[name].copy_(t)
    return state


def _chunk_plan(prompt: torch.Tensor, chunk: int, max_len: int, slots: int,
                slot: int, true_len: int | None, temperature: float,
                generator: torch.Generator | None
                ) -> tuple[torch.Tensor, int, int, int]:
    """Checks and padding shared by the chunked admission paths: returns
    (prompt zero-padded to a multiple of ``chunk``, slot, true_len,
    number of pieces)."""
    if not isinstance(chunk, int) or chunk <= 0:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    Lp = prompt.shape[0]
    s, tl = _check_admit(Lp, max_len, slots, slot, true_len, temperature,
                         generator)
    n_pieces = -(-Lp // chunk)
    Lpad = n_pieces * chunk
    if Lpad > max_len:
        raise ValueError(
            f"prompt length {Lp} padded to {Lpad} (chunk {chunk}) "
            f"exceeds cache max_len {max_len} — pick a chunk size "
            f"dividing max_len")
    if Lpad > Lp:
        prompt = torch.cat([prompt, prompt.new_zeros(Lpad - Lp)])
    return prompt, s, tl, n_pieces


def admit_chunked(params: M.Transformer, state: dict, prompt: torch.Tensor,
                  slot: int, *, chunk: int = 64, true_len: int | None = None,
                  temperature: float = 0.0,
                  generator: torch.Generator | None = None) -> dict:
    """:func:`admit`, sliced: prefill ``prompt`` into ``slot`` in
    ``chunk``-token pieces. The slot's stream is whole-prompt ``admit``'s
    (the same (position, K/V) sets). Padding the prompt's end to a
    multiple of ``chunk`` is safe by admit's bucket argument: pads are
    causally invisible and ``pos`` starts at ``true_len``."""
    return admit_interleaved(params, state, prompt, slot, chunk=chunk,
                             decode_steps=0, true_len=true_len,
                             temperature=temperature,
                             generator=generator)[0]


@torch.inference_mode()
def admit_interleaved(params: M.Transformer, state: dict,
                      prompt: torch.Tensor, slot: int, *, chunk: int = 64,
                      decode_steps: int = 8, true_len: int | None = None,
                      temperature: float = 0.0,
                      generator: torch.Generator | None = None,
                      serve_temperature=None,
                      serve_generator: torch.Generator | None = None
                      ) -> tuple[dict, torch.Tensor]:
    """Admission that does not stall the running batch: each prefill
    piece is followed by ``decode_steps`` tokens of ``serve_chunk`` for
    the slots already in flight (``serve_temperature`` and
    ``serve_generator`` are its per-slot sampling).

    Returns ``(state, emitted)``; emitted [n_pieces * decode_steps,
    SLOTS] stacks the interleaved decode output (the admitted slot is
    inactive until its finalize, so its column is all -1). A piece writes
    only the admitted slot's cache rows, so the other slots' streams are
    those of the same chunks run with no admission."""
    max_len = state["cache"][0]["k"].shape[1]
    slots = state["pos"].shape[0]
    padded, s, tl, n_pieces = _chunk_plan(
        prompt, chunk, max_len, slots, slot, true_len, temperature,
        generator)
    dev = state["pos"].device
    carry = params.embed.new_zeros((1, params.embed.shape[1]))
    slot_t, tl_t = _scalar(s, dev), _scalar(tl, dev)
    emitted = []
    for i in range(n_pieces):
        carry = _prefill_chunk(params, state,
                               padded[i * chunk:(i + 1) * chunk], slot_t,
                               _scalar(i * chunk, dev), tl_t, carry)
        if decode_steps > 0:
            state, em = serve_chunk(params, state, decode_steps,
                                    temperature=serve_temperature,
                                    generator=serve_generator)
            emitted.append(em)
    state = _finalize_compiled(params, state, s, tl, carry, temperature,
                               generator)
    if emitted:
        return state, torch.cat(emitted)
    return state, torch.zeros((0, slots), dtype=torch.long,
                              device=state["pos"].device)


# --------------------------------------------------------------------------
# Bucketed admission
# --------------------------------------------------------------------------

#: bucket length -> {"admits": n, "jitMisses": n}, the JAX package's
#: names: misses are the admissions whose key :mod:`graphs` had not
#: compiled (graph captures on the card; the same keys on the CPU, where
#: nothing is captured). After warm-up every admission is a hit.
#: Single-writer: the loop that owns admissions.
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
    real length as ``true_len``, and count the admission per bucket and
    whether it compiled a new key (``jitMisses``)."""
    max_len = state["cache"][0]["k"].shape[1]
    padded, tl = pad_to_bucket(prompt, buckets, max_len)
    before = graphs.cache_size("admit")
    out = admit(params, state, padded, slot, attn_fn=attn_fn, true_len=tl,
                temperature=temperature, generator=generator)
    entry = _ADMISSION_STATS.setdefault(int(padded.shape[0]),
                                        {"admits": 0, "jitMisses": 0})
    entry["admits"] += 1
    if graphs.cache_size("admit") > before:
        entry["jitMisses"] += 1
    return out


def admission_stats() -> dict[int, dict[str, int]]:
    """Per-bucket admission counts with derived hits, as the JAX package
    reports them: ``{bucket: {admits, jitMisses, jitHits}}``. Misses and
    hits count the admission step's graph captures and replays
    (:mod:`graphs`)."""
    return {b: dict(e, jitHits=e["admits"] - e["jitMisses"])
            for b, e in sorted(_ADMISSION_STATS.items())}


def reset_admission_stats() -> None:
    _ADMISSION_STATS.clear()


def max_batch_for_grant(cfg: M.ModelConfig, grant_hbm_gib: float,
                        max_len: int, headroom: float = 0.8) -> int:
    """Largest decode batch that fits a tpushare HBM grant: the weights
    once, then one KV-cache row per concurrent sequence, within
    ``headroom`` of the grant. 0 when the weights alone do not fit.

    Weight bytes come from the real module built on the ``meta`` device
    (no allocation), so they cannot drift from ``init_params``."""
    return _units_for_grant(cfg, grant_hbm_gib, headroom,
                            cache_hbm_bytes(cfg, batch=1, max_len=max_len))


def pages_for_grant(cfg: M.ModelConfig, grant_hbm_gib: float,
                    page_tokens: int = PAGE_TOKENS,
                    headroom: float = 0.8) -> int:
    """:func:`max_batch_for_grant`'s paged twin: the KV-cache pages that
    fit the grant after the weights. A stream then costs
    ``pages_for(true_len + decode)`` pages, not a whole ``max_len`` row."""
    if page_tokens <= 0:
        raise ValueError(
            f"page_tokens must be > 0, got {page_tokens}")
    return _units_for_grant(cfg, grant_hbm_gib, headroom,
                            cache_hbm_bytes(cfg, batch=1,
                                            max_len=page_tokens))


def _units_for_grant(cfg: M.ModelConfig, grant_hbm_gib: float,
                     headroom: float, unit_bytes: int) -> int:
    """How many ``unit_bytes`` KV units fit ``headroom`` of the grant
    after the weights, counted on the ``meta`` device (0 when the weights
    alone do not fit)."""
    budget = grant_hbm_gib * (1 << 30) * headroom
    shapes = M.Transformer(cfg, "meta")
    params_bytes = sum(p.numel() * p.element_size()
                       for p in shapes.parameters())
    if params_bytes >= budget:
        return 0
    return int((budget - params_bytes) // unit_bytes)


# --------------------------------------------------------------------------
# Paged KV cache
# --------------------------------------------------------------------------
#
# The slot server charges every stream a whole [max_len] cache row. The
# paged server keeps per-layer page pools [P, page, H, D] and a
# [SLOTS, max_len / page] page table (-1 = unmapped); a slot's logical
# cache is the gather ``pool[table[slot]]``.
#
# * ``admit_paged`` leases pages for the prompt's true length from a
#   :class:`~tpushare_torch.workload.paging.PagePool`, reuses same-tenant
#   prefix pages (never prefilled again) and prefills only the private
#   tail, one page-sized piece at a time: the chunked piece with
#   chunk == page, its K/V written into its physical page.
# * ``serve_chunk_paged`` gathers ``pool[table]`` once per chunk and runs
#   the contiguous path's ``_fused_chunk_step`` over it: the gathered view
#   holds the same (position, K/V) values as a contiguous cache, so the
#   streams are the same. The once-per-chunk flush goes through the table
#   into the flat pool. Decode writes land at positions >= true_len, in
#   the stream's private pages, so shared prefix pages are never written.
# * ``release_paged`` retires the slot and releases its lease; pages no
#   stream still shares return to the pool.


def init_paged_state(cfg: M.ModelConfig, slots: int, max_len: int,
                     total_pages: int, page_tokens: int = PAGE_TOKENS,
                     device: str | torch.device = "cuda") -> dict:
    """Fresh paged server state: zeroed page pools and an unmapped table.
    ``max_len`` must be a multiple of ``page_tokens`` (the table is dense);
    ``total_pages`` comes from :func:`pages_for_grant`."""
    if page_tokens <= 0 or max_len % page_tokens != 0:
        raise ValueError(
            f"max_len {max_len} must be a positive multiple of "
            f"page_tokens {page_tokens} (dense page table)")
    if total_pages <= 0:
        raise ValueError(f"total_pages must be > 0, got {total_pages}")
    dev = resolve_device(device)
    shape = (total_pages, page_tokens, cfg.n_heads, cfg.head_dim)
    with torch.inference_mode():
        return {
            "pages": [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
                      for _ in range(cfg.n_layers)],
            "table": torch.full((slots, max_len // page_tokens), -1,
                                dtype=torch.long, device=dev),
            "pos": torch.zeros(slots, dtype=torch.long, device=dev),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
            "token": torch.zeros(slots, dtype=torch.long, device=dev),
        }


def _paged_dims(state: dict) -> tuple[int, int, int, int]:
    """(total_pages, page_tokens, table_len, max_len) of a paged state."""
    P, page = state["pages"][0]["k"].shape[:2]
    MP = state["table"].shape[1]
    return P, page, MP, MP * page


def _prefill_paged_piece(params: M.Transformer, state: dict,
                         piece_tokens: torch.Tensor, slot: torch.Tensor,
                         piece: torch.Tensor, true_len: torch.Tensor,
                         carry: torch.Tensor) -> torch.Tensor:
    """Prefill logical page ``piece`` of ``slot`` (a page-sized piece; all
    three :func:`_scalar` tensors) into the physical page its table row
    maps, then attend the slot's whole table row gathered into a
    [1, max_len, H, D] view, unmapped entries clamped to page 0 (JAX's
    gather; the causal mask hides every row past the piece). One compiled
    step a (page, pages and table). Returns the carried hidden state."""
    P, page, _, max_len = _paged_dims(state)
    pages, table = state["pages"], state["table"]

    def body(piece_tokens, slot, piece, true_len, carry):
        # Every page up to this one is mapped before any piece runs; the
        # clamp keeps an index in range regardless.
        row = table.index_select(0, slot)[0].clamp(0, P - 1)      # [MP]
        pid = row.index_select(0, piece)

        def store_kv(i, k, v):
            pg = pages[i]
            pg["k"].index_copy_(0, pid, k)
            pg["v"].index_copy_(0, pid, v)
            shape = (1, max_len, *pg["k"].shape[2:])
            return (pg["k"].index_select(0, row).view(shape),
                    pg["v"].index_select(0, row).view(shape))

        return _run_piece(params, piece_tokens, piece * page, true_len,
                          carry, store_kv)

    return graphs.run("prefill_paged_piece", body,
                      (piece_tokens, slot, piece, true_len, carry),
                      bound=lambda: (*params.parameters(),
                                     *_cache_tensors(pages), table))


@torch.inference_mode()
def admit_paged(params: M.Transformer, state: dict, pool: paging.PagePool,
                prompt: torch.Tensor, slot: int, *, tenant: str = "default",
                true_len: int | None = None, temperature: float = 0.0,
                generator: torch.Generator | None = None) -> dict:
    """Admit ``prompt`` into ``slot`` of a paged server: lease pages for
    the prompt's true length from ``pool`` (reusing same-tenant prefix
    pages), prefill only the private tail in page-sized pieces, and
    finalize. The slot's stream is that of :func:`admit_chunked` with
    ``chunk`` = the page size.

    On failure the lease is released and the slot's table row restored,
    so the pool and the state are as they were. Prefix sharing never
    crosses tenants: the pool's index is tenant-keyed and the chain
    hashes are tenant-seeded."""
    P, page, MP, max_len = _paged_dims(state)
    if pool.page_tokens != page:
        raise ValueError(
            f"pool page_tokens {pool.page_tokens} != state page size "
            f"{page} — one pool per paged server")
    padded, s, tl, _ = _chunk_plan(prompt, page, max_len,
                                   state["pos"].shape[0], slot, true_len,
                                   temperature, generator)
    n_pages = pages_for(tl, page)
    owner = f"slot{s}"
    lease = pool.admit(owner, tenant, prompt[:tl].tolist(), tl)
    old_row = state["table"][s].clone()
    try:
        row = torch.full((MP,), -1, dtype=torch.long)
        row[:n_pages] = torch.tensor(lease.pages)
        state["table"][s] = row
        dev = state["pos"].device
        carry = params.embed.new_zeros((1, params.embed.shape[1]))
        slot_t, tl_t = _scalar(s, dev), _scalar(tl, dev)
        # Shared pages already hold bit-equal K/V (chain-hash match), so
        # their pieces are skipped. The page holding position
        # true_len - 1 is never shared (paging.shareable_pages), so a
        # piece that runs always computes the carried hidden state.
        for i in range(lease.shared, n_pages):
            carry = _prefill_paged_piece(
                params, state, padded[i * page:(i + 1) * page], slot_t,
                _scalar(i, dev), tl_t, carry)
        return _finalize_compiled(params, state, s, tl, carry, temperature,
                                  generator)
    except BaseException:
        state["table"][s] = old_row
        pool.release(owner)
        raise


@torch.inference_mode()
def ensure_chunk_pages(state: dict, pool: paging.PagePool,
                       n_steps: int) -> dict:
    """Map pages ahead of a decode chunk: every active slot gets table
    entries covering ``pos + n_steps`` (capped at max_len). Host-side;
    the chunk itself never allocates. Raises
    :class:`~tpushare_torch.workload.paging.PoolExhausted` when the pool
    cannot cover the growth; the state is then untouched and every page
    this call grew is shrunk back, so a retry grows them once."""
    _, page, _, max_len = _paged_dims(state)
    pos = state["pos"].tolist()
    active = state["active"].tolist()
    table = state["table"].to("cpu", copy=True)
    mapped = (table >= 0).sum(dim=1).tolist()
    grown: list[tuple[str, tuple[int, ...]]] = []
    try:
        for s, is_active in enumerate(active):
            if not is_active:
                continue
            need = pages_for(min(pos[s] + n_steps, max_len), page)
            have = mapped[s]
            if need > have:
                fresh = pool.grow(f"slot{s}", need - have)
                grown.append((f"slot{s}", fresh))
                table[s, have:need] = torch.tensor(fresh)
    except BaseException:
        for owner, pages in grown:
            pool.shrink(owner, pages)
        raise
    if grown:
        state["table"].copy_(table)
    return state


@torch.inference_mode()
def serve_chunk_paged(params: M.Transformer, state: dict,
                      pool: paging.PagePool, n_steps: int,
                      temperature=None,
                      generator: torch.Generator | None = None
                      ) -> tuple[dict, torch.Tensor]:
    """:func:`serve_chunk` over the paged cache: grow the page tables to
    cover the chunk, then advance every active slot ``n_steps`` tokens
    with the contiguous path's step over the gathered view. Same
    temperature/generator contract as ``serve_chunk``."""
    temperature = _serve_temperature(state, temperature, generator)
    state = ensure_chunk_pages(state, pool, n_steps)
    return _serve_chunk_paged(params, state, n_steps, temperature,
                              generator)


@torch.inference_mode()
def _serve_chunk_paged(params: M.Transformer, state: dict, n_steps: int,
                       temperature: torch.Tensor | None,
                       generator: torch.Generator | None
                       ) -> tuple[dict, torch.Tensor]:
    """The chunk itself, its pages already mapped: one compiled step
    (:mod:`graphs`) a (streams, table, ``n_steps``, sampled)."""
    P, page, MP, max_len = _paged_dims(state)
    B = state["pos"].shape[0]
    H, D = state["pages"][0]["k"].shape[2:]
    pages, table = state["pages"], state["table"]

    def body(pos, active, token, *temps):
        # The slot-contiguous view, gathered once per chunk. Unmapped
        # entries clamp to page 0: their rows lie past every slot's
        # position, where the step's mask hides them.
        phys = table.clamp(0, P - 1)                     # [B, MP]
        cache = [{"k": pg["k"][phys].view(B, max_len, H, D),
                  "v": pg["v"][phys].view(B, max_len, H, D)}
                 for pg in pages]
        start = {"pos": pos, "active": active, "token": token}
        pos, active, token, emitted, ring = _decode_chunk(
            params, cache, start, n_steps, temps[0] if temps else None,
            generator)
        # The once-per-chunk flush, routed through the page table into
        # the flat pool.
        rows = (start["pos"][:, None]
                + torch.arange(n_steps, device=pos.device)[None, :])
        logical = (rows // page).clamp(0, MP - 1)
        flat = phys.gather(1, logical) * page + rows % page
        _flush_ring([pg[kv].view(P * page, H, D)
                     for pg in pages for kv in ("k", "v")],
                    [rg[kv] for rg in ring for kv in ("k", "v")],
                    flat, (emitted >= 0).T)
        return pos, active, token, emitted

    pos, active, token, emitted = _run_chunk(
        "serve_chunk_paged", body, state, n_steps, temperature, generator,
        lambda: (*params.parameters(), *_cache_tensors(pages), table))
    state.update(pos=pos, active=active, token=token)
    return state, emitted


@torch.inference_mode()
def release_paged(state: dict, pool: paging.PagePool, slot: int) -> dict:
    """Retire ``slot`` and release its page lease; pages no stream still
    shares return to the pool. The table row resets to unmapped, so a
    recycled page is never read through a stale mapping."""
    s = int(slot)
    pool.release(f"slot{s}")
    state["table"][s] = -1
    state["active"][s] = False
    state["pos"][s] = 0
    return state
