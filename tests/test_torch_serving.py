"""The port's serving path against the JAX package's, on ``tiny()`` in
fp32 with the same weights: greedy streams must be token-exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workload import model as JM
from tpushare.workload import serving as JS
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import serving as S

#: Smallest top-2 logit gap (fp32) at which a greedy step is treated as
#: decided: the two frameworks differ by ~1e-6 in fp32 logits.
MIN_GAP = 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32,
                               remat=False)
    tcfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32,
                               remat=False)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, params


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_prefill_and_decode_logits_match_jax(setup):
    jcfg, tcfg, jparams, params = setup
    tokens = np.stack([_prompt(1, 7, jcfg.vocab_size),
                       _prompt(2, 7, jcfg.vocab_size)])
    jl, jcache = JS.prefill(jparams, jnp.asarray(tokens),
                            JS.init_cache(jcfg, 2, 16))
    tl, cache = S.prefill(params, _t(tokens),
                          S.init_cache(tcfg, 2, 16, device="cpu"))
    # fp32 logits of O(1): ulps of accumulated difference.
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    jl2, _ = JS.decode_step(jparams, jcache, jnp.asarray(nxt),
                            jnp.asarray(7))
    tl2, _ = S.decode_step(params, cache, _t(nxt), 7)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4)


@pytest.mark.parametrize("attn", ["default", "flash"])
def test_greedy_generate_matches_jax(setup, attn):
    jcfg, tcfg, jparams, params = setup
    tokens = np.stack([_prompt(3, 7, jcfg.vocab_size),
                       _prompt(4, 7, jcfg.vocab_size)])
    n_new, max_len = 6, 16
    want = np.asarray(JS.generate(jparams, jnp.asarray(tokens), jcfg,
                                  n_new=n_new, max_len=max_len))
    # Every JAX greedy step must be decided, so a mismatch is never a tie.
    for L in range(tokens.shape[1], tokens.shape[1] + n_new):
        logits = np.asarray(JM.forward(jparams, jnp.asarray(want[:, :L]),
                                       jcfg))[:, -1]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > MIN_GAP).all(), L
    attn_fn = FA.flash_attention if attn == "flash" else None
    got = S.generate(params, _t(tokens), tcfg, n_new=n_new,
                     max_len=max_len, attn_fn=attn_fn)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_decode_attention_in_row_slices(setup, monkeypatch, rows):
    """Past DECODE_ATTN_SLICE_BYTES decode attends the cache in slices of
    rows: the logits are the whole batch's, bit for bit, and generate's
    greedy stream is still JAX's token for token."""
    jcfg, tcfg, jparams, params = setup
    tokens = np.stack([_prompt(20 + i, 7, jcfg.vocab_size)
                       for i in range(5)])
    n_new, max_len = 6, 16
    cache = S.init_cache(tcfg, 5, max_len, device="cpu")
    logits, cache = S.prefill(params, _t(tokens), cache)
    nxt = logits.argmax(-1)
    whole, _ = S.decode_step(params, cache, nxt, 7)
    row_bytes = max_len * tcfg.n_heads * tcfg.head_dim * 4
    monkeypatch.setattr(S, "DECODE_ATTN_SLICE_BYTES", rows * row_bytes)
    calls = []
    real = M.causal_attention

    def counted(q, *args, **kw):
        calls.append(q.shape[0])
        return real(q, *args, **kw)

    monkeypatch.setattr(M, "causal_attention", counted)
    sliced, _ = S.decode_step(params, cache, nxt, 7)
    assert torch.equal(sliced, whole)
    assert calls == [min(rows, 5 - i) for i in range(0, 5, rows)] * \
        tcfg.n_layers
    want = np.asarray(JS.generate(jparams, jnp.asarray(tokens), jcfg,
                                  n_new=n_new, max_len=max_len))
    got = S.generate(params, _t(tokens), tcfg, n_new=n_new, max_len=max_len)
    assert np.array_equal(got.numpy(), want)


def test_slot_server_streams_match_jax(setup):
    """admit, serve_chunk, release, recycling and bucketed admission
    emit the same greedy streams as the JAX slot server."""
    jcfg, tcfg, jparams, params = setup
    V = jcfg.vocab_size
    pa, pb, pc, pd = (_prompt(s, n, V) for s, n in
                      ((10, 5), (11, 9), (12, 4), (13, 13)))
    buckets = (8, 16)
    jst = JS.init_server_state(jcfg, 4, 32)
    st = S.init_server_state(tcfg, 4, 32, device="cpu")

    def both(jfn, tfn):
        nonlocal jst, st
        jst, st = jfn(jst), tfn(st)
        assert np.array_equal(st["token"].numpy(), np.asarray(jst["token"]))
        assert np.array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))
        assert np.array_equal(st["active"].numpy(),
                              np.asarray(jst["active"]))

    def chunk(n):
        out = {}

        def j(s):
            s, out["j"] = JS.serve_chunk(jparams, s, n)
            return s

        def t(s):
            s, out["t"] = S.serve_chunk(params, s, n)
            return s
        both(j, t)
        assert np.array_equal(out["t"].numpy(), np.asarray(out["j"]))
        return out["t"]

    both(lambda s: JS.admit(jparams, s, jnp.asarray(pa), jnp.int32(0)),
         lambda s: S.admit(params, s, _t(pa), 0))
    both(lambda s: JS.admit(jparams, s, jnp.asarray(pb), jnp.int32(2)),
         lambda s: S.admit(params, s, _t(pb), 2))
    em = chunk(5)
    assert (em[:, 1] == -1).all() and (em[:, 0] >= 0).all()
    both(lambda s: JS.admit_bucketed(jparams, s, jnp.asarray(pc),
                                     jnp.int32(1), buckets=buckets),
         lambda s: S.admit_bucketed(params, s, _t(pc), 1, buckets=buckets))
    chunk(4)
    both(lambda s: JS.release(s, 0), lambda s: S.release(s, 0))
    both(lambda s: JS.admit_bucketed(jparams, s, jnp.asarray(pd),
                                     jnp.int32(0), buckets=buckets),
         lambda s: S.admit_bucketed(params, s, _t(pd), 0, buckets=buckets))
    chunk(6)


def test_self_retirement_at_max_len_matches_jax(setup):
    jcfg, tcfg, jparams, params = setup
    prompt = np.array([1, 2, 3, 4, 5], np.int32)
    jst = JS.admit(jparams, JS.init_server_state(jcfg, 1, 8),
                   jnp.asarray(prompt), jnp.int32(0))
    _, jem = JS.serve_chunk(jparams, jst, 6)
    st = S.admit(params, S.init_server_state(tcfg, 1, 8, device="cpu"),
                 _t(prompt), 0)
    st, em = S.serve_chunk(params, st, 6)
    assert np.array_equal(em.numpy(), np.asarray(jem))
    assert (em[:3] >= 0).all() and (em[3:] == -1).all()
    assert not bool(st["active"][0])


# (prompt length, slot, true_len, temperature, with a key/generator)
ADMIT_ERRORS = [
    (5, 2, None, 0.0, False),     # slot past the table
    (5, -1, None, 0.0, False),    # negative slot
    (9, 0, None, 0.0, False),     # prompt longer than the cache
    (8, 0, None, 0.0, False),     # prompt fills the cache
    (5, 0, 0, 0.0, False),        # true_len below 1
    (5, 0, 6, 0.0, False),        # true_len past the prompt
    (8, 0, 8, 0.0, False),        # true_len leaves no decode room
    (5, 0, None, -1.0, True),     # negative temperature
    (5, 0, None, 0.7, False),     # sampling without randomness
]


def _first_words(exc, n=3):
    return str(exc.value).split()[:n]


@pytest.mark.parametrize("lp,slot,true_len,temp,keyed", ADMIT_ERRORS)
def test_admit_validation_matches_jax(setup, lp, slot, true_len, temp,
                                      keyed):
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(20, lp, jcfg.vocab_size)
    with pytest.raises(ValueError) as jerr:
        JS.admit(jparams, JS.init_server_state(jcfg, 2, 8),
                 jnp.asarray(prompt), jnp.int32(slot), true_len=true_len,
                 temperature=temp,
                 key=jax.random.PRNGKey(0) if keyed else None)
    with pytest.raises(ValueError) as terr:
        S.admit(params, S.init_server_state(tcfg, 2, 8, device="cpu"),
                _t(prompt), slot, true_len=true_len, temperature=temp,
                generator=torch.Generator() if keyed else None)
    assert _first_words(terr) == _first_words(jerr)


@pytest.mark.parametrize("n_new,temp,keyed", [
    (10, 0.0, False),             # L + n_new past the cache
    (2, -0.5, True),              # negative temperature
    (2, 0.7, False),              # sampling without randomness
])
def test_generate_validation_matches_jax(setup, n_new, temp, keyed):
    jcfg, tcfg, jparams, params = setup
    tokens = _prompt(21, 7, jcfg.vocab_size)[None, :]
    with pytest.raises(ValueError) as jerr:
        JS.generate(jparams, jnp.asarray(tokens), jcfg, n_new=n_new,
                    max_len=16, temperature=temp,
                    key=jax.random.PRNGKey(0) if keyed else None)
    with pytest.raises(ValueError) as terr:
        S.generate(params, _t(tokens), tcfg, n_new=n_new, max_len=16,
                   temperature=temp,
                   generator=torch.Generator() if keyed else None)
    assert _first_words(terr) == _first_words(jerr)


@pytest.mark.parametrize("which", ["default", "tiny"])
@pytest.mark.parametrize("grant,max_len", [(16, 2048), (8, 2048), (1, 64),
                                           (0.01, 64), (0.5, 4096)])
def test_max_batch_for_grant_matches_jax(which, grant, max_len):
    jcfg, tcfg = JM.ModelConfig(), M.ModelConfig()
    if which == "tiny":
        jcfg, tcfg = jcfg.tiny(), tcfg.tiny()
    assert (S.max_batch_for_grant(tcfg, grant, max_len)
            == JS.max_batch_for_grant(jcfg, grant, max_len))
    assert (S.cache_hbm_bytes(tcfg, 3, max_len)
            == JS.cache_hbm_bytes(jcfg, 3, max_len))


@pytest.mark.parametrize("n,max_len", [(1, None), (32, None), (33, None),
                                       (2048, None), (2049, None),
                                       (40, 48), (49, 48), (2100, 4096)])
def test_bucket_len_matches_jax(n, max_len):
    try:
        want = JS.bucket_len(n, max_len=max_len)
    except ValueError:
        with pytest.raises(ValueError):
            S.bucket_len(n, max_len=max_len)
        return
    assert S.bucket_len(n, max_len=max_len) == want


def test_admission_stats_count_per_bucket(setup):
    _, tcfg, _, params = setup
    S.reset_admission_stats()
    st = S.init_server_state(tcfg, 3, 32, device="cpu")
    for slot, n in enumerate((3, 7, 12)):
        st = S.admit_bucketed(params, st, _t(_prompt(30 + slot, n, 256)),
                              slot, buckets=(8, 16))
    # The reference's shape: the second admission into bucket 8 reuses
    # the first one's compiled key.
    assert S.admission_stats() == {
        8: {"admits": 2, "jitMisses": 1, "jitHits": 1},
        16: {"admits": 1, "jitMisses": 1, "jitHits": 0}}
    S.reset_admission_stats()
    assert S.admission_stats() == {}


def test_sampling_contract(setup):
    """Sampled ids stay in vocab, one generator state gives one stream,
    and temperature-0 slots stay greedy beside sampled ones."""
    _, tcfg, _, params = setup
    tokens = _t(_prompt(40, 7, tcfg.vocab_size))[None, :]
    runs = [S.generate(params, tokens, tcfg, n_new=6, max_len=16,
                       temperature=1.0,
                       generator=torch.Generator().manual_seed(s))
            for s in (3, 3)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < tcfg.vocab_size)).all()

    greedy = S.generate(params, tokens, tcfg, n_new=6, max_len=16)
    st = S.init_server_state(tcfg, 2, 16, device="cpu")
    st = S.admit(params, st, tokens[0], 0)
    st = S.admit(params, st, tokens[0], 1, temperature=1.0,
                 generator=torch.Generator().manual_seed(1))
    st, em = S.serve_chunk(params, st, 5, temperature=[0.0, 1.0],
                           generator=torch.Generator().manual_seed(2))
    assert torch.equal(em[:, 0], greedy[0, 8:])
    assert ((em[:, 1] >= 0) & (em[:, 1] < tcfg.vocab_size)).all()
    with pytest.raises(ValueError, match="per-slot"):
        S.serve_chunk(params, st, 2, temperature=0.5,
                      generator=torch.Generator())
    with pytest.raises(ValueError, match="torch.Generator"):
        S.serve_chunk(params, st, 2, temperature=[0.5, 0.5])
