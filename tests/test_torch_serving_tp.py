"""The port's tensor-parallel decode against the JAX package's serving on
one device: a (2, 2, 1) gang of gloo ranks on the CPU
(``tests/torch_serving_tp_rank.py``, started once for the module by
``tpushare_torch.runtime.launch``) prefills its dp shard of the prompts
over its H / tp heads and decodes, held to JAX's single-device prefill and
decode logits on the same weights, as the JAX package's
test_tensor_parallel_generate_matches_single_device holds its dp x tp
mesh."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpushare.workload import model as JM
from tpushare.workload import serving as JS
from tpushare_torch.runtime import launch

HERE = os.path.dirname(os.path.abspath(__file__))
GANG_DEADLINE_S = 600
#: Sharded logits against single-device logits, fp32: the JAX test's own
#: ``atol`` (the tp pair's all-reduces sum in another order).
LOGIT_ATOL = 1e-4
N_NEW, MAX_LEN = 4, 16


@pytest.fixture(scope="module")
def jax_side():
    """The JAX test's setup (tiny fp32, prompts [2, 7]): its greedy stream,
    and its prefill and decode logits fed that stream (teacher forcing)."""
    cfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32,
                              remat=False)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 7), 0,
                                 cfg.vocab_size)
    stream = JS.generate(params, prompts, cfg, n_new=N_NEW, max_len=MAX_LEN)
    logits, cache = JS.prefill(params, prompts, JS.init_cache(cfg, 2,
                                                              MAX_LEN))
    steps = [logits]
    for pos in range(7, 7 + N_NEW - 1):
        logits, cache = JS.decode_step(params, cache, stream[:, pos],
                                       jnp.asarray(pos))
        steps.append(logits)
    return {"cfg": cfg, "params": jax.tree_util.tree_map(np.asarray, params),
            "prompts": np.asarray(prompts), "stream": np.asarray(stream),
            "logits": np.stack([np.asarray(x) for x in steps], 1)}


@pytest.fixture(scope="module")
def gang(jax_side, tmp_path_factory):
    """(rank records, rank 0's arrays)."""
    tmp = tmp_path_factory.mktemp("tp_gang")
    tree = jax_side["params"]
    flat = {"p/embed": tree["embed"], "p/final_norm": tree["final_norm"]}
    for i, blk in enumerate(tree["blocks"]):
        flat.update({f"p/blocks/{i}/{k}": v for k, v in blk.items()})
    np.savez(tmp / "inputs.npz", prompts=jax_side["prompts"],
             stream=jax_side["stream"], **flat)
    records = launch.launch(
        [os.path.join(HERE, "torch_serving_tp_rank.py"),
         str(tmp / "inputs.npz"), str(tmp / "out.npz"),
         f"file://{tmp / 'rendezvous'}"], 4,
        deadline_s=GANG_DEADLINE_S, env={"OMP_NUM_THREADS": "1"})
    return records, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("step", range(N_NEW))
def test_tp_logits_match_single_device_jax(jax_side, gang, step):
    """Teacher-forced: step 0 is the prefill's logits, each later one a
    ``decode_step`` fed JAX's stream; gathered over dp."""
    _, got = gang
    np.testing.assert_allclose(got["teacher_forced"][:, step],
                               jax_side["logits"][:, step], atol=LOGIT_ATOL,
                               rtol=0)


def test_tp_generate_keeps_the_prompt_and_the_vocab(jax_side, gang):
    """The global stream on every rank: the prompt kept, every token in
    vocab, and in fp32 JAX's greedy stream token for token."""
    _, got = gang
    out, cfg = got["greedy"], jax_side["cfg"]
    assert out.shape == (2, 7 + N_NEW)
    assert (out[:, :7] == jax_side["prompts"]).all()
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    np.testing.assert_array_equal(out, jax_side["stream"])


def test_tp_prefill_runs_attention_once_a_layer_on_the_ranks_heads(
        jax_side, gang):
    """``n_layers`` prefill ``attn_fn`` calls a rank, each over its dp
    shard of the rows and its H / tp heads, and a cache of those heads."""
    records, _ = gang
    cfg = jax_side["cfg"]
    for rec in records:
        assert rec["prefill_attn_calls"] == [
            [1, 7, cfg.n_heads // 2, cfg.head_dim]] * cfg.n_layers
        assert rec["cache_shape"] == [1, MAX_LEN, cfg.n_heads // 2,
                                      cfg.head_dim]


def test_tp_ranks_sample_the_same_tokens(gang):
    """At temperature > 0, the ranks of a tp pair hold the same logits and
    draw from generators of the same seed: the same stream."""
    _, got = gang
    by_rank = got["sampled_by_tp_rank"]
    assert by_rank.shape == (2, 2, 7 + N_NEW)
    np.testing.assert_array_equal(by_rank[0], by_rank[1])


def test_init_cache_refuses_heads_that_do_not_split(gang):
    records, _ = gang
    assert all("do not split over tp=2" in r["refused"] for r in records)
