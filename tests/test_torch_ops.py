"""The port's kv_cache, rope, top_k and tree ops against the JAX package on
the same numpy inputs (CPU).  Token ids, indices and tree structure must be
identical; float results agree to 1e-5 relative (single float32 ops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.torch_parity import CPU, t2n, in_fresh_interpreter_module
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops import rope as jrope
from vispec_tpu.ops import topk as jtopk
from vispec_tpu.ops import tree as jtree
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.ops import rope as trope
from vispec_tpu_torch.ops import topk as ttopk
from vispec_tpu_torch.ops import tree as ttree

RTOL = 1e-5


# --------------------------------------------------------------------- kv_cache

def test_kv_cache_reset_advance_commit():
    rng = np.random.default_rng(0)
    L, H, M, D, T, P = 2, 2, 64, 8, 6, 4
    kb = rng.normal(size=(L, H, T, D)).astype(np.float32)
    vb = rng.normal(size=(L, H, T, D)).astype(np.float32)
    nodes = np.array([0, 2, 5, 5], np.int32)

    jc = jkv.advance(jkv.init_cache(L, H, M, D, jnp.float32), 20, 23)
    tc = tkv.advance(tkv.init_cache(L, H, M, D, torch.float32, CPU), 20, 23)
    assert (int(tc.length), int(tc.real_length)) == (int(jc.length), int(jc.real_length))

    jc = jkv.commit_from_blocks(jc, jnp.asarray(20, jnp.int32), jnp.asarray(kb),
                                jnp.asarray(vb), jnp.asarray(nodes), jnp.asarray(3))
    tc = tkv.commit_from_blocks(tc, torch.tensor(20, dtype=torch.int32),
                                torch.from_numpy(kb), torch.from_numpy(vb),
                                torch.from_numpy(nodes), torch.tensor(3))
    assert (int(tc.length), int(tc.real_length)) == (int(jc.length), int(jc.real_length))
    np.testing.assert_array_equal(t2n(tc.k), np.asarray(jc.k))
    np.testing.assert_array_equal(t2n(tc.v), np.asarray(jc.v))

    jc, tc = jkv.reset(jc), tkv.reset(tc)
    assert int(tc.length) == int(jc.length) == 0
    assert int(tc.real_length) == int(jc.real_length) == 0
    assert tc.k.abs().sum() > 0  # a logical reset keeps the buffers


def test_write_rows_clamps_like_dynamic_update_slice():
    buf = torch.zeros(10, dtype=torch.int32)
    tkv.write_rows(buf, 0, torch.tensor(8), torch.arange(1, 5, dtype=torch.int32))
    ref = lax.dynamic_update_slice(jnp.zeros(10, jnp.int32),
                                   jnp.arange(1, 5, dtype=jnp.int32), (8,))
    np.testing.assert_array_equal(t2n(buf), np.asarray(ref))


# --------------------------------------------------------------------- rope

@pytest.mark.parametrize("kw", [
    dict(linear_scale=4.0),
    dict(dynamic_ntk=(2.0, 64)),
    dict(dynamic_ntk=(2.0, 64), seq_len=70),
])
@pytest.mark.parametrize("start", [0, 100])
def test_cos_sin_matches_jax(kw, start):
    pos = np.arange(start, start + 40, dtype=np.int32)
    jc, js = jrope.cos_sin(jnp.asarray(pos), 32, 10000.0, **kw)
    tc, ts = trope.cos_sin(torch.from_numpy(pos), 32, 10000.0, **kw)
    np.testing.assert_allclose(t2n(tc), np.asarray(jc), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(t2n(ts), np.asarray(js), rtol=RTOL, atol=1e-5)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, 6, 16)).astype(np.float32)
    pos = np.arange(30, 36, dtype=np.int32)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                              *jrope.cos_sin(jnp.asarray(pos), 16))
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              *trope.cos_sin(torch.from_numpy(pos), 16))
    np.testing.assert_allclose(t2n(tq), np.asarray(jq), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(t2n(tk), np.asarray(jk), rtol=RTOL, atol=1e-6)


# --------------------------------------------------------------------- top_k

@pytest.mark.parametrize("vocab", [64, 2048])  # lax.top_k / iterated-argmax paths
def test_top_k_ties_take_the_lowest_index(vocab):
    rng = np.random.default_rng(2)
    # few distinct values => many ties, including at the k-th place
    x = rng.integers(0, 5, size=(3, vocab)).astype(np.float32)
    jv, ji = jtopk.top_k(jnp.asarray(x), 8)
    tv, ti = ttopk.top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(t2n(ti), np.asarray(ji))
    np.testing.assert_array_equal(t2n(tv), np.asarray(jv))
    assert ti.dtype == torch.int32


# --------------------------------------------------------------------- tree

def _pool(rng, k=4, depth=3, ties=False):
    """A flat candidate pool in the draft's order: K root children, then K*K
    children per depth, each parented on one of the previous K beams."""
    c = k + k * k * depth
    tokens = rng.integers(0, 50, size=c).astype(np.int32)
    scores = -rng.uniform(0, 5, size=c).astype(np.float32)
    if ties:
        scores = np.round(scores)  # many equal scores across the pool
    parent1 = np.zeros(c, np.int32)
    prev = np.arange(k)
    for i in range(depth):
        block = k + i * k * k
        parent1[block:block + k * k] = np.repeat(prev + 1, k)
        prev = block + rng.choice(k * k, size=k, replace=False)
    return tokens, scores, parent1


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_tree_path_and_greedy_accept(seed, ties):
    rng = np.random.default_rng(seed)
    tokens, scores, parent1 = _pool(rng, ties=ties)
    jt = jtree.build_tree(jnp.asarray(7, jnp.int32), jnp.asarray(tokens),
                          jnp.asarray(scores), jnp.asarray(parent1), 12, 4)
    tt = ttree.build_tree(torch.tensor(7, dtype=torch.int32), torch.from_numpy(tokens),
                          torch.from_numpy(scores), torch.from_numpy(parent1), 12, 4)
    for name in ("tokens", "parent", "mask", "depth"):
        np.testing.assert_array_equal(t2n(getattr(tt, name)),
                                      np.asarray(getattr(jt, name)), err_msg=name)

    # argmax rows that accept one random chain; siblings drawn from 50
    # tokens may repeat a token, which gives equally deep accepted nodes
    # (argmax ties on the first)
    argmax = rng.integers(0, 50, size=12).astype(np.int32)
    node = int(rng.integers(1, 12))
    chain = np.nonzero(np.asarray(jt.mask)[node])[0]
    for a, b in zip(chain[:-1], chain[1:]):
        argmax[a] = np.asarray(jt.tokens)[b]
    jb, ja = jtree.greedy_accept(jt, jnp.asarray(argmax))
    tb, ta = ttree.greedy_accept(tt, torch.from_numpy(argmax))
    assert (int(tb), int(ta)) == (int(jb), int(ja))
    for n in range(12):
        np.testing.assert_array_equal(
            t2n(ttree.path_to_root(tt, torch.tensor(n, dtype=torch.int32), 5)),
            np.asarray(jtree.path_to_root(jt, jnp.asarray(n, jnp.int32), 5)))


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
