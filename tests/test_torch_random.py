"""The port's threefry streams (``repro_torch.utils.threefry``) against
``jax.random``, in process, over a grid of seeds, shapes and ranges.

Tolerance: bit for bit for the keys (``PRNGKey``, ``fold_in``, ``split``),
the random bits, ``uniform``, ``randint``, ``bernoulli``, ``permutation``
(up to the 128,256-token vocabulary, where sort keys tie) and the synthetic
batches; ``normal`` (float maths: the reference's erfinv polynomial over a
``log1p`` of its own) within 4 ulp of float32; ``init_tree`` on the reduced
llama3.2-1b config within 4 ulp for its float32 leaves and 1 ulp of
bfloat16 for the same config's bfloat16 leaves.
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.synthetic import make_batch as ref_make_batch
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticDataPipeline, make_batch
from repro_torch.models import build_model
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten

SEEDS = [0, 1, 7, 0x5EED, -1, 2**31 - 1, 2**33 + 5]
SHAPES = [(1,), (5,), (3, 7), (4, 33), (2, 3, 5)]
VOCAB = 128_256  # llama3.2-1b's


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two float32 (or
    bfloat16) arrays of finite values of one sign each."""
    view = np.int32 if a.dtype == np.float32 else np.int16
    return int(np.abs(a.view(view).astype(np.int64) - b.view(view).astype(np.int64)).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    k, jk = threefry.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert list(k) == np.asarray(jk).tolist()
    for data in (0, 1, 17, 2**32 - 1):
        assert list(threefry.fold_in(k, data)) == np.asarray(jax.random.fold_in(jk, data)).tolist()
    for num in (1, 2, 3, 11):
        assert [list(x) for x in threefry.split(k, num)] == np.asarray(jax.random.split(jk, num)).tolist()
    a, b = threefry.split(threefry.fold_in(k, 5))
    ja, jb = jax.random.split(jax.random.fold_in(jk, 5))
    assert (list(a), list(b)) == (np.asarray(ja).tolist(), np.asarray(jb).tolist())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_match_jax(seed, shape):
    k, jk = threefry.PRNGKey(seed), jax.random.PRNGKey(seed)
    bits = threefry.random_bits(k, shape).numpy().astype(np.uint32)
    assert bits.tobytes() == np.asarray(jax.random.bits(jk, shape, jnp.uint32)).tobytes()
    for lo, hi in ((0.0, 1.0), (-3.5, 2.25), (1e-3, 7.0)):
        got = threefry.uniform(k, shape, lo, hi).numpy()
        assert got.tobytes() == np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)).tobytes()
    for p in (0.05, 0.5, 0.93):
        got = threefry.bernoulli(k, p, shape).numpy()
        assert np.array_equal(got, np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", [(0, 10), (0, 1000), (0, VOCAB), (-5, 5), (3, 3), (9, 2),
                                  (-(2**31), 2**31 - 1), (0, 2**31 - 1)])
def test_randint_matches_jax(seed, span):
    """Both word streams and the span arithmetic: wrapping uint32 products
    (at 128,256 the squared 2**16 remainder wraps to 0), an empty range."""
    k, jk = threefry.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in ((7,), (4, 33)):
        got = threefry.randint(k, shape, *span).numpy()
        want = np.asarray(jax.random.randint(jk, shape, *span, jnp.int32))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (shape, span)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 10, 1000, 65_537, VOCAB])
def test_permutation_matches_jax(seed, n):
    """Rounds of stable sorts by fresh 32-bit words; at 128,256 some words
    tie, and the stable sort keeps the reference's order."""
    got = threefry.permutation(threefry.PRNGKey(seed), n).numpy()
    assert got.tobytes() == np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)).tobytes()
    if n == VOCAB:
        words = np.asarray(jax.random.bits(jax.random.split(jax.random.PRNGKey(seed))[1], (n,), jnp.uint32))
        assert len(np.unique(words)) < n  # ties do occur at this size


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp_of_jax(seed):
    k, jk = threefry.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in ((3, 7), (100_000,)):
        got, want = threefry.normal(k, shape).numpy(), np.asarray(jax.random.normal(jk, shape))
        assert got.dtype == want.dtype and np.array_equal(np.sign(got), np.sign(want))
        assert _ulps(got, want) <= 4
        assert np.mean(got == want) > 0.95  # almost every value bit-equal


def test_draws_work_through_the_index_in_chunks(monkeypatch):
    """A draw larger than a chunk gives the same words as one pass."""
    k = threefry.PRNGKey(3)
    whole = threefry.random_bits(k, (1000,))
    monkeypatch.setattr(threefry, "_CHUNK", 64)
    assert torch.equal(threefry.random_bits(k, (1000,)), whole)
    assert torch.equal(threefry.normal(k, (10, 100)).view(torch.int32),
                       threefry.normal(k, (1000,)).view(torch.int32).reshape(10, 100))


@pytest.mark.parametrize("vocab", [1000, VOCAB])
@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 4, 32), (3, 17, 2, 9), (123, 5, 8, 64), (-1, 2**31 - 1, 1, 5)])
def test_make_batch_matches_the_reference(vocab, seed, step, batch, seq):
    cfg = replace(get_config("llama3.2-1b").reduced(), vocab_size=vocab)
    ref_cfg = replace(ref_get_config("llama3.2-1b").reduced(), vocab_size=vocab)
    got, want = make_batch(cfg, seed, step, batch, seq), ref_make_batch(ref_cfg, seed, step, batch, seq)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.int32 and got[k].numpy().tobytes() == w.tobytes(), k


def test_pipeline_replays_by_step():
    cfg = get_config("llama3.2-1b").reduced()
    p = SyntheticDataPipeline(cfg, 2, 8, seed=4, device="cpu")
    first = [p.next() for _ in range(3)]
    p.restore({"seed": torch.tensor(4), "step": torch.tensor(1)})
    assert all(torch.equal(a["tokens"], b["tokens"]) for a, b in zip(first[1:], [p.next(), p.next()]))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference(param_dtype):
    """The reduced llama3.2-1b params from ``PRNGKey(0)``: one key per leaf
    in the reference's leaf order, the reference's normal draws."""
    ref_cfg = replace(ref_get_config("llama3.2-1b").reduced(), param_dtype=getattr(jnp, param_dtype))
    cfg = replace(get_config("llama3.2-1b").reduced(), param_dtype=getattr(torch, param_dtype))
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))))[0]
    paths, got = tree_flatten(build_model(cfg).init(threefry.PRNGKey(0), "cpu"))
    assert paths == [tuple(k.key for k in p) for p, _ in want]
    for p, x, (_, w) in zip(paths, got, want):
        w = np.asarray(w)
        x = x.numpy() if x.dtype != torch.bfloat16 else x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        assert x.dtype == w.dtype and x.shape == w.shape, p
        assert _ulps(x, w) <= (4 if w.dtype == np.float32 else 1), p
