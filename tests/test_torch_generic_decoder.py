"""The last two item-8 modules of the port against the JAX package, on the
CPU:

* ``ops/generic_decoder.GenericDecoderLayer`` against the JAX module in
  f32 (1e-5 absolute), its JAX params carried across by the weight bridge,
  with one and two memories, causal and not, with key masks, GELU and ReLU,
  and the gradients of a loss through it (1e-4);
* ``data/embeddings`` against the JAX functions bit for bit on a small
  GloVe text file: the parse (malformed lines skipped), both kinds of rows
  of the matrix (a word found in the file copies its vector; a word missing
  from it, or found with another width, draws N(0, 0.6) noise from the
  seed), the PAD row zeroed, the ``.npz`` cache written, read back and
  rebuilt when its shape is stale, and ``assign_embedding``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.data import embeddings as jemb
from case_rg_tpu.data.vocab import Vocabulary as JVocabulary
from case_rg_tpu.ops.generic_decoder import \
    GenericDecoderLayer as JGenericDecoderLayer
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.data import embeddings as temb
from case_rg_tpu_torch.data.vocab import Vocabulary
from case_rg_tpu_torch.ops.generic_decoder import GenericDecoderLayer
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

TOL = 1e-5
GRAD_TOL = 1e-4
D, HEADS, FF, T = 16, 2, 24, 7
MEM_LENS = (9, 5)
torch.set_float32_matmul_precision("highest")


def _inputs(num_memories, seed=0):
    rng = np.random.RandomState(seed)
    tgt = rng.randn(3, T, D).astype(np.float32)
    mems = [rng.randn(3, n, D).astype(np.float32)
            for n in MEM_LENS[:num_memories]]
    tgt_keep = np.arange(T)[None] < np.array([7, 4, 1])[:, None]
    mem_keeps = [np.arange(n)[None] < np.array([n, 2, 0])[:, None]
                 for n in MEM_LENS[:num_memories]]
    return tgt, mems, tgt_keep, mem_keeps


def _fast_jit(fn, *args):
    """``fn(*args)`` through one jit, compiled unoptimised (it runs once)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(*args)


def _params(module, *args, seed=1):
    """A parameter tree of the module's shapes, each leaf 0.3 * N(0, 1)
    from ``seed`` (nonzero biases and LayerNorm shifts)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("num_memories, causal, activation, masked", [
    (2, True, "gelu", True), (1, False, "relu", True),
    (2, True, "gelu", False)],
    ids=["two_memories_causal", "one_memory_relu", "no_masks"])
def test_generic_decoder_layer_matches_jax(num_memories, causal, activation,
                                           masked):
    tgt, mems, tgt_keep, mem_keeps = _inputs(num_memories)
    if not masked:
        tgt_keep = mem_keeps = None
    jmod = JGenericDecoderLayer(num_memories, D, HEADS, FF, dropout=0.1,
                                activation=activation)
    jargs = (jnp.asarray(tgt), [jnp.asarray(m) for m in mems],
             None if tgt_keep is None else jnp.asarray(tgt_keep),
             None if mem_keeps is None else [jnp.asarray(k)
                                             for k in mem_keeps])
    params = _params(jmod, *jargs)

    def jloss(p, tgt, mems):
        out = jmod.apply({"params": p}, tgt, mems, *jargs[2:],
                         causal=causal, deterministic=True)
        return jnp.sin(out).sum(), out

    (_, jout), (jgp, jgt) = _fast_jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), params, jargs[0], jargs[1])

    mod = GenericDecoderLayer(num_memories, D, HEADS, FF, dropout=0.1,
                              activation=activation)
    load_jax_params(mod, jax.tree_util.tree_map(np.asarray, params))
    x = torch.tensor(tgt, requires_grad=True)
    out = mod(x, [torch.tensor(m) for m in mems],
              None if tgt_keep is None else torch.tensor(tgt_keep),
              None if mem_keeps is None else [torch.tensor(k)
                                              for k in mem_keeps],
              causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=0)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgt),
                               atol=GRAD_TOL, rtol=0)
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    from case_rg_tpu_torch.bridge import state_dict_from_jax
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    assert set(got) == set(want)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], atol=GRAD_TOL, rtol=0,
                                   err_msg=n)


def test_generic_decoder_layer_dropout_is_seeded():
    """Training: the same generator state draws the same masks; another
    state, others; no generator is the deterministic layer."""
    tgt, mems, tgt_keep, mem_keeps = _inputs(2)
    mod = GenericDecoderLayer(2, D, HEADS, FF, dropout=0.3)
    from case_rg_tpu_torch.models import init_weights
    init_weights(mod, torch.Generator().manual_seed(0))
    args = (torch.tensor(tgt), [torch.tensor(m) for m in mems],
            torch.tensor(tgt_keep), [torch.tensor(k) for k in mem_keeps])
    run = lambda seed: mod(*args, gen=None if seed is None else  # noqa: E731
                           torch.Generator().manual_seed(seed))
    with torch.no_grad():
        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))
        assert not torch.equal(run(1), run(None))
        assert torch.equal(run(None), run(None))


GLOVE = """the 0.1 0.2 0.3 0.4
cat -1.5 2.25 0.0 3.125
dog 1 2 3
not a vector line
short 1.0
house 0.5 0.5 0.5 0.5
"""


@pytest.fixture(scope="module")
def glove(tmp_path_factory):
    d = tmp_path_factory.mktemp("glove")
    path = os.path.join(d, "glove.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(GLOVE)
    words = ["the", "cat", "dog", "house", "unseen", "zebra"]
    return str(d), path, words


def _vocabs(words):
    return (Vocabulary.build_from_texts([words]),
            JVocabulary.build_from_texts([words]))


def test_parse_glove_text_matches_jax(glove):
    _, path, _ = glove
    got, want = temb.parse_glove_text(path), jemb.parse_glove_text(path)
    assert list(got) == list(want) == ["the", "cat", "dog", "house"]
    for w in want:
        assert got[w].dtype == want[w].dtype
        assert np.array_equal(got[w], want[w])


@pytest.mark.parametrize("seed", [0, 7])
def test_embedding_matrix_matches_jax_bit_for_bit(glove, seed):
    """Found words copy their vectors; 'dog' (width 3 in the file), the
    vocabulary's specials and words absent from the file draw N(0, 0.6)
    rows from ``seed``; the PAD row is zero."""
    _, path, words = glove
    vocab, jvocab = _vocabs(words)
    assert vocab.id2vocab == jvocab.id2vocab
    got = temb.load_embedding_matrix(path, vocab, 4, seed=seed)
    want = jemb.load_embedding_matrix(path, jvocab, 4, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    table = temb.parse_glove_text(path)
    for w in ("the", "cat", "house"):
        assert np.array_equal(got[vocab.vocab2id[w]], table[w])
    assert not np.any(got[vocab.pad_id])
    noisy = [vocab.vocab2id[w] for w in ("dog", "unseen", "zebra")]
    assert np.all(got[noisy] != 0)


def test_embedding_cache_matches_jax(glove, tmp_path):
    """The cache: written on the first call, read back (the file is not
    parsed again), rebuilt when its shape is stale; byte-equal to the JAX
    package's cache contents at each step, and ``assign_embedding`` puts
    the matrix at a path of a param tree."""
    _, path, words = glove
    vocab, jvocab = _vocabs(words)
    mine = os.path.join(tmp_path, "port", "emb.npz")
    theirs = os.path.join(tmp_path, "jax", "emb.npz")
    first = temb.load_embedding_matrix(path, vocab, 4, cache=mine, seed=3)
    jfirst = jemb.load_embedding_matrix(path, jvocab, 4, cache=theirs, seed=3)
    assert first.tobytes() == jfirst.tobytes()
    assert np.load(mine)["matrix"].tobytes() == \
        np.load(theirs)["matrix"].tobytes()
    # a cache hit ignores the file and the seed
    again = temb.load_embedding_matrix(os.path.join(tmp_path, "missing"),
                                       vocab, 4, cache=mine, seed=99)
    assert again.tobytes() == first.tobytes()
    # a stale cache (another width) is rebuilt and overwritten
    wide = temb.load_embedding_matrix(path, vocab, 3, cache=mine, seed=3)
    jwide = jemb.load_embedding_matrix(path, jvocab, 3, cache=theirs, seed=3)
    assert wide.shape == (len(vocab), 3)
    assert wide.tobytes() == jwide.tobytes()
    assert np.load(mine)["matrix"].shape == (len(vocab), 3)
    tree = {"enc": {"embedding": {"embedding": np.zeros((len(vocab), 4),
                                                        np.float32)}}}
    keys = ("enc", "embedding", "embedding")
    got = temb.assign_embedding(tree, keys, first)
    want = jemb.assign_embedding(tree, keys, jfirst)
    assert got["enc"]["embedding"]["embedding"].tobytes() == \
        want["enc"]["embedding"]["embedding"].tobytes()
    assert not np.any(tree["enc"]["embedding"]["embedding"])   # a copy
