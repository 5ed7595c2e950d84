"""The port's host text path against the JAX package's, output for output
(no model is compiled here): the WordPiece tokenizer (the C++ fast path
and the Python one), sentence splitting and detokenization, the
vocabulary, request featurization (``serving/featurize.chunk_to_batch``),
training-sample featurization with labels (``data/featurize.featurize``),
answer post-processing (``runtime/io``), and checkpoints: the port's
reader of the flax msgpack the JAX package writes, leaf for leaf against
``flax.serialization.msgpack_restore``, and the port's own format.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from case_rg_tpu.config import DataConfig as JaxDataConfig
from case_rg_tpu.data import text as jax_text
from case_rg_tpu.data.vocab import Vocabulary as JaxVocabulary
from case_rg_tpu.runtime import io as jax_io
from case_rg_tpu.serving import featurize as jax_serving
from case_rg_tpu_torch import native
from case_rg_tpu_torch.config import DataConfig
from case_rg_tpu_torch.data import text as port_text
from case_rg_tpu_torch.data.vocab import Vocabulary
from case_rg_tpu_torch.runtime import io as port_io
from case_rg_tpu_torch.serving import featurize as port_serving
from case_rg_tpu_torch.train import checkpoint as port_ckpt
from fixtures import WORDS, make_dataset
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

# the packages' __init__ export the function ``featurize`` under the
# module's name
jax_featurize = importlib.import_module("case_rg_tpu.data.featurize")
port_featurize = importlib.import_module("case_rg_tpu_torch.data.featurize")

EDGE = ["", "   ", "Héllo Wörld, naïve café!", "東京は大きい 都市です",
        "a" * 150 + " short", "[SEP] kinetic [CLS] energy [MASK]",
        "kinetic-energy's (motion)... 42 ocean?!", "whalesharks dolphins",
        "Energy\tmotion\nheat power", "Dr. Smith went home. It rained! "
        "Did it? Yes.", "e.g. the U.S. grid. power plants."]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The toy corpus's texts, and a wordpiece vocab.txt over its words,
    some split into ## pieces."""
    root = str(tmp_path_factory.mktemp("text"))
    base = make_dataset(root, "toy", n_queries=12, n_passages=20)
    texts = []
    for name in ("query", "passage", "answer"):
        with open(os.path.join(base, f"toy.{name}")) as f:
            texts += [line.rstrip("\n").split("\t")[-1]
                      for line in f.readlines()[1:]]
    pieces = sorted({w[:3] for w in WORDS} | {"##" + w[3:] for w in WORDS
                                               if len(w) > 3}
                    | set(WORDS[::2]) | {".", ",", "?", "!", "-", "'", "(",
                                         ")", "42", "##s", "a", "##a", "e",
                                         "##g"})
    specials = ["[PAD]", "[unused0]", "[UNK]", "[unused1]", "[SEP]", "[CLS]",
                "[MASK]"]
    path = os.path.join(root, "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(specials + pieces) + "\n")
    return {"texts": texts + EDGE, "vocab_path": path}


def _vocabs(corpus):
    return (Vocabulary.load(corpus["vocab_path"]),
            JaxVocabulary.load(corpus["vocab_path"]))


def test_vocabulary_and_detokenizer(corpus):
    port, ref = _vocabs(corpus)
    assert port.vocab2id == ref.vocab2id and port.id2vocab == ref.id2vocab
    assert (port.pad_id, port.bos_id, port.unk_id, port.eos_id, port.sep_id,
            port.cls_id, port.mask_id) == (ref.pad_id, ref.bos_id, ref.unk_id,
                                           ref.eos_id, ref.sep_id, ref.cls_id,
                                           ref.mask_id)
    words = corpus["texts"][3].split() + ["nope", "[SEP]"]
    assert port.ids(words) == ref.ids(words)
    assert port.words(range(len(port) + 2)) == ref.words(range(len(ref) + 2))
    toks = ["kin", "##etic", "energy", "[SEP]", "##s", "wh", "##ale"]
    assert port.detokenizer()(toks) == ref.detokenizer()(toks)


def test_tokenizer_split_and_detokenize(corpus):
    port, ref = _vocabs(corpus)
    pt, rt = port.tokenizer(), ref.tokenizer()
    texts = corpus["texts"]
    assert [pt(t) for t in texts] == [rt(t) for t in texts]
    assert pt.batch(texts) == rt.batch(texts)
    assert [port_text.split_sentences(t) for t in texts] == \
        [jax_text.split_sentences(t) for t in texts]
    assert [port_text.basic_tokenize(t) for t in texts] == \
        [jax_text.basic_tokenize(t) for t in texts]
    toked = pt.batch(texts)
    assert [port_text.bert_detokenize(t) for t in toked] == \
        [jax_text.bert_detokenize(t) for t in toked]


def test_native_and_python_tokenizers_agree(corpus):
    """The C++ fast path (built into build/native/) gives the Python
    tokenizer's tokens, per text and batched; skips where no compiler
    builds it (the Python path is the documented fallback there)."""
    if not native.available():
        pytest.skip("no C++ compiler built the native tokenizer")
    assert native.lib_path().parent.parent == native.BUILD_ROOT
    port, _ = _vocabs(corpus)
    fast = port_text.WordPieceTokenizer(port.vocab2id)
    slow = port_text.WordPieceTokenizer(port.vocab2id)
    slow._native_tried = True           # the pure-Python path only
    assert fast._native_tokenizer() is not None
    texts = corpus["texts"]
    assert fast.batch(texts) == slow.batch(texts)
    assert [fast(t) for t in texts] == [slow(t) for t in texts]


def _requests():
    rng = np.random.RandomState(5)

    def sent(lo, hi):
        return " ".join(rng.choice(WORDS, rng.randint(lo, hi + 1)))

    reqs = []
    for i, n_pass in enumerate([3, 7, 0, 5, 1, 2]):
        r = {"id": f"r{i}", "query": sent(2, 9) + " ?",
             "passages": [f"{sent(4, 12)}. {sent(4, 12)}! {sent(2, 5)}"
                          for _ in range(n_pass)]}
        if i % 2:
            r["history"] = [sent(2, 6) for _ in range(i % 3 + 1)]
        if i in (1, 4):
            r["max_tokens"] = [0, 3, 99][i % 3]
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("n_req, width, pool", [
    (6, 8, 4),      # history, over-long pools, an empty pool, caps, padding
    (2, 4, 2),      # a pool bucket smaller than num_passage
    (1, 1, 5),
], ids=["pad-rows", "pool-bucket", "single"])
def test_chunk_to_batch(corpus, n_req, width, pool):
    port, ref = _vocabs(corpus)
    reqs = _requests()[:n_req]
    kw = dict(query_len=16, passage_len=12, num_passage=pool, answer_len=6)
    got = port_serving.chunk_to_batch(reqs, "case", port, DataConfig(**kw),
                                      width)
    want = jax_serving.chunk_to_batch(reqs, "case", ref, JaxDataConfig(**kw),
                                      width)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k


def test_bucket_helpers():
    for spec, cap in [("2,5", 10), ("10,3,3", 10), ("", 4)]:
        assert port_serving.parse_buckets(spec, cap) == \
            jax_serving.parse_buckets(spec, cap)
    for n in range(12):
        assert port_serving.bucket_for(n, [2, 5, 10]) == \
            jax_serving.bucket_for(n, [2, 5, 10])
    lines = ['{"id": 1}\n', "\n", '{"id": 2}\n', '{"id": 3}\n']
    assert list(port_serving.read_chunks(iter(lines), 2)) == \
        list(jax_serving.read_chunks(iter(lines), 2))
    with pytest.raises(SystemExit):
        port_serving.parse_buckets("0,2", 4)


def _training_inputs(vocab, rng):
    """Samples with gold passages and answers copied from them, the
    tokenized query/passage tables and a frequency table."""
    words = [w for w in vocab.vocab2id if not w.startswith("[")]
    query, passage, samples = {}, {}, []
    for p in range(8):
        passage[f"p{p}"] = list(rng.choice(words, rng.randint(5, 30)))
    for q in range(5):
        query[f"q{q}"] = list(rng.choice(words, rng.randint(2, 20)))
    for q in range(5):
        pool = [f"p{p}" for p in rng.choice(8, rng.randint(1, 7),
                                            replace=False)]
        gold = pool[:rng.randint(0, 3)]
        src = passage[gold[0]] if gold else passage[pool[-1]]
        start = rng.randint(0, len(src))
        samples.append({"query_id": f"q{q}",
                        "context_id": [f"q{c}" for c in range(q)][-2:],
                        "passage_pool_id": pool, "passage_id": gold,
                        "answer": src[start:start + rng.randint(1, 12)]})
    freq = {i: float(rng.randint(1, 50)) for i in range(len(vocab))}
    return samples, query, passage, freq


@pytest.mark.parametrize("model",
                         ["case", "masque", "tmemnet", "glks", "gttp", "s2sa"])
def test_featurize_training_samples(corpus, model):
    port, ref = _vocabs(corpus)
    samples, query, passage, freq = _training_inputs(
        port, np.random.RandomState(2))
    kw = dict(query_len=20, passage_len=16, num_passage=4, answer_len=8,
              min_window_size=3, num_windows=2)
    got = port_featurize.featurize(model, samples, query, passage, port, freq,
                                   DataConfig(**kw))
    want = jax_featurize.featurize(model, samples, query, passage, ref, freq,
                                   JaxDataConfig(**kw))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    assert port_featurize.sample_metadata(samples) == \
        jax_featurize.sample_metadata(samples)


def test_ids_to_sentence_and_remove_duplicate(corpus):
    port, ref = _vocabs(corpus)
    rng = np.random.RandomState(4)
    rows = rng.randint(0, len(port) + 3, size=(12, 14))
    rows[3, :] = port.pad_id
    rows[5, 4] = port.eos_id
    rows[7, :6] = np.tile(rows[7, :3], 2)
    got = [port_io.ids_to_sentence(r, port) for r in rows]
    want = [jax_io.ids_to_sentence(r, ref) for r in rows]
    assert got == want
    assert [port_io.ids_to_words(r, port) for r in rows] == \
        [jax_io.ids_to_words(r, ref) for r in rows]
    loops = [list("abcabcabc"), list("abcdabcd") + ["x"], list("aaaa"),
             list("xyz")]
    for sents in (got, loops):
        a, b = [list(s) for s in sents], [list(s) for s in sents]
        port_io.remove_duplicate(a)
        jax_io.remove_duplicate(b)
        assert a == b


def _jax_state():
    """A JAX TrainState over a small param tree (an Adam state, an EMA and
    a step, as the JAX trainer's): no model is compiled."""
    from case_rg_tpu.config import TrainConfig
    from case_rg_tpu.train.trainer import TrainState, make_optimizer
    rng = np.random.RandomState(0)

    def arr(*shape):
        return jnp.asarray(rng.randn(*shape).astype(np.float32))

    params = {"encoder": {"Dense_0": {"kernel": arr(4, 3), "bias": arr(3)},
                          "attn": {"qkv_kernel": arr(3, 9),
                                   "qkv_bias": arr(9)}},
              "norm": {"scale": arr(3), "bias": arr(3)},
              "embed": {"embedding": arr(7, 4)}}
    tx = make_optimizer(TrainConfig(), 100)
    ema = jax.tree_util.tree_map(lambda x: x * 0.5, params)
    return TrainState(params=params, opt_state=tx.init(params), ema=ema,
                      step=jnp.asarray(12, jnp.int32))


def _same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_msgpack_reader_equals_flax(tmp_path, monkeypatch):
    from case_rg_tpu.train.checkpoint import save_checkpoint
    state = jax.device_get(_jax_state())
    save_checkpoint(str(tmp_path), 3, state)
    with open(tmp_path / "model" / "3.ckpt", "rb") as f:
        data = f.read()
    _same_tree(port_ckpt.msgpack_restore(data),
               serialization.msgpack_restore(data))

    # a bfloat16 leaf, numpy scalars, Python values, and leaves over
    # flax's chunk size (lowered here) stored as chunked dicts
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    extra = {"bf16": np.asarray(jnp.arange(6, dtype=jnp.bfloat16) / 3),
             "big": np.arange(100, dtype=np.float32).reshape(4, 25),
             "big_bf16": np.asarray(jnp.linspace(-2, 2, 70,
                                                 dtype=jnp.bfloat16)),
             "scalars": {"i": np.int64(-7), "f": np.float32(2.5),
                         "b": np.bool_(True)},
             "py": {"i": 3, "neg": -40000, "f": 0.25, "s": "é", "n": None,
                    "t": True, "long": 2 ** 40, "list": [1, "a", 2.0]},
             "empty": {}}
    data = serialization.msgpack_serialize(extra)
    assert b"__msgpack_chunked_array__" in data
    _same_tree(port_ckpt.msgpack_restore(data),
               serialization.msgpack_restore(data))


def test_load_checkpoint_reads_the_jax_package(tmp_path):
    from case_rg_tpu.train.checkpoint import save_checkpoint
    from case_rg_tpu_torch.bridge import state_dict_from_jax
    state = jax.device_get(_jax_state())
    save_checkpoint(str(tmp_path), 2, state)
    assert port_ckpt.checkpoint_exists(str(tmp_path), 2)
    assert port_ckpt.latest_epoch(str(tmp_path)) == 2
    got = port_ckpt.load_checkpoint(str(tmp_path), 2)
    assert got["step"] == 12
    for name in ("params", "ema"):
        want = state_dict_from_jax(getattr(state, name))
        assert sorted(got[name]) == sorted(want)
        for k in want:
            assert got[name][k].dtype == torch.float32
            assert np.array_equal(got[name][k].numpy(), want[k]), k
    assert got["opt_state"] is not None


def test_port_checkpoint_round_trip(tmp_path):
    out = str(tmp_path)
    g = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn(3, 4, generator=g),
              "b.bias": torch.randn(5, generator=g).to(torch.bfloat16)}
    ema = {k: v * 2 for k, v in params.items()}
    path = port_ckpt.save_checkpoint(out, 4, {"params": params, "ema": ema,
                                              "step": 9})
    assert path.endswith(os.path.join("model", "4.pt"))
    assert port_ckpt.latest_epoch(out) == 4 and port_ckpt.best_epoch(out) \
        is None
    port_ckpt.save_best(out, 4, 0.5)
    assert port_ckpt.best_epoch(out) == 4
    port_ckpt.save_checkpoint(out, 5, {"params": params, "ema": ema,
                                       "step": 10}, update_latest=False)
    assert port_ckpt.latest_epoch(out) == 4
    got = port_ckpt.load_checkpoint(out, 4)
    assert got["step"] == 9 and got["opt_state"] is None
    for name, want in (("params", params), ("ema", ema)):
        for k, v in want.items():
            assert got[name][k].dtype == v.dtype and torch.equal(got[name][k],
                                                                 v)
    assert not port_ckpt.checkpoint_exists(out, 6)
    os.makedirs(os.path.join(out, "model", "6.orbax"))
    assert port_ckpt.checkpoint_exists(out, 6)
    with pytest.raises(SystemExit, match="orbax"):
        port_ckpt.load_checkpoint(out, 6)
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_checkpoint(out, 7)
