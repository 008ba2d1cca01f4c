"""The port's native C++ BM25 engine (``mfar_tpu_torch/native``, built from
the copied source with g++ into ``mfar_tpu_torch/build/``) against the
port's and the JAX package's scipy BM25: the stemmer and tokenizer, scores,
postings and their widths, retrieval, and ``native.bin`` indices saved by
one package and loaded by the other.  Tolerances are
``tests/test_native.py``'s (rtol 1e-5, atol 1e-6 on scores)."""

import os
import shutil

import numpy as np
import pytest
import torch

from mfar_tpu import native as jax_native
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu_torch import native
from mfar_tpu_torch.sparse.bm25 import BM25Index
from mfar_tpu_torch.sparse.stemmer import porter2_stem
from mfar_tpu_torch.sparse.tokenize import tokenize

torch.set_num_threads(1)

# the JAX package's library (tests/conftest.py builds it with make) is the
# other side of the cross-package checks
pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is missing: the native engine builds from source")

DOCS = [
    ("d0", "the red shoe glows brightly at night"),
    ("d1", "a blue lamp that glows in the dark"),
    ("d2", "red lamp red shoe red clock"),
    ("d3", "green table with a matching green chair; nationally rated!"),
    ("d4", ""),
    ("d5", "shoe shoe shoe shoe running easily generation"),
]
QUERIES = ["red shoe", "glows", "green chair table", "red red lamp",
           "running generation", "zebra missing", ""]


def test_library_builds_into_the_build_directory():
    path = native.build_native_library()
    assert native.available() and os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "build"
    src_dir = os.path.dirname(native.SOURCE)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    # the port's library, never the JAX package's
    assert os.path.dirname(native._load()._name) == native.BUILD_DIR


def test_stemmer_and_tokenizer_match_the_python_copies():
    words = """running fairly easily generation national skies dying agreed
    conflated troubling hopping happy relational generously communication
    abilities absorption atomization consciousness libraries knitting
    proceed exceed ties cries gas this gaps congeneric beautiful""".split()
    for w in words:
        assert native.native_stem(w) == porter2_stem(w), w
    texts = [t for _, t in DOCS] + [
        "Hello, World! это test_underscore 42 a7b",
        "MixedCASE    punctuation...and---dashes",
        "foo—bar baz", "don’t panic", "CAFÉ au lait", "naïve résumé", "«quoted» words",
        "中文、测试", "emoji \U0001F600 test", "Ηλιος Москва", "x" * 100 + " longtoken",
        "é a xy",
    ]
    for t in texts:
        assert native.native_tokenize(t) == list(tokenize(t)), t


@pytest.fixture(scope="module")
def indices():
    return dict(native=BM25Index.create(DOCS, backend="native"),
                auto=BM25Index.create(DOCS),
                scipy=BM25Index.create(DOCS, backend="scipy"),
                jax=JaxBM25.create(DOCS, backend="scipy"))


def test_scores_match_scipy_in_both_packages(indices):
    nat = indices["native"]
    assert nat.native is not None and indices["auto"].native is not None
    assert nat.vocab_size == indices["scipy"].vocab_size
    for ref in ("scipy", "jax"):
        np.testing.assert_allclose(nat.get_scores_batch(QUERIES),
                                   indices[ref].get_scores_batch(QUERIES),
                                   rtol=1e-5, atol=1e-6)
    for q in QUERIES:
        np.testing.assert_allclose(nat.get_scores(q), indices["jax"].get_scores(q),
                                   rtol=1e-5, atol=1e-6, err_msg=q)
    np.testing.assert_allclose(nat.score_batch(["red shoe"], ["d2", "nope", "d0"]),
                               indices["jax"].score_batch(["red shoe"], ["d2", "nope", "d0"]),
                               rtol=1e-5)
    sparse = nat.get_scores_sparse("red shoe")
    assert sparse == pytest.approx(indices["jax"].get_scores_sparse("red shoe"), rel=1e-5)
    nat.set_safe_docs({0})
    assert set(nat.get_scores_sparse("red shoe")) == {0}
    nat.set_safe_docs(set())


@pytest.mark.parametrize("pad", [4, 128, None])
def test_postings_and_widths_densify_like_scipy(indices, pad):
    """Postings densify as scipy's; the width is the longest query's in a
    geometric bucket, or with ``pad_multiple=None`` (the port's engine,
    which compiles nothing per width; not in the JAX package) the longest
    itself."""
    queries = ["red shoe", "glows", "red red lamp", "zebra", ""]
    got_i, got_v = indices["native"].get_postings_batch(queries, pad_multiple=pad)
    for ref in ("scipy", "jax") if pad else ("scipy",):
        ref_i, ref_v = indices[ref].get_postings_batch(queries, pad_multiple=pad)
        assert got_i.shape == ref_i.shape and got_i.dtype == np.int32
        dn = np.zeros((len(queries), len(DOCS)), np.float32)
        dr = np.zeros_like(dn)
        for qi in range(len(queries)):
            np.add.at(dn[qi], got_i[qi], got_v[qi])
            np.add.at(dr[qi], ref_i[qi], ref_v[qi])
        np.testing.assert_allclose(dn, dr, rtol=1e-5, atol=1e-6)
    longest = max(len(indices["native"].native.get_postings(q)[0]) for q in queries)
    assert got_i.shape[1] == (native.bucket_width(longest, pad) if pad else longest)
    # one threaded call gives each query's own postings, zero-padded
    for threads in (1, 3):
        ids, vals = indices["native"].native.get_postings_batch(queries, pad, n_threads=threads)
        for qi, q in enumerate(queries):
            want_i, want_v = indices["native"].native.get_postings(q)
            np.testing.assert_array_equal(ids[qi, : len(want_i)], want_i)
            np.testing.assert_allclose(vals[qi, : len(want_v)], want_v, rtol=1e-6)
            assert not vals[qi, len(want_v):].any() and not ids[qi, len(want_i):].any()


def test_retrieve_matches_scipy(indices):
    nat, jax_idx = indices["native"], indices["jax"]
    for got, want in zip(nat.retrieve_batch(["red shoe", "glows"], top_k=3),
                         jax_idx.retrieve_batch(["red shoe", "glows"], top_k=3)):
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5)
    rows = nat.retrieve_rows_batch(["red shoe"], top_k=2)[0]
    assert set(rows.tolist()) == set(np.argsort(-jax_idx.get_scores("red shoe"))[:2].tolist())
    ids, scores = nat.native.retrieve("red shoe", 3)
    want_ids, want_scores = jax_native.NativeBM25.create([t for _, t in DOCS]).retrieve(
        "red shoe", 3)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-6)
    np.testing.assert_allclose(np.sort(scores)[::-1],
                               np.sort(jax_idx.get_scores("red shoe"))[::-1][:3], rtol=1e-5)


def test_native_bin_round_trips_across_packages(indices, tmp_path):
    """An index saved by the port's native backend loads in the JAX package
    and in the port; one saved by the JAX package's native backend loads in
    the port; each scores as the scipy backend."""
    want = indices["jax"].get_scores_batch(QUERIES)
    port_dir = str(tmp_path / "port")
    indices["native"].save(port_dir)
    assert os.path.exists(os.path.join(port_dir, "native.bin"))
    back = BM25Index.load(port_dir)
    assert back.native is not None and back.keys == indices["native"].keys
    np.testing.assert_allclose(back.get_scores_batch(QUERIES), want, rtol=1e-5, atol=1e-6)
    jax_back = JaxBM25.load(port_dir)
    assert jax_back.native is not None
    np.testing.assert_allclose(jax_back.get_scores_batch(QUERIES), want, rtol=1e-5, atol=1e-6)
    jax_dir = str(tmp_path / "jax")
    JaxBM25.create(DOCS, backend="native").save(jax_dir)
    from_jax = BM25Index.load(jax_dir)
    assert from_jax.native is not None
    np.testing.assert_allclose(from_jax.get_scores_batch(QUERIES), want, rtol=1e-5, atol=1e-6)


def test_corrupt_native_bin_fails_cleanly(tmp_path):
    good = native.NativeBM25.create([t for _, t in DOCS])
    path = str(tmp_path / "idx.bin")
    good.save(path)
    with open(path, "rb") as f:
        data = f.read()
    trunc = str(tmp_path / "trunc.bin")
    with open(trunc, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(OSError):
        native.NativeBM25.load(trunc)
