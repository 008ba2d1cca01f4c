"""ctypes bindings for the native C++ BM25 engine (``bm25_native.cpp``).

Counterpart of ``mfar_tpu/native/__init__.py``.  The library is built from
the copied source with ``g++`` at first use, into ``mfar_tpu_torch/build/``
under a name that carries a hash of the source and the flags (never beside
the source, never at import), and loaded with ``ctypes``.  This is host
code: BM25 runs on the CPU in both packages.  Where ``g++`` is missing or the
build fails, :func:`available` is false and ``BM25Index(backend="auto")``
takes the scipy backend; ``backend="native"`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bm25_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
# no -march=native, so a library built on one host runs on another
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


def bucket_width(m: int, base: int = 128) -> int:
    """Round a width up to the next power-of-two multiple of ``base``: a
    geometric bucket keeps the number of distinct candidate and postings
    widths (and so of distinct kernel shapes) near log2 of the range, at
    <= 2x padding."""
    w = base
    while w < m:
        w *= 2
    return w


def postings_width(longest: int, pad_multiple: Optional[int]) -> int:
    """The width of a batch of postings whose longest row holds ``longest``:
    a :func:`bucket_width` of ``pad_multiple``, or with None the longest
    itself (at least 1), for a consumer that compiles nothing per width."""
    if pad_multiple is None:
        return max(longest, 1)
    return bucket_width(longest, pad_multiple)


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmfar_native-{h.hexdigest()[:16]}.so")


def build_native_library(force: bool = False) -> str:
    """Compile the library with ``g++`` unless it is built already; returns
    its path.  Raises when ``g++`` is missing or the build fails."""
    target = library_path()
    if os.path.exists(target) and not force:
        return target
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native BM25 engine builds from source")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n(exit {proc.returncode})\n{proc.stdout}")
    os.replace(tmp, target)
    return target


_P = ctypes.POINTER
_STRS = _P(ctypes.c_char_p)
_SIGNATURES = {  # name: (restype, argtypes)
    "mfar_bm25_build": (ctypes.c_void_p, [_STRS, ctypes.c_int32, ctypes.c_double,
                                          ctypes.c_double]),
    "mfar_bm25_free": (None, [ctypes.c_void_p]),
    "mfar_bm25_n_docs": (ctypes.c_int32, [ctypes.c_void_p]),
    "mfar_bm25_vocab_size": (ctypes.c_int64, [ctypes.c_void_p]),
    "mfar_bm25_score": (None, [ctypes.c_void_p, ctypes.c_char_p, _P(ctypes.c_float)]),
    "mfar_bm25_retrieve": (None, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                  _P(ctypes.c_int32), _P(ctypes.c_float)]),
    "mfar_bm25_postings_size": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_char_p]),
    "mfar_bm25_postings": (None, [ctypes.c_void_p, ctypes.c_char_p, _P(ctypes.c_int32),
                                  _P(ctypes.c_float)]),
    "mfar_bm25_postings_batch_sizes": (None, [ctypes.c_void_p, _STRS, ctypes.c_int32,
                                              _P(ctypes.c_int64), ctypes.c_int32]),
    "mfar_bm25_postings_batch_fill": (None, [ctypes.c_void_p, _STRS, ctypes.c_int32,
                                             ctypes.c_int64, _P(ctypes.c_int32),
                                             _P(ctypes.c_float), ctypes.c_int32]),
    "mfar_bm25_score_batch_mt": (None, [ctypes.c_void_p, _STRS, ctypes.c_int32,
                                        _P(ctypes.c_float), ctypes.c_int32]),
    "mfar_bm25_save": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_char_p]),
    "mfar_bm25_load": (ctypes.c_void_p, [ctypes.c_char_p]),
    "mfar_stem": (None, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]),
    "mfar_tokenize": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]),
}


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native_library())
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None when it cannot be built."""
    try:
        return _load()
    except (RuntimeError, OSError):
        return None


def available() -> bool:
    return load_library() is not None


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_P(ctypes.c_float))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_P(ctypes.c_int32))


def native_stem(word: str) -> str:
    # a stem is never longer than its input
    n = max(len(word.encode("utf-8")) + 1, 64)
    buf = ctypes.create_string_buffer(n)
    _load().mfar_stem(word.encode("utf-8"), buf, n)
    return buf.value.decode("utf-8")


def native_tokenize(text: str) -> List[str]:
    lib = _load()
    encoded = text.encode("utf-8")
    need = lib.mfar_tokenize(encoded, None, 0)
    buf = ctypes.create_string_buffer(int(need))
    lib.mfar_tokenize(encoded, buf, need)
    s = buf.value.decode("utf-8")
    return s.split("\n") if s else []


def _c_str_array(texts: Sequence[str]):
    encoded = [t.encode("utf-8") for t in texts]
    arr = (ctypes.c_char_p * len(texts))(*encoded)
    return arr, encoded  # keep encoded alive


class NativeBM25:
    """The native engine's scoring core; keys <-> row ids stay in Python
    (:class:`mfar_tpu_torch.sparse.bm25.BM25Index`)."""

    def __init__(self, handle, n_docs: int):
        self._lib = _load()
        self._handle = handle
        self.n_docs = n_docs

    @classmethod
    def create(cls, texts: Sequence[str], k1: float = 1.2, b: float = 0.75) -> "NativeBM25":
        arr, _keep = _c_str_array(texts)
        return cls(_load().mfar_bm25_build(arr, len(texts), k1, b), len(texts))

    @property
    def vocab_size(self) -> int:
        return int(self._lib.mfar_bm25_vocab_size(self._handle))

    def get_scores(self, query: str) -> np.ndarray:
        out = np.zeros(self.n_docs, np.float32)
        self._lib.mfar_bm25_score(self._handle, query.encode("utf-8"), _f32(out))
        return out

    def get_scores_batch(self, queries: Sequence[str], n_threads: int = 0) -> np.ndarray:
        """[B, n_docs] scores, the queries spread over ``n_threads`` threads
        (0: one per core)."""
        out = np.zeros((len(queries), self.n_docs), np.float32)
        arr, _keep = _c_str_array(queries)
        self._lib.mfar_bm25_score_batch_mt(self._handle, arr, len(queries), _f32(out),
                                           n_threads)
        return out

    def get_postings(self, query: str) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated (doc_ids, impacts) of the query's terms, one entry
        per term occurrence (consumers scatter-add)."""
        q = query.encode("utf-8")
        n = int(self._lib.mfar_bm25_postings_size(self._handle, q))
        ids = np.zeros(n, np.int32)
        vals = np.zeros(n, np.float32)
        if n:
            self._lib.mfar_bm25_postings(self._handle, q, _i32(ids), _f32(vals))
        return ids, vals

    def get_postings_batch(
        self, queries: Sequence[str], pad_multiple: Optional[int] = 128, n_threads: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched, threaded postings: one call sizes every query, one fills
        the zero-padded [B, M] (ids, impacts) pair, M the batch's longest
        rounded up to a :func:`bucket_width` of ``pad_multiple`` (None: the
        longest itself, at least 1)."""
        b = len(queries)
        arr, _keep = _c_str_array(queries)
        sizes = np.zeros(b, np.int64)
        self._lib.mfar_bm25_postings_batch_sizes(
            self._handle, arr, b, sizes.ctypes.data_as(_P(ctypes.c_int64)), n_threads)
        m = postings_width(int(sizes.max()) if b else 0, pad_multiple)
        ids = np.zeros((b, m), np.int32)
        vals = np.zeros((b, m), np.float32)
        self._lib.mfar_bm25_postings_batch_fill(self._handle, arr, b, m, _i32(ids), _f32(vals),
                                                n_threads)
        return ids, vals

    def retrieve(self, query: str, top_k: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full(top_k, -1, np.int32)
        scores = np.zeros(top_k, np.float32)
        self._lib.mfar_bm25_retrieve(self._handle, query.encode("utf-8"), top_k, _i32(ids),
                                     _f32(scores))
        return ids, scores

    def save(self, path: str) -> None:
        if self._lib.mfar_bm25_save(self._handle, path.encode("utf-8")) != 0:
            raise OSError(f"native BM25 save failed: {path}")

    @classmethod
    def load(cls, path: str) -> "NativeBM25":
        lib = _load()
        handle = lib.mfar_bm25_load(path.encode("utf-8"))
        if not handle:
            raise OSError(f"native BM25 load failed: {path}")
        return cls(handle, int(lib.mfar_bm25_n_docs(handle)))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.mfar_bm25_free(self._handle)
            self._handle = None
