"""Bag-of-binary-words place recognition as dense linear algebra.

Array-native replacement for the vendored DBoW3 library
(/root/reference/3rdPartLib/DBow3, used at src/backend/vo_loopclosing.cpp:
251-253 `voc.transform(descriptors) → BowVector` and 425 `voc.score(a, b)`).

Re-design: DBoW3's hierarchical k-medians tree exists to make word lookup
O(k·L) per descriptor on a CPU.  Here the entire vocabulary is compared
against every descriptor in ONE matmul: descriptors and words are
unpacked to ±1 floats, so Hamming distance = (256 − a·bᵀ)/2 and word
assignment is an argmax of a (N, V) product.  tf-idf weighting and the
normalized-L1 similarity score (DBoW3's default, ScoringObject.h:73) are
then dense vector ops, and scoring one query against the whole keyframe
database — the reference's O(N) loop over KFs — is a single matvec.

The reference expects a pre-trained vocabulary file (voc_orb.dbow3,
launch/flvis_euroc_mav.launch:22 — not shipped in the repo).  Here the
vocabulary can be trained on-device from collected descriptors with batched
binary k-means (majority-vote centroids), or loaded from an .npz.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import orb


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Vocabulary:
    words_pm1: jax.Array    # (V, 256) ±1 float — centroid bits
    idf: jax.Array          # (V,) inverse document frequency weights


@functools.partial(jax.jit, static_argnames=("num_words", "iters"))
def _train_kernel(descriptors_packed, seed, num_words: int, iters: int):
    """The whole k-means as ONE jitted program, so a (re)train is one
    dispatch instead of one per op.  ±1 operands and their integer sums are
    exact at any matmul precision, including TF32."""
    d = orb.unpack_pm1(descriptors_packed)           # (N, 256)
    n = d.shape[0]
    key = jax.random.PRNGKey(seed)
    init_idx = jax.random.choice(key, n, (num_words,), replace=n < num_words)
    centroids = d[init_idx]

    def step(c, _):
        sim = d @ c.T                                  # (N, V)
        assign = jnp.argmax(sim, axis=1)
        one_hot = jax.nn.one_hot(assign, num_words, dtype=d.dtype)
        sums = one_hot.T @ d                           # (V, 256)
        counts = jnp.sum(one_hot, axis=0)[:, None]
        new_c = jnp.where(counts > 0, jnp.sign(sums + 0.5), c)
        return new_c, None

    centroids, _ = jax.lax.scan(step, centroids, None, length=iters)

    # idf from the training set's word occupancy.
    sim = d @ centroids.T
    assign = jnp.argmax(sim, axis=1)
    df = jnp.zeros(num_words).at[assign].add(1.0)
    idf = jnp.log(jnp.maximum(n, 1.0) / jnp.maximum(df, 1.0))
    return centroids, idf


def train(descriptors_packed, valid, num_words: int = 1024, iters: int = 8, seed: int = 0):
    """Batched binary k-means over packed descriptors → Vocabulary.

    Centroids are the majority vote (sign of the mean of ±1 vectors), the
    binary analogue of k-medians that DBoW3 trains offline.  The invalid-
    row filter runs on host (one-time training paths pass ragged sets; the
    steady refresh passes a FIXED all-valid 8192 sample so the jitted
    kernel compiles once)."""
    if hasattr(valid, "shape"):
        vmask = np.asarray(valid)
        if not vmask.all():
            descriptors_packed = jnp.asarray(descriptors_packed)[
                jnp.asarray(vmask)]
    centroids, idf = _train_kernel(jnp.asarray(descriptors_packed),
                                   jnp.asarray(seed, jnp.uint32),
                                   num_words=num_words, iters=iters)
    return Vocabulary(centroids, idf)


def save(path: str, vocab: Vocabulary) -> None:
    """Persist a vocabulary (.npz) — the voc_orb.dbow3 file equivalent."""
    np.savez_compressed(path, words_pm1=np.asarray(vocab.words_pm1),
                        idf=np.asarray(vocab.idf))


def load(path: str) -> Vocabulary:
    data = np.load(path)
    return Vocabulary(jnp.asarray(data["words_pm1"]), jnp.asarray(data["idf"]))


@jax.jit
def transform(vocab: Vocabulary, descriptors_packed, valid):
    """Descriptors → normalized tf-idf BoW vector (V,).

    The DBoW3 Vocabulary::transform equivalent; one matmul + scatter."""
    V = vocab.words_pm1.shape[0]
    d = orb.unpack_pm1(descriptors_packed)            # (N, 256)
    sim = d @ vocab.words_pm1.T                       # (N, V)
    sim = jnp.where(valid[:, None], sim, -jnp.inf)
    assign = jnp.argmax(sim, axis=1)
    tf = jnp.zeros(V).at[jnp.where(valid, assign, V - 1)].add(
        jnp.where(valid, 1.0, 0.0)
    )
    v = tf * vocab.idf
    n1 = jnp.sum(jnp.abs(v))
    return v / jnp.maximum(n1, 1e-9)


@jax.jit
def score(a, b):
    """L1 similarity of two normalized BoW vectors ∈ [0, 1]
    (DBoW3 L1Scoring: 1 − ½‖a − b‖₁, ScoringObject.h:73)."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(a - b))


@jax.jit
def score_database(query, database, db_valid):
    """Similarity of one query BoW vector against the whole KF database —
    the reference's per-KF scoring loop (vo_loopclosing.cpp:421-436) as one
    batched op.  database: (K, V); returns (K,) with invalid rows = 0."""
    s = 1.0 - 0.5 * jnp.sum(jnp.abs(database - query[None, :]), axis=1)
    return jnp.where(db_valid, s, 0.0)
