"""Ungapped (gapless) diagonal scoring — the device prefilter compute.

Equivalent of the reference's brute-force prefilter
(lib/mmseqs/src/prefiltering/ungappedprefilter.cpp, the role the libmarv
CUDA GAPLESS kernel plays in --gpu mode): for each (query, target) pair,
the maximum local run score over all diagonals,

    D(i,j) = max(0, D(i-1,j-1) + S(i,j)),   score = max D

computed with the same column scan as the gapped XLA form (sw_jax.py)
but a 2-op inner loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..data.submat import BLOSUM62_SCORES
from .sw_jax import build_scores

NEG = -(10 ** 6)


@functools.partial(jax.jit, static_argnums=(4, 5))
def gapless_scores_xla(q_enc, q_bias, q_len, t_enc, Lq, Lt, t_len=None):
    """Max gapless diagonal score per padded pair."""
    submat = jnp.asarray(BLOSUM62_SCORES, dtype=jnp.int32)
    prof = submat[q_enc] + q_bias[:, :, None]
    qmask = jnp.arange(Lq)[None, :] < q_len[:, None]
    prof = jnp.where(qmask[:, :, None], prof, NEG)
    S = build_scores(prof, t_enc)
    tmask = jnp.arange(Lt)[None, :] < t_len[:, None]
    S = jnp.where(tmask[:, None, :], S, NEG)

    def step(carry, s_col):
        D, best = carry
        Dd = jnp.pad(D[:, :-1], ((0, 0), (1, 0)))
        Dn = jnp.maximum(0, Dd + s_col)
        best = jnp.maximum(best, jnp.max(Dn, axis=1))
        return (Dn, best), None

    B = q_enc.shape[0]
    D0 = jnp.zeros((B, Lq), jnp.int32)
    best0 = jnp.zeros(B, jnp.int32)
    (D, best), _ = jax.lax.scan(step, (D0, best0), jnp.moveaxis(S, 2, 0))
    return best


@functools.partial(jax.jit, static_argnums=(7, 8))
def gapless_gathered_jit(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj,
                         Lq, Lt):
    """Device-side pair gather + gapless scoring in one dispatch."""
    valid = li >= 0
    li = jnp.maximum(li, 0)
    q_enc = q_mat[li]
    q_bias = qb_mat[li]
    q_len = jnp.where(valid, q_lens[li], 0)
    t_enc = t_mat[lj]
    t_len = jnp.where(valid, t_lens[lj], 0)
    return gapless_scores_xla(q_enc, q_bias, q_len, t_enc, Lq, Lt, t_len=t_len)


def gapless_scores_gathered(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj):
    """Deferred (device-array) gapless scores for index-pair lists."""
    B = len(li)
    Bp = ((B + 7) // 8) * 8
    li_p = np.full(Bp, -1, np.int32)
    lj_p = np.zeros(Bp, np.int32)
    li_p[:B] = li
    lj_p[:B] = lj
    Lq, Lt = int(q_mat.shape[1]), int(t_mat.shape[1])
    return gapless_gathered_jit(
        q_mat, qb_mat, jnp.asarray(q_lens, jnp.int32), t_mat,
        jnp.asarray(t_lens, jnp.int32), jnp.asarray(li_p), jnp.asarray(lj_p),
        Lq, Lt)


def gapless_scores(q_enc, q_bias, q_len, t_enc, t_len):
    """Gapless scores for a host-padded batch."""
    Lq, Lt = int(np.shape(q_enc)[1]), int(np.shape(t_enc)[1])
    return np.asarray(gapless_scores_xla(
        jnp.asarray(q_enc, jnp.int32), jnp.asarray(q_bias, jnp.int32),
        jnp.asarray(q_len, jnp.int32), jnp.asarray(t_enc, jnp.int32),
        Lq, Lt, t_len=jnp.asarray(t_len, jnp.int32)))
