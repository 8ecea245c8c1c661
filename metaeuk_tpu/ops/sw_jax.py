"""Batched Smith-Waterman via XLA (jit + scan).

A batch reformulation of the reference's striped SW
(lib/mmseqs/src/alignment/StripedSmithWaterman.cpp): instead of one
SIMD-striped DP per pair, we run thousands of (query,target) pairs as a
single dense batch. The column-wise affine-gap recurrence's in-column
dependency (the F/"lazy-F" loop, StripedSmithWaterman.cpp:822-870) is
resolved exactly with one max-plus cumulative scan per column:

    F(i,j) = max_{k<i} ( H(k,j) - gap_open - (i-1-k)*gap_extend )
           = cummax_k( H(k,j) + k*ge ) - gap_open - (i-1)*ge

so each target column is one batch of elementwise ops over (B, Lq), and
the score matrix S[b,i,j] = prof[b,i,t[b,j]] is an integer gather. Cells
saturate at SCORE_CAP like the reference's word kernel. End/start-position tie-breaking matches sw_sse2_byte
(smallest target column attaining the global max, then smallest query row;
StripedSmithWaterman.cpp:879-916), and start positions come from the same
kernel on reversed prefixes (ssw_align_private:398-482).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..data.submat import BLOSUM62_SCORES

NEG = -(10 ** 6)
GO = 11
GE = 1
SCORE_CAP = 32767  # the reference word kernel saturates here
                   # (StripedSmithWaterman.cpp:943 sw_sse2_word)


def _scan_columns(S, t_mask, go=GO, ge=GE):
    """Run the column scan over S: (B, Lq, Lt) int32 (padded cells NEG).

    Returns (best, q_end, t_end) per pair, with reference tie-breaking.
    go/ge parametrize the affine gap costs (11/1 protein, 5/2 nucleotide).
    """
    B, Lq, Lt = S.shape
    idx = jnp.arange(Lq, dtype=jnp.int32)

    def step(carry, inp):
        H, E, best, q_end, t_end = carry
        s_col, j = inp
        Hd = jnp.pad(H[:, :-1], ((0, 0), (1, 0)))
        G = jnp.maximum(0, jnp.maximum(Hd + s_col, E))
        A = G + idx[None, :] * ge
        M = jax.lax.cummax(A, axis=1)
        F = jnp.pad(M[:, :-1], ((0, 0), (1, 0)), constant_values=NEG) \
            - go - (idx[None, :] - 1) * ge
        Hn = jnp.minimum(jnp.maximum(G, F), SCORE_CAP)
        col_max = jnp.max(Hn, axis=1)
        improved = col_max > best
        best = jnp.where(improved, col_max, best)
        t_end = jnp.where(improved, j, t_end)
        q_end = jnp.where(improved, jnp.argmax(Hn, axis=1).astype(jnp.int32), q_end)
        E = jnp.maximum(jnp.maximum(E - ge, Hn - go), 0)
        return (Hn, E, best, q_end, t_end), None

    H0 = jnp.zeros((B, Lq), dtype=jnp.int32)
    E0 = jnp.zeros((B, Lq), dtype=jnp.int32)
    best0 = jnp.zeros(B, dtype=jnp.int32)
    qe0 = jnp.full(B, Lq - 1, dtype=jnp.int32)
    te0 = jnp.full(B, -1, dtype=jnp.int32)
    cols = jnp.moveaxis(S, 2, 0)  # (Lt, B, Lq)
    js = jnp.arange(Lt, dtype=jnp.int32)
    (H, E, best, q_end, t_end), _ = jax.lax.scan(
        step, (H0, E0, best0, qe0, te0), (cols, js))
    del t_mask
    return best, q_end, t_end


def build_scores(prof, t_enc):
    """S[b,i,j] = prof[b,i,t[b,j]] as an exact integer gather."""
    return jnp.take_along_axis(prof, t_enc[:, None, :].astype(jnp.int32),
                               axis=2, mode="clip")


@functools.partial(jax.jit, static_argnums=(4, 5, 7, 8))
def sw_batch_ends(q_enc, q_bias, q_len, t_enc, Lq, Lt, t_len=None,
                  go=GO, ge=GE, submat=None):
    """Forward SW for a batch of padded pairs.

    Args:
      q_enc: (B, Lq) int32 residue indices (pad arbitrary)
      q_bias: (B, Lq) int32 rounded composition bias
      q_len: (B,) int32 query lengths
      t_enc: (B, Lt) int32 target residue indices
      t_len: (B,) int32 target lengths
    Returns:
      (score, q_end, t_end) each (B,) int32.
    """
    B = q_enc.shape[0]
    submat = jnp.asarray(BLOSUM62_SCORES if submat is None else submat,
                         dtype=jnp.int32)
    prof = submat[q_enc] + q_bias[:, :, None]  # (B, Lq, alph)
    qmask = jnp.arange(Lq)[None, :] < q_len[:, None]
    prof = jnp.where(qmask[:, :, None], prof, NEG)
    S = build_scores(prof, t_enc)  # (B, Lq, Lt)
    tmask = jnp.arange(Lt)[None, :] < t_len[:, None]
    S = jnp.where(tmask[:, None, :], S, NEG)
    return _scan_columns(S, tmask, go, ge)


@functools.partial(jax.jit, static_argnums=(4, 5, 9, 10))
def sw_batch_starts(q_enc, q_bias, q_len, t_enc, Lq, Lt,
                    t_len=None, q_end=None, t_end=None, go=GO, ge=GE,
                    submat=None):
    """Reverse-prefix SW: start positions for pairs with known ends.

    Runs the same column scan on reversed prefixes q[q_end::-1],
    t[t_end::-1]; returns (score2, q_start, t_start).
    """
    B = q_enc.shape[0]
    iq = jnp.arange(Lq, dtype=jnp.int32)[None, :]
    it = jnp.arange(Lt, dtype=jnp.int32)[None, :]
    # reversed gather indices; positions beyond the prefix point at 0 but are masked
    q_rev_idx = jnp.maximum(q_end[:, None] - iq, 0)
    t_rev_idx = jnp.maximum(t_end[:, None] - it, 0)
    qr = jnp.take_along_axis(q_enc, q_rev_idx, axis=1)
    br = jnp.take_along_axis(q_bias, q_rev_idx, axis=1)
    tr = jnp.take_along_axis(t_enc, t_rev_idx, axis=1)
    qr_len = q_end + 1
    tr_len = t_end + 1
    return sw_batch_ends(qr, br, qr_len, tr, Lq, Lt, t_len=tr_len,
                         go=go, ge=ge, submat=submat)


@functools.partial(jax.jit, static_argnums=(3, 4))
def sw_batch_ends_prof(prof, q_len, t_enc, Lq, Lt, t_len=None):
    """Forward SW with a caller-provided position-specific score profile
    (PSSM query, e.g. HMM-profile vs sequence; the PROFILE_SEQ path of
    ssw_align, StripedSmithWaterman.cpp:296-299)."""
    prof = prof.astype(jnp.int32)
    qmask = jnp.arange(Lq)[None, :] < q_len[:, None]
    prof = jnp.where(qmask[:, :, None], prof, NEG)
    S = build_scores(prof, t_enc)
    tmask = jnp.arange(Lt)[None, :] < t_len[:, None]
    S = jnp.where(tmask[:, None, :], S, NEG)
    return _scan_columns(S, tmask)


def sw_align_batch_prof(prof, q_len, t_enc, t_len):
    """Full batched PSSM-vs-sequence alignment (ends + reverse starts)."""
    prof = jnp.asarray(prof, jnp.int32)
    q_len = jnp.asarray(q_len, jnp.int32)
    t_enc = jnp.asarray(t_enc, jnp.int32)
    t_len = jnp.asarray(t_len, jnp.int32)
    Lq, Lt = int(prof.shape[1]), int(t_enc.shape[1])
    score, q_end, t_end = sw_batch_ends_prof(prof, q_len, t_enc, Lq, Lt,
                                             t_len=t_len)
    qe = jnp.maximum(q_end, 0)
    te = jnp.maximum(t_end, 0)
    iq = jnp.arange(Lq, dtype=jnp.int32)[None, :]
    it = jnp.arange(Lt, dtype=jnp.int32)[None, :]
    q_rev_idx = jnp.maximum(qe[:, None] - iq, 0)
    t_rev_idx = jnp.maximum(te[:, None] - it, 0)
    prof_rev = jnp.take_along_axis(prof, q_rev_idx[:, :, None], axis=1)
    tr = jnp.take_along_axis(t_enc, t_rev_idx, axis=1)
    score2, qr_end, tr_end = sw_batch_ends_prof(
        prof_rev, (qe + 1).astype(jnp.int32), tr, Lq, Lt,
        t_len=(te + 1).astype(jnp.int32))
    aligned = (t_end >= 0) & (score > 0)
    q_start = jnp.where(aligned, qe - qr_end, -1)
    t_start = jnp.where(aligned, te - tr_end, -1)
    return (np.asarray(score), np.asarray(q_start), np.asarray(q_end),
            np.asarray(t_start), np.asarray(t_end))


def sw_align_batch(q_enc, q_bias, q_len, t_enc, t_len, submat=None,
                   go=GO, ge=GE):
    """Full batched alignment (host wrapper): ends + reverse-pass starts.

    All arrays pre-padded to (B, Lq)/(B, Lt). Returns numpy arrays
    (score, q_start, q_end, t_start, t_end). submat: substitution
    matrix override (e.g. the --realign scoreBias -0.2 matrix); go/ge:
    affine gap costs (a gap of length L costs go + (L-1)*ge)."""
    q_enc = jnp.asarray(q_enc, jnp.int32)
    q_bias = jnp.asarray(q_bias, jnp.int32)
    q_len = jnp.asarray(q_len, jnp.int32)
    t_enc = jnp.asarray(t_enc, jnp.int32)
    t_len = jnp.asarray(t_len, jnp.int32)
    if submat is not None:
        submat = jnp.asarray(submat, jnp.int32)
    Lq, Lt = int(q_enc.shape[1]), int(t_enc.shape[1])
    score, q_end, t_end = sw_batch_ends(q_enc, q_bias, q_len, t_enc, Lq, Lt,
                                        t_len=t_len, go=go, ge=ge,
                                        submat=submat)
    # clamp for pairs with no alignment so the reverse gather stays in bounds
    qe = jnp.maximum(q_end, 0)
    te = jnp.maximum(t_end, 0)
    score2, qr_end, tr_end = sw_batch_starts(
        q_enc, q_bias, q_len, t_enc, Lq, Lt, t_len=t_len, q_end=qe, t_end=te,
        go=go, ge=ge, submat=submat)
    q_start = qe - qr_end
    t_start = te - tr_end
    aligned = (t_end >= 0) & (score > 0)
    q_start = jnp.where(aligned, q_start, -1)
    t_start = jnp.where(aligned, t_start, -1)
    return (np.asarray(score), np.asarray(q_start), np.asarray(q_end),
            np.asarray(t_start), np.asarray(t_end))
