"""Ungapped prefilter driver: candidate (fragment, target) pair selection.

Mirrors the contract of the reference's ungapped prefilter
(lib/mmseqs/src/prefiltering/ungappedprefilter.cpp:358-470): per query,
targets with max-gapless-diagonal score > --min-ungapped-score are kept,
sorted by (score desc, targetKey asc), truncated to --max-seqs. The scores
come from the device gapless scan (ops/ungapped.py) over blocked
query x target cross products.
"""

import numpy as np

from ..data.submat import composition_bias_rounded, encode_aa
from ..ops.ungapped import gapless_scores


def _bucket(n, lo=32):
    b = lo
    while b < n:
        b *= 2
    return b


class UngappedPrefilter:
    """Produces candidate pairs for SearchDriver.search(pair_generator=...)."""

    def __init__(self, params, target_db, min_diag_score=15):
        self.params = params
        self.min_diag_score = min_diag_score
        self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                            for i in range(len(target_db))]
        self.target_lens = np.array([len(t) for t in self.targets_enc], np.int64)

    def candidate_pairs(self, orf_aa_seqs, block_cells=1 << 27):
        """Returns an (n_pairs, 2) int64 array of (orf_idx, target_idx),
        ordered per fragment by (score desc, target_idx asc), top max-seqs."""
        p = self.params
        orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
        orf_bias = [composition_bias_rounded(e, p.comp_bias_correction_scale)
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                    for e in orfs_enc]
        n_orfs = len(orfs_enc)
        n_targets = len(self.targets_enc)
        if n_orfs == 0 or n_targets == 0:
            return np.zeros((0, 2), dtype=np.int64)

        orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
        scores = np.zeros((n_orfs, n_targets), dtype=np.int32)

        # group by padded length buckets; stage each bucket's padded
        # matrices once and gather pairs on device; fetch scores at the end
        from .driver import pad_rows
        from ..ops.ungapped import gapless_scores_gathered
        q_buckets = np.array([_bucket(max(l, 1)) for l in orf_lens])
        t_buckets = np.array([_bucket(max(l, 1)) for l in self.target_lens])
        pending = []
        import jax.numpy as jnp
        for Lq in np.unique(q_buckets):
            qi_all = np.flatnonzero(q_buckets == Lq)
            q_mat = jnp.asarray(pad_rows([orfs_enc[i] for i in qi_all], Lq))
            qb_mat = jnp.asarray(pad_rows([orf_bias[i] for i in qi_all], Lq))
            q_lens = jnp.asarray(orf_lens[qi_all], jnp.int32)
            for Lt in np.unique(t_buckets):
                ti_all = np.flatnonzero(t_buckets == Lt)
                t_mat = jnp.asarray(pad_rows([self.targets_enc[i] for i in ti_all], Lt))
                t_lens = jnp.asarray(self.target_lens[ti_all], jnp.int32)
                max_pairs = max(8, block_cells // (Lq * Lt))
                n_pairs = len(qi_all) * len(ti_all)
                li_full = np.repeat(np.arange(len(qi_all), dtype=np.int32),
                                    len(ti_all))
                lj_full = np.tile(np.arange(len(ti_all), dtype=np.int32),
                                  len(qi_all))
                for s in range(0, n_pairs, max_pairs):
                    li = li_full[s:s + max_pairs]
                    lj = lj_full[s:s + max_pairs]
                    # fixed chunk shape per bucket -> exactly one compile
                    if len(li) < max_pairs:
                        pad = max_pairs - len(li)
                        li = np.concatenate([li, np.full(pad, -1, np.int32)])
                        lj = np.concatenate([lj, np.zeros(pad, np.int32)])
                        li, lj = li, lj
                        n_real = n_pairs - s
                    else:
                        n_real = max_pairs
                    out = gapless_scores_gathered(
                        q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj)
                    pending.append((qi_all, ti_all, li[:n_real], lj[:n_real], out))
        if pending:
            # one concatenated device->host fetch instead of per-chunk trips
            import jax.numpy as jnp2
            all_scores = np.asarray(jnp2.concatenate([o for *_, o in pending]))
            off = 0
            for qi_all, ti_all, li, lj, out in pending:
                n_full = out.shape[0]
                s = all_scores[off:off + n_full][:len(li)]
                scores[qi_all[li], ti_all[lj]] = s
                off += n_full

        pairs = []
        max_seqs = p.max_res_list_len
        for qi in range(n_orfs):
            row = scores[qi]
            keep = np.flatnonzero(row > self.min_diag_score)
            if len(keep) == 0:
                continue
            # (score desc, target key asc), truncate to max-seqs
            order = np.lexsort((keep, -row[keep]))[:max_seqs]
            for ti in keep[order]:
                pairs.append((qi, ti))
        return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
