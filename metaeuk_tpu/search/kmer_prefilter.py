"""K-mer inverted-index prefilter (double-diagonal matching).

A redesign of the reference's k-mer prefilter
(lib/mmseqs/src/prefiltering/: IndexTable.h:65, IndexBuilder.cpp:55,
QueryMatcher.cpp:213-340): an inverted index over target k-mers feeds a
double-hit-on-same-diagonal candidate screen, and survivors are rescored
with the device gapless kernel (ops/ungapped.py) standing in for the
SIMD ungapped diagonal rescoring (UngappedAlignment.cpp:25).

Differences from the reference, by design (documented contract):
- exact k-mer matching (the reference's --exact-kmer-matching 1 mode);
  similar-k-mer list generation (KmerGenerator) is a later sensitivity
  extension
- survivors are rescored over *all* diagonals by the gapless kernel
  (a superset of the reference's matched-diagonal rescoring)
The output contract matches the other prefilter modes: per fragment the
top --max-seqs candidates by ungapped score above --min-ungapped-score.

The index build and the posting join are vectorized numpy (sort +
searchsorted) — the host-side analog of CacheFriendlyOperations.
"""

import numpy as np

from ..data.submat import composition_bias_rounded, encode_aa

KMER_K = 6


def seq_kmers(enc, k=KMER_K):
    """Packed base-21 k-mer codes + positions; k-mers containing X (20)
    are skipped (the reference never indexes X, IndexBuilder.cpp)."""
    n = len(enc) - k + 1
    if n <= 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    enc = np.asarray(enc, np.int64)
    codes = np.zeros(n, np.int64)
    has_x = np.zeros(n, bool)
    for i in range(k):
        codes = codes * 21 + enc[i:i + n]
        has_x |= enc[i:i + n] == 20
    pos = np.arange(n, dtype=np.int64)
    keep = ~has_x
    return codes[keep], pos[keep]


class KmerIndex:
    """Inverted index: k-mer code -> (target_id, position) postings."""

    def __init__(self, targets_enc, k=KMER_K):
        self.k = k
        codes_all, tids_all, pos_all = [], [], []
        for ti, enc in enumerate(targets_enc):
            codes, pos = seq_kmers(enc, k)
            codes_all.append(codes)
            pos_all.append(pos)
            tids_all.append(np.full(len(codes), ti, np.int64))
        codes = np.concatenate(codes_all) if codes_all else np.zeros(0, np.int64)
        tids = np.concatenate(tids_all) if tids_all else np.zeros(0, np.int64)
        pos = np.concatenate(pos_all) if pos_all else np.zeros(0, np.int64)
        order = np.argsort(codes, kind="stable")
        self.codes = codes[order]
        self.tids = tids[order]
        self.pos = pos[order]

    def lookup(self, query_codes):
        """(start, end) ranges into the postings for each query code."""
        lo = np.searchsorted(self.codes, query_codes, side="left")
        hi = np.searchsorted(self.codes, query_codes, side="right")
        return lo, hi


class KmerPrefilter:
    """Candidate pairs via double-diagonal k-mer matching + gapless rescore."""

    def __init__(self, params, target_db, min_diag_score=15,
                 min_diag_matches=2, k=KMER_K, mask_mode=1):
        self.params = params
        self.min_diag_score = min_diag_score
        self.min_diag_matches = min_diag_matches
        self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                            for i in range(len(target_db))]
        self.target_lens = np.array([len(t) for t in self.targets_enc], np.int64)
        # low-complexity masking of indexed targets (--mask-mode 1 default,
        # Masker/tantan at index build; scoring still uses unmasked residues)
        if mask_mode:
            from ..ops.masker import mask_sequence
            index_seqs = [mask_sequence(t)[0] for t in self.targets_enc]
        else:
            index_seqs = self.targets_enc
        self.index = KmerIndex(index_seqs, k)
        self.n_targets = len(self.targets_enc)

    def candidate_targets(self, orf_enc):
        """Targets with >= min_diag_matches k-mer hits on one diagonal
        (QueryMatcher double-hit contract, QueryMatcher.cpp:213-340)."""
        codes, qpos = seq_kmers(orf_enc, self.index.k)
        if len(codes) == 0:
            return np.zeros(0, np.int64)
        lo, hi = self.index.lookup(codes)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        # expand posting ranges
        qk = np.repeat(np.arange(len(codes)), counts)
        flat = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)
                               if h > l]) if total else np.zeros(0, np.int64)
        tid = self.index.tids[flat]
        diag = self.index.pos[flat] - qpos[qk]
        # count hits per (target, diagonal); diagonal range is bounded
        key = tid * (2 ** 20) + (diag + 2 ** 19)
        uniq, cnt = np.unique(key, return_counts=True)
        hit_targets = np.unique(uniq[cnt >= self.min_diag_matches] // (2 ** 20))
        if self.min_diag_matches <= 1:
            hit_targets = np.unique(tid)
        return hit_targets

    def candidate_pairs(self, orf_aa_seqs):
        """Same contract as UngappedPrefilter.candidate_pairs."""
        p = self.params
        orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
        orf_bias = [composition_bias_rounded(e, p.comp_bias_correction_scale)
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                    for e in orfs_enc]
        pairs = []
        for qi, enc in enumerate(orfs_enc):
            for ti in self.candidate_targets(enc):
                pairs.append((qi, ti))
        if not pairs:
            return np.zeros((0, 2), dtype=np.int64)
        pairs = np.asarray(pairs, dtype=np.int64)

        # rescore candidates with the gapless kernel, keep the prefilter
        # contract (score > min, top max-seqs by (score desc, target asc))
        from .driver import pad_rows
        from ..ops.ungapped import gapless_scores_gathered
        import jax.numpy as jnp
        orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
        Lq = 1 << max(6, int(np.ceil(np.log2(max(1, orf_lens.max())))))
        Lt = 1 << max(6, int(np.ceil(np.log2(max(1, self.target_lens.max())))))
        q_mat = jnp.asarray(pad_rows(orfs_enc, Lq))
        qb_mat = jnp.asarray(pad_rows(orf_bias, Lq))
        q_lens = jnp.asarray(orf_lens, jnp.int32)
        t_mat = jnp.asarray(pad_rows(self.targets_enc, Lt))
        t_lens = jnp.asarray(self.target_lens, jnp.int32)
        cap = max(128, (1 << 27) // (Lq * Lt))
        outs = []
        for s in range(0, len(pairs), cap):
            li = pairs[s:s + cap, 0].astype(np.int32)
            lj = pairs[s:s + cap, 1].astype(np.int32)
            if len(li) < cap and s > 0:
                li = np.concatenate([li, np.full(cap - len(li), -1, np.int32)])
                lj = np.concatenate([lj, np.zeros(cap - len(lj), np.int32)])
            outs.append(gapless_scores_gathered(
                q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj))
        import jax.numpy as jnp2
        scores = np.asarray(jnp2.concatenate(outs))[:len(pairs)]

        keep = scores > self.min_diag_score
        pairs, scores = pairs[keep], scores[keep]
        out = []
        max_seqs = p.max_res_list_len
        for qi in np.unique(pairs[:, 0]):
            m = pairs[:, 0] == qi
            tis = pairs[m, 1]
            sc = scores[m]
            order = np.lexsort((tis, -sc))[:max_seqs]
            for ti in tis[order]:
                out.append((qi, ti))
        return np.asarray(out, dtype=np.int64).reshape(-1, 2)
