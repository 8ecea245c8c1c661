"""Profile-target search (the --exhaustive-search sliced-profile mode).

Replicates the reference's inverted profile search
(workflow/Search.cpp:357-400 + data/workflow/searchslicedtargetprofile.sh):
profiles act as queries against the fragment DB (PROFILE_SEQ alignment,
no composition bias), the E-value threshold is scaled by
(#fragments / #profiles), and swapresults re-keys hits per fragment,
recomputing the E-value from the integer bit score with the profile-side
residue count (Matcher::result_t::swapResult, Matcher.h:94-115;
swapresults.cpp:76, :273).
"""

import numpy as np

from ..data.submat import encode_aa
from ..ops.sw_jax import sw_align_batch_prof
from .driver import (HIT_DTYPE, KERNEL_MAX_PAIRS, KERNEL_SCRATCH_BYTES,
                     align_route, estimate_seq_id)
from .evalue import EvalueComputation

CELL_BUDGET = 1 << 24
# staged-profile bytes per slice (searchslicedtargetprofile.sh:46-120
# sizes profile slices to a disk budget; here the budget bounds host+HBM
# staging of the PSSM matrices). Overridable per run via
# Params.disk_space_limit (the reference's --disk-space-limit role) or
# METAEUK_SLICE_BUDGET.
SLICE_BUDGET = 1 << 28


def _slice_budget(params):
    import os
    env = os.environ.get("METAEUK_SLICE_BUDGET")
    if env:
        return max(1 << 20, int(env))
    if getattr(params, "disk_space_limit", 0):
        return max(1 << 20, int(params.disk_space_limit))
    return SLICE_BUDGET


def _bucket(n, lo=256):
    """Coarse x4 length tiers: few distinct jit shapes; the kernel route
    aligns every pair at its true lengths, so padding costs it nothing."""
    b = lo
    while b < n:
        b *= 4
    return b


def slice_search_db(query_db, prof_db, out_db, evalue=0.001,
                    add_backtrace=True, params=None):
    """DB-level sliced profile-target search (`search
    --exhaustive-search [-a]`, searchslicedtargetprofile.sh): fragments
    vs an HMM-profile DB, results keyed per fragment."""
    import dataclasses

    from ..io import mmseqsdb
    from ..io.profiledb import ProfileDB
    from ..params import Params
    from ..pipeline.alnformat import (compress_backtrace,
                                      matcher_seq_id_text)

    p = params or Params()
    p = dataclasses.replace(p, search_evalue_thr=evalue)
    qdb = mmseqsdb.read_seqdb(query_db)
    profiles = ProfileDB.from_db(str(prof_db))
    driver = ProfileSearchDriver(p, profiles)
    qbytes = [qdb.seq_bytes(i) for i in range(len(qdb))]
    hits = driver.search(qbytes)
    bts = sids = None
    if add_backtrace:
        orfs_enc = [encode_aa(s) for s in qbytes]
        bts, sids = driver.backtraces(hits, orfs_enc)
    by_query = {i: [] for i in range(len(qdb))}
    for idx, h in enumerate(hits):
        sid = sids[idx] if sids is not None else h["seq_id"]
        line = (f"{profiles.keys[int(h['target_idx'])]}\t"
                f"{int(h['bit_score'])}\t{matcher_seq_id_text(sid)}\t"
                f"{'%.3E' % h['evalue']}\t{int(h['q_start'])}\t"
                f"{int(h['q_end'])}\t{int(h['q_len'])}\t"
                f"{int(h['t_start'])}\t{int(h['t_end'])}\t"
                f"{int(h['t_len'])}")
        if bts is not None:
            line += f"\t{compress_backtrace(bts[idx])}"
        by_query[int(h["orf_idx"])].append(line + "\n")
    out = [(int(qdb.keys[i]), "".join(by_query[i]).encode())
           for i in range(len(qdb))]
    mmseqsdb.write_db(out_db, out, mmseqsdb.DBTYPE_ALIGNMENT_RES)
    return out_db


import functools

import jax
import jax.numpy as jnp

from ..ops import sw_cuda


@functools.partial(jax.jit, static_argnums=(6, 7))
def _gathered_align_prof_kernel(prof_k, p_lens, t_mat, t_lens, li, lj,
                                Lq, Lt):
    """Full PSSM-vs-sequence alignment through the CUDA kernel: forward
    ends, then starts from the reversed prefixes. prof_k is the slice's
    (np, A, Lq) profile table (sw_cuda.pssm_profile)."""
    valid = li >= 0
    nrows = jnp.where(valid, p_lens[jnp.maximum(li, 0)], 0)
    ncols = jnp.where(valid, t_lens[lj], 0)
    score, row, col = sw_cuda.ends(prof_k, li, t_mat, lj, nrows, ncols)
    q_end = jnp.where(col >= 0, row, Lq - 1)
    t_end = col
    aligned = (t_end >= 0) & (score > 0)
    qe = jnp.maximum(q_end, 0)
    te = jnp.maximum(t_end, 0)
    _, row2, col2 = sw_cuda.ends(prof_k, jnp.where(aligned, li, -1), t_mat,
                                 lj, qe + 1, te + 1, qe, te, reverse=True)
    q_start = jnp.where(aligned, qe - row2, -1)
    t_start = jnp.where(aligned, te - col2, -1)
    return score, q_start, q_end, t_start, t_end


@functools.partial(jax.jit, static_argnums=(6, 7))
def _gathered_align_prof_xla(prof_mat, p_lens, t_mat, t_lens, li, lj,
                             Lq, Lt):
    """Device-side pair gather + full PSSM-vs-sequence alignment in one
    dispatch (padded tail pairs flagged by li < 0), XLA route."""
    valid = li >= 0
    li = jnp.maximum(li, 0)
    prof = prof_mat[li]
    q_len = jnp.where(valid, p_lens[li], 0)
    t_enc = t_mat[lj].astype(jnp.int32)
    t_len = jnp.where(valid, t_lens[lj], 0)
    from ..ops.sw_jax import sw_batch_ends_prof
    score, q_end, t_end = sw_batch_ends_prof(prof, q_len, t_enc, Lq, Lt,
                                             t_len=t_len)
    qe = jnp.maximum(q_end, 0)
    te = jnp.maximum(t_end, 0)
    iq = jnp.arange(Lq, dtype=jnp.int32)[None, :]
    it = jnp.arange(Lt, dtype=jnp.int32)[None, :]
    prof_rev = jnp.take_along_axis(
        prof, jnp.maximum(qe[:, None] - iq, 0)[:, :, None], axis=1)
    tr = jnp.take_along_axis(t_enc, jnp.maximum(te[:, None] - it, 0), axis=1)
    score2, qr_end, tr_end = sw_batch_ends_prof(
        prof_rev, (qe + 1).astype(jnp.int32), tr, Lq, Lt,
        t_len=(te + 1).astype(jnp.int32))
    aligned = (t_end >= 0) & (score > 0)
    q_start = jnp.where(aligned, qe - qr_end, -1)
    t_start = jnp.where(aligned, te - tr_end, -1)
    return score, q_start, q_end, t_start, t_end


class ProfileSearchDriver:
    """Aligns encoded fragments against an HMM-profile DB (inverted)."""

    def __init__(self, params, profile_db):
        self.params = params
        self.profiles = profile_db
        self.profile_lens = np.array([len(p) for p in profile_db.pssms], np.int64)

    def _candidate_pairs(self, orfs_enc, orf_lens, n_orfs, n_prof):
        """(profile_idx, orf_idx) candidate pairs.

        Default mode mirrors the reference's sliced workflow
        (searchslicedtargetprofile.sh:108-110 runs the k-mer PREFILTER
        with the profiles as queries against the fragment DB, with
        maxResListLen = max(300, #fragments), Search.cpp:373): the
        native profile-query prefilter (pf_match_profile, byte-parity
        verified via the iterative-search goldens) generates the
        candidate set, and only candidates are aligned on the device —
        the path that scales to the published 88k-profile MERC regime.
        METAEUK_PROFILE_PREF=exhaustive restores the full cross
        product (aligns every (profile, fragment) pair; equivalent
        output whenever every E-value survivor also passes the k-mer
        gate, but O(n_prof*n_orfs) device work)."""
        import os
        mode = os.environ.get(
            "METAEUK_PROFILE_PREF",
            getattr(self.params, "prefilter_mode", "kmer"))
        raws = getattr(self.profiles, "raw_scores", None)
        if mode == "kmer" and raws is not None and n_orfs > 0:
            from .prefilter_kmer import (KmerPrefilter,
                                         profile_kmer_threshold)
            import concurrent.futures as cf

            from ..utils import log
            pf = KmerPrefilter(orfs_enc, kmer_score=0,
                               max_res_list_len=max(300, n_orfs))
            prof_thr = profile_kmer_threshold(self.params.sensitivity)
            # one native scratch per worker thread: the ctypes call
            # releases the GIL and every mutable buffer lives in the
            # scratch, so per-profile matches run on all host cores
            # against the shared read-only index (the reference
            # prefilter is OpenMP across queries)
            import threading
            nw = max(1, min(os.cpu_count() or 1, 8))
            tls = threading.local()
            prog = log.progress(n_prof, "profile prefilter")

            def one(pid):
                sc = getattr(tls, "sc", None)
                if sc is None:
                    sc = tls.sc = pf.new_scratch()
                ids, _scs, _dgs = pf.match_profile(
                    raws[pid], self.profiles.query_seqs[pid],
                    kmer_thr=prof_thr, scratch=sc)
                prog.update()
                return ids

            if nw > 1:
                with cf.ThreadPoolExecutor(nw) as ex:
                    per = list(ex.map(one, range(n_prof), chunksize=64))
            else:
                per = [one(pid) for pid in range(n_prof)]
            prog.finish()
            pi_parts, oi_parts = [], []
            for pid, ids in enumerate(per):
                if len(ids):
                    pi_parts.append(np.full(len(ids), pid, np.int64))
                    oi_parts.append(ids.astype(np.int64))
            if not pi_parts:
                return (np.zeros(0, np.int64), np.zeros(0, np.int64))
            return np.concatenate(pi_parts), np.concatenate(oi_parts)
        pi = np.repeat(np.arange(n_prof, dtype=np.int64), n_orfs)
        oi = np.tile(np.arange(n_orfs, dtype=np.int64), n_prof)
        return pi, oi

    def search(self, orf_aa_seqs):
        p = self.params
        orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
        orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
        n_orfs = len(orfs_enc)
        n_prof = len(self.profiles)
        if n_orfs == 0 or n_prof == 0:
            return np.zeros(0, dtype=HIT_DTYPE)

        # evaluers: inverted pass vs swapped results (swapresults.cpp:76)
        total_orf_res = int(orf_lens.sum())
        ev_inv = EvalueComputation(total_orf_res, gapped=True)
        ev_swap = EvalueComputation(self.profiles.total_residues(), gapped=True)
        # Search.cpp:366-368: evalThr *= (float)queryDbSize/targetDbSize
        scaled_thr = p.search_evalue_thr * float(
            np.float32(np.float32(n_orfs) / np.float32(n_prof)))

        pi, oi = self._candidate_pairs(orfs_enc, orf_lens, n_orfs, n_prof)
        keep = (orf_lens[oi] > 0) & (self.profile_lens[pi] > 0)
        pi, oi = pi[keep], oi[keep]

        # stage per-bucket padded matrices once and gather pairs on the
        # device (the exhaustive cross product repeats each profile
        # n_orfs times — re-uploading it per chunk dominated wall clock
        # on high-latency links); fetches are deferred and concatenated
        lq_b = np.array([_bucket(l) for l in self.profile_lens])[pi]
        lt_b = np.array([_bucket(max(l, 1)) for l in orf_lens])[oi]
        parts = []
        slice_rows = _slice_budget(p)
        use_kernel = align_route() == "kernel"
        for (Lq, Lt) in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            bsel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            p_ids_all = np.unique(pi[bsel])
            o_ids = np.unique(oi[bsel])
            no_pad = _bucket(max(len(o_ids), 1), lo=8)
            t_mat = np.zeros((no_pad, Lt), np.uint8)
            t_lens = np.zeros(no_pad, np.int32)
            for k, oid in enumerate(o_ids):
                te = orfs_enc[oid]
                t_mat[k, :len(te)] = te
                t_lens[k] = len(te)
            t_dev = jnp.asarray(t_mat)
            tlens_dev = jnp.asarray(t_lens)
            o_remap = np.zeros(int(o_ids.max()) + 1, np.int32)
            o_remap[o_ids] = np.arange(len(o_ids), dtype=np.int32)
            # profile SLICES sized to the staging budget (the reference
            # sizes profile slices to --disk-space-limit,
            # searchslicedtargetprofile.sh:46-120; at 88k-profile scale
            # one monolithic PSSM matrix would not fit host/device RAM)
            per_slice = max(8, slice_rows // (Lq * 21 * 4))
            pos_of = np.searchsorted(p_ids_all, pi[bsel])
            for s0 in range(0, len(p_ids_all), per_slice):
                p_ids = p_ids_all[s0:s0 + per_slice]
                sel = bsel[(pos_of >= s0) & (pos_of < s0 + per_slice)]
                np_pad = per_slice if len(p_ids_all) > per_slice \
                    else _bucket(max(len(p_ids), 1), lo=8)
                prof_mat = np.zeros((np_pad, Lq, 21), np.int32)
                p_lens = np.zeros(np_pad, np.int32)
                for k, pid in enumerate(p_ids):
                    pssm = self.profiles.pssms[pid]
                    prof_mat[k, :len(pssm)] = pssm
                    p_lens[k] = len(pssm)
                prof_dev = jnp.asarray(prof_mat)
                if use_kernel:
                    prof_dev = sw_cuda.pssm_profile(prof_dev)
                plens_dev = jnp.asarray(p_lens)
                p_remap = np.zeros(int(p_ids.max()) + 1, np.int32)
                p_remap[p_ids] = np.arange(len(p_ids), dtype=np.int32)
                # the kernel never materializes a (B, Lq, Lt) tensor, so
                # its launches are bounded by the pair count and its
                # boundary scratch (8 B per pair and target column)
                if use_kernel:
                    cap = max(64, min(KERNEL_MAX_PAIRS,
                                      KERNEL_SCRATCH_BYTES // (8 * Lt)))
                else:
                    cap = min(max(8, CELL_BUDGET // (Lq * Lt)), 32768)
                for s in range(0, len(sel), cap):
                    chunk = sel[s:s + cap]
                    li = p_remap[pi[chunk]]
                    lj = o_remap[oi[chunk]]
                    mult = 8
                    # pad rows to a power-of-4 ladder capped at cap:
                    # every distinct jit shape costs a compile + an
                    # executable load, and exact-size padding gave each
                    # (Lq, Lt) combo's final chunk its own shape (the
                    # dominant cost of the 50k-profile run)
                    Bp = min(cap, _bucket(max(len(li), 1), lo=mult))
                    Bp = ((Bp + mult - 1) // mult) * mult
                    li_p = np.full(Bp, -1, np.int32)
                    lj_p = np.zeros(Bp, np.int32)
                    li_p[:len(li)] = li
                    lj_p[:len(lj)] = lj
                    align = _gathered_align_prof_kernel if use_kernel \
                        else _gathered_align_prof_xla
                    outs = align(prof_dev, plens_dev, t_dev, tlens_dev,
                                 jnp.asarray(li_p), jnp.asarray(lj_p), Lq, Lt)
                    parts.append((pi[chunk], oi[chunk], p_lens[li],
                                  t_lens[lj], outs))
                if len(p_ids_all) > per_slice and parts:
                    # memory-bounded regime: keep at most one slice's
                    # staged PSSM matrix alive on the device at a time
                    parts[-1][4][0].block_until_ready()
        if not parts:
            return np.zeros(0, dtype=HIT_DTYPE)
        cat = [np.asarray(jnp.concatenate([p[4][k] for p in parts]))
               for k in range(5)]
        offs = np.cumsum([0] + [p[4][0].shape[0] for p in parts])
        resolved = []
        for idx, (pi_c, oi_c, q_len_c, t_len_c, _outs) in enumerate(parts):
            B = len(pi_c)
            sl = slice(offs[idx], offs[idx] + B)
            out = np.zeros(B, dtype=HIT_DTYPE)
            # store inverted-orientation coords; swapped later
            out["orf_idx"] = oi_c
            out["target_idx"] = pi_c
            out["score_raw"] = cat[0][sl]
            out["q_start"], out["q_end"] = cat[1][sl], cat[2][sl]
            out["q_len"] = q_len_c
            out["t_start"], out["t_end"] = cat[3][sl], cat[4][sl]
            out["t_len"] = t_len_c
            resolved.append(out)
        hits = np.concatenate(resolved)
        return self._filter_swap_sort(hits, ev_inv, ev_swap, scaled_thr)

    def backtraces(self, hits, orfs_enc):
        """True backtraces + seqIds for SWAPPED output rows (the -a /
        alignment-mode-3 path of the sliced search): the PROFILE_SEQ
        banded traceback on the pre-swap orientation, then the
        swapresults I<->D cigar flip (Matcher.h swapResult)."""
        from .. import native

        p = self.params
        bts = []
        seq_ids = np.zeros(len(hits), np.float32)
        swap = str.maketrans("ID", "DI")
        for idx, h in enumerate(hits):
            pidx = int(h["target_idx"])
            pssm = np.asarray(self.profiles.pssms[pidx], np.int32)
            qletters = self.profiles.query_seqs[pidx]
            frag = orfs_enc[int(h["orf_idx"])]
            # pre-swap: profile = (t_start..t_end), fragment = (q..)
            ps, pe = int(h["t_start"]), int(h["t_end"])
            fs, fe = int(h["q_start"]), int(h["q_end"])
            band = abs((fe - fs + 1) - (pe - ps + 1)) + 1
            bt = native.banded_sw_traceback_prof(
                pssm[ps:pe + 1], frag[fs:fe + 1], int(h["score_raw"]),
                band, p.gap_open, p.gap_extend)
            if not bt:
                bts.append("")
                continue
            pp, fp, ids = ps, fs, 0
            for op in bt:
                if op == "M":
                    ids += int(qletters[pp] == frag[fp])
                    pp += 1
                    fp += 1
                elif op == "I":
                    pp += 1
                else:
                    fp += 1
            seq_ids[idx] = np.float32(ids) / np.float32(len(bt))
            bts.append(bt.translate(swap))
        return bts, seq_ids

    def _filter_swap_sort(self, hits, ev_inv, ev_swap, scaled_thr):
        p = self.params
        score = hits["score_raw"].astype(np.float64)
        # inverted pass: evalue over the profile length
        eval_inv = ev_inv.compute_evalue(score, hits["q_len"].astype(np.float64))
        bit = ev_inv.compute_bit_score_int(score)
        q_aln = np.maximum(hits["q_end"] - hits["q_start"], 1)
        t_aln = np.maximum(hits["t_end"] - hits["t_start"], 1)
        seq_id = estimate_seq_id(hits["score_raw"], q_aln, t_aln)
        aligned = (hits["t_end"] >= 0) & (hits["score_raw"] > 0) \
            & (hits["t_start"] >= 0)
        aln_len = np.maximum(np.abs(hits["q_end"] - hits["q_start"]),
                             np.abs(hits["t_end"] - hits["t_start"])) + 1
        ok = (aligned & (eval_inv <= scaled_thr) & (seq_id >= p.seq_id_thr)
              & (aln_len >= p.aln_len_thr))
        hits = hits[ok]
        bit = bit[ok]
        seq_id = seq_id[ok]

        # swapResult (Matcher.h:94-115): raw from the integer bit score,
        # evalue over the fragment length with profile-side residue count
        import math
        raw2 = (ev_swap.log_k + bit.astype(np.float64) * math.log(2.0)) \
            / ev_swap.p["lam"]
        eval_swap = ev_swap.compute_evalue(raw2, hits["t_len"].astype(np.float64))

        out = np.zeros(len(hits), dtype=HIT_DTYPE)
        out["orf_idx"] = hits["orf_idx"]
        out["target_idx"] = hits["target_idx"]
        out["score_raw"] = hits["score_raw"]
        out["bit_score"] = bit
        out["seq_id"] = seq_id
        out["evalue"] = eval_swap
        # swapped orientation: fragment is the query now
        out["q_start"], out["q_end"] = hits["t_start"], hits["t_end"]
        out["q_len"] = hits["t_len"]
        out["t_start"], out["t_end"] = hits["q_start"], hits["q_end"]
        out["t_len"] = hits["q_len"]
        order = np.lexsort((out["target_idx"], out["t_len"],
                            -out["bit_score"], out["evalue"], out["orf_idx"]))
        return out[order]
