"""Batched translated-fragment → target-DB search.

Replaces the reference's search workflow (prefilter + Alignment::run,
lib/mmseqs/src/workflow/Search.cpp + alignment/Alignment.cpp:244-312) with a
batched device driver: candidate (fragment, target) pairs are
length-bucketed and aligned in device batches, on the GPU by the CUDA
kernel (ops/sw_cuda.py) and on the CPU by the XLA form (ops/sw_jax.py),
chosen by align_route(). The hit
contract matches Matcher::result_t + Alignment::checkCriteria +
Matcher::compareHits ordering so downstream stages see exactly what the
reference's align module produces.

The default candidate generator is exhaustive (every fragment × every
target) — equivalent to the reference's --exhaustive-search "fake_pref"
path (data/workflow/blastp.sh:22-33); the k-mer prefilter plugs in as an
alternative generator with the same contract.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..data.submat import composition_bias_rounded, encode_aa
from ..ops import sw_cuda
from ..ops.sw_jax import sw_align_batch, sw_batch_ends, sw_batch_starts
from ..platform import platform
from .evalue import EvalueComputation

HIT_DTYPE = np.dtype([
    ("orf_idx", np.int64),
    ("target_idx", np.int64),
    ("score_raw", np.int32),
    ("bit_score", np.int32),
    ("seq_id", np.float32),
    ("evalue", np.float64),
    ("q_start", np.int32),
    ("q_end", np.int32),
    ("q_len", np.int32),
    ("t_start", np.int32),
    ("t_end", np.int32),
    ("t_len", np.int32),
])

# device batch budget in DP cells per launch on the XLA route, which
# materializes the S tensor (cells * 4 bytes)
CELL_BUDGET = 1 << 27
# pairs per kernel launch on the CUDA route: one thread per pair, so a
# launch needs tens of thousands of pairs to fill the card; the
# kernel's per-column boundary scratch (8 B per pair and target column)
# is held to KERNEL_SCRATCH_BYTES
KERNEL_MAX_PAIRS = 1 << 16
KERNEL_SCRATCH_BYTES = 1 << 30


def align_route():
    """"kernel" (the CUDA kernel) on the GPU, "xla" on the CPU."""
    return "kernel" if platform() == "gpu" else "xla"

# process-wide aligned-cell accounting (true sequence lengths, not
# padding): forward-pass cells over every candidate pair plus
# reverse-prefix cells over E-value survivors.  bench.py reads and
# resets these around timed runs to report end-to-end aligned
# residue-cells/s.
CELLS = {"fwd": 0, "rev": 0}


def _bucket(n, lo=None):
    """Length buckets. Sequence-length tiers are x2 from 64 up to 1024
    (the range where nearly all fragments and targets live — x4 tiers
    padded 330-aa targets to 1024 columns, a 3x compute tax on every
    padded DP cell of the XLA route) and x4 above (rare long sequences;
    the number of compiled shapes stays bounded). Row-count tiers (lo=8)
    stay x4: padded rows cost upload bytes, not DP cells."""
    if lo is not None:
        b = lo
        while b < n:
            b *= 4
        return b
    b = 64
    while b < n:
        b *= 2 if b < 1024 else 4
    return b


_LEN_TIERS = np.array([64, 128, 256, 512, 1024, 4096, 16384, 65536,
                       262144], np.int64)
_LEN_TIERS_COARSE = np.array([256, 1024, 4096, 16384, 65536, 262144],
                             np.int64)

# fragment count above which the x2 length tiers are used: fine tiers
# cut padded DP cells 2-4x at metagenome scale but multiply the number
# of compiled shapes — small workloads stay on the coarse x4 tiers
FINE_TIER_MIN_FRAGS = int(os.environ.get("METAEUK_FINE_TIER_MIN",
                                         "400000"))


def _bucket_arr(lens, fine=True):
    """Vectorized sequence-length tier lookup (same tiers as _bucket).
    Lengths beyond the largest tier clamp to it."""
    tiers = _LEN_TIERS if fine else _LEN_TIERS_COARSE
    lens = np.maximum(np.asarray(lens, np.int64), 1)
    idx = np.minimum(np.searchsorted(tiers, lens), len(tiers) - 1)
    return tiers[idx]


def pad_rows(seqs, width, dtype=np.int32):
    """Stack variable-length rows into one padded matrix (vectorized)."""
    n = len(seqs)
    out = np.zeros((n, width), dtype)
    if n == 0:
        return out
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    flat = np.concatenate([np.asarray(s) for s in seqs]) if lens.sum() else \
        np.zeros(0, dtype)
    mask = np.arange(width)[None, :] < lens[:, None]
    out[mask] = flat
    return out


def _pad_rows_to(mat, n_rows):
    """Pad a (n, W) matrix with zero rows up to n_rows (shape tiering)."""
    if mat.shape[0] >= n_rows:
        return mat
    return np.pad(mat, ((0, n_rows - mat.shape[0]), (0, 0)))


def estimate_seq_id(score, q_aln_len, t_aln_len):
    """Matcher::estimateSeqIdByScorePerCol (Matcher.cpp:284-288), float32."""
    m = np.maximum(np.maximum(q_aln_len, t_aln_len), 1).astype(np.float32)
    # float32 division, float64 affine, float32 result — the reference's
    # exact float dance
    est = ((score.astype(np.float32) / m).astype(np.float64)
           * 0.1656 + 0.1141).astype(np.float32)
    return np.clip(est, np.float32(0.0), np.float32(1.0))


def _pack_ends_u16(score, q_end, t_end):
    """(3, B) uint16 forward result pack: half the bytes of int32 on the
    way to the host. Scores are capped to the reference word-kernel
    saturation (32767), coordinates are < 65535, and -1 round-trips as
    65535. Packing inside the jit keeps every fetch shape
    data-independent."""
    score = jnp.minimum(score, 32767)
    return jnp.stack([score, q_end, t_end]).astype(jnp.uint16)


def _pack_starts_u16(q_start, t_start):
    return jnp.stack([q_start, t_start]).astype(jnp.uint16)


def _gather_pairs(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj):
    """Device-side pair gather of the staged tiers (padded tail pairs
    are flagged by li < 0 and get length 0)."""
    valid = li >= 0
    li = jnp.maximum(li, 0)
    q_enc = q_mat[li].astype(jnp.int32)
    q_bias = qb_mat[li].astype(jnp.int32)
    q_len = jnp.where(valid, q_lens[li], 0)
    t_enc = t_mat[lj].astype(jnp.int32)
    t_len = jnp.where(valid, t_lens[lj], 0)
    return valid, q_enc, q_bias, q_len, t_enc, t_len


def _pair_ends_xla(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj, Lq, Lt):
    """Pair gather + forward ends in one dispatch (XLA route)."""
    _, q_enc, q_bias, q_len, t_enc, t_len = _gather_pairs(
        q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj)
    return _pack_ends_u16(
        *sw_batch_ends(q_enc, q_bias, q_len, t_enc, Lq, Lt, t_len=t_len))


def _pair_starts_xla(q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj, qe, te,
                     Lq, Lt):
    """Pair gather + reverse-prefix starts (survivors only, XLA route)."""
    valid, q_enc, q_bias, q_len, t_enc, t_len = _gather_pairs(
        q_mat, qb_mat, q_lens, t_mat, t_lens, li, lj)
    qe = jnp.where(valid, qe, 0)
    te = jnp.where(valid, te, 0)
    score2, qr_end, tr_end = sw_batch_starts(
        q_enc, q_bias, q_len, t_enc, Lq, Lt, t_len=t_len, q_end=qe, t_end=te)
    return _pack_starts_u16(qe - qr_end, te - tr_end)


def _pair_ends_kernel(prof, q_lens, t_mat, t_lens, li, lj, Lq, Lt):
    """Forward ends through the CUDA kernel: every pair reads its
    query's row of the staged profile table and its target's row of the
    staged target codes, at its true lengths."""
    valid = li >= 0
    nrows = jnp.where(valid, q_lens[jnp.maximum(li, 0)], 0)
    ncols = jnp.where(valid, t_lens[lj], 0)
    score, row, col = sw_cuda.ends(prof, li, t_mat, lj, nrows, ncols)
    return _pack_ends_u16(score, jnp.where(col >= 0, row, Lq - 1), col)


def _pair_starts_kernel(prof, q_lens, t_mat, t_lens, li, lj, qe, te,
                        Lq, Lt):
    """Reverse-prefix starts through the same kernel walking
    q[qe::-1] against t[te::-1]."""
    valid = li >= 0
    qe = jnp.where(valid, qe, 0)
    te = jnp.where(valid, te, 0)
    score2, row, col = sw_cuda.ends(prof, li, t_mat, lj, qe + 1, te + 1,
                                    qe, te, reverse=True)
    return _pack_starts_u16(qe - row, te - col)


_IMPLS = {
    # (name, route) -> (impl, replicated arg count, sharded arg count);
    # every impl returns one (k, B) uint16 pack with B (dim 1) sharded
    # over the mesh
    ("pair_ends", "xla"): (_pair_ends_xla, 5, 2),
    ("pair_starts", "xla"): (_pair_starts_xla, 5, 4),
    ("pair_ends", "kernel"): (_pair_ends_kernel, 4, 2),
    ("pair_starts", "kernel"): (_pair_starts_kernel, 4, 4),
}


def n_devices():
    """Alignment data-parallel width: all local devices (the reference's
    MPI rank fan-out over queries, Alignment.cpp:219-243 — here pure
    data parallelism over candidate pairs / query tiles on a 1D mesh),
    cappable via METAEUK_DEVICES. LOCAL devices only: across processes
    the parallel unit is the contig partition (parallel/multihost.py),
    so each process keeps its alignment arrays addressable."""
    n = jax.local_device_count()
    cap = os.environ.get("METAEUK_DEVICES")
    if cap:
        n = min(n, max(1, int(cap)))
    return n


@functools.lru_cache(maxsize=None)
def _dispatcher(name, Lq, Lt, route, n_dev):
    """Jitted (and, on a multi-device mesh, shard_mapped) entry point
    for one alignment impl at one bucket shape. Staged matrices are
    replicated; pair index arrays and outputs are sharded over the 1D
    "pairs" mesh axis — device-parallel alignment with no collectives
    (results are fetched shard-wise by the host merge)."""
    impl, n_rep, n_shard = _IMPLS[(name, route)]

    def core(*arrs):
        return impl(*arrs, Lq, Lt)

    if n_dev == 1:
        return jax.jit(core)
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.local_devices()[:n_dev]), ("pairs",))
    f = jax.shard_map(
        core, mesh=mesh,
        in_specs=(P(),) * n_rep + (P("pairs"),) * n_shard,
        out_specs=P(None, "pairs"),
        check_vma=False)
    return jax.jit(f)


# ---------------------------------------------------------------------------
# Device-side result accumulation.  Each dispatch's fixed-width uint16
# pack is written into large device-side buffers (score row and
# coordinate rows separately) with a donated dynamic_update_slice — one
# small extra dispatch per pack, no N-operand concat compile — and the
# results reach the host as a few large transfers: the score buffer in
# full (2 B/pair) for the host E-value gate, then coordinates gathered on
# device for gate survivors only (~10% of pairs at scale).  Whether this
# still pays on a local GPU is an open measurement (ROADMAP A6).
# ---------------------------------------------------------------------------
ACCUM_W = int(os.environ.get("METAEUK_ACCUM_W", str(4 << 20)))
ACCUM_MIN_PAIRS = int(os.environ.get("METAEUK_ACCUM_MIN", "100000"))


@functools.lru_cache(maxsize=None)
def _accum_add_fn(ns, nc, w, W):
    def f(sbuf, ebuf, pack, off):
        out_s = sbuf
        if ns:
            out_s = jax.lax.dynamic_update_slice(sbuf, pack[:ns], (0, off))
        out_e = jax.lax.dynamic_update_slice(ebuf, pack[ns:], (0, off))
        return out_s, out_e
    return jax.jit(f, donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _accum_gather_fn(ncols, W):
    def f(ebuf, cols):
        return jnp.take(ebuf, cols, axis=1)
    return jax.jit(f)


class _DevAccum:
    """Accumulates (ns+nc, w) uint16 result packs into (ns, W)/(nc, W)
    device buffers.  add() returns (group_idx, col_off); fetch_scores()
    downloads every score buffer; gather() downloads selected columns
    of one group's coordinate buffer."""

    def __init__(self, ns, nc, width=ACCUM_W):
        self.ns, self.nc, self.W = ns, nc, width
        self.done = []            # finalized (sbuf, ebuf)
        self.sbuf = self.ebuf = None
        self.off = 0

    def _open(self):
        self.sbuf = jnp.zeros((max(self.ns, 1), self.W), jnp.uint16)
        self.ebuf = jnp.zeros((self.nc, self.W), jnp.uint16)
        self.off = 0

    def add(self, pack):
        w = int(pack.shape[1])
        if self.ebuf is None or self.off + w > self.W:
            if self.ebuf is not None:
                self.done.append((self.sbuf, self.ebuf))
            self._open()
        fn = _accum_add_fn(self.ns, self.nc, w, self.W)
        self.sbuf, self.ebuf = fn(self.sbuf, self.ebuf, pack,
                                  jnp.int32(self.off))
        gidx, off = len(self.done), self.off
        self.off += w
        return gidx, off

    def _groups(self):
        if self.ebuf is not None:
            self.done.append((self.sbuf, self.ebuf))
            self.sbuf = self.ebuf = None
        return self.done

    def fetch_scores(self):
        """[(ns, W) np.uint16 per group]; transfers pipeline."""
        groups = self._groups()
        for s, _ in groups:
            try:
                s.copy_to_host_async()
            except AttributeError:
                pass
        from ..utils import log as _log
        prog = _log.progress(len(groups), "align fetch scores", step=1)
        outs = []
        for s, _ in groups:
            outs.append(np.asarray(s))
            prog.update()
        prog.finish()
        return outs

    def fetch_coords(self):
        """[(nc, W) np.uint16 per group] — the whole coordinate buffers
        (the reverse pass wants every submitted row)."""
        groups = self._groups()
        for _s, e in groups:
            try:
                e.copy_to_host_async()
            except AttributeError:
                pass
        return [np.asarray(e) for _s, e in groups]

    def gather(self, per_group_cols):
        """per_group_cols: {gidx: int32 np array of columns} -> {gidx:
        (nc, len(cols)) np.uint16}.  Columns are padded to power-of-2
        buckets so the gather executables stay few."""
        groups = self._groups()
        devs = {}
        for gidx, cols in per_group_cols.items():
            n = len(cols)
            if n == 0:
                continue
            npad = 1 << max(10, (n - 1).bit_length())
            cols_p = np.zeros(npad, np.int32)
            cols_p[:n] = cols
            fn = _accum_gather_fn(npad, self.W)
            devs[gidx] = (n, fn(groups[gidx][1], jnp.asarray(cols_p)))
        for _n, d in devs.values():
            try:
                d.copy_to_host_async()
            except AttributeError:
                pass
        return {g: np.asarray(d)[:, :n] for g, (n, d) in devs.items()}


def _fetch_parts(parts):
    """Fetch many deferred (k, w) device arrays as one host-concatenated
    (k, sum w) array. Async device->host copies are issued up front so
    transfers pipeline; progress ticks cover long fetch waits."""
    from ..utils import log as _log
    for d in parts:
        try:
            d.copy_to_host_async()
        except AttributeError:
            break
    prog = _log.progress(len(parts), "align fetch", step=16)
    outs = []
    for d in parts:
        outs.append(np.asarray(d))
        prog.update()
    prog.finish()
    return np.concatenate(outs, axis=1) if outs else None


def _u16_coords(u16):
    """uint16 coordinates -> int32 with the -1 sentinel restored (65535).
    Coordinates are < 65535 (no sequence is that long), so
    the mapping is unambiguous."""
    v = np.asarray(u16).astype(np.int32)
    v[v == 65535] = -1
    return v


_seq_profile_jit = jax.jit(sw_cuda.seq_profile)


class SearchDriver:
    """Aligns encoded fragments against an encoded target DB."""

    def __init__(self, params, target_db):
        import threading
        self.params = params
        self.targets_enc = [encode_aa(target_db.seq_bytes(i))
                            for i in range(len(target_db))]
        self.target_lens = np.array([len(t) for t in self.targets_enc], np.int64)
        self.evaluer = EvalueComputation(target_db.total_residues(), gapped=True)
        # per-tier device staging of the whole target set, built lazily
        # and kept for the driver's lifetime: repeated search() calls
        # (batched pipelines, servers, splits) stop re-uploading targets
        self._t_stage = {}
        self._stage_lock = threading.Lock()

    def _target_tier(self, Lt):
        """(t_mat, t_lens_dev, t_remap) for every target whose length
        tier is Lt; cached on device across search() calls."""
        fine = getattr(self, "_fine", True)
        with self._stage_lock:
            st = self._t_stage.get((Lt, fine))
            if st is None:
                lt_of = _bucket_arr(self.target_lens, fine)
                t_ids = np.flatnonzero(lt_of == Lt)
                nt_pad = _bucket(max(len(t_ids), 1), lo=8)
                t_mat = jnp.asarray(_pad_rows_to(
                    pad_rows([self.targets_enc[i] for i in t_ids], Lt,
                             dtype=np.uint8), nt_pad))
                t_lens = self.target_lens[t_ids].astype(np.int32)
                t_lens_dev = jnp.asarray(np.pad(t_lens,
                                                (0, nt_pad - len(t_ids))))
                t_remap = np.zeros(len(self.targets_enc), np.int32)
                t_remap[t_ids] = np.arange(len(t_ids), dtype=np.int32)
                from ..utils.log import MemoryTracker
                MemoryTracker.track(
                    f"align staged targets Lt={Lt}",
                    int(t_mat.size) + 4 * int(t_lens_dev.size))
                st = dict(t_mat=t_mat, t_lens_dev=t_lens_dev,
                          t_remap=t_remap)
                self._t_stage[(Lt, fine)] = st
        return st

    def _query_stage(self, orf_aa_seqs):
        """Per-Lq-tier device staging of ALL fragments (codes, bias,
        lengths, remap), cached across search() calls on the same list.
        Staging the full fragment set (not just pair participants) makes
        every jit shape a function of the dataset's length histogram
        alone — known BEFORE the prefilter — so prewarm() can pull
        executables in while the prefilter runs, and pipelined batches
        re-use one staging."""
        cache = getattr(self, "_q_cache", None)
        if cache is not None and cache[0] is orf_aa_seqs:
            return cache[1], cache[2], cache[3]
        with self._stage_lock:
            cache = getattr(self, "_q_cache", None)
            if cache is not None and cache[0] is orf_aa_seqs:
                return cache[1], cache[2], cache[3]
            p = self.params
            orfs_enc = [encode_aa(s) for s in orf_aa_seqs]
            orf_lens = np.array([len(e) for e in orfs_enc], np.int64)
            if p.comp_bias_correction:
                from ..data.submat import composition_bias_rounded_batch
                biases = composition_bias_rounded_batch(
                    orfs_enc, p.comp_bias_correction_scale)
            else:
                biases = [np.zeros(len(e), np.int8) for e in orfs_enc]
            # tier policy for THIS dataset (and, via self._fine, for the
            # matching target tiers)
            self._fine = len(orfs_enc) >= FINE_TIER_MIN_FRAGS
            lq_of = _bucket_arr(orf_lens, self._fine)
            tiers = {}
            from ..utils.log import MemoryTracker
            for Lq in np.unique(lq_of[orf_lens > 0]):
                q_ids = np.flatnonzero((lq_of == Lq) & (orf_lens > 0))
                nq_pad = _bucket(max(len(q_ids), 1), lo=8)
                q_mat = jnp.asarray(_pad_rows_to(
                    pad_rows([orfs_enc[i] for i in q_ids], Lq,
                             dtype=np.uint8), nq_pad))
                qb_mat = jnp.asarray(_pad_rows_to(
                    pad_rows([biases[i] for i in q_ids], Lq,
                             dtype=np.int8), nq_pad))
                q_lens_dev = jnp.asarray(np.pad(
                    orf_lens[q_ids].astype(np.int32),
                    (0, nq_pad - len(q_ids))))
                q_remap = np.zeros(len(orfs_enc), np.int32)
                q_remap[q_ids] = np.arange(len(q_ids), dtype=np.int32)
                if align_route() == "kernel":
                    # the kernel reads a per-query score profile table
                    qside = (_seq_profile_jit(q_mat, qb_mat),)
                else:
                    qside = (q_mat, qb_mat)
                MemoryTracker.track(
                    f"align staged queries Lq={Lq}",
                    sum(int(a.nbytes) for a in qside)
                    + 4 * int(q_lens_dev.size))
                tiers[int(Lq)] = dict(qside=qside, q_lens_dev=q_lens_dev,
                                      q_remap=q_remap, nq=len(q_ids))
            self._q_cache = (orf_aa_seqs, orfs_enc, orf_lens, tiers)
        return orfs_enc, orf_lens, tiers

    def prewarm(self, orf_aa_seqs, background=True, max_combos=None):
        """Stage both sides and pull the alignment executables in
        (compile or persistent-cache load) for the (Lq, Lt) tier combos
        of this dataset, in a daemon thread while the prefilter occupies
        the host cores. Small workloads (coarse tiers) warm their ~4
        combos; metagenome-scale workloads (fine tiers) have 10-30
        combos and a long prefilter window to hide them in, so they warm
        everything. Loads overlap on a thread pool; the tail still
        compiles on demand."""
        import threading

        def work():
            try:
                _, orf_lens, q_tiers = self._query_stage(orf_aa_seqs)
                lt_of = _bucket_arr(self.target_lens, self._fine)
                lq_of = _bucket_arr(orf_lens, self._fine)
                q_w = {int(l): int((lq_of == l).sum())
                       for l in np.unique(lq_of)}
                t_w = {int(l): int(self.target_lens[lt_of == l].sum())
                       for l in np.unique(lt_of)}
                combos = sorted(
                    ((lq, lt) for lq in q_tiers for lt in t_w),
                    key=lambda c: -(q_w.get(c[0], 0) * t_w.get(c[1], 0)))
                cap = max_combos
                if cap is None:
                    cap = len(combos) if self._fine else 4
                combos = combos[:cap]
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=6) as pool:
                    futs = [pool.submit(self._warm_combo, op,
                                        q_tiers[Lq], Lq, Lt)
                            for op in ("pair_ends", "pair_starts")
                            for (Lq, Lt) in combos]
                    for f in futs:
                        f.result()
            except Exception as e:  # pragma: no cover - best effort
                from ..utils import log
                log.debug(f"prewarm aborted: {e}")

        if background:
            t = threading.Thread(target=work, daemon=True,
                                 name="align-prewarm")
            t.start()
            return t
        work()

    def _warm_combo(self, name, qt, Lq, Lt):
        """Dispatch one all-padding chunk through the real submit path
        so the exact executable for this (op, Lq, Lt) combo is built."""
        ctx = dict(Lq=Lq, Lt=Lt, qside=qt["qside"],
                   q_lens_dev=qt["q_lens_dev"], q_remap=qt["q_remap"],
                   nq=qt["nq"])
        tst = self._target_tier(Lt)
        ctx.update(t_mat=tst["t_mat"], t_lens_dev=tst["t_lens_dev"],
                   t_remap=tst["t_remap"])
        rows = np.zeros(1, np.int64)
        oi = np.zeros(1, np.int64)
        ti = np.zeros(1, np.int64)
        ends = (np.zeros(1, np.int32), np.zeros(1, np.int32))
        for _ in self._submit_pair(ctx, rows, oi, ti, name,
                                   None if name == "pair_ends" else ends):
            pass

    def search(self, orf_aa_seqs, pair_generator=None):
        """Align fragments; returns a HIT_DTYPE array sorted per fragment.

        orf_aa_seqs: list of AA byte strings (translated fragments).
        pair_generator: optional iterable of (orf_idx, target_idx) candidate
          pairs; None = exhaustive.
        """
        p = self.params
        orfs_enc, orf_lens, q_tiers = self._query_stage(orf_aa_seqs)
        n_orfs = len(orfs_enc)
        n_targets = len(self.targets_enc)

        if pair_generator is None:
            oi = np.repeat(np.arange(n_orfs, dtype=np.int64), n_targets)
            ti = np.tile(np.arange(n_targets, dtype=np.int64), n_orfs)
        else:
            pairs = pair_generator if isinstance(pair_generator, np.ndarray) \
                else np.asarray(list(pair_generator), dtype=np.int64)
            if len(pairs) == 0:
                return np.zeros(0, dtype=HIT_DTYPE)
            oi, ti = (pairs[:, 0].astype(np.int64),
                      pairs[:, 1].astype(np.int64))

        # drop pairs with empty sequences
        keep = (orf_lens[oi] > 0) & (self.target_lens[ti] > 0)
        oi, ti = oi[keep], ti[keep]
        if len(oi) == 0:
            return np.zeros(0, dtype=HIT_DTYPE)

        import time as _time
        phase_s = {}
        _t0 = _time.perf_counter()

        def _mark(name):
            nonlocal _t0
            t = _time.perf_counter()
            phase_s[name] = phase_s.get(name, 0.0) + (t - _t0)
            _t0 = t

        # stage per-bucket padded matrices ONCE (device-side gather per
        # chunk keeps the host out of the per-pair path)
        lq_of = _bucket_arr(orf_lens, self._fine)
        lt_of = _bucket_arr(self.target_lens, self._fine)
        lq_b, lt_b = lq_of[oi], lt_of[ti]
        n_pairs = len(oi)
        _mark("prep")

        # ---- phase 1: stage buckets + submit forward-ends dispatches ----
        from ..utils import log as _log
        prog = _log.progress(n_pairs, "align submit")
        buckets = []
        # at scale, packs accumulate into device buffers and reach the
        # host as a few large transfers (see _DevAccum); below the
        # threshold the per-part fetch path keeps things simple
        accum = _DevAccum(1, 2) \
            if (n_pairs >= ACCUM_MIN_PAIRS and platform() == "gpu") else None
        fwd_parts = []  # (pair rows, deferred pack | (g, off, w))

        def _part(parts, rows, outs, acc):
            if acc is not None:
                gidx, off = acc.add(outs)
                parts.append((rows, (gidx, off, int(outs.shape[1]))))
            else:
                parts.append((rows, outs))
        for (Lq, Lt) in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            sel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            # both sides come from the persistent per-tier staging
            # (queries cached per fragment list, targets per driver) —
            # a bucket is just the (Lq, Lt) pairing of the two remaps
            qt = q_tiers[int(Lq)]
            tst = self._target_tier(Lt)
            ctx = dict(Lq=Lq, Lt=Lt, sel=sel, qside=qt["qside"],
                       q_lens_dev=qt["q_lens_dev"], t_mat=tst["t_mat"],
                       t_lens_dev=tst["t_lens_dev"],
                       q_remap=qt["q_remap"],
                       t_remap=tst["t_remap"], nq=qt["nq"])
            buckets.append(ctx)
            for rows, li, lj, outs in self._submit_pair(
                    ctx, sel, oi, ti, "pair_ends", None):
                _part(fwd_parts, rows, outs, accum)
                prog.update(len(rows))
        prog.finish()
        _mark("fwd_submit")
        if len(fwd_parts) > 64:
            _log.info(f"align: {len(fwd_parts)} dispatches in flight; "
                      "fetching results")
        if not fwd_parts:
            return np.zeros(0, dtype=HIT_DTYPE)

        # ---- phase 2: fetch forward results ----
        score_all = np.zeros(n_pairs, np.int32)
        qe_all = np.zeros(n_pairs, np.int32)
        te_all = np.full(n_pairs, -1, np.int32)
        if accum is not None:
            # score rows only (2 B/pair); coordinates stay on device
            # until the gate has shrunk the set
            sgroups = accum.fetch_scores()
            _mark("fwd_fetch")
            for rows, (gidx, off, w) in fwd_parts:
                score_all[rows] = sgroups[gidx][0, off:off + len(rows)]
        else:
            # per-part fetch: async copies are issued for every part
            # first so the transfers pipeline, then concatenated on
            # HOST — a device-side concat would compile an N-operand op
            # whose compile time explodes for tens of thousands of
            # dispatches
            cat = _fetch_parts([pp[1] for pp in fwd_parts])
            _mark("fwd_fetch")
            off = 0
            for rows, dev in fwd_parts:
                m = len(rows)
                seg = cat[:, off:off + m]
                off += int(dev.shape[1])
                score_all[rows] = seg[0]
                qe_all[rows] = _u16_coords(seg[1])
                te_all[rows] = _u16_coords(seg[2])
        _mark("fwd_assemble")

        # ---- phase 3: E-value gate on host (exact float64 semantics) ----
        # Alignment::checkCriteria drops rows failing the E-value gate
        # regardless of start coordinates, so the reverse-prefix pass
        # only runs on rows that can possibly survive.
        # The decision ev(score, qlen) <= thr is evaluated as an integer
        # score-cutoff compare: ev is monotone non-increasing in score
        # for fixed qlen, so per distinct qlen the minimal passing score
        # is found once by bisection over the SAME float64 evalue
        # function (boundary-verified) — identical decisions without
        # materializing ~15 float64 temporaries over every candidate
        # pair; the exact E-values are then computed for survivors only.
        p = self.params
        q_len_pairs = orf_lens[oi]
        cutoffs = self._gate_cutoffs(q_len_pairs, p.search_evalue_thr)
        if cutoffs is not None:
            surv = (score_all > 0) & (score_all >= cutoffs)
        else:  # monotonicity verification failed: dense fallback
            ev_gate = self.evaluer.compute_evalue(
                score_all.astype(np.float64),
                q_len_pairs.astype(np.float64))
            surv = (score_all > 0) & (ev_gate <= p.search_evalue_thr)
        if accum is not None:
            # download coordinates for the score-gate survivors only,
            # gathered on device (surv is a superset of the final gate:
            # the te >= 0 condition below completes it)
            per_cols, per_gids = {}, {}
            for rows, (gidx, off, w) in fwd_parts:
                loc = np.flatnonzero(surv[rows])
                if len(loc):
                    per_cols.setdefault(gidx, []).append(off + loc)
                    per_gids.setdefault(gidx, []).append(rows[loc])
            got = accum.gather({g: np.concatenate(c)
                                for g, c in per_cols.items()})
            for g, arr in got.items():
                gids = np.concatenate(per_gids[g])
                qe_all[gids] = _u16_coords(arr[0])
                te_all[gids] = _u16_coords(arr[1])
        surv &= te_all >= 0
        CELLS["fwd"] += int((q_len_pairs.astype(np.int64)
                             * self.target_lens[ti]).sum())
        CELLS["rev"] += int(((qe_all[surv].astype(np.int64) + 1)
                             * (te_all[surv].astype(np.int64) + 1)).sum())
        _mark("gate")

        # ---- phase 4: reverse pass on survivors only ----
        qs_all = np.full(n_pairs, -1, np.int32)
        ts_all = np.full(n_pairs, -1, np.int32)
        rev_accum = _DevAccum(0, 2) if accum is not None else None
        rev_parts = []
        for ctx in buckets:
            sel = ctx["sel"]
            rows_s = sel[surv[sel]]
            for rows, li, lj, outs in self._submit_pair(
                    ctx, rows_s, oi, ti, "pair_starts", (qe_all, te_all)):
                _part(rev_parts, rows, outs, rev_accum)
        _mark("rev_submit")
        if rev_parts and rev_accum is not None:
            cgroups = rev_accum.fetch_coords()
            for rows, (gidx, off, w) in rev_parts:
                seg = cgroups[gidx][:, off:off + len(rows)]
                qs_all[rows] = _u16_coords(seg[0])
                ts_all[rows] = _u16_coords(seg[1])
        elif rev_parts:
            cat = _fetch_parts([pp[1] for pp in rev_parts])
            off = 0
            for rows, dev in rev_parts:
                seg = cat[:, off:off + len(rows)]
                off += int(dev.shape[1])
                qs_all[rows] = _u16_coords(seg[0])
                ts_all[rows] = _u16_coords(seg[1])
        _mark("rev_fetch")

        # compact to gate survivors BEFORE the scoring/sort pass: rows
        # failing the E-value gate can never pass checkCriteria (same
        # E-value formula and inputs), and at metagenome scale survivors
        # are ~10% of pairs — the per-field math and the lexsort shrink
        # accordingly
        keep_rows = np.flatnonzero(surv)
        hits = np.zeros(len(keep_rows), dtype=HIT_DTYPE)
        hits["orf_idx"] = oi[keep_rows]
        hits["target_idx"] = ti[keep_rows]
        hits["score_raw"] = score_all[keep_rows]
        hits["q_start"], hits["q_end"] = qs_all[keep_rows], qe_all[keep_rows]
        hits["q_len"] = q_len_pairs[keep_rows]
        hits["t_start"], hits["t_end"] = ts_all[keep_rows], te_all[keep_rows]
        hits["t_len"] = self.target_lens[ti[keep_rows]]
        ev_surv = self.evaluer.compute_evalue(
            score_all[keep_rows].astype(np.float64),
            q_len_pairs[keep_rows].astype(np.float64))
        out = self._filter_and_sort(hits, evalue=ev_surv)
        _mark("filter_sort")
        self.phase_seconds = phase_s
        from ..utils import log
        log.info("align phases: " + "  ".join(
            f"{k}={v:.2f}s" for k, v in phase_s.items())
            + f"  pairs={n_pairs} surv={int(surv.sum())}")
        return out

    def _submit_pair(self, ctx, rows, oi, ti, name, ends):
        """Chunk + pad + dispatch candidate pairs of one (Lq, Lt) bucket;
        yields (rows, li, lj, deferred device pack) per chunk."""
        if not len(rows):
            return
        Lq, Lt = ctx["Lq"], ctx["Lt"]
        route = align_route()
        n_dev = n_devices()
        mult = 8 * n_dev
        fn = _dispatcher(name, Lq, Lt, route, n_dev)
        if route == "kernel":
            # one jit shape per bucket/op: padding pairs exit at once in
            # the kernel, so a fixed launch width costs nothing
            batch_cap = max(64, min(KERNEL_MAX_PAIRS,
                                    KERNEL_SCRATCH_BYTES // (8 * Lt)))
            batch_cap = ((batch_cap + mult - 1) // mult) * mult
        else:
            # rows cap: short-tier launches are bounded by the per-row
            # staging intermediates long before the cell budget
            batch_cap = max(8, min(CELL_BUDGET // (Lq * Lt), 32768))
        for s in range(0, len(rows), batch_cap):
            r = rows[s:s + batch_cap]
            if route == "kernel" or len(rows) > batch_cap:
                fixed = batch_cap
            else:
                fixed = 0
            B = len(r)
            Bp = ((max(B, fixed) + mult - 1) // mult) * mult
            li_p = np.full(Bp, -1, np.int32)
            lj_p = np.zeros(Bp, np.int32)
            li_p[:B] = ctx["q_remap"][oi[r]]
            lj_p[:B] = ctx["t_remap"][ti[r]]
            args = (*ctx["qside"], ctx["q_lens_dev"], ctx["t_mat"],
                    ctx["t_lens_dev"], jnp.asarray(li_p), jnp.asarray(lj_p))
            if ends is not None:
                qe_p = np.zeros(Bp, np.int32)
                te_p = np.zeros(Bp, np.int32)
                qe_p[:B] = ends[0][r]
                te_p[:B] = ends[1][r]
                args += (jnp.asarray(qe_p), jnp.asarray(te_p))
            yield r, li_p, lj_p, fn(*args)

    def _gate_cutoffs(self, q_len_pairs, thr):
        """Per-pair minimal passing raw score for the E-value gate, via
        per-distinct-qlen bisection over the exact evalue function.
        Returns None if the boundary verification fails for any length
        (caller falls back to the dense gate). METAEUK_GATE_CUTOFF=0
        disables the fast path."""
        if os.environ.get("METAEUK_GATE_CUTOFF") == "0":
            return None
        cache = getattr(self, "_gate_cut_cache", None)
        if cache is None or cache[0] != thr:
            cache = (thr, {})
            self._gate_cut_cache = cache
        cut = cache[1]
        uniq = np.unique(q_len_pairs)
        ev = self.evaluer
        for L in uniq:
            L = int(L)
            if L in cut:
                continue
            fL = float(L)

            def e(s):
                return float(ev.compute_evalue(np.float64(s),
                                               np.float64(fL)))
            hi = 1
            while e(hi) > thr and hi < (1 << 22):
                hi <<= 1
            lo = 0   # e(lo) > thr invariant (score 0 rows never survive)
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if e(mid) <= thr:
                    hi = mid
                else:
                    lo = mid
            # boundary verification of monotonicity
            if e(hi) > thr or (hi > 1 and e(hi - 1) <= thr):
                return None
            cut[L] = hi
        lut_len = int(uniq[-1]) + 1 if len(uniq) else 1
        lut = getattr(self, "_gate_cut_lut", None)
        if lut is None or lut[0] != thr or lut[2] != len(cut) \
                or len(lut[1]) < lut_len:
            arr = np.full(max(lut_len, max(cut, default=1) + 1, 2),
                          np.iinfo(np.int32).max, np.int32)
            for L, s in cut.items():
                arr[L] = s
            self._gate_cut_lut = (thr, arr, len(cut))
            lut = self._gate_cut_lut
        return lut[1][q_len_pairs]

    def _filter_and_sort(self, hits, evalue=None):
        p = self.params
        ev = self.evaluer
        score = hits["score_raw"].astype(np.float64)
        # evalue over the full query length (ssw_align_private:391);
        # reuse the gate's values when provided (identical formula)
        hits["evalue"] = evalue if evalue is not None else \
            ev.compute_evalue(score, hits["q_len"].astype(np.float64))
        hits["bit_score"] = ev.compute_bit_score_int(score)
        q_aln = np.maximum(hits["q_end"] - hits["q_start"], 1)
        t_aln = np.maximum(hits["t_end"] - hits["t_start"], 1)
        hits["seq_id"] = estimate_seq_id(hits["score_raw"], q_aln, t_aln)

        aligned = (hits["t_end"] >= 0) & (hits["score_raw"] > 0) & (hits["t_start"] >= 0)
        # Alignment::checkCriteria (Alignment.cpp:548-567)
        aln_len = np.maximum(np.abs(hits["q_end"] - hits["q_start"]),
                             np.abs(hits["t_end"] - hits["t_start"])) + 1
        q_cov = (np.abs(hits["q_end"] - hits["q_start"]) + 1) \
            / np.maximum(hits["q_len"], 1)
        t_cov = (np.abs(hits["t_end"] - hits["t_start"]) + 1) \
            / np.maximum(hits["t_len"], 1)
        if p.cov_mode == 1:  # COV_MODE_TARGET (Util.cpp:496-511)
            has_cov = t_cov >= p.cov_thr
        elif p.cov_mode == 2:  # COV_MODE_QUERY
            has_cov = q_cov >= p.cov_thr
        else:
            has_cov = (q_cov >= p.cov_thr) & (t_cov >= p.cov_thr)
        ok = (aligned
              & (hits["evalue"] <= p.search_evalue_thr)
              & (hits["seq_id"] >= p.seq_id_thr)
              & has_cov
              & (aln_len >= p.aln_len_thr))
        hits = hits[ok]
        # Matcher::compareHits order per query (Matcher.h:157-168):
        # evalue asc, score desc, dbLen asc, dbKey asc; grouped by orf
        order = np.lexsort((hits["target_idx"], hits["t_len"],
                            -hits["bit_score"], hits["evalue"], hits["orf_idx"]))
        return hits[order]

    def realign(self, hits, orf_aa_seqs, realign_score_bias=-0.2,
                realign_max_seqs=None, realign_cov=0.0, cov_mode=0):
        """--realign pass (Alignment.cpp:298-446): recompute alignment
        boundaries and backtraces with the scoreBias-shifted matrix
        (default -0.2, Parameters.cpp:2437); scores and E-values keep
        the first-pass values. Composition bias is recomputed with the
        realign matrix (the realigner Matcher owns realign_m,
        Alignment.cpp:158-162, 303).

        Returns (hits_out, backtraces, seq_ids): coords replaced by the
        realign pass; rows dropped only by the realign coverage gate,
        and per query at most realign_max_seqs rows survive."""
        from ..data.submat import scores_with_bias
        from .. import native

        p = self.params
        sub = scores_with_bias(2.0, realign_score_bias)
        enc_cache = {}

        def q_arrays(oi):
            if oi not in enc_cache:
                e = encode_aa(orf_aa_seqs[oi])
                b = composition_bias_rounded(
                    e, p.comp_bias_correction_scale, scores=sub) \
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                enc_cache[oi] = (e, b)
            return enc_cache[oi]

        n = len(hits)
        score2 = np.zeros(n, np.int32)
        qs2 = np.zeros(n, np.int32)
        qe2 = np.zeros(n, np.int32)
        ts2 = np.zeros(n, np.int32)
        te2 = np.zeros(n, np.int32)
        # bucket hit pairs and realign in dense batches
        ol = np.array([len(q_arrays(int(h["orf_idx"]))[0]) for h in hits],
                      np.int64)
        tl = hits["t_len"].astype(np.int64)
        lq_b = np.array([_bucket(max(l, 1)) for l in ol])
        lt_b = np.array([_bucket(max(l, 1)) for l in tl])
        for (Lq, Lt) in sorted(set(zip(lq_b.tolist(), lt_b.tolist()))):
            sel = np.flatnonzero((lq_b == Lq) & (lt_b == Lt))
            qm = pad_rows([q_arrays(int(hits[i]["orf_idx"]))[0]
                           for i in sel], Lq)
            qb = pad_rows([q_arrays(int(hits[i]["orf_idx"]))[1]
                           for i in sel], Lq)
            tm = pad_rows([self.targets_enc[int(hits[i]["target_idx"])]
                           for i in sel], Lt)
            sc, qs, qe, ts, te = sw_align_batch(
                qm, qb, ol[sel].astype(np.int32), tm,
                tl[sel].astype(np.int32), submat=sub)
            score2[sel], qs2[sel], qe2[sel] = sc, qs, qe
            ts2[sel], te2[sel] = ts, te

        keep = np.zeros(n, bool)
        bts, seq_ids = [], []
        per_query = {}
        cap = realign_max_seqs if realign_max_seqs is not None else 1 << 62
        for i in range(n):
            oi = int(hits[i]["orf_idx"])
            if per_query.get(oi, 0) >= cap:
                continue
            if score2[i] <= 0 or te2[i] < 0:
                continue
            q_cov = (abs(int(qe2[i]) - int(qs2[i])) + 1) / max(int(ol[i]), 1)
            t_cov = (abs(int(te2[i]) - int(ts2[i])) + 1) / max(int(tl[i]), 1)
            if cov_mode == 1:  # COV_MODE_TARGET
                cov_ok = t_cov >= realign_cov
            elif cov_mode == 2:  # COV_MODE_QUERY
                cov_ok = q_cov >= realign_cov
            else:
                cov_ok = q_cov >= realign_cov and t_cov >= realign_cov
            if not cov_ok:
                continue
            per_query[oi] = per_query.get(oi, 0) + 1
            keep[i] = True
            q_enc, q_bias = q_arrays(oi)
            t_enc = self.targets_enc[int(hits[i]["target_idx"])]
            qs, qe = int(qs2[i]), int(qe2[i])
            ts, te = int(ts2[i]), int(te2[i])
            band = abs((te - ts + 1) - (qe - qs + 1)) + 1
            bt = native.banded_sw_traceback(
                q_enc[qs:qe + 1], q_bias[qs:qe + 1], t_enc[ts:te + 1],
                int(score2[i]), band, p.gap_open, p.gap_extend, submat=sub)
            if bt is None:
                bt = ""
            bts.append(bt)
            if bt:
                qp, tp, ids = qs, ts, 0
                for op in bt:
                    if op == "M":
                        ids += int(q_enc[qp] == t_enc[tp])
                        qp += 1
                        tp += 1
                    elif op == "I":
                        qp += 1
                    else:
                        tp += 1
                seq_ids.append(np.float32(ids) / np.float32(len(bt)))
            else:
                seq_ids.append(np.float32(0.0))
        out = hits[keep].copy()
        out["q_start"], out["q_end"] = qs2[keep], qe2[keep]
        out["t_start"], out["t_end"] = ts2[keep], te2[keep]
        return out, bts, np.asarray(seq_ids, np.float32)

    def backtraces(self, hits, orf_aa_seqs):
        """M/I/D backtraces + exact seqIds for accepted hits — the reference's
        alignment-mode-3 path (banded_sw on the alignment window +
        computerBacktrace, StripedSmithWaterman.cpp:498-581). Returns
        (list[str], float32 seqIds by alnLen)."""
        from .. import native
        from ..data.submat import composition_bias_rounded

        p = self.params
        enc_cache = {}
        bts = []
        seq_ids = np.zeros(len(hits), np.float32)
        for idx, h in enumerate(hits):
            oi = int(h["orf_idx"])
            if oi not in enc_cache:
                e = encode_aa(orf_aa_seqs[oi])
                b = composition_bias_rounded(e, p.comp_bias_correction_scale) \
                    if p.comp_bias_correction else np.zeros(len(e), np.int8)
                enc_cache[oi] = (e, b)
            q_enc, q_bias = enc_cache[oi]
            t_enc = self.targets_enc[int(h["target_idx"])]
            qs, qe = int(h["q_start"]), int(h["q_end"])
            ts, te = int(h["t_start"]), int(h["t_end"])
            band = abs((te - ts + 1) - (qe - qs + 1)) + 1
            bt = native.banded_sw_traceback(
                q_enc[qs:qe + 1], q_bias[qs:qe + 1], t_enc[ts:te + 1],
                int(h["score_raw"]), band, p.gap_open, p.gap_extend)
            if bt is None:
                bt = ""
            bts.append(bt)
            if bt:
                qp, tp, ids = qs, ts, 0
                for op in bt:
                    if op == "M":
                        ids += int(q_enc[qp] == t_enc[tp])
                        qp += 1
                        tp += 1
                    elif op == "I":
                        qp += 1
                    else:
                        tp += 1
                seq_ids[idx] = np.float32(ids) / np.float32(len(bt))
        return bts, seq_ids
