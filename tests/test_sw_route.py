"""The alignment routes against the numpy oracle (ops/sw.py).

Three things are checked here without a GPU:
- the XLA route (ops/sw_jax.py) at the shapes the search meets;
- the CUDA kernel's DP core, built for the host (native/sw_host.cpp,
  the same sw_dp.h the kernel compiles);
- the kernel route's wrappers end to end (staging, padding, reverse
  prefixes, profile tables, route choice), with the FFI call replaced by
  the host build through a callback.
The compiled kernel itself is compared with the oracle on the card by
phase b of chip_smoke.py.
"""

import pathlib

import numpy as np
import pytest

from metaeuk_tpu.data.submat import BLOSUM62_SCORES
from metaeuk_tpu.ops import sw_cuda
from metaeuk_tpu.ops.sw import sw_align, sw_end
from metaeuk_tpu.ops.sw_jax import sw_align_batch, sw_align_batch_prof

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = pathlib.Path(__file__).parent / "golden"
FIELDS = ("score", "q_start", "q_end", "t_start", "t_end")


def _ragged(rng, B, Lq, Lt, lo_q=5, lo_t=5):
    qs = [rng.integers(0, 20, int(rng.integers(lo_q, Lq + 1)))
          for _ in range(B)]
    ts = [rng.integers(0, 21, int(rng.integers(lo_t, Lt + 1)))
          for _ in range(B)]
    # plant shared segments so real, gapped alignments exist
    for i in range(0, B, 2):
        n = min(len(qs[i]), len(ts[i])) // 2
        if n:
            ts[i][:n] = qs[i][:n]
    bias = [rng.integers(-2, 3, len(q)) for q in qs]
    return qs, ts, bias


def _pad(rows, width):
    out = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _check(got, qs, ts, bias):
    for i in range(len(qs)):
        ref = sw_align(qs[i], ts[i], bias[i])
        assert int(got[0][i]) == ref["score"], i
        if ref["score"] > 0:
            assert tuple(int(g[i]) for g in got[1:]) == tuple(
                ref[k] for k in FIELDS[1:]), i


# (B, Lq, Lt): short pairs; many target columns (the old column-chunk
# boundary); a long query (Lq > 2048, the old row-tiled regime)
SHAPES = {"short": (12, 40, 48), "multichunk": (4, 24, 1024),
          "long_query": (2, 2100, 64)}


@pytest.mark.parametrize("shape", SHAPES)
def test_xla_route_matches_oracle(shape):
    B, Lq, Lt = SHAPES[shape]
    rng = np.random.default_rng(len(shape))
    qs, ts, bias = _ragged(rng, B, Lq, Lt, lo_q=max(5, Lq // 2))
    got = sw_align_batch(_pad(qs, Lq), _pad(bias, Lq),
                         np.array([len(q) for q in qs], np.int32),
                         _pad(ts, Lt), np.array([len(t) for t in ts],
                                                np.int32))
    _check(got, qs, ts, bias)


def _prof_oracle(prof, q_len, t, t_len):
    p = prof[:q_len].astype(np.int64)
    t = np.asarray(t[:t_len])
    score, qe, te = sw_end(p, t)
    if te < 0 or score == 0:
        return score, -1, -1, -1
    _, qr, tr = sw_end(p[qe::-1], t[te::-1])
    return score, qe - qr, qe, te - tr, te


def test_xla_route_pssm_matches_oracle():
    rng = np.random.default_rng(11)
    B, Lq, Lt = 10, 48, 64
    prof = rng.integers(-10, 12, (B, Lq, 21)).astype(np.int32)
    q_len = rng.integers(5, Lq + 1, B).astype(np.int32)
    t_enc = rng.integers(0, 21, (B, Lt)).astype(np.int32)
    t_len = rng.integers(5, Lt + 1, B).astype(np.int32)
    got = sw_align_batch_prof(prof, q_len, t_enc, t_len)
    for i in range(B):
        ref = _prof_oracle(prof[i], q_len[i], t_enc[i], t_len[i])
        assert int(got[0][i]) == ref[0], i
        if ref[0] > 0:
            assert tuple(int(g[i]) for g in got[1:]) == ref[1:], i


def _kernel_host_align(prof, pidx, t_mat, tidx, q_len, t_len):
    """Full alignment through the kernel core built for the host, the way
    the kernel route calls the kernel: forward, then reversed prefixes."""
    score, row, col = sw_cuda.ends_host(prof, pidx, t_mat, tidx, q_len,
                                        t_len, q_len * 0, q_len * 0, False)
    qe, te = np.maximum(row, 0), np.maximum(col, 0)
    _, row2, col2 = sw_cuda.ends_host(prof, pidx, t_mat, tidx, qe + 1,
                                      te + 1, qe, te, True)
    ok = (col >= 0) & (score > 0)
    return (score, np.where(ok, qe - row2, -1), row,
            np.where(ok, te - col2, -1), col)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_core_matches_oracle(shape):
    B, Lq, Lt = SHAPES[shape]
    rng = np.random.default_rng(100 + len(shape))
    qs, ts, bias = _ragged(rng, B, Lq, Lt, lo_q=max(1, Lq // 2), lo_t=1)
    LP = -(-Lq // 16) * 16
    prof = np.asarray(sw_cuda.seq_profile(_pad(qs, LP), _pad(bias, LP)))
    got = _kernel_host_align(
        prof, np.arange(B, dtype=np.int32), _pad(ts, Lt).astype(np.uint8),
        np.arange(B, dtype=np.int32),
        np.array([len(q) for q in qs], np.int32),
        np.array([len(t) for t in ts], np.int32))
    _check(got, qs, ts, bias)


def test_kernel_core_pssm_matches_oracle():
    rng = np.random.default_rng(12)
    B, Lq, Lt = 10, 48, 64
    prof = rng.integers(-10, 12, (B, Lq, 21)).astype(np.int32)
    q_len = rng.integers(5, Lq + 1, B).astype(np.int32)
    t_enc = rng.integers(0, 21, (B, Lt)).astype(np.uint8)
    t_len = rng.integers(5, Lt + 1, B).astype(np.int32)
    got = _kernel_host_align(np.asarray(sw_cuda.pssm_profile(prof)),
                             np.arange(B, dtype=np.int32), t_enc,
                             np.arange(B, dtype=np.int32), q_len, t_len)
    for i in range(B):
        ref = _prof_oracle(prof[i], q_len[i], t_enc[i], t_len[i])
        assert int(got[0][i]) == ref[0], i
        if ref[0] > 0:
            assert tuple(int(g[i]) for g in got[1:]) == ref[1:], i


def test_kernel_core_saturates_at_cap():
    """A self-alignment past 32767 saturates like the XLA form."""
    q = np.full(3400, 18, np.int32)   # W: BLOSUM62 self-score 11
    ref = sw_align_batch(q[None], np.zeros((1, 3400), np.int32),
                         np.array([3400], np.int32), q[None],
                         np.array([3400], np.int32))
    prof = np.asarray(sw_cuda.seq_profile(q[None], np.zeros((1, 3400))))
    got = _kernel_host_align(prof, np.zeros(1, np.int32),
                             q[None].astype(np.uint8), np.zeros(1, np.int32),
                             np.array([3400], np.int32),
                             np.array([3400], np.int32))
    assert int(ref[0][0]) == 32767
    for name, a, b in zip(FIELDS, ref, got):
        assert int(a[0]) == int(b[0]), name


def test_kernel_padding_pairs_align_nothing():
    prof = np.zeros((1, 21, 16), np.int16)
    t = np.zeros((1, 8), np.uint8)
    one = np.ones(3, np.int32)
    score, row, col = sw_cuda.ends_host(
        prof + 5, np.array([-1, 0, 0], np.int32), t, np.zeros(3, np.int32),
        np.array([4, 0, 4], np.int32), np.array([4, 4, 0], np.int32),
        one, one, False)
    assert score.tolist() == [0, 0, 0]
    assert row.tolist() == col.tolist() == [-1, -1, -1]


def test_kernel_wrapper_rejects_unaligned_profile():
    import jax.numpy as jnp
    with pytest.raises(ValueError, match="multiple of 16"):
        sw_cuda.ends(jnp.zeros((1, 21, 20), jnp.int16),
                     jnp.zeros(2, jnp.int32), jnp.zeros((1, 8), jnp.uint8),
                     jnp.zeros(2, jnp.int32), jnp.ones(2, jnp.int32),
                     jnp.ones(2, jnp.int32))


def test_seq_profile_layout():
    q = np.array([[0, 5, 19, 20]], np.int32)
    b = np.array([[1, -2, 0, 3]], np.int32)
    prof = np.asarray(sw_cuda.seq_profile(q, b))
    assert prof.shape == (1, 21, 4) and prof.dtype == np.int16
    for i in range(4):
        np.testing.assert_array_equal(prof[0, :, i],
                                      BLOSUM62_SCORES[q[0, i]] + b[0, i])


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route with the FFI call replaced by the host build, on
    one device (host callbacks inside a multi-device CPU shard_map can
    deadlock)."""
    import metaeuk_tpu.search.driver as drv
    monkeypatch.setenv("METAEUK_DEVICES", "1")
    import metaeuk_tpu.search.profile_search as ps
    monkeypatch.setattr(drv, "align_route", lambda: "kernel")
    monkeypatch.setattr(ps, "align_route", lambda: "kernel")
    monkeypatch.setattr(sw_cuda, "kernel_call", sw_cuda.host_call)
    dispatcher = drv._dispatcher
    dispatcher.cache_clear()
    yield drv
    dispatcher.cache_clear()


class _TDB:
    def __init__(self, seqs):
        self.seqs = seqs

    def __len__(self):
        return len(self.seqs)

    def seq_bytes(self, i):
        return self.seqs[i]

    def total_residues(self):
        return sum(len(s) for s in self.seqs)


def test_driver_kernel_route_matches_xla_route(kernel_route, monkeypatch):
    """SearchDriver on the kernel route (stubbed kernel) gives the hit
    array of the XLA route, field for field."""
    import metaeuk_tpu.search.driver as drv
    from metaeuk_tpu.params import Params

    aas = b"ACDEFGHIKLMNPQRSTVWY"
    r = np.random.default_rng(5)
    targets = [bytes(aas[c] for c in r.integers(0, 20, int(n)))
               for n in r.integers(20, 300, 37)]
    orfs = [bytes(aas[c] for c in r.integers(0, 20, int(n)))
            for n in r.integers(20, 300, 9)]
    orfs[0] = targets[3][:40] + orfs[0][:20]
    orfs[4] = targets[10][5:60]
    p = Params()
    p.search_evalue_thr = 1e5
    got = drv.SearchDriver(p, _TDB(targets)).search(orfs)
    monkeypatch.setattr(drv, "align_route", lambda: "xla")
    ref = drv.SearchDriver(p, _TDB(targets)).search(orfs)
    assert len(ref) == len(got) > 0
    for name in ref.dtype.names:
        np.testing.assert_array_equal(ref[name], got[name], name)


def test_easypredict_kernel_route_byte_parity(kernel_route, tmp_path):
    """easy-predict through the kernel route's wrappers reproduces the
    goldens byte for byte."""
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    out = tmp_path / "preds"
    EasyPredict(Params()).run(DATA / "contigs.fna", DATA / "proteins.faa",
                              str(out))
    for suffix in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        assert pathlib.Path(f"{out}.{suffix}").read_bytes() \
            == (GOLDEN / f"easypredict.{suffix}").read_bytes(), suffix


def test_kernel_route_launch_padding(kernel_route, monkeypatch):
    """Kernel launches have one width per bucket, padding pairs carry
    li = -1, and the scratch bound caps long target tiers."""
    drv = kernel_route
    ctx = dict(Lq=64, Lt=1 << 16, qside=(None,), q_lens_dev=None,
               t_mat=None, t_lens_dev=None,
               q_remap=np.arange(10, dtype=np.int32),
               t_remap=np.arange(10, dtype=np.int32), nq=10)
    seen = []
    monkeypatch.setattr(drv, "_dispatcher",
                         lambda *a: lambda *args: seen.append(args) or 0)
    d = object.__new__(drv.SearchDriver)
    rows = np.arange(5)
    chunks = list(d._submit_pair(ctx, rows, rows, rows, "pair_ends", None))
    cap = drv.KERNEL_SCRATCH_BYTES // (8 * (1 << 16))
    assert len(chunks) == 1
    li = np.asarray(seen[0][-2])
    assert len(li) == cap
    assert li[:5].tolist() == list(range(5)) and (li[5:] == -1).all()
