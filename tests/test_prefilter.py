import pathlib

import numpy as np
import pytest

from metaeuk_tpu.io.seqdb import SeqDB, DBTYPE_AA
from metaeuk_tpu.ops.ungapped import gapless_scores
from metaeuk_tpu.params import Params
from metaeuk_tpu.pipeline.predict import EasyPredict
from metaeuk_tpu.search.prefilter import UngappedPrefilter

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = pathlib.Path(__file__).parent / "golden"

rng = np.random.default_rng(9)


def gapless_naive(q, t, bias):
    from metaeuk_tpu.data.submat import BLOSUM62_SCORES
    best = 0
    for d in range(-(len(t) - 1), len(q)):
        run = 0
        for j in range(len(t)):
            i = j + d
            if 0 <= i < len(q):
                run = max(0, run + BLOSUM62_SCORES[q[i], t[j]] + bias[i])
                best = max(best, run)
            else:
                run = 0
        best = max(best, run)
    return best


def test_gapless_scores_match_naive():
    B, Lq, Lt = 6, 24, 32
    qs = [rng.integers(0, 20, int(rng.integers(5, Lq + 1))) for _ in range(B)]
    ts = [rng.integers(0, 20, int(rng.integers(5, Lt + 1))) for _ in range(B)]
    biases = [rng.integers(-2, 3, len(q)) for q in qs]
    q_enc = np.zeros((B, Lq), np.int32)
    q_bias = np.zeros((B, Lq), np.int32)
    t_enc = np.zeros((B, Lt), np.int32)
    q_len = np.array([len(q) for q in qs], np.int32)
    t_len = np.array([len(t) for t in ts], np.int32)
    for i in range(B):
        q_enc[i, :q_len[i]] = qs[i]
        q_bias[i, :q_len[i]] = biases[i]
        t_enc[i, :t_len[i]] = ts[i]
    got = gapless_scores(q_enc, q_bias, q_len, t_enc, t_len)
    for i in range(B):
        assert got[i] == gapless_naive(qs[i], ts[i], biases[i]), i


def test_ungapped_prefilter_pipeline_matches_exhaustive():
    """On the fixture, the ungapped prefilter must keep all true candidate
    pairs -> identical final predictions to the exhaustive (golden) path."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        out = f"{td}/preds"
        EasyPredict(Params(prefilter_mode="ungapped")).run(
            DATA / "contigs.fna", DATA / "proteins.faa", out)
        mine = pathlib.Path(f"{out}.fas").read_bytes()
    golden = (GOLDEN / "easypredict.fas").read_bytes()
    assert mine == golden


def test_kmer_prefilter_pipeline_matches_exhaustive():
    """K-mer prefilter keeps all true candidates on the fixture ->
    identical final predictions."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        out = f"{td}/preds"
        EasyPredict(Params(prefilter_mode="kmer")).run(
            DATA / "contigs.fna", DATA / "proteins.faa", out)
        mine = pathlib.Path(f"{out}.fas").read_bytes()
    golden = (GOLDEN / "easypredict.fas").read_bytes()
    assert mine == golden


def test_kmer_index_basics():
    from metaeuk_tpu.search.kmer_prefilter import KmerIndex, seq_kmers
    import numpy as np
    enc = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int64)
    codes, pos = seq_kmers(enc, 6)
    assert len(codes) == 3 and list(pos) == [0, 1, 2]
    # X-containing k-mers dropped
    enc[2] = 20
    codes2, pos2 = seq_kmers(enc, 6)
    assert len(codes2) == 0
    idx = KmerIndex([np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int64)])
    lo, hi = idx.lookup(codes)
    assert (hi - lo).tolist() == [1, 1, 1]
