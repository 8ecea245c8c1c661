import os

import numpy as np
import pytest

import jax

from metaeuk_tpu.ops.sw import sw_align
from metaeuk_tpu.parallel.dist import make_mesh, sharded_search_step

rng = np.random.default_rng(3)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_search_matches_oracle():
    mesh = make_mesh(frags=2, targets=4)
    Bq, Nt, Lq, Lt = 4, 8, 32, 32
    q_enc = rng.integers(0, 20, (Bq, Lq)).astype(np.int32)
    q_bias = np.zeros((Bq, Lq), np.int32)
    q_len = np.full(Bq, Lq, np.int32)
    t_enc = rng.integers(0, 20, (Nt, Lt)).astype(np.int32)
    t_len = np.full(Nt, Lt, np.int32)
    step = sharded_search_step(mesh, Lq, Lt)
    score, q_end, t_end = step(q_enc, q_bias, q_len, t_enc, t_len)
    score = np.asarray(score)
    for i in range(Bq):
        for j in range(Nt):
            ref = sw_align(q_enc[i], t_enc[j])
            assert score[i, j] == ref["score"], (i, j)


def test_contig_partition_merge_byte_identical(tmp_path):
    """Multi-host data parallelism: 2-partition run + merge equals the
    single-run easy-predict goldens byte-for-byte."""
    import pathlib
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    from metaeuk_tpu.parallel.multihost import contig_partition, \
        merge_predictions
    data = pathlib.Path(__file__).parent / "data"
    golden = pathlib.Path(__file__).parent / "golden"
    for i in range(2):
        rng = contig_partition(2, i, 2)
        EasyPredict(Params()).run(data / "contigs.fna", data / "proteins.faa",
                                  str(tmp_path / f"part{i}"),
                                  contig_range=rng)
    merge_predictions(str(tmp_path / "merged"),
                      [str(tmp_path / f"part{i}") for i in range(2)])
    for s in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        assert (tmp_path / f"merged.{s}").read_bytes() \
            == (golden / f"easypredict.{s}").read_bytes(), s


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mesh_easy_predict_matches_goldens(tmp_path, monkeypatch):
    """Full easy-predict with the alignment stage shard_mapped over the
    8-device mesh (search/driver.py `_dispatcher`) is byte-identical to
    the single-device goldens. The suite exercises the mesh implicitly
    (conftest gives every test 8 CPU devices); this pins it explicitly
    and guards against a future single-device default."""
    import pathlib
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    from metaeuk_tpu.search import driver

    monkeypatch.setenv("METAEUK_DEVICES", "8")
    assert driver.n_devices() == 8
    data = pathlib.Path(__file__).parent / "data"
    golden = pathlib.Path(__file__).parent / "golden"
    out = tmp_path / "preds"
    EasyPredict(Params()).run(data / "contigs.fna", data / "proteins.faa",
                              str(out))
    for s in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        assert (tmp_path / f"preds.{s}").read_bytes() \
            == (golden / f"easypredict.{s}").read_bytes(), s


def test_two_process_distributed_easy_predict(tmp_path):
    """REAL multi-process data parallelism: two jax.distributed worker
    processes (CPU backend, gloo collectives) each run their contig
    partition; rank 0 merges after the cross-process barrier. Merged
    outputs == the single-run goldens byte-for-byte."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    repo = pathlib.Path(__file__).parent.parent
    data = pathlib.Path(__file__).parent / "data"
    golden = pathlib.Path(__file__).parent / "golden"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "preds")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(repo / "tools" / "dist_worker.py"), str(i),
         "2", f"127.0.0.1:{port}", str(data / "contigs.fna"),
         str(data / "proteins.faa"), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg.decode(errors="replace")[-2000:]
    for s_ in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        assert pathlib.Path(f"{out}.{s_}").read_bytes() \
            == (golden / f"easypredict.{s_}").read_bytes(), s_


@pytest.mark.skipif(os.environ.get("METAEUK_BIG_DIST") != "1",
                    reason="bench-scale 2-process run takes minutes; "
                           "set METAEUK_BIG_DIST=1")
def test_two_process_distributed_bench_config(tmp_path):
    """The 4 Mbp / 8k-target bench config across two jax.distributed
    processes with the target-split prefilter (--split 2) doing real
    split work fanned over the ranks (runMpiSplits contract,
    Prefiltering.cpp:575-660). Rank-0-merged outputs must equal the
    committed single-process --split 2 digests byte-for-byte."""
    import hashlib
    import json
    import pathlib
    import socket
    import subprocess
    import sys

    repo = pathlib.Path(__file__).parent.parent
    golden = json.loads((pathlib.Path(__file__).parent / "golden" /
                         "dist_bench_slice.json").read_text())
    sys.path.insert(0, str(repo))
    from tools.make_metagenome import make_metagenome, write_fasta
    contigs, proteins = make_metagenome(golden["mbp"], golden["targets"])
    write_fasta(tmp_path / "c.fna", contigs)
    write_fasta(tmp_path / "p.faa", proteins)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "preds")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    import time
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(repo / "tools" / "dist_worker.py"), str(i),
         "2", f"127.0.0.1:{port}", str(tmp_path / "c.fna"),
         str(tmp_path / "p.faa"), out, str(golden["split"])],
        env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = [p.communicate(timeout=3000)[0] for p in procs]
    wall_2proc = time.perf_counter() - t0
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg.decode(errors="replace")[-2000:]
    for s_ in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        digest = hashlib.sha256(
            pathlib.Path(f"{out}.{s_}").read_bytes()).hexdigest()
        assert digest == golden["sha256"][s_], s_
    # measured scaling-efficiency datapoint: each process
    # is pinned to ONE OpenMP thread so a process emulates a host with
    # fixed resources on this 2-core machine — wall_1proc(full work,
    # 1 thread) vs wall_2proc(half the target splits each, 1 thread
    # each); efficiency = wall_1 / (2 * wall_2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port1 = s.getsockname()[1]
    out1 = str(tmp_path / "preds1")
    t0 = time.perf_counter()
    p1 = subprocess.Popen(
        [sys.executable, str(repo / "tools" / "dist_worker.py"), "0",
         "1", f"127.0.0.1:{port1}", str(tmp_path / "c.fna"),
         str(tmp_path / "p.faa"), out1, str(golden["split"])],
        env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lg1 = p1.communicate(timeout=3000)[0]
    wall_1proc = time.perf_counter() - t0
    assert p1.returncode == 0, lg1.decode(errors="replace")[-2000:]
    eff = wall_1proc / (2 * wall_2proc)
    print(f"\n[dist-efficiency] wall_1proc={wall_1proc:.1f}s "
          f"wall_2proc={wall_2proc:.1f}s efficiency={eff:.3f}")


def test_dist_prefilter_single_process_equals_sequential(tmp_path):
    """DistributedSplitKmerPrefilter with process_count == 1 runs all
    splits through the same phased code path and must reproduce the
    sequential SplitKmerPrefilter lists exactly."""
    from metaeuk_tpu.parallel.dist_prefilter import \
        DistributedSplitKmerPrefilter
    from metaeuk_tpu.search.prefilter_kmer import SplitKmerPrefilter

    r = np.random.default_rng(11)
    targets = [r.integers(0, 20, int(r.integers(40, 120))).astype(np.uint8)
               for _ in range(40)]
    queries = [t.copy() for t in targets[:12]]
    ident = np.arange(12, dtype=np.int64)
    seq = SplitKmerPrefilter(targets, n_splits=3)
    base = seq.match_batch(queries, identity_ids=ident)
    dist = DistributedSplitKmerPrefilter(targets, str(tmp_path / "dp"), 3)
    got = dist.match_batch(queries, identity_ids=ident)
    assert len(base) == len(got)
    for qi, ((bi, bs, bd), (gi, gs, gd)) in enumerate(zip(base, got)):
        np.testing.assert_array_equal(bi, gi, err_msg=f"q{qi} ids")
        np.testing.assert_array_equal(bs, gs, err_msg=f"q{qi} scores")
        np.testing.assert_array_equal(bd, gd, err_msg=f"q{qi} diags")
    np.testing.assert_array_equal(seq.stats, dist.stats)


def test_two_process_distributed_prefilter_splits(tmp_path):
    """Splits fanned over processes (runMpiSplits role): a 2-process
    easy-predict with --split 2 must byte-match the single-process
    split-2 run, with each process building only its own split."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    repo = pathlib.Path(__file__).parent.parent
    data = pathlib.Path(__file__).parent / "data"
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict

    base = str(tmp_path / "base")
    EasyPredict(Params(split=2)).run(data / "contigs.fna",
                                     data / "proteins.faa", base)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "preds")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(repo / "tools" / "dist_worker.py"), str(i),
         "2", f"127.0.0.1:{port}", str(data / "contigs.fna"),
         str(data / "proteins.faa"), out, "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = [p.communicate(timeout=600)[0].decode(errors="replace")
            for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-2000:]
    # each process built exactly its round-robin split
    assert "split 1/2 on process 0" in logs[0]
    assert "split 2/2 on process 1" in logs[1]
    assert "split 2/2 on process 0" not in logs[0]
    # the shared scratch holds per-(split, query-block) hit files
    dist_dir = pathlib.Path(f"{out}.dist_pref")
    for si in range(2):
        for qp in range(2):
            assert (dist_dir / f"hits_{si}_{qp}.npz").exists()
    for s_ in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        assert pathlib.Path(f"{out}.{s_}").read_bytes() \
            == pathlib.Path(f"{base}.{s_}").read_bytes(), s_


def test_contig_partition_bounds():
    from metaeuk_tpu.parallel.multihost import contig_partition
    parts = [contig_partition(10, i, 3) for i in range(3)]
    assert parts == [(0, 4), (4, 7), (7, 10)]
    assert contig_partition(2, 1, 4) == (1, 2)
    assert contig_partition(2, 3, 4) == (2, 2)  # empty partition ok


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_topk_matches_dense():
    """The bandwidth-efficient per-shard top-k reduction returns exactly
    the dense cross product's top-k rows (scores and endpoints)."""
    from metaeuk_tpu.parallel.dist import sharded_search_topk_step
    mesh = make_mesh(frags=2, targets=4)
    Bq, Nt, Lq, Lt, K = 4, 16, 32, 32, 5
    q_enc = rng.integers(0, 20, (Bq, Lq)).astype(np.int32)
    q_bias = np.zeros((Bq, Lq), np.int32)
    q_len = np.full(Bq, Lq, np.int32)
    t_enc = rng.integers(0, 20, (Nt, Lt)).astype(np.int32)
    t_len = np.full(Nt, Lt, np.int32)
    dense = sharded_search_step(mesh, Lq, Lt)
    sc_d, qe_d, te_d = (np.asarray(a)
                        for a in dense(q_enc, q_bias, q_len, t_enc, t_len))
    topk = sharded_search_topk_step(mesh, Lq, Lt, K)
    sc, qe, te, gid = (np.asarray(a)
                       for a in topk(q_enc, q_bias, q_len, t_enc, t_len))
    assert sc.shape == (Bq, K) and gid.shape == (Bq, K)
    for i in range(Bq):
        want = np.sort(sc_d[i])[::-1][:K]
        np.testing.assert_array_equal(sc[i], want)
        for r in range(K):
            j = gid[i, r]
            assert sc[i, r] == sc_d[i, j]
            assert qe[i, r] == qe_d[i, j]
            assert te[i, r] == te_d[i, j]
