"""Quickest proof that easy-predict runs on an NVIDIA GPU, and runs right.

    python chip_smoke.py          # one card: phases a-e
    python chip_smoke.py --four   # four cards: phase f only

a. the card's name and power limit (nvidia-smi); JAX is on the GPU, with
   no CPU fallback; the native host library loaded.
b. the CUDA alignment kernel (forward ends, then starts from the reversed
   prefixes) against the numpy oracle ops/sw.py and against the XLA form
   ops/sw_jax.py, exact integer equality, on ragged batches in every
   length tier up to Lq 8192, plus a PSSM batch.
c. easy-predict on tests/data against tests/golden/easypredict.* bytes.
d. easy-predict on the 1.6 Mbp / 3000-protein slice against the digests
   in tests/golden/multichip_slice.json.
e. easy-predict on the 4 Mbp / 8000-protein synthetic metagenome: cold
   and steady walls, stage seconds, digests against
   tests/golden/bench_4mbp.json.
f. (--four) the 1.6 Mbp slice with the alignment shard_mapped over four
   cards (METAEUK_DEVICES=4) and over one, same digests, both walls.

Any failed phase raises: the script exits non-zero and prints no result.
Its last line is {"ok": true, "device": {...}} with the device as JAX
reports it. Everything runs in this one process, which holds the card.
"""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
DATA = REPO / "tests" / "data"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")


def log(msg):
    print(msg, flush=True)


def phase_a():
    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("no NVIDIA GPU here: nvidia-smi is not on PATH")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    log(f"[a] card: {smi.stdout.strip()}")
    import jax
    from metaeuk_tpu import native
    from metaeuk_tpu.platform import platform
    if platform() != "gpu":
        raise RuntimeError("JAX runs on the CPU (JAX_PLATFORMS=cpu), "
                           "not on the GPU")
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not load")
    dev = jax.devices()[0]
    log(f"[a] jax {jax.__version__} on {dev.platform} / {dev.device_kind} "
        f"x{len(jax.devices())}; native host library loaded")
    return dev


def _ragged_batch(rng, B, Lq, Lt):
    """Ragged sequence pairs with planted shared segments."""
    q_len = rng.integers(max(1, Lq // 2), Lq + 1, B).astype(np.int32)
    t_len = rng.integers(max(1, Lt // 4), Lt + 1, B).astype(np.int32)
    q_mat = rng.integers(0, 20, (B, Lq)).astype(np.int32)
    t_mat = rng.integers(0, 21, (B, Lt)).astype(np.int32)
    bias = rng.integers(-2, 3, (B, Lq)).astype(np.int32)
    for i in range(0, B, 2):
        n = int(min(q_len[i], t_len[i]) // 2)
        s = int(rng.integers(0, q_len[i] - n + 1))
        t_mat[i, :n] = q_mat[i, s:s + n]
    return q_mat, bias, q_len, t_mat, t_len


def _prof_full(prof, q_len, t_mat, t_len, Lq, Lt):
    """Full alignment of pair i = (profile i, target i) on the kernel."""
    import jax.numpy as jnp
    from metaeuk_tpu.search.profile_search import \
        _gathered_align_prof_kernel
    idx = jnp.arange(len(q_len), dtype=jnp.int32)
    out = _gathered_align_prof_kernel(
        prof, jnp.asarray(q_len), jnp.asarray(t_mat, jnp.uint8),
        jnp.asarray(t_len), idx, idx, Lq, Lt)
    return [np.asarray(o) for o in out]


def _oracle_prof(p, t):
    from metaeuk_tpu.ops.sw import sw_end
    score, qe, te = sw_end(p, t)
    if te < 0 or score == 0:
        return (int(score),)
    _, qr, tr = sw_end(p[qe::-1], t[te::-1])
    return (int(score), int(qe - qr), int(qe), int(te - tr), int(te))


# (Lq, Lt, pairs): every query tier up to 8192 rows
TIERS = [(64, 64, 4096), (128, 256, 4096), (256, 512, 2048),
         (1024, 1024, 256), (4096, 512, 128), (8192, 256, 64)]
N_ORACLE = 12


def phase_b(tiers=TIERS, n_oracle=N_ORACLE):
    import jax.numpy as jnp
    from metaeuk_tpu.data.submat import BLOSUM62_SCORES
    from metaeuk_tpu.ops import sw_cuda
    from metaeuk_tpu.ops.sw_jax import sw_align_batch, sw_align_batch_prof
    rng = np.random.default_rng(2026)
    checks = 0
    for Lq, Lt, B in tiers:
        q_mat, bias, q_len, t_mat, t_len = _ragged_batch(rng, B, Lq, Lt)
        prof = sw_cuda.seq_profile(jnp.asarray(q_mat), jnp.asarray(bias))
        got = _prof_full(prof, q_len, t_mat, t_len, Lq, Lt)
        ref = sw_align_batch(q_mat, bias, q_len, t_mat, t_len)
        for name, g, r in zip(("score", "q_start", "q_end", "t_start",
                               "t_end"), got, ref):
            aligned = got[0] > 0
            bad = np.flatnonzero((g != r) & (aligned | (name == "score")))
            if len(bad):
                raise AssertionError(f"kernel != XLA at Lq {Lq} Lt {Lt}: "
                                     f"{name} of pair {int(bad[0])}")
        for i in rng.choice(B, n_oracle, replace=False):
            p = (BLOSUM62_SCORES[q_mat[i, :q_len[i]]]
                 + bias[i, :q_len[i], None]).astype(np.int64)
            want = _oracle_prof(p, t_mat[i, :t_len[i]])
            have = tuple(int(g[i]) for g in got)[:len(want)]
            if have != want:
                raise AssertionError(f"kernel != oracle at Lq {Lq} Lt {Lt} "
                                     f"pair {i}: {have} vs {want}")
        checks += B + n_oracle
        log(f"[b] Lq {Lq:5d} Lt {Lt:5d}: {B} pairs equal to XLA, "
            f"{n_oracle} equal to the oracle "
            f"(max score {int(got[0].max())})")
    # PSSM batch
    Lq, Lt, B = 256, 512, 1024
    pssm = rng.integers(-10, 12, (B, Lq, 21)).astype(np.int32)
    q_len = rng.integers(16, Lq + 1, B).astype(np.int32)
    t_mat = rng.integers(0, 21, (B, Lt)).astype(np.int32)
    t_len = rng.integers(16, Lt + 1, B).astype(np.int32)
    got = _prof_full(sw_cuda.pssm_profile(jnp.asarray(pssm)), q_len, t_mat,
                     t_len, Lq, Lt)
    ref = sw_align_batch_prof(pssm, q_len, t_mat, t_len)
    for g, r in zip(got, ref):
        if not np.array_equal(g, r):
            raise AssertionError("PSSM kernel != XLA")
    for i in rng.choice(B, n_oracle, replace=False):
        want = _oracle_prof(pssm[i, :q_len[i]].astype(np.int64),
                            t_mat[i, :t_len[i]])
        if tuple(int(g[i]) for g in got)[:len(want)] != want:
            raise AssertionError(f"PSSM kernel != oracle at pair {i}")
    checks += B + n_oracle
    log(f"[b] PSSM Lq {Lq} Lt {Lt}: {B} pairs equal to XLA, {n_oracle} "
        f"equal to the oracle; {checks} checks, 0 mismatches")


def _easy_predict(contigs, proteins, out):
    """One easy-predict run; returns (wall seconds, stage seconds)."""
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    ep = EasyPredict(Params())
    t0 = time.perf_counter()
    ep.run(str(contigs), str(proteins), str(out))
    wall = time.perf_counter() - t0
    stages = dict(getattr(ep, "predict_stage_seconds", {}))
    stages.update(getattr(ep, "stage_seconds", {}))
    return wall, stages


def _digests(out):
    return {s: hashlib.sha256(pathlib.Path(f"{out}.{s}").read_bytes())
            .hexdigest() for s in SUFFIXES}


def _check_digests(out, golden, what):
    got = _digests(out)
    for s in SUFFIXES:
        if got[s] != golden[s]:
            raise AssertionError(f"{what}: {s} digest differs")


def phase_c(tmp):
    out = tmp / "fixture"
    wall, _ = _easy_predict(DATA / "contigs.fna", DATA / "proteins.faa",
                            out)
    for s in SUFFIXES:
        if pathlib.Path(f"{out}.{s}").read_bytes() \
                != (GOLDEN / f"easypredict.{s}").read_bytes():
            raise AssertionError(f"fixture easy-predict: {s} differs")
    log(f"[c] fixture easy-predict byte-identical to the goldens "
        f"({wall:.2f} s)")


def _metagenome(tmp, mbp, targets, tag):
    sys.path.insert(0, str(REPO))
    from tools.make_metagenome import make_metagenome, write_fasta
    contigs, proteins = make_metagenome(mbp, targets)
    c, p = tmp / f"{tag}.fna", tmp / f"{tag}.faa"
    write_fasta(c, contigs)
    write_fasta(p, proteins)
    return c, p, len(contigs)


def phase_d(tmp):
    golden = json.loads((GOLDEN / "multichip_slice.json").read_text())
    c, p, n = _metagenome(tmp, golden["mbp"], golden["targets"], "slice")
    wall, _ = _easy_predict(c, p, tmp / "slice")
    _check_digests(tmp / "slice", golden["sha256"], "1.6 Mbp slice")
    log(f"[d] {golden['mbp']} Mbp slice ({n} contigs): digests match "
        f"({wall:.2f} s)")


def phase_e(tmp, n_steady=2):
    golden = json.loads((GOLDEN / "bench_4mbp.json").read_text())
    c, p, n = _metagenome(tmp, golden["mbp"], golden["targets"], "bench")
    cold, _ = _easy_predict(c, p, tmp / "bench_cold")
    _check_digests(tmp / "bench_cold", golden["sha256"], "4 Mbp (cold)")
    walls, stages = [], {}
    for i in range(n_steady):
        w, stages = _easy_predict(c, p, tmp / f"bench{i}")
        _check_digests(tmp / f"bench{i}", golden["sha256"], "4 Mbp")
        walls.append(w)
    log(f"[e] {golden['mbp']} Mbp / {golden['targets']} targets "
        f"({n} contigs): digests match; cold wall {cold:.3f} s, steady "
        f"walls {[round(w, 3) for w in walls]} s")
    log("[e] stage seconds: " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))


def phase_f(tmp):
    import jax
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    golden = json.loads((GOLDEN / "multichip_slice.json").read_text())
    c, p, n = _metagenome(tmp, golden["mbp"], golden["targets"], "slice")
    walls = {}
    for n_dev in (1, 4, 4, 1):
        os.environ["METAEUK_DEVICES"] = str(n_dev)
        out = tmp / f"slice{n_dev}"
        w, _ = _easy_predict(c, p, out)
        _check_digests(out, golden["sha256"], f"slice on {n_dev} cards")
        walls.setdefault(n_dev, []).append(round(w, 3))
    os.environ.pop("METAEUK_DEVICES")
    log(f"[f] {golden['mbp']} Mbp slice: digests match on 1 and 4 cards; "
        f"walls (first run includes compilation) 1 card {walls[1]} s, "
        f"4 cards {walls[4]} s")


def main(argv):
    four = "--four" in argv
    dev = phase_a()
    with tempfile.TemporaryDirectory(prefix="chip_smoke") as td:
        tmp = pathlib.Path(td)
        if four:
            phase_f(tmp)
        else:
            phase_b()
            phase_c(tmp)
            phase_d(tmp)
            phase_e(tmp)
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
