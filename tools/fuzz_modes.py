"""Randomized parity fuzzing for the non-predict pipelines.

Per trial, generates a random protein family set (seeded mutants around
a few ancestors, plus decoys) and random contigs, then byte-compares
this framework against the reference binary on:

  - easy-search (m8 incl. backtrace-derived columns)
  - easy-cluster (cluster TSV + rep/all FASTAs)
  - search --search-type 3 (nucleotide contigs vs contigs, full aln DB)

Usage: python tools/fuzz_modes.py <n_trials> [seed0]
(requires the reference binary at .refbuild/src/metaeuk)
"""

import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REF = pathlib.Path(__file__).resolve().parent.parent / ".refbuild/src/metaeuk"
AA = "ACDEFGHIKLMNPQRSTVWY"


def mutate(rng, s, rate):
    out = list(s)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = AA[rng.integers(0, 20)]
    return "".join(out)


def make_proteins(rng, path):
    prots = {}
    n_fam = int(rng.integers(2, 5))
    for f in range(n_fam):
        anc = "".join(rng.choice(list(AA), int(rng.integers(60, 300))))
        for m in range(int(rng.integers(1, 5))):
            rate = float(rng.uniform(0.02, 0.4))
            prots[f"F{f}_m{m}"] = mutate(rng, anc, rate)
    for d in range(int(rng.integers(1, 6))):
        prots[f"decoy{d}"] = "".join(
            rng.choice(list(AA), int(rng.integers(40, 200))))
    with open(path, "w") as f:
        for n, s in prots.items():
            f.write(f">{n}\n{s}\n")
    return prots


def make_contigs(rng, path):
    with open(path, "w") as f:
        for c in range(int(rng.integers(1, 4))):
            s = "".join(rng.choice(list("ACGT"),
                                   int(rng.integers(300, 3000))))
            f.write(f">c{c}\n{s}\n")


def ref(*args):
    subprocess.run([str(REF), *args, "-v", "0"], check=True,
                   capture_output=True)


def mine(*args):
    r = subprocess.run([sys.executable, "-m", "metaeuk_tpu.cli", *args],
                       capture_output=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr.decode()[-2000:])


def cmp_files(td, pairs):
    diffs = []
    for a, b in pairs:
        if pathlib.Path(f"{td}/{a}").read_bytes() != \
                pathlib.Path(f"{td}/{b}").read_bytes():
            diffs.append(a)
    return diffs


def trial_easy_search(rng, td):
    make_proteins(rng, f"{td}/q.faa")
    make_proteins(rng, f"{td}/t.faa")
    ref("easy-search", f"{td}/q.faa", f"{td}/t.faa", f"{td}/ref.m8",
        f"{td}/rtmp", "--threads", "1", "--shuffle", "0")
    mine("easy-search", f"{td}/q.faa", f"{td}/t.faa", f"{td}/my.m8",
         f"{td}/mtmp")
    return cmp_files(td, [("ref.m8", "my.m8")])


def trial_easy_cluster(rng, td):
    make_proteins(rng, f"{td}/s.faa")
    ref("easy-cluster", f"{td}/s.faa", f"{td}/ref", f"{td}/rtmp",
        "--threads", "1", "--shuffle", "0")
    mine("easy-cluster", f"{td}/s.faa", f"{td}/my", f"{td}/mtmp")
    return cmp_files(td, [(f"ref_{s}", f"my_{s}") for s in
                          ("cluster.tsv", "rep_seq.fasta", "all_seqs.fasta")])


def trial_nucl_search(rng, td):
    make_contigs(rng, f"{td}/a.fna")
    make_contigs(rng, f"{td}/b.fna")
    ref("createdb", f"{td}/a.fna", f"{td}/adb", "--shuffle", "0")
    ref("createdb", f"{td}/b.fna", f"{td}/bdb", "--shuffle", "0")
    ref("search", f"{td}/adb", f"{td}/bdb", f"{td}/refaln", f"{td}/rtmp",
        "--threads", "1", "--search-type", "3")
    mine("createdb", f"{td}/a.fna", f"{td}/madb")
    mine("createdb", f"{td}/b.fna", f"{td}/mbdb")
    mine("search", f"{td}/madb", f"{td}/mbdb", f"{td}/myaln",
         "--search-type", "3")
    # with unsplit inputs the reference's dbOrfStart/End columns (13-14)
    # are uninitialized stack bytes (offsetalignment updateOffset on
    # passthrough splitsequence headers) —
    # compare everything else
    def canon(path):
        out = []
        for key, payload in __import__("metaeuk_tpu.io.mmseqsdb",
                                       fromlist=["x"]).read_db(path):
            lines = [ln.split("\t")[:13] for ln in
                     payload.decode().split("\n") if ln]
            out.append((key, lines))
        return out
    return [] if canon(f"{td}/refaln") == canon(f"{td}/myaln") \
        else ["nucl-cols0-12"]


TRIALS = [("easy-search", trial_easy_search),
          ("easy-cluster", trial_easy_cluster),
          ("nucl-search", trial_nucl_search)]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 7000
    failures = 0
    for t in range(n):
        name, fn = TRIALS[t % len(TRIALS)]
        rng = np.random.default_rng(seed0 + t)
        with tempfile.TemporaryDirectory() as td:
            try:
                diffs = fn(rng, td)
            except Exception as e:  # keep fuzzing, count as failure
                diffs = [f"EXC {type(e).__name__}: {str(e)[:200]}"]
            status = "OK" if not diffs else f"DIFFERS: {diffs}"
            print(f"trial {seed0 + t} [{name}]: {status}", flush=True)
            if diffs:
                failures += 1
                keep = pathlib.Path(f"/tmp/fuzzfail_{name}_{seed0 + t}")
                keep.mkdir(exist_ok=True)
                for f in pathlib.Path(td).iterdir():
                    if f.is_file():
                        keep.joinpath(f.name).write_bytes(f.read_bytes())
    print(f"{n - failures}/{n} cases byte-identical")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
