"""Host k-mer prefilter vs device gapless prefilter crossover benchmark.

The reference ships two prefilter engines: the CPU k-mer/double-diagonal
engine (prefiltering/Prefiltering.cpp) and the GPU gapless engine
(ungappedprefilter.cpp:358-470 / libmarv GAPLESS). This framework has
both (native/prefilter.cpp and ops/ungapped.py); this tool measures the
throughput of each against target-DB size so the default routing is a
measured decision, not a guess.

    python tools/prefilter_crossover.py [n_queries] [sizes...]

Prints one JSON line per DB size: build+match seconds for the k-mer
engine, kernel seconds for the device gapless engine, and the implied
queries/s of each (steady state: k-mer index build is amortized across
the whole run, so match-only rate is also reported).
"""

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def make_db(rng, n, lo=80, hi=400):
    return [rng.integers(0, 20, int(rng.integers(lo, hi))).astype(np.uint8)
            for _ in range(n)]


def main():
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.search.prefilter import UngappedPrefilter
    from metaeuk_tpu.search.prefilter_kmer import KmerPrefilter

    n_queries = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    sizes = [int(s) for s in sys.argv[2:]] or [10_000, 50_000, 100_000,
                                               200_000]
    rng = np.random.default_rng(11)
    queries = make_db(rng, n_queries, 120, 300)
    qbytes = [bytes(q + 65) for q in queries]  # dummy letters for encode

    class _TDB:
        def __init__(self, seqs):
            self.seqs = seqs

        def __len__(self):
            return len(self.seqs)

        def seq_bytes(self, i):
            return bytes(self.seqs[i] + 65)

        def total_residues(self):
            return sum(len(s) for s in self.seqs)

    for n in sizes:
        targets = make_db(rng, n)
        t0 = time.perf_counter()
        pf = KmerPrefilter(targets)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = pf.match_batch(queries)
        t_match = time.perf_counter() - t0
        kmer_cands = int(sum(len(r[0]) for r in res))
        del pf

        p = Params()
        up = UngappedPrefilter(p, _TDB(targets))
        t0 = time.perf_counter()
        pairs = up.candidate_pairs(qbytes)
        t_gapless_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs = up.candidate_pairs(qbytes)
        t_gapless = time.perf_counter() - t0

        print(json.dumps({
            "targets": n, "queries": n_queries,
            "kmer_build_s": round(t_build, 3),
            "kmer_match_s": round(t_match, 3),
            "kmer_match_qps": round(n_queries / t_match, 1),
            "kmer_candidates": kmer_cands,
            "gapless_cold_s": round(t_gapless_cold, 3),
            "gapless_warm_s": round(t_gapless, 3),
            "gapless_warm_qps": round(n_queries / t_gapless, 1),
            "gapless_candidates": int(len(pairs)),
        }), flush=True)


if __name__ == "__main__":
    main()
