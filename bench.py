"""Benchmark: easy-predict end-to-end contigs/s on one GPU.

The primary metric is contigs/s for easy-predict on a mid-scale
synthetic metagenome (deterministic, generated at run time by
tools/make_metagenome.py; default 4 Mbp of contigs vs an 8k-protein
target DB). `vs_baseline` divides by the reference binary's contigs/s on
the same host and inputs (.refbuild/src/metaeuk) when that binary is
present, and is null otherwise.

Secondary numbers (same JSON line, under "extra"): per-stage seconds,
the aligned residue-cell counts and the wall times. The alignment
kernel's own check against the numpy oracle is phase b of chip_smoke.py.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BENCH_MBP = float(os.environ.get("METAEUK_BENCH_MBP", "4"))
BENCH_TARGETS = int(os.environ.get("METAEUK_BENCH_TARGETS", "8000"))


def make_inputs(tmp):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.make_metagenome import make_metagenome, write_fasta
    contigs, proteins = make_metagenome(BENCH_MBP, BENCH_TARGETS)
    cpath = os.path.join(tmp, "contigs.fna")
    ppath = os.path.join(tmp, "proteins.faa")
    write_fasta(cpath, contigs)
    write_fasta(ppath, proteins)
    return cpath, ppath, len(contigs)


N_STEADY = int(os.environ.get("METAEUK_BENCH_RUNS", "3"))


def run_ours(cpath, ppath, tmp, n_steady=N_STEADY):
    """(walls, cold_wall, stage_seconds, cells): one cold easy-predict
    then n_steady timed runs, all in one process. The cold run carries
    per-process one-time costs (compilation or compile-cache loads, the
    kernel build). Production deployments are long-lived processes, so
    the steady-state median is the primary number; the cold wall is
    reported alongside.
    cells = per-run {fwd, rev} aligned residue-cell counts (true
    lengths) from the last steady run."""
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    from metaeuk_tpu.search import driver as drv

    t0 = time.perf_counter()
    EasyPredict(Params()).run(cpath, ppath, os.path.join(tmp, "ours_cold"))
    cold = time.perf_counter() - t0
    walls = []
    cells = None
    stages = {}
    for i in range(n_steady):
        ep = EasyPredict(Params())
        drv.CELLS["fwd"] = drv.CELLS["rev"] = 0
        t0 = time.perf_counter()
        ep.run(cpath, ppath, os.path.join(tmp, "ours"))
        walls.append(time.perf_counter() - t0)
        cells = dict(drv.CELLS)
        stages = dict(getattr(ep, "predict_stage_seconds", {}))
        stages.update(getattr(ep, "stage_seconds", {}))
    return walls, cold, {k: round(v, 3) for k, v in stages.items()}, cells


def run_reference(cpath, ppath, tmp, n_steady=N_STEADY):
    """(walls, cold) reference walls: one cold run then n_steady timed
    runs (fresh tmp dirs each; the binary re-execs per run — page-cache
    warmth is the only steady-state it has), symmetric with run_ours."""
    ref = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".refbuild", "src", "metaeuk")
    if not os.path.exists(ref):
        return None, None
    walls = []
    for i in range(n_steady + 1):
        t0 = time.perf_counter()
        r = subprocess.run(
            [ref, "easy-predict", cpath, ppath,
             os.path.join(tmp, f"ref{i}"),
             os.path.join(tmp, f"reftmp{i}"), "-v", "0"],
            capture_output=True)
        if r.returncode != 0:
            return None, None
        walls.append(time.perf_counter() - t0)
    return walls[1:], walls[0]


def run_parity(cpath, ppath, tmp):
    """Byte-compare the bench's own outputs against the reference binary
    on the same inputs with the deterministic methodology the committed
    goldens use (createdb --shuffle 0 so key order matches input order,
    --threads 1 so per-thread writer merge order is fixed; both only
    permute per-record output blocks — record sets are identical either
    way). Returns True/False/None(binary missing)."""
    ref = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".refbuild", "src", "metaeuk")
    if not os.path.exists(ref):
        return None
    cdb = os.path.join(tmp, "parityContigsDB")
    tdb = os.path.join(tmp, "parityTargetsDB")
    for src, db in ((cpath, cdb), (ppath, tdb)):
        r = subprocess.run([ref, "createdb", src, db, "--shuffle", "0",
                            "-v", "0"], capture_output=True)
        if r.returncode != 0:
            return False
    refout = os.path.join(tmp, "parity_ref")
    r = subprocess.run(
        [ref, "easy-predict", cdb, tdb, refout,
         os.path.join(tmp, "parity_reftmp"), "-v", "0", "--threads", "1"],
        capture_output=True)
    if r.returncode != 0:
        return False
    ours = os.path.join(tmp, "ours")
    for suffix in ("fas", "codon.fas", "headersMap.tsv", "gff"):
        with open(f"{ours}.{suffix}", "rb") as a, \
                open(f"{refout}.{suffix}", "rb") as b:
            if a.read() != b.read():
                print(f"PARITY MISMATCH: {suffix}", file=sys.stderr)
                return False
    return True


def main():
    tmp = tempfile.mkdtemp(prefix="meukbench")
    cpath, ppath, n_contigs = make_inputs(tmp)
    walls, cold_wall, stages, cells = run_ours(cpath, ppath, tmp)
    wall = float(np.median(walls))
    contigs_per_s = n_contigs / wall

    ref_walls, ref_cold_wall = (None, None) if "--no-ref" in sys.argv \
        else run_reference(cpath, ppath, tmp)
    ref_wall = float(np.median(ref_walls)) if ref_walls else None
    vs = contigs_per_s / (n_contigs / ref_wall) if ref_wall else None

    # the bench verifies the outputs it times: rerun the reference with
    # the goldens' deterministic methodology and byte-compare
    parity_ok = None if "--no-ref" in sys.argv \
        else run_parity(cpath, ppath, tmp)

    import jax
    dev = jax.devices()[0]
    total_cells = sum(cells.values()) if cells else 0
    print(json.dumps({
        "metric": "easy_predict_contigs_per_s",
        "value": contigs_per_s,
        "unit": "contigs/s",
        "vs_baseline": vs,
        "extra": {
            "config": {"mbp": BENCH_MBP, "targets": BENCH_TARGETS,
                       "contigs": n_contigs},
            "ours_wall_s": round(wall, 2),
            "ours_walls_s": [round(w, 2) for w in walls],
            "ours_cold_wall_s": round(cold_wall, 2),
            "ref_wall_s": round(ref_wall, 2) if ref_wall else None,
            "ref_walls_s": [round(w, 2) for w in ref_walls]
            if ref_walls else None,
            "ref_cold_wall_s": round(ref_cold_wall, 2)
            if ref_cold_wall else None,
            "parity_ok": parity_ok,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "stage_seconds": stages,
            "aligned_cells": cells,
            # end-to-end aligned residue-cells/s over the whole easy-
            # predict wall: workload-limited at this scale, since the
            # prefilter keeps candidate pairs sparse by design
            "aligned_cells_per_s_e2e": total_cells / wall if wall else None,
        },
    }))


if __name__ == "__main__":
    main()
