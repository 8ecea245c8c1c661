"""Runtime Gumbel-parameter fitting (search/gumbel.py) and arbitrary
matrix-file loading (data/submat_file.py).

The reference fits non-default (matrix, gap) E-value parameters at
runtime with ALP's Monte-Carlo simulation, whose realization counts are
sized from wall-clock measurements (sls_alp_sim.cpp:223,336,351) — its
output varies with machine speed, so byte parity is impossible by the
reference's own design.  The contract here is ALP's own tolerance band
(lambda 1%, K 5%) plus determinism, which the reference does not have.

Golden 12-parameter sets below were produced from the vendored ALP
library (seed 42, the reference's exact call) via tools/alpfit; each
was confirmed stable across repeated runs on this host.
"""

import numpy as np
import pytest

from metaeuk_tpu.data.submat import (ALPHABET, BLOSUM62_PBACK,
                                     BLOSUM62_SCORES)
from metaeuk_tpu.data.submat_file import parse_matrix_file, build_scores
from metaeuk_tpu.search.evalue import (EvalueComputation,
                                       _BLOSUM62_GAPPED_11_1)
from metaeuk_tpu.search.gumbel import fit_gapped, lambda_ungapped

import os

from metaeuk_tpu.data import submat as _submat
from metaeuk_tpu.data import vtml80 as _vtml80


def _matrix_file(halfbit, lam, back):
    """A .out matrix file (the reference's format) serialised from a
    baked half-bit table, its lambda and its background."""
    rows = halfbit.strip().split("\n")
    lines = ["# Background (precomputed optional): "
             + " ".join(f"{b:.5f}" for b in back),
             f"# Lambda     (precomputed optional): {lam}",
             "   " + "  ".join(ALPHABET)]
    lines += [f"{a} {r}" for a, r in zip(ALPHABET, rows)]
    return "\n".join(lines) + "\n"


MATRIX_FILES = {
    "blosum62.out": _matrix_file(_submat._BLOSUM62_HALFBIT,
                                 _submat._BLOSUM62_LAMBDA,
                                 _submat._BLOSUM62_BACK),
    "VTML80.out": _matrix_file(_vtml80._VTML80_HALFBIT,
                               _vtml80._VTML80_LAMBDA, _vtml80._VTML80_BACK),
}

# (matrix, gapOpen, gapExtend) -> (lambda, K) from the vendored ALP
# (tools/alpfit/alp_params_tool, seed 42)
ALP_GOLD = {
    ("VTML80.out", 10, 1): (0.2964532269042508, 0.095176195102098307),
    ("blosum80.out", 9, 1): (0.29324274403818607, 0.061475643948420207),
    ("blosum62.out", 8, 2): (0.26921621780494986, 0.051702500472119196),
    ("blosum45.out", 13, 2): (0.35575136286833492, 0.10259003508922594),
    # round-5 additions (same seed-42 alpfit methodology)
    ("PAM30.out", 9, 1): (0.30666302111776467, 0.13481275039924145),
    ("VTML40.out", 13, 2): (0.34108491436421284, 0.27414359983031422),
    ("blosum50.out", 10, 2): (0.32771470513030798, 0.079951009050250516),
}


def test_matrix_file_parser_reproduces_baked_in_blosum62():
    parsed = parse_matrix_file(MATRIX_FILES["blosum62.out"])
    scores, pback, pback2, _ = build_scores(parsed)
    assert np.array_equal(scores, BLOSUM62_SCORES)
    assert np.allclose(pback, BLOSUM62_PBACK)


def test_matrix_file_parser_integer_scores_match_reference():
    """VTML80 integer matrix spot values (validated bit-exact against
    the reference's SubstitutionMatrix via tools/alpfit/print_submat)."""
    scores, _, _, _ = build_scores(
        parse_matrix_file(MATRIX_FILES["VTML80.out"]))
    a, c, w = ALPHABET.index("A"), ALPHABET.index("C"), ALPHABET.index("W")
    assert scores[a, a] == 5
    assert scores[c, c] == 10
    assert scores[w, w] == 11
    assert scores[20, 20] == -1  # X column


def test_lambda_ungapped_matches_alp_gapless():
    """The exact Newton solve reproduces ALP initGapless lambda for
    blosum62 (tabulated in the reference, EvalueComputation.h:71) to
    float precision."""
    lam = lambda_ungapped(BLOSUM62_SCORES, BLOSUM62_PBACK)
    assert abs(lam / 0.3207378152604042354 - 1.0) < 1e-6


def test_fit_gapped_deterministic():
    """Same seed -> bit-identical parameters (the property the
    reference's ALP path lacks)."""
    p1 = fit_gapped(BLOSUM62_SCORES, BLOSUM62_PBACK, 8, 2,
                    n_pairs=512, length=128, chunk=256)
    p2 = fit_gapped(BLOSUM62_SCORES, BLOSUM62_PBACK, 8, 2,
                    n_pairs=512, length=128, chunk=256)
    assert p1 == p2


def test_for_scoring_default_fast_path():
    ev = EvalueComputation.for_scoring(1000000, BLOSUM62_SCORES,
                                       BLOSUM62_PBACK, 11, 1)
    assert ev.p is _BLOSUM62_GAPPED_11_1


def test_fit_gapped_smoke_tolerance():
    """Small-sample fit lands in the right neighbourhood (loose bound;
    the full ALP-tolerance validation below runs on the GPU)."""
    scores, pback, _, _ = build_scores(
        parse_matrix_file(MATRIX_FILES["blosum62.out"]))
    p = fit_gapped(scores, pback, 8, 2, n_pairs=2048, length=192,
                   chunk=512)
    lam_r, k_r = ALP_GOLD[("blosum62.out", 8, 2)]
    assert abs(p["lam"] / lam_r - 1.0) < 0.08
    assert 0.2 < p["K"] / k_r < 5.0


@pytest.mark.gpu
def test_fit_gapped_full_alp_tolerance():
    """All seven (matrix, gap) combos within lambda 1.2% / K 6% of the
    vendored ALP (its own tolerance band 1%/5% plus Monte-Carlo
    allowance on both sides).  Runs tools/gumbel_validate.py in a
    SUBPROCESS so the 262k-pair SW simulations escape the conftest CPU
    pinning and use the GPU (the in-process CPU form takes longer than
    a test run may)."""
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).parent.parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS",)}
    r = subprocess.run(
        [sys.executable, str(repo / "tools" / "gumbel_validate.py")],
        capture_output=True, timeout=3600, env=env)
    sys.stdout.write(r.stdout.decode())
    assert r.returncode == 0, r.stdout.decode() + r.stderr.decode()[-1000:]
