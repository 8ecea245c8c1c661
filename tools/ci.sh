#!/bin/bash
# CI lane (the reference's azure-pipelines.yml:14-79 role): rebuild every
# native library from scratch, run an ASan+UBSan build of the native layer
# through the native-heavy tests, run the full pytest suite, and fuzz
# end-to-end parity against the reference binary when it is present.
#
#   tools/ci.sh [fuzz_trials]     (default 20; 0 skips the fuzz stage)
#   tools/ci.sh --big             additionally runs the gated heavyweight
#                                 lanes the default suite skips: the
#                                 bench-config 2-process jax.distributed
#                                 easy-predict (METAEUK_BIG_DIST=1, ~25 min
#                                 contended CPU wall) and the full Gumbel
#                                 fit validation (METAEUK_GUMBEL_FULL=1)
set -euo pipefail
cd "$(dirname "$0")/.."
BIG=0
if [ "${1:-}" = "--big" ]; then BIG=1; shift; fi
TRIALS=${1:-20}

echo "== [1/4] clean native rebuild =="
rm -f native/libmetaeuk_host.so native/libmetaeuk_fwbw.so
python - <<'PY'
from metaeuk_tpu import native
assert native.get_lib() is not None, "host library failed to build"
from metaeuk_tpu.search import fwbw
assert fwbw._get_lib() is not None, "fwbw library failed to build"
print("native libraries rebuilt")
PY

echo "== [2/4] sanitizer lane (ASan+UBSan) =="
SAN=$(mktemp -d)
g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=undefined \
    -shared -fPIC -std=c++17 -fopenmp \
    native/host_ops.cpp native/prefilter.cpp native/nucl_align.cpp \
    native/prefilter_nucl.cpp native/sw_host.cpp -o "$SAN/host_asan.so"
g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=undefined \
    -ffp-contract=off -shared -fPIC -std=c++17 \
    native/fwbw.cpp -o "$SAN/fwbw_asan.so"
ASAN_LIB=$(g++ -print-file-name=libasan.so)
# detect_leaks=0: CPython itself holds allocations at exit
LD_PRELOAD="$ASAN_LIB" ASAN_OPTIONS=detect_leaks=0 \
    UBSAN_OPTIONS=print_stacktrace=1 \
    METAEUK_HOST_SO="$SAN/host_asan.so" METAEUK_FWBW_SO="$SAN/fwbw_asan.so" \
    python -m pytest tests/test_native.py tests/test_prefilter_kmer.py \
        tests/test_orf.py tests/test_nucl_search.py tests/test_masker.py \
        -q -x
rm -rf "$SAN"

echo "== [3/4] full test suite =="
python -m pytest tests/ -q

echo "== [4/4] reference parity fuzz (N=$TRIALS) =="
if [ "$TRIALS" -gt 0 ] && [ -x .refbuild/src/metaeuk ]; then
    python tools/fuzz_parity.py "$TRIALS"
elif [ "$TRIALS" -gt 0 ]; then
    echo "SKIP: .refbuild/src/metaeuk not built (see tools/make_s2p_goldens.sh header)"
fi

if [ "$BIG" = "1" ]; then
    echo "== [5/5] gated heavyweight lanes (--big) =="
    METAEUK_GUMBEL_FULL=1 python -m pytest tests/test_gumbel.py -q -x
    METAEUK_BIG_DIST=1 python -m pytest tests/test_dist.py -q -x
fi

echo "CI: all lanes green"
