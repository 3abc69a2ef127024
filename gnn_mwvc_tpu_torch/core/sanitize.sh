#!/bin/bash
# Sanitizer builds of the port's copy of the native core (core/src), and a
# run of the port's own core tests against them.
# Usage: bash gnn_mwvc_tpu_torch/core/sanitize.sh [asan|ubsan|tsan] [pytest args]
# With no pytest args it runs tests/test_torch_core_exact.py, which imports
# neither jax nor the JAX package; the repository's conftest (which imports
# jax) is not loaded.
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
MODE=${1:-asan}
shift || true
case "$MODE" in
  asan)  FLAGS="-fsanitize=address -fno-omit-frame-pointer"; RT=libasan.so ;;
  ubsan) FLAGS="-fsanitize=undefined -fno-sanitize-recover=undefined -fno-omit-frame-pointer"
         RT=libubsan.so ;;
  tsan)  FLAGS="-fsanitize=thread"; RT=libtsan.so ;;
  *) echo "unknown mode $MODE"; exit 1 ;;
esac

TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
OUT="$TMP/libmwvc_core_${MODE}.so"
g++ -std=c++17 -O1 -g -fPIC -shared $FLAGS -o "$OUT" "$HERE/src/capi.cpp"
echo "built $OUT"

# python itself is not instrumented, so the sanitizer's runtime is preloaded;
# -s lets its report through pytest's capture when it aborts the process
PRELOAD=$(g++ -print-file-name=$RT)
cd "$HERE/../.."
[ $# -gt 0 ] || set -- tests/test_torch_core_exact.py
LD_PRELOAD="$PRELOAD" MWVC_CORE_LIB="$OUT" \
  ASAN_OPTIONS=detect_leaks=0 UBSAN_OPTIONS=print_stacktrace=1 \
  python -m pytest --noconftest -p no:cacheprovider -q -s "$@"
