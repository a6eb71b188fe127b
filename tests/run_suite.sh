#!/bin/bash
# Robust full-suite invocation: one pytest process per test file.
#
# A monolithic `pytest tests/` has intermittently crashed (SIGSEGV/
# SIGABRT inside XLA:CPU backend_compile) late in the run — an
# accumulation-dependent compiler crash that never reproduces in
# isolation. Per-file processes sidestep it and parallelize trivially;
# the persistent compile cache keeps total time comparable.
#
#   bash tests/run_suite.sh [extra pytest args]
set -u
cd "$(dirname "$0")/.."
fail=0
for f in tests/test_*.py; do
  echo "=== $f"
  JAX_PLATFORMS=cpu timeout 1200 \
    python -m pytest "$f" -q "$@" || fail=1
done
exit $fail
