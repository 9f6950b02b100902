"""Real multi-process training of the port:
scripts/torch_dryrun_multiprocess.py end to end (two gloo ranks of
``data=2`` running ``fit_gpt`` and ``fit_vae``, one process beside them,
a fresh process restoring the two-rank checkpoint), held to
tests/test_multiprocess.py's tolerances."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_fit_matches_single_process():
    script = os.path.join(REPO, "scripts", "torch_dryrun_multiprocess.py")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["val_multiprocess"] == pytest.approx(
        last["val_singleprocess"], abs=1e-4)
    assert last["val_restored"] == pytest.approx(
        last["val_multiprocess"], abs=1e-6)
    assert last["mi_multiprocess"] == pytest.approx(
        last["mi_singleprocess"], abs=1e-6)
    assert last["au_multiprocess"] == last["au_singleprocess"]
    assert last["vae_val_multiprocess"] > 0
