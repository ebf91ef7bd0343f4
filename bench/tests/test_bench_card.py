"""Each cell once on the card through ``bench/run.py``, a short window
(marked ``cuda``: skips without a GPU)."""
import json
import subprocess
import sys

import pytest

from bench.tests.tiny import ROOT, workloads


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", workloads())
def test_cell_on_the_card(card, name):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                          "--seed", str(2 ** 31 + 5), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                          "--workload", workloads()[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
