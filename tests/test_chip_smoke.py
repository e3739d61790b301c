"""chip_smoke.py on the CPU: every phase at a tiny size (the router sends
everything to the XLA engines here), the host rescoring it relies on, and
the script's refusal to report anything without a GPU."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from anyseq_tpu import AffineScoring, Alignment, LinearScoring, align
from anyseq_tpu.bench import device
from anyseq_tpu.engine import route
from anyseq_tpu.kernels import sweep

import sweep_model

ROOT = pathlib.Path(chip_smoke.__file__).resolve().parent
LIN = LinearScoring(2, -1, -1)
AFF = AffineScoring(2, -1, -3, -1)


@pytest.mark.parametrize("name, kw", [
    ("phase_scores", dict(L=500, La=300, Lo=150)),
    ("phase_construction", dict(L=700, La=400)),
    ("phase_fulltb", dict(L=300)),
    ("phase_batches", dict(pairs=30, plen=64, construct=8, sample=6)),
    ("phase_cli", dict(lo=40, hi=160)),
    ("phase_kernel_vs_xla", dict(L=600, pairs=20, plen=48)),
    ("phase_four_cards", dict(L=900, pairs=9, plen=48)),
])
def test_phase_passes_at_tiny_size(name, kw):
    rec = getattr(chip_smoke, name)(**kw)
    assert rec["parity"] is True
    json.dumps(rec)  # each phase prints its record as one JSON line


@pytest.mark.parametrize("name, kw", [
    ("phase_scores", dict(L=300, La=200, Lo=100)),
    ("phase_construction", dict(L=600, La=300)),
    ("phase_batches", dict(pairs=12, plen=40, construct=4, sample=4)),
    ("phase_kernel_vs_xla", dict(L=300, pairs=8, plen=40)),
])
def test_phase_passes_on_the_kernel_routes(monkeypatch, name, kw):
    """The phases as they run on a GPU: the router sends the kernel paths
    to the sweep kernel, here its numpy model."""
    monkeypatch.setattr(route, "platform", lambda: "gpu")
    monkeypatch.setattr(sweep, "_ffi_sweep", sweep_model.ffi_sweep)
    rec = getattr(chip_smoke, name)(**kw)
    assert rec["parity"] is True


def test_run_phase_reports_a_failing_phase(capsys):
    def phase_broken():
        raise ValueError("boom")

    assert not chip_smoke.run_phase("z", phase_broken, "card")
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == "z" and rec["parity"] is False
    assert "boom" in rec["error"]


def test_rescore_linear_alignment():
    q, s = b"GATTACA", b"GATCACA"
    aln = align(q, s, "global", LIN, traceback="full")
    assert chip_smoke.rescore(aln, q, s, "global", LIN) == (True, aln.score)


def test_rescore_charges_one_open_per_affine_gap_run():
    q, s = b"ACGTTTACGT", b"ACGTACGT"
    aln = align(q, s, "global", AFF, traceback="full")
    valid, score = chip_smoke.rescore(aln, q, s, "global", AFF)
    assert valid and score == aln.score == 16 - 3 - 2


def test_rescore_rejects_an_alignment_of_other_sequences():
    aln = align(b"GATTACA", b"GATCACA", "global", LIN, traceback="full")
    valid, _ = chip_smoke.rescore(aln, b"GATTACC", b"GATCACA", "global",
                                  LIN)
    assert not valid


def test_rescore_rejects_a_partial_global_alignment():
    aln = Alignment(4, b" AC", b" AC", (0, 0))
    assert not chip_smoke.rescore(aln, b"ACG", b"AC", "global", LIN)[0]


def test_related_pair_is_seeded():
    a = device.related_pair(np.random.default_rng(3), 500)
    b = device.related_pair(np.random.default_rng(3), 500)
    assert a == b and len(a[0]) == len(a[1]) == 500
    diff = sum(x != y for x, y in zip(*a))
    assert 0 < diff < 60


def test_gpu_devices_refuses_the_cpu():
    with pytest.raises(device.NoGPU, match="no GPU"):
        device.gpu_devices()


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    res = _run(ROOT / script, ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"value"' not in res.stdout


def test_suite_exits_nonzero_without_gpu():
    env = {k: v for k, v in os.environ.items()}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "anyseq_tpu.bench.suite",
                          "--quick"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and "no GPU" in res.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
