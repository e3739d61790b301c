"""The engine router (engine/route.py): which engine each public path
takes per platform and size, the public engine strings, and that no path
falls back to an interpreted kernel."""
import pathlib
import re

import numpy as np
import pytest

import anyseq_tpu
from conftest import mutate, random_dna
from anyseq_tpu.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu.dist.mesh import make_mesh
from anyseq_tpu.dist.sharded import score_pair_sharded
from anyseq_tpu.engine import route
from anyseq_tpu.kernels import sweep
from anyseq_tpu.ref import oracle, oracle_affine

import sweep_model

LIN = LinearScoring(2, -1, -1)
AFF = AffineScoring(2, -1, -3, -1)
OLD_ENGINES = ["pallas", "pallas-interpret", "collective",
               "collective-interpret", "swarm-interpret"]
PAIR = (b"GATTACAGATTACA", b"GATTTACAGATACA")


def _entry_points():
    q, s = PAIR
    return {
        "align_score": lambda e: anyseq_tpu.align_score(q, s, engine=e),
        "align": lambda e: anyseq_tpu.align(q, s, engine=e),
        "align_hirschberg": lambda e: anyseq_tpu.align(
            q, s, traceback="hirschberg", engine=e),
        "align_full_tb": lambda e: anyseq_tpu.align_full_tb(q, s, engine=e),
        "align_scores_batch": lambda e: anyseq_tpu.align_scores_batch(
            [q], [s], engine=e),
        "align_batch": lambda e: anyseq_tpu.align_batch([q], [s],
                                                        engine=e),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
@pytest.mark.parametrize("engine", OLD_ENGINES)
def test_removed_engine_strings_rejected(entry, engine):
    with pytest.raises(ValueError, match="unknown engine"):
        _entry_points()[entry](engine)


@pytest.mark.parametrize("engine", OLD_ENGINES + ["gpu", ""])
def test_sharded_rejects_removed_engine_strings(engine):
    mesh = make_mesh(sp=2, dp=4)
    with pytest.raises(ValueError, match="unknown engine"):
        score_pair_sharded(*PAIR, "global", LIN, mesh, engine=engine)


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_xla_and_auto_agree_on_cpu(entry):
    fn = _entry_points()[entry]
    a, b = fn("auto"), fn("xla")
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("path", ["score", "levels", "batch"])
def test_cpu_routes_to_xla(path):
    assert route.platform() == "cpu"
    assert not route.use_kernel(path, "auto", 1024)


@pytest.mark.parametrize("path", ["score", "levels", "batch"])
def test_gpu_routes_kernel_paths(monkeypatch, path):
    monkeypatch.setattr(route, "platform", lambda: "gpu")
    assert route.use_kernel(path, "auto", 1024) == (
        path in route.KERNEL_PATHS)
    assert not route.use_kernel(path, "xla", 1024)


def test_gpu_routes_too_tall_problems_to_xla(monkeypatch):
    monkeypatch.setattr(route, "platform", lambda: "gpu")
    assert not route.use_kernel("score", "auto", sweep.MAX_ROWS + 1)
    assert route.use_kernel("score", "auto", sweep.MAX_ROWS) == (
        "score" in route.KERNEL_PATHS)


@pytest.mark.parametrize("plat", ["METAL", "rocm"])
def test_other_platforms_route_to_xla(monkeypatch, plat):
    monkeypatch.setattr(route, "platform", lambda: plat)
    assert not route.use_kernel("score", "auto", 1024)


def test_unknown_path_rejected():
    with pytest.raises(ValueError, match="unknown path"):
        route.use_kernel("fulltb", "auto", 8)


@pytest.fixture
def fake_gpu(monkeypatch):
    """Route as on a GPU, with the numpy model of the kernel in place of
    the compiled one; counts kernel calls."""
    calls = []

    def counted(*args):
        calls.append(args[5])
        return sweep_model.ffi_sweep(*args)

    monkeypatch.setattr(route, "platform", lambda: "gpu")
    monkeypatch.setattr(sweep, "_ffi_sweep", counted)
    return calls


@pytest.mark.parametrize("scheme", ["linear", "affine"])
@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_gpu_align_score_runs_the_kernel(fake_gpu, mode, scheme):
    sc = AFF if scheme == "affine" else LIN
    rng = np.random.default_rng(5)
    q = random_dna(rng, 150)
    s = mutate(rng, q)
    got = anyseq_tpu.align_score(q, s, mode, sc)
    want = (oracle_affine.align_score_affine(q, s, mode, sc)
            if scheme == "affine" else oracle.align_score(q, s, mode, sc))
    assert got == want
    assert fake_gpu == [Mode.parse(mode)]


def test_gpu_scores_batch_runs_the_kernel(fake_gpu):
    rng = np.random.default_rng(6)
    qs = [random_dna(rng, int(rng.integers(20, 120))) for _ in range(5)]
    ss = [mutate(rng, q) for q in qs]
    got = anyseq_tpu.align_scores_batch(qs, ss, "local", LIN)
    want = [oracle.align_score(q, s, "local", LIN) for q, s in zip(qs, ss)]
    np.testing.assert_array_equal(got, want)
    assert fake_gpu and all(m is Mode.LOCAL for m in fake_gpu)


@pytest.mark.parametrize("scheme", ["linear", "affine"])
def test_gpu_construction_levels_run_the_kernel(fake_gpu, scheme):
    """Hirschberg / Myers-Miller: the forward score pass and every level
    sweep go through the kernel and the alignment equals the XLA one."""
    sc = AFF if scheme == "affine" else LIN
    rng = np.random.default_rng(8)
    q = random_dna(rng, 600)
    s = mutate(rng, q)
    got = anyseq_tpu.align(q, s, "global", sc, traceback="hirschberg")
    assert fake_gpu.count(Mode.GLOBAL) >= 2  # at least two levels
    fake_gpu.clear()
    want = anyseq_tpu.align(q, s, "global", sc, traceback="hirschberg",
                            engine="xla")
    assert not fake_gpu
    assert got == want


def test_no_interpreted_kernel_anywhere():
    """No module of the package runs a Pallas kernel, in interpret mode
    or otherwise, nor probes for the removed kernel stack."""
    pkg = pathlib.Path(anyseq_tpu.__file__).parent
    pattern = re.compile(r"interpret\s*=|pallas|available\(\)")
    hits = [f"{p.relative_to(pkg)}:{i}"
            for p in sorted(pkg.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []
