"""The port's mutation check (``go_audio_resampler_tpu_torch/tools/
mutation_check.py``): its mutations stay well formed.  No mutant runs
here."""

import shutil

import pytest

from go_audio_resampler_tpu_torch.tools import mutation_check as mc

ALL = mc.MUTATIONS + mc.CUDA_MUTATIONS


@pytest.mark.parametrize("mut", ALL, ids=[m.note for m in ALL])
def test_mutation_is_well_formed(mut):
    src = mc.source(mut)
    assert src.is_file()
    assert mc.PACKAGE in src.parents
    assert src.read_text().count(mut.old) == 1
    assert mut.new != mut.old
    files = mc.test_files(mut)
    assert files and all(f.is_file() for f in files)
    assert all(f.name.startswith("test_torch_") for f in files)


def test_sets_cover_the_jax_checks_sites_and_every_cuda_source():
    assert len(mc.MUTATIONS) >= 12
    assert len({m.note for m in ALL}) == len(ALL)
    assert {src.rsplit("/", 1)[1] for src, *_ in mc.CUDA_MUTATIONS} == {
        "fused_resample.cu", "fused_resample_tmajor.cu",
        "general_resample.cu", "banded_mma.cuh"}
    for mut in mc.CUDA_MUTATIONS:
        assert mut.targets == mc.CUDA_TARGETS == ("tests/test_torch_cuda.py",)
    assert mc.CUDA_OPTIONS == ("--noconftest", "-m", "cuda")


@pytest.mark.parametrize("path", [
    "go_audio_resampler_tpu/engine/counts.py",
    "go_audio_resampler_tpu_torch/../go_audio_resampler_tpu/api.py",
    "tools/mutation_check.py",
])
def test_refuses_a_file_outside_the_port(path):
    with pytest.raises(ValueError, match="outside"):
        mc.source(mc.Mutation(path, "a", "b", ("tests/test_torch_plan.py",),
                              "outside"))


@pytest.mark.parametrize("target", [
    "tests/test_engine_core.py", "tests/test_torch_plan.txt",
    "go_audio_resampler_tpu_torch/api.py",
])
def test_refuses_a_target_that_is_not_a_port_test(target):
    mut = mc.MUTATIONS[0]._replace(targets=(target,))
    with pytest.raises(ValueError, match="not a port test"):
        mc.test_files(mut)


def test_restore_stragglers_puts_back_each_backup(tmp_path):
    root = tmp_path / "pkg"
    shutil.copytree(mc.PACKAGE / "engine", root / "engine")
    shutil.copytree(mc.PACKAGE / "ops" / "csrc", root / "ops" / "csrc")
    originals = {}
    for rel in ("engine/counts.py", "ops/csrc/banded_mma.cuh"):
        src = root / rel
        originals[src] = src.read_text()
        shutil.copy(src, src.with_name(src.name + mc.BACKUP))
        src.write_text("a live mutant")
    assert sorted(mc.restore_stragglers(root)) == sorted(originals)
    for src, text in originals.items():
        assert src.read_text() == text
    assert not list(root.rglob(f"*{mc.BACKUP}"))
    assert mc.restore_stragglers(root) == []


def test_run_restores_the_file_when_the_tests_are_interrupted(monkeypatch,
                                                               tmp_path):
    """A mutant is put back also when its test run ends in an exception
    (the SIGTERM handler raises KeyboardInterrupt)."""
    pkg = tmp_path / "go_audio_resampler_tpu_torch"
    shutil.copytree(mc.PACKAGE / "engine", pkg / "engine")
    monkeypatch.setattr(mc, "REPO", tmp_path.resolve())
    monkeypatch.setattr(mc, "PACKAGE", pkg.resolve())
    mut = mc.MUTATIONS[0]
    before = (pkg / "engine" / "counts.py").read_text()
    seen = []

    def interrupted(targets, options):
        seen.append((pkg / "engine" / "counts.py").read_text())
        raise KeyboardInterrupt

    monkeypatch.setattr(mc, "_pytest", interrupted)
    with pytest.raises(KeyboardInterrupt):
        mc.run(mut)
    assert mut.new in seen[0] and mut.old not in seen[0]
    assert (pkg / "engine" / "counts.py").read_text() == before
    assert not list(pkg.rglob(f"*{mc.BACKUP}"))


@pytest.mark.parametrize("caught", [True, False])
def test_run_reports_caught_and_survived(monkeypatch, tmp_path, capsys,
                                         caught):
    pkg = tmp_path / "go_audio_resampler_tpu_torch"
    shutil.copytree(mc.PACKAGE / "engine", pkg / "engine")
    monkeypatch.setattr(mc, "REPO", tmp_path.resolve())
    monkeypatch.setattr(mc, "PACKAGE", pkg.resolve())
    monkeypatch.setattr(mc, "_pytest",
                        lambda targets, options: (not caught, "1 failed"))
    assert mc.run(mc.MUTATIONS[0]) is caught
    assert capsys.readouterr().out.startswith(
        "CAUGHT" if caught else "SURVIVED")


@pytest.mark.parametrize("baseline, mutants, rc", [
    (False, [], 2),                  # the unmutated tree fails: no verdict
    (True, [False, False], 0),       # every mutant caught
    (True, [False, True], 1),        # one survived
])
def test_main_exit_codes(monkeypatch, baseline, mutants, rc):
    monkeypatch.setattr(mc.signal, "signal", lambda *a: None)
    monkeypatch.setattr(mc, "restore_stragglers", lambda: [])
    baselines = []

    def fake_pytest(targets, options):
        baselines.append((tuple(targets), options))
        return baseline, "summary"

    survived = iter(mutants)
    ran = []

    def fake_run(mut, options):
        ran.append(mut.note)
        return not next(survived)

    monkeypatch.setattr(mc, "_pytest", fake_pytest)
    monkeypatch.setattr(mc, "run", fake_run)
    assert mc.main(["poly count model"]) == rc
    assert baselines == [(("tests/test_torch_plan.py",), ())]
    assert ran == [m.note for m in mc.MUTATIONS
                   if "poly count model" in m.note][:len(mutants)]
