"""The kernel library's name tracks everything its build reads.

``ops/_build.py`` names each built library by a digest of its source,
the shared headers ``csrc/*.cuh`` and the ``nvcc`` flags, so that an
edited kernel or header is rebuilt instead of loading a stale library.
These cases run on the CPU without ``nvcc``: they only compute names,
over a copy of ``csrc`` in a temporary directory.
"""

import shutil

import pytest

from skypilot_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


def test_shared_header_exists():
    """The bf16 flash bodies share their tensor-core helpers through a
    header, which is what makes hashing headers necessary."""
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    for name in ("flash_fwd", "flash_bwd"):
        assert '#include "sm90.cuh"' in (
            _build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", _build.SOURCES)
def test_digest_is_stable(csrc, name):
    first = _build._lib_path(name)
    assert first == _build._lib_path(name)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith(f"lib{name}-") and first.suffix == ".so"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_editing_a_header_changes_every_digest(csrc, name):
    before = _build._lib_path(name)
    _append(csrc / "sm90.cuh")
    assert _build._lib_path(name) != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_adding_a_header_changes_the_digest(csrc, name):
    before = _build._lib_path(name)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._lib_path(name) != before


def test_renaming_a_header_changes_the_digest(csrc):
    before = _build._lib_path("flash_fwd")
    (csrc / "sm90.cuh").rename(csrc / "sm90_old.cuh")
    assert _build._lib_path("flash_fwd") != before


def test_editing_a_source_changes_only_its_digest(csrc):
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    _append(csrc / "flash_bwd.cu")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert after["flash_bwd"] != before["flash_bwd"]
    assert after["flash_fwd"] == before["flash_fwd"]
    assert after["paged_attention"] == before["paged_attention"]


def test_changing_the_flags_changes_the_digest(csrc, monkeypatch):
    before = _build._lib_path("flash_fwd")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lcuda"])
    assert _build._lib_path("flash_fwd") != before


@pytest.fixture
def fake_nvcc(csrc, tmp_path, monkeypatch):
    """A stand-in compiler: writes the ``-o`` file after ``delay`` s."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      'sleep "${FAKE_NVCC_DELAY:-0}"\necho lib > "$2"\n'
                      'echo "ptxas info: built"\n')
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "_pending", {})
    return monkeypatch


def test_build_all_waits_for_a_started_build(fake_nvcc):
    fake_nvcc.setenv("FAKE_NVCC_DELAY", "0.2")
    _build.start(("flash_bwd",))
    assert set(_build._pending) == {"flash_bwd"}
    assert not _build._lib_path("flash_bwd").exists()
    # The started process is the one waited for: no second nvcc.
    proc = _build._pending["flash_bwd"][0]
    logs = _build.build_all(("flash_bwd", "flash_fwd"))
    assert proc.returncode == 0 and not _build._pending
    assert "ptxas info" in logs["flash_bwd"]
    for name in ("flash_bwd", "flash_fwd"):
        assert _build._lib_path(name).read_text() == "lib\n"


def test_start_skips_what_is_built_or_building(fake_nvcc):
    _build.build_all(("flash_fwd",))
    fake_nvcc.setenv("FAKE_NVCC_DELAY", "0.2")
    _build.start()
    assert set(_build._pending) == {"paged_attention", "flash_bwd"}
    first = dict(_build._pending)
    _build.start()
    assert _build._pending == first
    _build.build_all()
    assert not _build._pending


def test_stop_ends_unwaited_builds(fake_nvcc):
    fake_nvcc.setenv("FAKE_NVCC_DELAY", "30")
    _build.start(("flash_bwd",))
    proc, tmp, out = _build._pending["flash_bwd"]
    _build.stop()
    assert proc.returncode is not None and not _build._pending
    assert not tmp.exists() and not out.exists()
