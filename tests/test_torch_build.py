"""The kernel build's library names: a hash of the source, every shared
header (``csrc/*.cuh``) beside it and the flags, so that an edit to a
header such as ``hopper.cuh`` rebuilds every library that includes it
instead of loading a stale one.  Runs on copies of the sources; nothing
is compiled."""
import shutil

import pytest

from repro_torch.kernels import build

SOURCES = ("cim_matmul.cu", "flash_attention.cu", "selective_scan.cu",
           "strategy_eval.cu")


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_sources_include_the_shared_header():
    assert (build.CSRC / "hopper.cuh").exists()
    for name in ("cim_matmul.cu", "flash_attention.cu"):
        assert '#include "hopper.cuh"' in (build.CSRC / name).read_text()


@pytest.mark.parametrize("source", SOURCES)
def test_copy_names_the_same_library(csrc, source):
    flags = build.BASE_FLAGS
    assert build.library_path(csrc / source, flags) == \
        build.library_path(build.CSRC / source, flags)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("edit", ["header", "new header", "source", "flags"])
def test_path_changes_with_each_input(csrc, source, edit):
    flags = build.BASE_FLAGS
    before = build.library_path(csrc / source, flags)
    if edit == "header":
        header = csrc / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif edit == "source":
        (csrc / source).write_text((csrc / source).read_text() + "\n")
    else:
        flags = flags + ("-lineinfo",)
    after = build.library_path(csrc / source, flags)
    assert after != before
    assert after.name.startswith(f"lib{source[:-3]}-")


def test_unrelated_file_keeps_the_path(csrc):
    before = build.library_path(csrc / "cim_matmul.cu", build.BASE_FLAGS)
    (csrc / "notes.txt").write_text("not a header")
    assert build.library_path(csrc / "cim_matmul.cu",
                              build.BASE_FLAGS) == before
