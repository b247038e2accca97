"""The kernels' build: a library is named by the hash of its source, of every
header the source includes by a quoted path and of the flags, so an edited
header is rebuilt and never loaded stale.  Nothing here compiles: the CPU
has no nvcc."""

from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

HEADER = Path(build.__file__).resolve().parent / "common" / "csrc" / "hopper.cuh"


def test_sources_follow_quoted_includes():
    for mod in (fa_kernel, gmm_kernel, ssd_kernel):
        assert build.sources(mod.SOURCE) == [mod.SOURCE.resolve(), HEADER]


def test_library_name_changes_with_an_included_header(tmp_path):
    (tmp_path / "inc").mkdir()
    src, header, inner = tmp_path / "k.cu", tmp_path / "inc" / "a.cuh", tmp_path / "b.cuh"
    src.write_text('#include <cuda.h>\n#include "inc/a.cuh"\nint k;\n')
    header.write_text('#pragma once\n  #  include "../b.cuh"\n#include "../b.cuh"\n')
    inner.write_text("int b = 1;\n")
    assert build.sources(src) == [src.resolve(), header.resolve(), inner.resolve()]
    before = build._library_path("k", src)
    assert build._library_path("k", src) == before  # unchanged sources: the same library
    inner.write_text("int b = 2;\n")  # an edit two includes down
    assert build._library_path("k", src) != before
