"""PyTorch port, the CUDA build helper (`kernels._build`) on the CPU.

A library is named by a hash of its source and of every file the source
includes by a quoted path, followed from file to file, so that an edited
header (``kernels/_mma.cuh``, ``ssd_chunk/csrc/chunk_walk.cuh``) rebuilds
the kernels that include it and a stale library is never loaded.  No
compiler is run here.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402


def _tree(tmp_path):
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/a.cuh"\n'
                   '  # include "b.cuh"\nint k() { return 1; }\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n'
                                            '#include "../b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b();\n")
    (tmp_path / "other.cuh").write_text("int other();\n")
    return src


def test_included_files_follow_quoted_includes(tmp_path):
    src = _tree(tmp_path)
    assert _build.included_files(src) == [
        src.resolve(), (tmp_path / "inc" / "a.cuh").resolve(),
        (tmp_path / "b.cuh").resolve()]


@pytest.mark.parametrize("edited,moves", [
    ("k.cu", True), ("inc/a.cuh", True), ("b.cuh", True),
    ("other.cuh", False)])
def test_editing_an_included_header_changes_the_library_path(tmp_path,
                                                             edited, moves):
    src = _tree(tmp_path)
    before = _build.library_path(src)
    path = tmp_path / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path(src)
    assert (after != before) == moves
    assert after.parent == _build.BUILD_DIR and after.stem.startswith("k-")


@pytest.mark.parametrize("module,headers", [
    (FA, {"flash_attention_tc.cu", "_hopper.cuh", "_mma.cuh",
          "flash_scale.cuh"}),
    (SK, {"ssd_chunk_tc.cu", "_hopper.cuh", "_mma.cuh"})])
def test_tensor_core_sources_hash_the_shared_header(module, headers):
    assert {p.name for p in _build.included_files(module._SOURCE_TC)} == \
        headers


def test_backward_source_hashes_the_hopper_header():
    """The flash backward's library is named by its source and the headers
    it includes (`_hopper.cuh`: the wgmma, TMA and mbarrier helpers;
    `_mma.cuh`: the hi/lo split; `flash_scale.cuh`: the score scaling and
    exp it shares with the forward)."""
    from repro_torch.kernels.flash_attention import kernel_bwd as FAB

    assert {p.name for p in _build.included_files(FAB._SOURCE)} == {
        "flash_attention_bwd.cu", "_hopper.cuh", "_mma.cuh",
        "flash_scale.cuh"}


def test_ssd_backward_source_hashes_the_mma_header():
    """The SSD backward's library is named by its source, `_hopper.cuh`
    (wgmma, TMA, mbarriers) and `_mma.cuh` (ldmatrix and the three-part
    split helpers)."""
    from repro_torch.kernels.ssd_chunk import kernel_bwd as SKB

    assert {p.name for p in _build.included_files(SKB._SOURCE)} == {
        "ssd_chunk_bwd.cu", "_hopper.cuh", "_mma.cuh"}
