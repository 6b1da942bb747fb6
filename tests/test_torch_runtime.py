"""The kernel runtime's library names, on the CPU: a library is named by a
hash of its source and of the local headers the source includes, so that
an edited header rebuilds every library that includes it (the attention
forward and backward share ``attention_tc.cuh``) and nothing else is
rebuilt."""
import hashlib

import pytest

from repro_torch.kernels import runtime


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree: ``a.cu`` includes ``h.cuh``, which includes
    ``g.cuh``; ``b.cu`` includes ``g.cuh`` and a system header; ``c.cu``
    includes nothing of its own."""
    (tmp_path / "g.cuh").write_text("#pragma once\nconstexpr int kG = 1;\n")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "h.cuh"\n'
                                   '  #  include "g.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "g.cuh"\nint b;\n')
    (tmp_path / "c.cu").write_text("#include <stdint.h>\nint c;\n")
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_sources_follow_local_includes_once(csrc):
    assert [p.name for p in runtime._sources(csrc / "a.cu")] == \
        ["a.cu", "h.cuh", "g.cuh"]
    assert [p.name for p in runtime._sources(csrc / "b.cu")] == \
        ["b.cu", "g.cuh"]
    assert [p.name for p in runtime._sources(csrc / "c.cu")] == ["c.cu"]


@pytest.mark.parametrize("header", ["h.cuh", "g.cuh"])
def test_changed_header_gives_a_new_library_path(csrc, header):
    before = {n: runtime._lib_path(n) for n in "abc"}
    (csrc / header).write_text((csrc / header).read_text() + "// edited\n")
    after = {n: runtime._lib_path(n) for n in "abc"}
    assert after["a"] != before["a"]
    assert (after["b"] != before["b"]) == (header == "g.cuh")
    assert after["c"] == before["c"]


def test_unchanged_sources_keep_their_path(csrc):
    assert runtime._lib_path("a") == runtime._lib_path("a")
    assert runtime._lib_path("a").parent == csrc / "build"


def test_source_without_headers_keeps_its_hash(csrc):
    """A source that includes no local header is named as before headers
    were hashed: by its own bytes and the flags."""
    digest = hashlib.sha256((csrc / "c.cu").read_bytes() + " ".join(
        runtime.NVCC_FLAGS).encode()).hexdigest()[:12]
    assert runtime._lib_path("c").name == f"libc-{digest}.so"


def test_missing_local_header_is_left_to_the_compiler(csrc):
    (csrc / "d.cu").write_text('#include "missing.cuh"\nint d;\n')
    assert [p.name for p in runtime._sources(csrc / "d.cu")] == ["d.cu"]


def test_attention_sources_share_their_header():
    for name in ("flash_attention", "flash_attention_bwd"):
        assert [p.name for p in runtime._sources(
            runtime.CSRC / f"{name}.cu")] == [f"{name}.cu",
                                              "attention_tc.cuh"]
