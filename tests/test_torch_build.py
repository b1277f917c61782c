"""The kernel build's host side: the sources and headers it hashes, and the
SASS reader that shows which kernels run on the tensor cores (the builds
themselves need nvcc and a card)."""
import re

import pytest

from coldrec_tpu_torch.ops.cuda import build as kbuild
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", kbuild.SOURCES + kbuild.HEADERS)
def test_every_included_header_is_hashed(name):
    """A header a source includes is in HEADERS, so an edit to it changes
    the library's name and is never served a stale build."""
    text = (kbuild.CSRC_DIR / name).read_text()
    for header in re.findall(r'#include "([^"]+)"', text):
        assert header in kbuild.HEADERS, (name, header)
        assert (kbuild.CSRC_DIR / header).exists()


def test_library_name_hashes_every_header(tmp_path, monkeypatch):
    before = kbuild.library_path()
    for name in kbuild.SOURCES + kbuild.HEADERS:
        (tmp_path / name).write_bytes((kbuild.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(kbuild, "CSRC_DIR", tmp_path)
    assert kbuild.library_path() == before
    (tmp_path / "mma_tile.cuh").write_text(
        (tmp_path / "mma_tile.cuh").read_text() + "\n// edited\n")
    assert kbuild.library_path() != before


SASS = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0470*/                   LDSM.16.MT88.4 R36, [R195] ;
        /*0480*/                   HMMA.16816.F32.BF16 R32, R16.reuse, R36, R32 ;
        /*0490*/                   HMMA.16816.F32.BF16 R28, R16, R38, R28 ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_116mma_sweep_kernelILi1EEEvPKtS2_
        /*0480*/                   HGMMA.64x16x16.F32.BF16 R24, gdesc[UR4], R24 ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_118fused_sweep_kernelILi0ELb1EEEvPKfS2_
        /*0480*/                   FFMA R3, R4, R5, R3 ;
\t\t..........
"""


def test_mma_counts_reads_a_sass_listing():
    counts = kbuild.mma_counts(SASS, "mma_sweep_kernel")
    assert counts == {
        "_ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_": 2,
        "_ZN12_GLOBAL__N_116mma_sweep_kernelILi1EEEvPKtS2_": 1,
    }
    assert kbuild.mma_counts(SASS, "fused_sweep_kernel") == {
        "_ZN12_GLOBAL__N_118fused_sweep_kernelILi0ELb1EEEvPKfS2_": 0}
    assert kbuild.mma_counts(SASS, "dot_sweep_kernel") == {}


def test_sass_counts_need_cuobjdump(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "find_cuobjdump", lambda: None)
    assert kbuild.sass_mma_counts(tmp_path / "lib.so", "mma") is None


SYMBOLS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

symbols:
STT_SECTION      STB_LOCAL  .text._ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_
STT_FUNC         STB_LOCAL  STO_ENTRY      _ZN12_GLOBAL__N_116mma_sweep_kernelILi1EEEvPKtS2_
STT_FUNC         STB_LOCAL  STO_ENTRY      _ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_
STT_FUNC         STB_LOCAL  STO_ENTRY      _ZN12_GLOBAL__N_118fused_sweep_kernelILi0ELb1EEEvPKfS2_
STT_OBJECT       STB_LOCAL  STV_DEFAULT    _ZN12_GLOBAL__N_116mma_sweep_kernel_table
"""


def test_function_names_reads_a_symbol_listing():
    assert kbuild.function_names(SYMBOLS, "mma_sweep_kernel") == [
        "_ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_",
        "_ZN12_GLOBAL__N_116mma_sweep_kernelILi1EEEvPKtS2_",
    ]
    assert kbuild.function_names(SYMBOLS, "dot_sweep_kernel") == []


def _fake_cuobjdump(monkeypatch, symbols):
    """Stand in for cuobjdump: ``-symbols`` answers ``symbols``, ``-sass
    -fun a,b`` the SASS of the named functions of SASS. Returns the list
    its calls' arguments are logged in."""
    calls = []

    def run(tool, *args):
        calls.append(args)
        if args[0] == "-symbols":
            return symbols
        names = args[args.index("-fun") + 1].split(",")
        parts = re.split(r"\n(?=\s*Function : )", SASS)
        return "\n".join(p for p in parts if any(n in p for n in names))

    monkeypatch.setattr(kbuild, "find_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(kbuild, "_cuobjdump", run)
    return calls


def test_sass_counts_disassemble_only_the_named_kernel(monkeypatch,
                                                       tmp_path):
    calls = _fake_cuobjdump(monkeypatch, SYMBOLS)
    lib = str(tmp_path / "lib.so")
    counts = kbuild.sass_mma_counts(lib, "mma_sweep_kernel")
    assert counts == {
        "_ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_": 2,
        "_ZN12_GLOBAL__N_116mma_sweep_kernelILi1EEEvPKtS2_": 1,
    }
    assert calls == [
        ("-symbols", lib),
        ("-sass", "-fun",
         "_ZN12_GLOBAL__N_116mma_sweep_kernelILi0EEEvPKtS2_,"
         "_ZN12_GLOBAL__N_116mma_sweep_kernelILi1EEEvPKtS2_", lib)]


def test_sass_counts_without_the_kernel_are_empty(monkeypatch, tmp_path):
    """No symbol names the kernel: no disassembly, and no count, which
    phase sass reports as a failure."""
    calls = _fake_cuobjdump(monkeypatch, SYMBOLS.replace("mma_sweep", "xyz"))
    assert kbuild.sass_mma_counts(str(tmp_path / "lib.so"),
                                  "mma_sweep_kernel") == {}
    assert len(calls) == 1
