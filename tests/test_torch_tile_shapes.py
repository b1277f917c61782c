"""The tile-shape tool's host side: the shape lines it rewrites, the
register report it reads, and its refusal to run without a card (the
builds and times themselves need nvcc and a card)."""
import pytest
import torch

from coldrec_tpu_torch.ops.cuda import build as kbuild
from coldrec_tpu_torch.tools import tile_shapes as ts
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_committed_shapes_have_seven_fields():
    fused, dot = ts.committed_shapes()
    for shape in (fused, dot):
        fields = [int(x) for x in shape.split(",")]
        assert len(fields) == 7 and all(f > 0 for f in fields)


def test_shape_sources_replace_only_the_shape_lines():
    texts = ts.shape_sources("16,4,1,32,8,16,2", "64,8,8,4,2,16,3")
    assert set(texts) == set(kbuild.SOURCES + kbuild.HEADERS)
    assert "using Sweep = Shape<16, 4, 1, 32, 8, 16, 2>;" in \
        texts["retrieval.cu"]
    assert "using DotTile = tile::Shape<64, 8, 8, 4, 2, 16, 3>;" in \
        texts["exp_retrieval_kernels.cu"]
    for name, text in texts.items():
        orig = (kbuild.CSRC_DIR / name).read_text().splitlines()
        new = text.splitlines()
        assert len(orig) == len(new)
        changed = [a for a, b in zip(orig, new) if a != b]
        assert len(changed) == (name in ts.SHAPE_LINES), (name, changed)


@pytest.mark.parametrize("shape", ["16,4,1,32,8,16", "a,b"])
def test_shape_sources_refuse_bad_shapes(shape):
    with pytest.raises(ValueError):
        ts.shape_sources(shape, ts.committed_shapes()[1])


def test_registers_reads_the_ptxas_report():
    report = (
        "ptxas info    : Compiling entry function '_ZN4fused_sweep_kernelILi0"
        "EEEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4fused_sweep_kernelILi0E\n"
        "    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN4merge_parts_kernelE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4merge_parts_kernelE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers\n")
    assert ts.registers(report, "fused_sweep_kernel") == "128/12"
    assert ts.registers(report, "merge_parts_kernel") == "32/0"
    assert ts.registers(report, "dot_sweep_kernel") == ""


def test_tool_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="card"):
        ts.run([ts.committed_shapes()], device="cpu")
