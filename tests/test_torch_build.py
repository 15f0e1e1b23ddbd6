"""The port's build helpers that run without the CUDA toolkit: reading
``cuobjdump -sass`` listings and ``-Xptxas -v`` logs (``ops/build.py``),
which ``chip_smoke.py`` uses to count tensor-core instructions and report
registers and spills of the built kernels, and the argument parsing of
``tools/sass_compare.py``."""
import pytest

from vidsgg_big_tpu_torch.ops import build
from vidsgg_big_tpu_torch.tools import sass_compare

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]

        code for sm_90a
                Function : _ZN45_GLOBAL__N__a_composed_attn_bwd_cu_b32composed_attn_bwd_dq_bf16_kernelEv
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                               /* 0x000fe20000000800 */
        /*0010*/                   WARPGROUP.ARRIVE ;                           /* 0x0000000000007990 */
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ; /* 0x... */
        /*10000*/              @P0 BRA 0x30 ;                                   /* 0x... */
                Function : _ZN45_GLOBAL__N__a_composed_attn_bwd_cu_b32composed_attn_bwd_dq_f32_kernelEv
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;         /* 0x... */
        /*0010*/                   EXIT ;                                       /* 0x... */
"""


def test_parse_sass_splits_kernels_and_strips_encodings():
    got = build.parse_sass(SASS)
    dq_bf16, dq_f32 = sorted(got)
    assert dq_bf16.endswith("dq_bf16_kernelEv")
    assert got[dq_bf16] == ["LDC R1, c[0x0][0x28]", "WARPGROUP.ARRIVE",
                            "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, "
                            "!UPT", "@P0 BRA 0x30"]
    assert got[dq_f32] == ["HMMA.1688.F32.TF32 R4, R8, R12, R4", "EXIT"]


PTXAS = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9dq_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z9dq_kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z10dkv_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z10dkv_kernelPf
    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    assert build.ptxas_usage(PTXAS) == {
        "_Z9dq_kernelPf": {"registers": 200, "spill_stores": 0,
                           "spill_loads": 0},
        "_Z10dkv_kernelPf": {"registers": 255, "spill_stores": 20,
                             "spill_loads": 28}}


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit of composed_attn_common.cuh rebuilds every library that
    includes it: the header is hashed into each library's name."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setitem(build.KERNELS, "k", csrc / "k.cu")
    before = build.library_path("k")
    (csrc / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != before


@pytest.mark.parametrize("argv,source,kernel", [
    (["other"], "composed_attn.cu", "composed_attn_f32_kernelILb1E"),
    (["--source", "forward", "other"], "composed_attn.cu",
     "composed_attn_bf16_kernelILb0E"),
    (["--source", "backward", "other"], "composed_attn_bwd.cu",
     "composed_attn_bwd_dkv_f32_kernel")])
def test_sass_compare_picks_the_source_and_its_kernels(argv, source, kernel):
    """``sass_compare [--source forward|backward] OTHER``: the forward by
    default; each source with the names of its four kernels."""
    args = sass_compare.parse_args(argv)
    assert args.other == "other"
    path, kernels = sass_compare.SOURCES[args.source]
    assert path.name == source and len(kernels) == 4 and kernel in kernels


def test_sass_compare_rejects_an_unknown_source():
    with pytest.raises(SystemExit):
        sass_compare.parse_args(["--source", "role", "other"])
