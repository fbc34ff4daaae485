"""utils/wide_probe.py on the CPU: the SASS opcode count on a sample of
cuobjdump's output, and the timing path, which needs a card."""

import pytest
import torch

from vulkan_radix_sort_tpu_torch.utils import wide_probe

SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_117chunk_wide_kernelILi3ELi1ELi12EEEv4BufsIXT_EXT0_EEPKi
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   IADD3 R2, P0, R4, -R5, RZ ;              /* 0x8000000504027210 */
        /*0020*/               @P0 LOP3.LUT R6, R7, R8, R9, 0xca, !PT ;     /* 0x0000000807067212 */
        /*0030*/                   LOP3.LUT R10, R7, R8, R9, 0xca, !PT ;    /* 0x0000000807067212 */
        /*0040*/                   EXIT ;                                   /* 0x000000000000794d */
                Function : _ZN12_GLOBAL__N_118chunk_merge_kernelILi12EEEv4BufsILi3ELi0EEPKi
        /*0000*/                   SHFL.BFLY PT, R3, R2, 0x1, 0x1f ;        /* 0x0c201f0002037f89 */
"""


def test_opcode_mix_counts_one_kernel():
    name, count, ops = wide_probe.opcode_mix(SASS, "chunk_wide_kernel")
    assert "chunk_wide_kernelILi3ELi1ELi12E" in name
    assert count == 5
    assert ops == {"LDC": 1, "IADD3": 1, "LOP3": 2, "EXIT": 1}
    assert wide_probe.opcode_mix(SASS, "chunk_merge_kernel")[2] == {
        "SHFL": 1}
    assert wide_probe.opcode_mix(SASS, "fused_wide_kernel") is None


def test_wide_times_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the timing path runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        wide_probe.wide_times(1 << 14)
