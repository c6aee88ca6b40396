"""The SASS counting of `boojum_tpu_torch/utils/cuda_build.py` on a made-up
listing (the CPU has no `cuobjdump`): loops from backward branches, and the
integer instructions of one pass with each innermost loop run its trips."""

import pytest

from boojum_tpu_torch.utils import cuda_build

# an outer loop 0x10..0x90 around three inner loops, then the exit and the
# branch to itself that ends every kernel
LISTING = [(0x00, "IMAD", "IMAD R1, R2, R3, R4"),
           (0x10, "IADD3", "IADD3 R1, R1, 0x1, RZ"),
           (0x20, "IMAD.WIDE.U32", "IMAD.WIDE.U32 R2, R3, R4, RZ"),
           (0x30, "BRA", "@P0 BRA 0x20"),
           (0x40, "LOP3.LUT", "LOP3.LUT R1, R1, R2, RZ, 0x3c, !PT"),
           (0x50, "BRA", "@P1 BRA 0x40"),
           (0x60, "SHF.L.U64.HI", "SHF.L.U64.HI R1, R2, 0x4, R3"),
           (0x70, "MOV", "MOV R1, R2"),
           (0x80, "BRA", "@P2 BRA 0x60"),
           (0x90, "BRA", "@P3 BRA 0x10"),
           (0xa0, "EXIT", "EXIT"),
           (0xb0, "BRA", "BRA 0xb0")]


def test_sass_summary_counts_loops_and_trips():
    s = cuda_build.sass_summary(LISTING)
    assert (s["total"], s["integer"], s["imad"]) == (12, 5, 2)
    assert [(lp["start"], lp["end"], lp["integer"]) for lp in s["loops"]] == [
        (0x20, 0x30, 1), (0x40, 0x50, 1), (0x60, 0x80, 1), (0x10, 0x90, 4)]
    assert "integer_per_pass" not in s
    s = cuda_build.sass_summary(LISTING, cuda_build.P2_ROUND_TRIPS)
    # 5 once, and the three inner bodies 3, 21 and 3 more times
    assert s["integer_per_pass"] == 5 + 3 + 21 + 3
    with pytest.raises(ValueError):
        cuda_build.sass_summary(LISTING, (4, 22))
