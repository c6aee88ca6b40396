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
    s = cuda_build.sass_summary(LISTING, (4, 22, 4))
    # 5 once, and the three inner bodies 3, 21 and 3 more times
    assert s["integer_per_pass"] == 5 + 3 + 21 + 3
    # trips of every loop, by start address (the outer one first): each
    # instruction times the trips of the loops that hold it
    s = cuda_build.sass_summary(LISTING, (2, 4, 22, 4))
    assert s["integer_per_pass"] == 1 + 2 * (1 + 4 + 22 + 4)
    assert len(cuda_build.P2_ROUND_TRIPS) == 5
    with pytest.raises(ValueError):
        cuda_build.sass_summary(LISTING, (4, 22))



def test_chain_per_round():
    """K6: three innermost round loops take the trips (4, 22, 4), over 30
    rounds. K5: the innermost loop with the most funnel shifts (six a
    round) is the chain's; a kernel without one gives None."""
    s = cuda_build.sass_summary(LISTING)
    assert cuda_build.chain_per_round("sha256_witness", LISTING, s) is None
    # K6: a small loop (3 integer instructions, left out), then three round
    # loops of 20 integer instructions each, 5 integer instructions outside
    add = ("IADD3", "IADD3 R1, R1, R2, R3")
    k6 = [(0x0, "LOP3.LUT", "LOP3.LUT R1, R1, R2, RZ, 0x3c, !PT"),
          (0x10, *add), (0x20, *add), (0x30, *add),
          (0x40, "BRA", "@P0 BRA 0x10")]
    addr = 0x50
    for _ in range(3):
        start = addr
        for _ in range(20):
            k6.append((addr, *add))
            addr += 0x10
        k6.append((addr, "BRA", "@P1 BRA %#x" % start))
        addr += 0x10
    k6 += [(addr + 0x10 * i, *add) for i in range(4)]
    s = cuda_build.sass_summary(k6)
    assert cuda_build.chain_per_round("poseidon", k6, s) == \
        round((5 + 30 * 20) / 30, 1)
    # two rounds (12 funnel shifts) and an add in one loop; a loop with one
    # shift after it
    shf = "SHF.R.W.U32"
    chain = [(0x00, "IMAD", "IMAD R1, R2, R3, R4")]
    chain += [(0x10 * (i + 1), shf, shf + " R1, R1, 0x6, R1")
              for i in range(12)]
    chain += [(0xd0, "IADD3", "IADD3 R1, R1, R2, R3"),
              (0xe0, "BRA", "@P0 BRA 0x10"),
              (0xf0, shf, shf + " R2, R2, 0x7, R2"),
              (0x100, "BRA", "@P1 BRA 0xf0"),
              (0x110, "EXIT", "EXIT")]
    s = cuda_build.sass_summary(chain)
    assert cuda_build.chain_per_round("sha256_witness", chain, s) == 6.5
