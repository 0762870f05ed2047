"""K2's operations bound from its SASS (``chip_smoke.sass_counts`` and
``chip_smoke._k2_bound``), on a SASS listing shaped like ``cuobjdump``'s:
the families counted per instruction, the body cut at the function's last
unpredicated ``EXIT``, other functions ignored, and the bound the slowest
of the INT pipe, the FMA pipe and issue."""

import pytest

import chip_smoke

SASS = """
	code for sm_90a
		Function : _Z5otherv
        /*0000*/                   LOP3.LUT R0, R1, R2, RZ, 0x3c, !PT ;   /* 0x0 */
        /*0010*/                   EXIT ;                                  /* 0x0 */
		Function : _ZN44_GLOBAL__N__11_chacha20_cu15chacha20_kernelEPK5uint4mmmPS0_
        /*0000*/                   S2R R3, SR_CTAID.X ;                    /* 0x0 */
        /*0010*/                   IMAD.WIDE.U32 R14, R3, 0x100, R14 ;     /* 0x0 */
        /*0020*/               @P0 EXIT ;                                  /* 0x0 */
        /*0030*/              @!P0 BRA 0x60 ;                              /* 0x0 */
        /*0040*/                   CALL.REL.NOINC 0x100 ;                  /* 0x0 */
        /*0050*/                   VIADD R2, R0, 0xffffffe ;               /* 0x0 */
        /*0060*/                   IMAD.IADD R4, R4, 0x1, R5 ;             /* 0x0 */
        /*0070*/                   LOP3.LUT R6, R6, R4, RZ, 0x3c, !PT ;    /* 0x0 */
        /*0080*/                   SHF.L.W.U32.HI R6, R6, 0x10, R6 ;       /* 0x0 */
        /*0090*/                   PRMT R7, R7, 0x1032, R7 ;               /* 0x0 */
        /*00a0*/                   IADD3.X R8, R8, R9, RZ, P0, !PT ;       /* 0x0 */
        /*00b0*/                   STG.E.128 desc[UR4][R2.64], R4 ;        /* 0x0 */
        /*00c0*/                   EXIT ;                                  /* 0x0 */
        /*00d0*/                   BRA 0xd0;                               /* 0x0 */
        /*0100*/                   IMAD.HI.U32 R4, R5, R6, RZ ;            /* 0x0 */
        /*0110*/                   IADD3 R4, R4, 0x1, RZ ;                 /* 0x0 */
        /*0120*/                   RET.REL.NODEC R2 0x0 ;                  /* 0x0 */
"""


def test_counts_the_body_by_family():
    body, after = chip_smoke.sass_counts(SASS, "chacha20_kernel", chip_smoke.K2_SASS_FAMILIES)
    assert body == {"LOP3": 1, "SHF": 1, "PRMT": 1, "IADD3": 1, "IMAD": 2, "VIADD": 1}
    assert after == {"LOP3": 0, "SHF": 0, "PRMT": 0, "IADD3": 1, "IMAD": 1, "VIADD": 0}


def test_refuses_a_missing_function():
    with pytest.raises(ValueError, match="no SASS"):
        chip_smoke.sass_counts(SASS, "limb_share_sum", chip_smoke.K2_SASS_FAMILIES)


@pytest.fixture
def per_block(monkeypatch):
    counts = {}
    monkeypatch.setattr(chip_smoke, "K2_PER_BLOCK", counts)
    return counts


def test_bound_needs_the_count(per_block):
    with pytest.raises(RuntimeError, match="SASS has not been counted"):
        chip_smoke._k2_bound(1, 1, 1.0)


@pytest.mark.parametrize("int_pipe, imad, issue, clocks", [
    (640, 336, 976, 10.0),     # the INT pipe binds: 640 / 64
    (100, 640, 740, 10.0),     # the FMA pipe binds: 640 / 64
    (300, 300, 1920, 15.0),    # issue binds: 1920 / 128
])
def test_bound_is_the_slowest_pipe(per_block, int_pipe, imad, issue, clocks):
    per_block.update(int_pipe=int_pipe, IMAD=imad, issue=issue)
    seeds, n_blocks = 10, 1000
    moved, ops, int_ops, bytes_ms, ops_ms = chip_smoke._k2_bound(seeds, n_blocks, 2.0)
    assert moved == seeds * 32 + seeds * n_blocks * 64
    assert ops == seeds * n_blocks * issue and int_ops == seeds * n_blocks * int_pipe
    assert ops_ms == pytest.approx(seeds * n_blocks * clocks / 2.0)
    assert bytes_ms == pytest.approx(moved / chip_smoke.HBM_BYTES_PER_S * 1e3)
