"""kernel_report.py's SASS accounting on synthetic cuobjdump listings (no
card, no nvcc): the listing parser, loop detection, the instructions per
Poseidon permutation, the NTT's whole-kernel instructions per butterfly,
the Ed25519 counts from the probe kernels, and the ptxas lines kept."""

import pytest

import kernel_report as kr


def listing(*blocks):
    """[(address, text)] from blocks of opcodes, 16 bytes apart; an entry
    ("BRA", k) branches back to the start of block k."""
    out, starts, addr = [], [], 0
    for block in blocks:
        starts.append(addr)
        for op in block:
            text = f"@!P0 BRA {hex(starts[op[1]])}" if isinstance(op, tuple) else f"{op} R0, R1"
            out.append((addr, text))
            addr += 0x10
    return out


def test_parse_sass_skips_nops_and_encodings():
    text = """
        code for sm_90a
                Function : _Z6kernelPl
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   NOP ;                           /* 0x0000000000007918 */
        /*0020*/              @!P0 BRA 0x0 ;                       /* 0x0000000000008947 */
                Function : _Z5otherv
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
    """
    assert kr.parse_sass(text) == {
        "_Z6kernelPl": [(0x0, "LDC R1, c[0x0][0x28]"), (0x20, "@!P0 BRA 0x0")],
        "_Z5otherv": [(0x0, "EXIT")],
    }


def test_loops_are_backward_branches_only():
    instrs = [(0x0, "MOV R0, R1"), (0x10, "IADD3 R0, R0, 1"), (0x20, "@!P0 BRA 0x10"),
              (0x30, "@P1 BRA 0x50"), (0x40, "MOV R2, R3"), (0x50, "EXIT"), (0x60, "BRA 0x60")]
    assert kr.loops(instrs) == [dict(start="0x10", end="0x20", instructions=2)]


@pytest.mark.parametrize("bodies, want", [((10, 5, 10), 100 + 10 * 3 + 5 * 21 + 10 * 3), ((10, 5), None)])
def test_per_permutation_counts_each_round_loop_per_trip(bodies, want):
    round_loops = [dict(start="0x0", end="0x0", instructions=b) for b in bodies]
    assert kr.per_permutation(100, round_loops) == want


TILE_BLOCKS = [
    ["MOV"] * 5,                                                   # 0: straight code
    ["LDG", "LDG", "IMAD", "IMAD", "IMAD", "STS", "STS", ("BRA", 1)],  # 1: first pass, 8
    ["MOV"],                                                       # 2: pass loop head
    ["LDS", "IMAD", "IMAD", "STS", ("BRA", 3)],                    # 3: middle pass, 5
    ["BAR", ("BRA", 2)],                                           # 4: pass loop, 8 in all
    ["LDS"] + ["STG"] * 8 + [("BRA", 5)],                          # 5: last pass, radix 2
    ["LDS", "IMAD"] + ["STG"] * 16 + [("BRA", 6)],                 # 6: last pass, radix 4
    ["LDS"] + ["STG"] * 32 + [("BRA", 7)],                         # 7: last pass, radix 8
    ["EXIT"],
]
SMEM_BLOCKS = [
    ["MOV"] * 3,
    ["LDG", "LDG", "STS", ("BRA", 1)],                             # 1: load, 4
    ["MOV"],
    ["LDG", "LDS", "LDS", "IMAD", "STS", "STS", ("BRA", 3)],       # 3: stage, 7
    ["BAR", ("BRA", 2)],                                           # 4: stage loop, 10 in all
    ["LDS", "STG", "STG", ("BRA", 5)],                             # 5: store, 4
    ["EXIT"],
]
TILE, SMEM = listing(*TILE_BLOCKS), listing(*SMEM_BLOCKS)


def without_loop(blocks, k):
    return listing(*blocks[:k], ["MOV"], *blocks[k + 1:])


@pytest.mark.parametrize("fn, instrs, parts, threads, butterflies", [
    # (2048, 2048): tiles of 4 columns, 512 threads, 1024 radix-8 groups a
    # pass (2 trips), 2048 radix-4 groups in the last (4 trips), 2 middle passes
    ("_Z15ntt_tile_kernelPKlS0_PlS1_PKmiiiim", TILE,
     {"first pass": 8 * 2, "middle passes": 2 * (5 * 2 + 3), "last pass (radix 4)": 19 * 4, "outside loops": 6},
     512, 88.0),
    # one column a block, 1024 threads: 2 trips to load and store, 11 stages of one trip
    ("_Z15ntt_smem_kernelPKlS0_PlS1_PKmiiim", SMEM,
     {"load": 4 * 2, "stages": 11 * (7 + 3), "store": 4 * 2, "outside loops": 4}, 1024, 11.0),
])
def test_ntt_count_whole_kernel_per_butterfly(fn, instrs, parts, threads, butterflies):
    got = kr.ntt_count(fn, instrs, kr.loops(instrs))
    assert got["instructions_per_thread"] == parts
    assert (got["threads"], got["butterflies_per_thread"]) == (threads, butterflies)
    assert got["per_butterfly"] == round(sum(parts.values()) / butterflies, 2)


@pytest.mark.parametrize("fn, instrs", [
    ("_Z15ntt_tile_kernelPKlS0_PlS1_PKmiiiim", without_loop(TILE_BLOCKS, 1)),
    ("_Z15ntt_tile_kernelPKlS0_PlS1_PKmiiiim", without_loop(TILE_BLOCKS, 6)),
    ("_Z15ntt_smem_kernelPKlS0_PlS1_PKmiiim", without_loop(SMEM_BLOCKS, 5)),
    ("_Z16other_kernelv", TILE),
])
def test_ntt_count_none_without_its_loops(fn, instrs):
    assert kr.ntt_count(fn, instrs, kr.loops(instrs)) is None


def probe_listing(sizes: dict) -> dict:
    """{mangled probe kernel: [(address, text)]} with the given instruction counts."""
    return {f"_Z10{name}PKlS0_Pli": [(16 * i, "IMAD R0, R1, R2, R3") for i in range(count)]
            for name, count in sizes.items()}


@pytest.mark.parametrize("sizes, add_static, want", [
    # mul2 - mul1 = 160 a multiply, sq2 - sq1 = 130 a squaring, sq1 - 130 = 70
    # around them; the chain: 251 squarings + 11 multiplies + 70
    ({"probe_mul1": 300, "probe_mul2": 460, "probe_sq1": 200, "probe_sq2": 330}, 1234,
     dict(per_multiply=160, per_squaring=130, load_store=70, per_edwards_add=1234,
          per_pow22523_chain=251 * 130 + 11 * 160 + 70)),
    ({"probe_mul1": 300, "probe_mul2": 460, "probe_sq1": 200}, 1234, None),
])
def test_ed_count_from_probe_kernels(sizes, add_static, want):
    assert kr.ed_count(probe_listing(sizes), add_static) == want


@pytest.mark.parametrize("text, square", [("fe fe_sq(const fe& a) {}", "fe_sq(v)"), ("fe fe_mul(fe a, fe b) {}", "fe_mul(v, v)")])
def test_probe_squares_with_the_design_s_own_squaring(tmp_path, text, square):
    (tmp_path / "ed25519.cu").write_text(text)
    src = kr.probe_source(tmp_path)
    assert src.startswith(f"#define SQ(v) {square}\n#include \"ed25519.cu\"")
    assert all(f"PROBE({p}," in src for p in ("probe_mul1", "probe_mul2", "probe_sq1", "probe_sq2"))


def test_ptxas_lines_keep_each_kernel_s_name():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z10sqn_kernelPKlPlii' for 'sm_90a'
ptxas info    : Function properties for _Z10sqn_kernelPKlPlii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 376 bytes cmem[0]"""
    assert kr.ptxas_lines(log) == [
        "ptxas info    : Compiling entry function '_Z10sqn_kernelPKlPlii' for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 376 bytes cmem[0]",
    ]


LONG_LAST_BLOCKS = [
    ["MOV"] * 5,                                                   # 0: straight code
    ["LDG", "LDG", "IMAD", "STS", "STS", ("BRA", 1)],              # 1: first pass (u64 in), 6
    ["MOV"],                                                       # 2: pass loop head
    ["LDS", "LDS", "IMAD", "STS", "STS", ("BRA", 3)],              # 3: middle pass, radix 8, 6
    ["LDS", "IMAD", "STS", ("BRA", 4)],                            # 4: middle pass, radix 4, 4
    ["BAR", ("BRA", 2)],                                           # 5: pass loop, 13 in all
    ["LDS"] + ["STG"] * 16 + [("BRA", 6)],                         # 6: last pass, radix 4, (lo, hi) out
    ["LDS"] + ["STG"] * 32 + [("BRA", 7)],                         # 7: last pass, radix 8
    ["EXIT"],
]


def test_ntt_count_long_pass_kernel_per_butterfly():
    """The last pass of (2^21, 32) forward: 10 stages as radix 8, 8, 4, 4 over
    tiles of 2^10 positions x 4 columns, 512 threads (1 trip a radix-8 pass,
    2 a radix-4 one), 16384 blocks; 40 butterflies a thread."""
    instrs = listing(*LONG_LAST_BLOCKS)
    got = kr.ntt_count("_Z20ntt_long_last_kernelPKlS0_PlS1_PmPKmiiiiiim", instrs, kr.loops(instrs), 21, 32,
                       long_pass=(10, 2))
    parts = {"first pass": 6 * 1, "middle passes": 1 * (6 * 1 + 3), "middle passes (radix 4)": 1 * (4 * 2 + 3),
             "last pass (radix 4)": 18 * 2, "outside loops": 77 - (6 + 13 + 18 + 34)}
    assert got["instructions_per_thread"] == parts
    assert (got["threads"], got["butterflies_per_thread"], got["blocks"], got["stages"]) == (512, 40.0, 16384, 10)
    assert got["per_butterfly"] == round(sum(parts.values()) / 40, 2)
    # the first and middle kernels write the u64 intermediate: one STG an element, none matches here
    assert kr.ntt_count("_Z21ntt_long_first_kernelPKlS0_PlS1_PmPKmiiiiiim", instrs, kr.loops(instrs), 21, 32,
                        long_pass=(10, 2)) is None


def test_long_transform_count_weights_passes_by_their_work():
    first = dict(instructions_per_thread={"a": 100}, threads=512, blocks=10, butterflies_per_thread=4.0)
    last = dict(instructions_per_thread={"a": 30, "b": 30}, threads=256, blocks=20, butterflies_per_thread=2.0)
    want = (100 * 512 * 10 + 60 * 256 * 20) / (4 * 512 * 10 + 2 * 256 * 20)
    assert kr.long_transform_count([first, last]) == round(want, 2)
    assert kr.long_transform_count([first, None]) is None
