"""bench_torch.py at toy sizes on the CPU, and the SASS reader it uses.

``python3 bench_torch.py --platform cpu --tiny`` must exit 0 and print one
JSON line that carries every metric name bench.py prints and the port
keeps; a measurement that raises must end the run with a non-zero exit
and no result line.  ``sass_census.py`` is held to a listing in the
format ``cuobjdump -sass`` prints.
"""

import json
import os
import subprocess
import sys

import pytest

import sass_census as sass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXTRA_KEYS = [
    "mapped", "n_reads", "index_build_s", "gcups",
    "product_mixed_reads_per_s", "product_mixed_bases_per_s",
    "cigar_reads_per_s", "indel_reads_per_s", "indel_vs_baseline",
    "indel_counters", "cigar_indel_reads_per_s", "cigar_indel_pct_of_score",
    "cigar_indel_counters", "repeat_reads_per_s", "repeat_cigar_reads_per_s",
    "repeat_vs_baseline", "repeat_counters", "longread",
    "cold_start_reads_per_s", "sol", "platform", "baseline_reads_per_s",
    "baseline_omp_reads_per_s", "device", "nvidia_smi"]
LONGREAD_KEYS = ["longread_20k_reads_per_s", "longread_20k_bases_per_s",
                 "longread_20k_cigar_reads_per_s", "longread_50k_reads_per_s",
                 "longread_50k_bases_per_s"]
SOL_KEYS = ["int32_tops", "int32_issued_tops", "band_cells_per_s_g",
            "band_cells_per_s_g_general", "ops_per_cell", "gcups_sol_pct",
            "gcups_needed_pct"]


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_bench_tiny_cpu_prints_every_metric():
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--platform", "cpu", "--tiny"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "reads_per_s_4kb_ecoli"
    assert res["unit"] == "reads/s" and res["vs_baseline"] is None
    assert res["value"] > 0
    extra = res["extra"]
    for k in EXTRA_KEYS:
        assert k in extra, k
    for k in LONGREAD_KEYS:
        assert extra["longread"][k] > 0, k
    # A CPU run states no device rate.
    assert extra["platform"] == "cpu" and extra["tiny"] is True
    assert all(extra["sol"][k] is None for k in SOL_KEYS)
    assert extra["sol"]["needed_ops_per_cell"] == 7
    assert extra["longread"]["longread_50k_counters"]["reads"] > 0
    assert extra["mapped"] == extra["n_reads"]
    assert extra["band_vs_full_parity"] is True
    for k in ("indel_counters", "cigar_indel_counters", "repeat_counters"):
        assert extra[k]["reads"] == extra[k]["mapped"] > 0
        assert "t_host_s" in extra[k] and "realign_reroutes" in extra[k]


@pytest.mark.parametrize("ql,tl,W", [(5, 9, 2), (7, 3, 4), (1, 1, 128),
                                     (0, 4, 2), (6, 6, 1), (40, 25, 8)])
def test_band_cells_counts_the_matrix_cells_inside_the_band(ql, tl, W):
    import torch

    import bench_torch
    want = sum(1 for i in range(1, ql + 1) for j in range(1, tl + 1)
               if -W <= j - i <= W - 1)
    one = bench_torch.band_cells(torch.tensor([ql]), torch.tensor([tl]), W)
    assert one == want
    # A batch is the sum of its pairs; an empty pair adds nothing.
    both = bench_torch.band_cells(torch.tensor([ql, 0, 3]),
                                  torch.tensor([tl, 7, 3]), W)
    assert both == want + sum(1 for i in range(1, 4) for j in range(1, 4)
                              if -W <= j - i <= W - 1)


def test_bench_measurement_that_raises_fails_the_run():
    code = ("import sys, bench_torch\n"
            "def boom(*a, **k):\n"
            "    raise RuntimeError('measurement failed')\n"
            "bench_torch.measure_product = boom\n"
            "sys.exit(bench_torch.main(['--platform', 'cpu', '--tiny']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "measurement failed" in proc.stderr
    assert proc.stdout.strip() == ""


def test_bench_without_cuda_exits_1():
    proc = subprocess.run([sys.executable, "bench_torch.py", "--tiny"],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


LISTING = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN3foo12probe_kernelEPKiPi
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                         /* 0x0000000000007919 */
                                                                              /* 0x000e220000002100 */
        /*0020*/              @!P0 BRA 0x80 ;                                 /* 0x0000000000148947 */
                                                                              /* 0x000fea0003800000 */
        /*0030*/                   IMAD R8, R4.reuse, UR4, R7 ;               /* 0x0000000404087c24 */
                                                                              /* 0x041fe4000f8e0207 */
        /*0040*/                   VIMNMX R7, R8, R7, !PT ;                   /* 0x0000000708077248 */
                                                                              /* 0x000fe20007fe0100 */
        /*0050*/                   UIADD3 UR4, UR4, 0x1, URZ ;                /* 0x0000000104047890 */
                                                                              /* 0x000fe2000fffe03f */
        /*0060*/                   ISETP.LE.AND P0, PT, R3, UR4, PT ;         /* 0x0000000403007c0c */
                                                                              /* 0x000fda000bf03270 */
        /*0070*/              @!P0 BRA 0x30 ;                                 /* 0xffffffec00f48947 */
                                                                              /* 0x000fea000383ffff */
        /*0080*/                   STG.E desc[UR4][R2.64], R7 ;               /* 0x0000000702007986 */
                                                                              /* 0x000fe2000c101904 */
        /*0090*/                   EXIT ;                                     /* 0x000000000000794d */
                                                                              /* 0x000fea0003800000 */
        /*00a0*/                   BRA 0xa0;                                  /* 0xfffffffc00fc7947 */
                                                                              /* 0x000fc0000383ffff */
		..........

		Function : _ZN3foo5otherEv
        /*0000*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_sass_reader_finds_loops_and_counts():
    fns = sass.functions(LISTING)
    assert sorted(fns) == ["_ZN3foo12probe_kernelEPKiPi", "_ZN3foo5otherEv"]
    instrs = sass.function(LISTING, "probe_kernel")
    assert [i.op for i in instrs] == [
        "LDC", "S2R", "BRA", "IMAD", "VIMNMX", "UIADD3", "ISETP", "BRA",
        "STG", "EXIT", "BRA"]
    assert instrs[2].pred == "@!P0" and instrs[6].full_op == "ISETP.LE.AND"
    assert sass.loops(instrs) == [(3, 7)]       # the self-branch is no loop
    assert sass.innermost(instrs) == [(3, 7)]
    (row,) = sass.cell_loops(LISTING, "probe_kernel")
    assert (row["first"], row["last"], row["instructions"]) == \
        ("0x0030", "0x0070", 5)
    assert row["by_kind"] == {"int": 3, "uniform": 1, "control": 1}
    assert row["by_op"]["IMAD"] == 1 and row["by_op"]["VIMNMX"] == 1
    with pytest.raises(KeyError):
        sass.function(LISTING, "missing")
    with pytest.raises(KeyError):
        sass.function(LISTING, "foo")           # two kernels match


def _sass_lines(rows):
    """Listing text from (address, predicate, instruction) rows."""
    return "".join(f"        /*{addr:04x}*/ {pred:>16} {ins} ;\n"
                   for addr, pred, ins in rows)


# A register band kernel in miniature: a border loop, an interior loop, a
# shuffle under a run-time mask whose out-of-line handler (after EXIT)
# branches back into the interior loop.
BAND_LISTING = (
    "\t\tFunction : _ZN3foo15band_reg_kernelILb0ELb1ELi0ELi8ELb0EEEvNS_8BandArgsE\n"
    + _sass_lines(
        [(0x0000, "", "S2R R0, SR_TID.X")]
        # border loop 0x10-0x70: 7 instructions, 5 integer
        + [(0x0010 + 0x10 * k, "", "VIMNMX R7, R8, R7, !PT") for k in range(5)]
        + [(0x0060, "", "ISETP.GE.AND P0, PT, R3, R4, PT"),
           (0x0070, "@!P0", "BRA 0x10")]
        # interior loop 0x80-0xd0: 6 instructions, 3 integer
        + [(0x0080, "", "BRA.DIV UR7, 0x100"),
           (0x0090, "", "SHFL.UP PT, R27, R21, 0x1, RZ"),
           (0x00a0, "", "VIADDMNMX R4, R27, R4, R28, !PT"),
           (0x00b0, "", "VIMNMX R7, R8, R7, !PT"),
           (0x00c0, "", "ISETP.GE.AND P0, PT, R3, R4, PT"),
           (0x00d0, "@!P0", "BRA 0x80"),
           (0x00e0, "", "EXIT"),
           (0x00f0, "", "BRA 0xf0"),
           # the handler
           (0x0100, "", "WARPSYNC.COLLECTIVE R27, 0x130"),
           (0x0110, "", "SHFL.UP P1, R27, R21, R29, R28"),
           (0x0120, "", "ENDCOLLECTIVE"),
           (0x0130, "", "BRA 0xa0")])
    + "\t\tFunction : _ZN3foo15band_reg_kernelILb1ELb1ELi0ELi8ELb0EEEvNS_8BandArgsE\n"
    + _sass_lines([(0x0000, "", "EXIT")]))


def test_sass_reader_skips_divergent_shuffle_handlers():
    needle = sass.band_reg_needle(False, True, 0, 8, False)
    assert needle == "band_reg_kernelILb0ELb1ELi0ELi8ELb0E"
    instrs = sass.function(BAND_LISTING, needle)
    # The handler's branch back to 0xa0 is a return, not a loop.
    assert [(instrs[a].addr, instrs[b].addr) for a, b in sass.loops(instrs)] \
        == [(0x10, 0x70), (0x80, 0xd0)]
    border, interior = sass.cell_loops(BAND_LISTING, needle)
    assert border["instructions"] == 7 and interior["instructions"] == 6


@pytest.mark.parametrize("lpt", [4, 8, 16])
def test_band_interior_loop_counts_per_cell(lpt):
    needle = sass.band_reg_needle(False, True, 0, 8, False)
    row = sass.band_interior_loop(BAND_LISTING, needle, lpt)
    assert (row["first"], row["last"]) == ("0x0080", "0x00d0")
    assert row["cells_per_trip"] == 2 * lpt
    # VIADDMNMX, VIMNMX and ISETP are integer; SHFL and the branches not.
    assert row["by_kind"]["int"] == 3
    assert row["int_per_cell"] == 3 / (2 * lpt)
    # A kernel without both pair loops is refused, not guessed at.
    with pytest.raises(KeyError):
        sass.band_interior_loop(
            BAND_LISTING, sass.band_reg_needle(True, True, 0, 8, False), lpt)
