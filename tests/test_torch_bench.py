"""bench_torch.py at toy sizes on the CPU, and the SASS reader it uses.

``python3 bench_torch.py --platform cpu --tiny`` must exit 0 and print one
JSON line that carries every metric name bench.py prints and the port
keeps, the ``*_baseline`` ratios against the rate pinned in
BASELINE_MEASURED.json, and at toy sizes the two measurements of the
``tools/`` scripts (``scaling``: one and two CPU processes; ``sharded_genome``:
two CPU entries, auto-sharded at a 1e3-byte budget); a measurement that
raises must end the run with a non-zero exit and no result line.
``sass_census.py`` is held to a listing in the format ``cuobjdump -sass``
prints.
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
    "baseline_omp_reads_per_s", "device", "nvidia_smi", "baseline_note",
    "scaling", "sharded_genome"]
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
    assert res["unit"] == "reads/s"
    assert res["value"] > 0
    extra = res["extra"]
    for k in EXTRA_KEYS:
        assert k in extra, k
    # The baseline is the pinned reference rate, read and never measured.
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as fh:
        base = json.load(fh)["reads_per_s"]
    assert extra["baseline_reads_per_s"] == round(base, 3)
    assert extra["baseline_omp_reads_per_s"] is None
    assert res["vs_baseline"] == round(res["value"] / base, 2)
    assert extra["indel_vs_baseline"] == \
        round(extra["indel_reads_per_s"] / base, 2)
    assert extra["repeat_vs_baseline"] == \
        round(extra["repeat_reads_per_s"] / base, 2)
    scaling = extra["scaling"]
    assert scaling["cards"] == 0 and scaling["platform"] == "cpu"
    assert sorted(scaling["configs"]) == ["1", "2"]
    for n, row in scaling["configs"].items():
        assert row["nproc"] == int(n) and row["oversubscribed"] is False
        assert row["mapped"] == row["n_reads"] > 0
        assert row["map_s"] == row["map_only_s"] + row["merge_s"]
        assert len(row["map_only_runs_s"]) == 3
    assert scaling["efficiency"]["1"] == 1.0
    assert scaling["efficiency_map_only"]["1"] == 1.0
    assert scaling["efficiency"]["2"] > 0
    sharded = extra["sharded_genome"]
    assert sharded["entries"] == ["cpu", "cpu"]
    assert sharded["auto_shards_engaged"] == 2
    assert sharded["output_identical_to_replicated"] is True
    assert sharded["mapped_sharded"] == sharded["n_reads"] > 0
    assert len(sharded["per_entry_lookup_bytes_sharded"]) == 2
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


@pytest.mark.parametrize("rate", [17.2260, 17.2275, 17.2283, 11.151, 0.004])
def test_ratios_divide_the_printed_rates(rate):
    """A *_vs_baseline ratio is that of the printed rate to the pinned
    base: a rate of 17.226-17.228 reads/s prints as 17.23, whose ratio to
    11.151 rounds to 1.55 where the unrounded rate's rounds to 1.54."""
    import bench_torch
    shown, ratio = bench_torch.printed_ratio(rate, 11.151)
    assert shown == round(rate, 2)
    assert ratio == round(shown / 11.151, 2)
    if 17.225 <= rate < 17.2283:
        assert ratio == 1.55 != round(rate / 11.151, 2)


def test_scaling_workload_is_the_tools_draw_for_draw(tmp_path):
    """measure_scaling's reads file and genome are
    tools/measure_scaling.py's and tools/scaling_worker.py's, byte for
    byte."""
    import importlib.util

    import numpy as np

    import bench_torch
    spec = importlib.util.spec_from_file_location(
        "measure_scaling", os.path.join(REPO, "tools", "measure_scaling.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.write_reads(str(tmp_path))
    got = tmp_path / "port.fasta"
    bench_torch.write_scaling_reads(str(got), bench_torch.FULL)
    with open(want) as fh:
        assert got.read_text() == fh.read()
    rng = np.random.default_rng(42)            # scaling_worker.py's genome
    assert bench_torch.scaling_genome(200_000) == "".join(
        "CATG"[i] for i in rng.integers(0, 4, 200_000))


def test_sharded_genome_workload_is_the_demos_draw_for_draw():
    """measure_sharded_genome's genome and reads are
    tools/demo_sharded_big_genome.py's (its draws, here at a toy length)."""
    import dataclasses

    import numpy as np

    import bench_torch
    sizes = dataclasses.replace(bench_torch.TINY, sharded_genome=50_000,
                                sharded_reads=6, sharded_read_len=4000)
    rng = np.random.default_rng(20260822)
    bases = np.frombuffer(b"CATG", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, sizes.sharded_genome)]
    records = []
    for i in range(sizes.sharded_reads):
        s = int(rng.integers(0, sizes.sharded_genome - 4000))
        r = genome[s:s + 4000].copy()
        pos = rng.integers(0, 4000, 4000 // 50)
        r[pos] = bases[rng.integers(0, 4, len(pos))]
        records.append((f"r{i}", r.tobytes().decode("latin1")))
    assert bench_torch.sharded_genome_workload(sizes) == \
        (genome.tobytes().decode("latin1"), records)


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
    "\t\tFunction : _ZN3foo15band_reg_kernelILb0ELb1ELi0ELi8ELb0ELb0EEEvNS_8BandArgsE\n"
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
    + "\t\tFunction : _ZN3foo15band_reg_kernelILb1ELb1ELi0ELi8ELb0ELb0EEEvNS_8BandArgsE\n"
    + _sass_lines([(0x0000, "", "EXIT")]))


def test_sass_reader_skips_divergent_shuffle_handlers():
    needle = sass.band_reg_needle(False, True, 0, 8, False)
    assert needle == "band_reg_kernelILb0ELb1ELi0ELi8ELb0ELb0E"
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


def test_plan_needle_names_each_register_path():
    """The kernel that serves a plan: one warp (W = 256), several warps
    (W = 512), a cluster (W = 25,088), strips (W = 32,896), and past the
    strips K2's epochs (W = 540,800)."""
    from bioinfo1_tpu_torch.ops import band as bd
    want = {256: "Lb0ELb0E", 512: "Lb1ELb0E", 25088: "Lb1ELb1E"}
    for W, tail in want.items():
        for parents in (False, True):
            needle = sass.plan_needle(bd.band_plan(W, 11, parents), parents)
            assert needle == (f"band_reg_kernelILb{int(parents)}ELb1ELi0E"
                              f"Li8E{tail}")
    for parents in (False, True):
        needle = sass.plan_needle(bd.band_plan(32896, 11, parents), parents,
                                  mode=2)
        assert needle == f"band_strip_kernelILb{int(parents)}ELb1ELi2E"
    plan = bd.band_plan(bd.W_STRIP + 128, 1, False)
    assert sass.plan_needle(plan, False, mode=1) == \
        f"band_epoch_kernelILb1ELi1ELi{bd.EPOCH_HALO}E"


# The walk kernel in miniature: a copy loop (cp.async, LDGSTS), the step
# loop, which reads a staged byte (LDS) and stores codes (STG), and a tail
# loop that stores codes only.
WALK_LISTING = (
    "\t\tFunction : _ZN3foo19walk_parents_kernelILb0EEEvPKhiiiPh\n"
    + _sass_lines(
        [(0x0000, "", "S2R R0, SR_TID.X"),
         (0x0010, "", "IMAD R4, R0, 0x10, R2"),
         (0x0020, "", "LDGSTS.E.BYPASS.128 [R4], desc[UR4][R6.64]"),
         (0x0030, "", "ISETP.GE.AND P0, PT, R4, R3, PT"),
         (0x0040, "@!P0", "BRA 0x10"),
         (0x0050, "", "LDS.U8 R8, [R9]"),
         (0x0060, "", "SHF.R.U32.HI R8, RZ, R10, R8"),
         (0x0070, "", "LOP3.LUT R8, R8, 0x3, RZ, 0xc0, !PT"),
         (0x0080, "@!P1", "STG.E.U8 desc[UR4][R2.64], R8"),
         (0x0090, "", "IMAD.IADD R9, R9, 0x1, R8"),
         (0x00a0, "", "ISETP.GE.AND P0, PT, R9, R3, PT"),
         (0x00b0, "@!P0", "BRA 0x50"),
         (0x00c0, "", "STG.E.U8 desc[UR4][R2.64], R11"),
         (0x00d0, "", "IADD3 R11, R11, 0x1, RZ"),
         (0x00e0, "@!P0", "BRA 0xc0"),
         (0x00f0, "", "EXIT"),
         (0x0100, "", "BRA 0x100")])
    + "\t\tFunction : _ZN3foo19walk_parents_kernelILb1EEEvPKhiiiPh\n"
    + _sass_lines([(0x0000, "", "EXIT")]))


def test_walk_step_loop_is_the_loop_that_stores_codes():
    row = sass.walk_step_loop(WALK_LISTING)
    assert (row["first"], row["last"]) == ("0x0050", "0x00b0")
    # SHF, LOP3, IMAD and ISETP are integer; LDS, STG and BRA not.
    assert row["int_per_step"] == row["by_kind"]["int"] == 4
    # A kernel without a step loop is refused, not guessed at.
    with pytest.raises(KeyError):
        sass.walk_step_loop(WALK_LISTING, local=True)


def _chain_function(path):
    """The chain kernel in miniature: a bounds loop (REDUX with a load), the
    cross loop (the largest: 8 pairs a trip, 16 integer instructions), the
    serial loop (one REDUX, no memory access; 5 integer instructions) and
    the chase loop."""
    cross = [(0x0100 + 0x10 * k, "", "IADD3 R7, R8, -R9, RZ")
             for k in range(15)]
    rows = ([(0x0000, "", "S2R R0, SR_TID.X"),
             (0x0010, "", "LDG.E R4, desc[UR4][R2.64]"),
             (0x0020, "", "REDUX.MIN.S32 UR5, R4"),
             (0x0030, "", "ISETP.GE.AND P0, PT, R3, R4, PT"),
             (0x0040, "@!P0", "BRA 0x10"),
             (0x00f0, "", "LDS.128 R8, [R5]")]
            + cross
            + [(0x0200, "", "ISETP.GE.AND P0, PT, R3, R4, PT"),
               (0x0210, "@!P0", "BRA 0xf0"),
               (0x0220, "", "SEL R6, R7, RZ, P1"),
               (0x0230, "", "REDUX.MAX UR6, R6"),
               (0x0240, "", "VIMNMX.U32 R9, R6, R10, !PT"),
               (0x0250, "", "LOP3.LUT R11, R9, 0xffff0000, RZ, 0xc0, !PT"),
               (0x0260, "", "IADD3 R3, R3, 0x1, RZ"),
               (0x0270, "", "ISETP.GE.AND P0, PT, R3, R4, PT"),
               (0x0280, "@!P0", "BRA 0x220"),
               (0x0290, "", "LDS.U16 R12, [R12]"),
               (0x02a0, "", "ISETP.NE.AND P0, PT, R12, 0xffff, PT"),
               (0x02b0, "@P0", "BRA 0x290"),
               (0x02c0, "", "EXIT"),
               (0x02d0, "", "BRA 0x2d0")])
    return (f"\t\tFunction : _ZN3foo16lis_chain_kernelILi{path}EEvPKiS1_S1_ii"
            "PjPtPi\n" + _sass_lines(rows))


def test_chain_loops_finds_the_cross_and_the_serial_loop():
    listing = "".join(_chain_function(p) for p in range(4))
    got = sass.chain_loops(listing)
    assert set(got) == {"shared", "state", "scratch", "wide"}
    for row in got.values():
        cross, serial = row["cross"], row["serial"]
        assert (cross["first"], cross["last"]) == ("0x00f0", "0x0210")
        assert cross["int_per_pair"] == 16 / 8       # 15 IADD3 + ISETP
        assert (serial["first"], serial["last"]) == ("0x0220", "0x0280")
        # SEL, VIMNMX, LOP3, IADD3, ISETP; REDUX is no integer instruction.
        assert serial["int_per_step"] == 5
        assert serial["by_op"]["REDUX"] == 1
    # A listing without the kernel's four instantiations is refused.
    with pytest.raises(KeyError):
        sass.chain_loops(_chain_function(0))
