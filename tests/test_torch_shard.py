"""The port's data parallelism (bioinfo1_tpu_torch/parallel/shard.py): the
mapper's batches dealt to the devices in turn, each against its device's
index copy, held to the one-device mapper and the JAX package.

* ``pow2_prefix`` against ``bioinfo1_tpu.parallel.shard.auto_mesh`` on the
  8 virtual JAX devices of tests/conftest.py, for caps 0-9.
* ``DeviceSet``: the deal in turn (also from many threads at once), the
  thread's current device, its refusals; ``replicate_index`` keeps one
  copy per distinct device.
* A Mapper over ``[cpu] * 2`` and ``[cpu] * 4`` against the JAX CLI, which
  runs an 8-device mesh here: byte-identical PAF, score-only global and
  ``-c -a local``, every entry dealt a batch; batch by batch, its results
  and ``MapperCounters`` equal the one-device mapper's.
* ``--devices 2`` on the CPU CLI (one device there) prints the JAX CLI's
  ``--devices 2`` output.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import pytest
import torch

from bioinfo1_tpu import cli as jcli
from bioinfo1_tpu.parallel import shard as jshard
from bioinfo1_tpu_torch import cli as tcli
from bioinfo1_tpu_torch.index import builder
from bioinfo1_tpu_torch.io import fastx
from bioinfo1_tpu_torch.parallel import shard as ps
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
from test_torch_cli import (_cpu, _one_native_library, _run,  # noqa: F401
                            inputs)
from test_torch_cli_cigar import cigar_inputs  # noqa: F401

CPU = torch.device("cpu")


@pytest.mark.parametrize("cap", range(10))
def test_pow2_prefix_matches_auto_mesh(cap):
    mesh = jshard.auto_mesh(cap)
    want = 1 if mesh is None else mesh.size
    assert ps.pow2_prefix(jax.local_device_count(), cap) == want


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_device_set_deals_in_turn(n_dev):
    devices = ps.DeviceSet([CPU] * n_dev)
    assert devices.distinct() == [CPU]
    assert devices.streams == [None] * n_dev
    for _ in range(2 * n_dev + 1):
        with devices.batch() as d:
            assert d == CPU and devices.current() == CPU
    assert devices.batches == [3] + [2] * (n_dev - 1)
    assert devices.current() == CPU


def test_device_set_from_many_threads():
    """The mapper's batch threads take entries at once: every deal is
    counted once and each thread sees its own entry's device."""
    devices = ps.DeviceSet([CPU] * 4)

    def one(_):
        with devices.batch() as d:
            return d == devices.current()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            assert all(pool.map(one, range(800)))
    finally:
        sys.setswitchinterval(old)
    assert devices.batches == [200] * 4


@pytest.mark.parametrize("devices", [[], [torch.device("cuda")]],
                         ids=["empty", "no_card_index"])
def test_device_set_refuses(devices):
    with pytest.raises(ValueError, match="DeviceSet"):
        ps.DeviceSet(devices)


def test_replicate_index_keeps_one_copy_per_device():
    index = builder.build_index("ACGTTGCAAGGCTTACCGATGCATGCAAGT" * 40, 11,
                                5, 0.0)
    didx = dm.device_index_from_host(index, CPU)
    copies = ps.replicate_index(didx, ps.DeviceSet([CPU] * 3))
    assert list(copies) == [CPU] and copies[CPU] is didx


def _records(path):
    return list(fastx.parse_reads(path).records)


def test_mapper_takes_device_or_devices(inputs):
    refs = fastx.parse_fasta_any(inputs[1])
    with pytest.raises(ValueError, match="not both"):
        Mapper(refs, MapperConfig(), device=CPU, devices=[CPU, CPU])
    # On the CPU cfg.devices resolves to the one device.
    assert Mapper(refs, MapperConfig(devices=4),
                  device=CPU).devices.devices == [CPU]


_KINDS = {"score": ([], MapperConfig(batch_size=8)),
          "c_local": (["-c", "-a", "local"],
                      MapperConfig(align_type="local", output_cigar=True,
                                   batch_size=8))}


@pytest.fixture(scope="module")
def jax_paf(inputs, cigar_inputs):  # noqa: F811
    """The JAX CLI's PAF of each kind, with its reference and reads."""
    out = {}
    for kind, (flags, _cfg) in _KINDS.items():
        _, ref, fq = cigar_inputs if "-c" in flags else inputs[:3]
        rc, want, _ = _run(jcli.main, flags + [ref, fq])
        assert rc == 0
        out[kind] = (ref, fq, want)
    return out


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("kind", list(_KINDS))
def test_dealt_mapper_matches_jax_cli(jax_paf, kind, n_dev):
    ref, fq, want = jax_paf[kind]
    recs = _records(fq)
    mapper = Mapper(fastx.parse_fasta_any(ref), _KINDS[kind][1],
                    devices=[CPU] * n_dev)
    got = mapper.map_records(recs)
    assert "".join(line + "\n" for line in got) == want
    assert len(got) >= len(recs) - 2
    assert min(mapper.devices.batches) >= 1
    assert mapper.counters.faults == 0


@pytest.mark.parametrize("kind", list(_KINDS))
def test_dealt_batches_count_like_one_device(jax_paf, kind):
    """Batch by batch (no batches in flight, so the bands each batch starts
    from are the same in both runs): the results and every counter but the
    timings equal the one-device mapper's."""
    ref, fq, _ = jax_paf[kind]
    # By length, as map_records batches them: few length buckets a batch.
    seqs = sorted((s for _, s in _records(fq)), key=len)
    refs = fastx.parse_fasta_any(ref)
    cfg = _KINDS[kind][1]
    runs = []
    for mapper in (Mapper(refs, cfg, devices=[CPU, CPU]),
                   Mapper(refs, cfg, device=CPU)):
        # On a worker thread, as map_records runs its batches: torch's CPU
        # ops on the main thread run ~10x slower beside other busy
        # processes (its OpenMP team spins).
        with ThreadPoolExecutor(1) as pool:
            results = pool.submit(lambda m=mapper: [
                m.map_batch(seqs[o:o + 8])
                for o in range(0, len(seqs), 8)]).result()
        runs.append((results, {k: v for k, v in
                               mapper.counters.as_dict().items()
                               if not k.startswith("t_")}))
    (got, got_counts), (want, want_counts) = runs
    assert got == want
    assert got_counts == want_counts
    assert got_counts["faults"] == 0 and got_counts["realign_batches"] > 0


def test_cli_devices_2_matches_jax(inputs):
    _, ref, fq, _ = inputs
    rc_t, out_t, err_t = _run(tcli.main, ["--devices", "2", ref, fq])
    rc_j, out_j, _ = _run(jcli.main, ["--devices", "2", ref, fq])
    assert (rc_t, rc_j) == (0, 0), err_t
    assert out_t == out_j
    assert out_t.count("\n") > 20
