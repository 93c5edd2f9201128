"""The int32 throughput probe of the port against the TPU kernel.

``ops/probe.int32_probe_plain`` (what a CPU tensor gets from
``int32_probe``) against bench.py's ``measure_sol.kern`` run through
``pl.pallas_call(..., interpret=True)`` - the kernel's lines are copied
here, since importing bench.py would edit ``sys.path`` - and against the
closed form.  Integers, tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bioinfo1_tpu_torch.ops import probe

SHAPE, ILP, KU = (8, 128), 4, 32


def kern(n_iter, x_ref, o_ref):
    accs = [x_ref[...] + (i + 1) for i in range(ILP)]

    def body(i, accs):
        for _ in range(KU):
            accs = [jnp.maximum(a + i, a) for a in accs]
        return accs

    accs = jax.lax.fori_loop(0, n_iter, body, accs)
    r = accs[0]
    for a in accs[1:]:
        r = jnp.maximum(r, a)
    o_ref[...] = r


def _pallas(x, n_iter):
    f = pl.pallas_call(functools.partial(kern, n_iter),
                       out_shape=jax.ShapeDtypeStruct(SHAPE, jnp.int32),
                       interpret=True)
    return np.asarray(jax.device_get(f(jnp.asarray(x))))


@pytest.mark.parametrize("n_iter", [0, 1, 7])
def test_probe_plain_equals_tpu_kernel_and_closed_form(n_iter):
    assert (probe.ILP, probe.UNROLL) == (ILP, KU)
    rng = np.random.default_rng(n_iter)
    x = rng.integers(-10**6, 10**6, SHAPE).astype(np.int32)
    got = probe.int32_probe(torch.from_numpy(x), n_iter)
    assert got.dtype == torch.int32 and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.numpy(), _pallas(x, n_iter))
    np.testing.assert_array_equal(got.numpy(),
                                  x + 4 + 16 * n_iter * (n_iter - 1))
    assert torch.equal(got, probe.int32_probe_plain(torch.from_numpy(x),
                                                    n_iter))


def test_probe_wraps_like_the_tpu_kernel():
    """Near INT32_MAX a + i wraps negative and the max keeps a."""
    x = np.full(SHAPE, 2**31 - 40, np.int32)
    x[0, :4] = [-2**31, 0, 2**31 - 6, 2**31 - 5]
    got = probe.int32_probe(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), _pallas(x, 3))


def test_probe_counts_and_rejects():
    assert probe.source_ops(256 * 1024, 1000) == 256 * 1024 * 1000 * 256
    with pytest.raises(ValueError):
        probe.int32_probe(torch.zeros(4, dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        probe.int32_probe(torch.zeros(4, dtype=torch.int32), -1)
    assert probe.int32_probe.launches == 0      # no kernel on the CPU
