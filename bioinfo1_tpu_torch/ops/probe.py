"""Int32 add/max throughput probe (port of bench.py ``measure_sol.kern``).

The function, for an int32 tensor ``x`` and a trip count ``n_iter``: four
chains per element, chain c starting at ``x + c + 1``; trip i
(0 <= i < n_iter) applies ``a = max(a + i, a)`` 32 times to every chain;
the result is the maximum over the chains, in ``x``'s shape.  Additions
wrap in 32 bits.  While nothing wraps this is ``x + 4 + 16 * n_iter *
(n_iter - 1)``.

``int32_probe`` is the wrapper of kernel K6 (csrc/int32_probe.cu): CUDA
tensors launch the kernel, CPU tensors take ``int32_probe_plain``.  The
bench times the kernel to learn the card's sustained int32 rate, the
ceiling of every DP kernel here; the plain version only checks it.
"""

from __future__ import annotations

import torch

from bioinfo1_tpu_torch.kernels import build

ILP = 4         # independent chains per element
UNROLL = 32     # add/max steps per chain and loop trip


def source_ops(numel: int, n_iter: int) -> int:
    """Add and max operations the function performs in its loop: two per
    step, as the source writes them."""
    return numel * n_iter * UNROLL * ILP * 2


def int32_probe_plain(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Plain PyTorch version: the same arithmetic, step by step."""
    accs = [x + (c + 1) for c in range(ILP)]
    for i in range(n_iter):
        for _ in range(UNROLL):
            accs = [torch.maximum(a + i, a) for a in accs]
    r = accs[0]
    for a in accs[1:]:
        r = torch.maximum(r, a)
    return r


def int32_probe(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The probe function of ``x``: kernel K6 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.dtype != torch.int32:
        raise ValueError("int32_probe: x must be an int32 tensor")
    if n_iter < 0:
        raise ValueError("int32_probe: n_iter must be >= 0")
    if x.device.type == "cpu":
        return int32_probe_plain(x, n_iter)
    if not x.is_contiguous():
        raise ValueError("int32_probe: x must be contiguous")
    out = torch.empty_like(x)
    if x.numel():
        build.launch(int32_probe, "bioinfo1_int32_probe", x.data_ptr(),
                     out.data_ptr(), x.numel(), n_iter, 1,
                     torch.cuda.current_stream(x.device).cuda_stream,
                     device=x.device)
    return out


int32_probe.launches = 0
