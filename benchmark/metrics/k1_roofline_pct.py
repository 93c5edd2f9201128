"""K1's share of its roofline over the traced stretch: the card's least
time for the calls' work (benchmark/work.py) over the time their kernels
took, summed over the calls whose kernels the trace holds."""


def read(ctx):
    calls = [(b, k) for kind, b, k in ctx.calls if kind == "K1"]
    spent = sum(k for _, k in calls)
    return 100.0 * sum(b for b, _ in calls) / spent if spent > 0 else None
