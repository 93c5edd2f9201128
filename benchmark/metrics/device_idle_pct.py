"""Share of the traced stretch in which no operation ran on a card, the
mean over the cards the mapper uses."""


def read(ctx):
    if ctx.trace is None or not ctx.card_ids or ctx.trace.seconds <= 0:
        return None
    s = ctx.trace.seconds
    idle = [100.0 * (1.0 - ctx.busy_by_card[d] / s) for d in ctx.card_ids]
    return sum(idle) / len(idle)
