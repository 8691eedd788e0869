"""One field at a time: ``compress`` of a field of the pool, then
``decompress`` of the archive just written, the pool taken in order and
cycled. A closed loop with one caller, as a simulation's writer and the
analyst who reads the output back."""

from __future__ import annotations


def one(ctx, i: int, timed: bool = True) -> None:
    k = i % len(ctx.pool)
    field = ctx.pool[k]
    t0 = ctx.clock()
    blob = ctx.program.compress(field, ctx.conf)
    ctx.sync()
    t1 = ctx.clock()
    out = ctx.program.decompress(blob)
    ctx.sync()
    t2 = ctx.clock()
    if timed:
        ctx.record("compress", t0, t1, field.nbytes, 1, len(blob))
        ctx.record("decompress", t1, t2, out.numel() * out.element_size(), 1, len(blob))
        ctx.keep(k, out)


def warm(ctx) -> None:
    """Each field of the pool once: every shape, and every algorithm the
    tuner picks for them, meets the program before the window."""
    for i in range(len(ctx.pool)):
        one(ctx, i, timed=False)


def step(ctx, i: int) -> None:
    one(ctx, i)
