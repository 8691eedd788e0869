"""The whole pool as one batch: ``serving.compress_batch`` of the stack of
fields, then ``serving.decompress_batch`` of its archives. A closed loop
with one caller, as in-situ checkpointing of one shape every time step."""

from __future__ import annotations


def one(ctx, timed: bool = True) -> None:
    stack = ctx.pool
    t0 = ctx.clock()
    blobs = ctx.program.compress_batch(stack, ctx.conf)
    ctx.sync()
    t1 = ctx.clock()
    out = ctx.program.decompress_batch(blobs)
    ctx.sync()
    t2 = ctx.clock()
    if timed:
        size = sum(len(b) for b in blobs)
        ctx.record("compress", t0, t1, stack.nbytes, len(stack), size)
        ctx.record("decompress", t1, t2, out.numel() * out.element_size(), len(blobs), size)
        for k in range(out.shape[0]):
            ctx.keep(k, out[k])


def warm(ctx) -> None:
    one(ctx, timed=False)


def step(ctx, i: int) -> None:
    one(ctx)
